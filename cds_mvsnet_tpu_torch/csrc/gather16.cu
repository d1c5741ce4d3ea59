// P2: the row gather with 16-bit value and index types, and the int16
// arithmetic probe. Wrappers, plain versions and design note:
// ops/kernels/gather16.py.
#include <cstdint>

#include "common.cuh"

constexpr int kThreads = 128;

// One block per row: the row, converted to the value type V, is staged in
// shared memory (the TPU's lane crossbar reads one vreg row); each thread
// then gathers outputs, its index converted to the index type I as an
// astype would (int16 wraps), negative indices counting from the row's end
// and indices outside [-L, L) giving NaN, as jnp.take_along_axis fills.
template <typename S, typename V, typename I>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(const S* __restrict__ src,   // (R, L)
                                                              const int* __restrict__ idx,  // (R, L)
                                                              float* __restrict__ out,      // (R, L)
                                                              int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* row = reinterpret_cast<V*>(smem);
  const size_t base = (size_t)blockIdx.x * L;
  for (int l = threadIdx.x; l < L; l += kThreads) row[l] = from_f32<V>(to_f32(src[base + l]));
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kThreads) {
    int j = static_cast<int>(static_cast<I>(__ldg(idx + base + l)));
    if (j < 0) j += L;
    out[base + l] = (j >= 0 && j < L) ? to_f32(row[j]) : __int_as_float(0x7fc00000);
  }
}

// out = src + ((int16(l) + 3) % 7 == 2), the lane index l and its
// arithmetic in int16 (wrapping), % floored as jnp's.
__global__ void __launch_bounds__(kThreads) int16_arith_kernel(const float* __restrict__ src,
                                                               float* __restrict__ out, int L, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const short lane = static_cast<short>(i % L);
  const short j = static_cast<short>(lane + static_cast<short>(3));
  short m = static_cast<short>(j % static_cast<short>(7));
  if (m < 0) m = static_cast<short>(m + 7);
  out[i] = src[i] + (m == 2 ? 1.f : 0.f);
}

template <typename S, typename V>
static int launch_index(const void* src, const void* idx, void* out, int index16, int R, int L, cudaStream_t st) {
  const size_t smem = (size_t)L * sizeof(V);
  auto go = [&](auto kernel) {
    kernel<<<R, kThreads, smem, st>>>(static_cast<const S*>(src), static_cast<const int*>(idx),
                                      static_cast<float*>(out), L);
  };
  if (index16)
    go(row_gather_kernel<S, V, int16_t>);
  else
    go(row_gather_kernel<S, V, int32_t>);
  return (int)cudaGetLastError();
}

template <typename S>
static int launch_value(const void* src, const void* idx, void* out, int value_bf16, int index16, int R, int L,
                        cudaStream_t st) {
  return value_bf16 ? launch_index<S, bf16>(src, idx, out, index16, R, L, st)
                    : launch_index<S, float>(src, idx, out, index16, R, L, st);
}

// src_bf16 / value_bf16: bf16 (1) or fp32 (0); index16: int16 (1) or int32 (0).
CDS_EXPORT int row_gather_launch(const void* src, const void* idx, void* out, int src_bf16, int value_bf16,
                                 int index16, int R, int L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  if ((size_t)L * (value_bf16 ? 2 : 4) > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return src_bf16 ? launch_value<bf16>(src, idx, out, value_bf16, index16, R, L, st)
                  : launch_value<float>(src, idx, out, value_bf16, index16, R, L, st);
}

CDS_EXPORT int int16_arith_launch(const void* src, void* out, int L, long long n, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  int16_arith_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(src),
                                                                              static_cast<float*>(out), L, n);
  return (int)cudaGetLastError();
}
