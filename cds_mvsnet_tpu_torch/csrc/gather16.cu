// P2: the row gather with 16-bit value and index types, and the int16
// arithmetic probe. Wrappers, plain versions and design note:
// ops/kernels/gather16.py.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

constexpr int kThreads = 128;         // int16_arith, the direct gather, the smallest staged block
constexpr int kMaxThreads = 1024;     // the largest staged block
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets without opting in
constexpr int kMaxSmem = 232448;      // what one block may opt in to on the H100
constexpr int kUnroll = 4;            // loads a thread keeps in flight
constexpr int kTargetBlocks = 264;    // two blocks for each of the H100's 132 SMs
constexpr int kMinChunk = 4096;       // the fewest outputs a staged block gathers

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// A source value as fp32, read through the read-only cache.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) {
  return bf2f(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// idx[i] converted to the index type I as an astype would (int16 wraps), a
// negative index counting from the row's end.
template <typename I>
__device__ __forceinline__ int row_index(const int* __restrict__ idx, long long i, int L) {
  const int j = static_cast<int>(static_cast<I>(__ldg(idx + i)));
  return j < 0 ? j + L : j;
}

// Row [0, L) of s into shared memory as V. vec: 16-byte loads (the row's
// start 16-byte aligned, L·sizeof(S) a multiple of 16), stored as they came
// where S is V; else one value a load. Each thread keeps kUnroll loads in
// flight.
template <typename S, typename V>
__device__ __forceinline__ void stage_row(const S* __restrict__ s, V* row, int L, bool vec) {
  const int step = blockDim.x;
  if (vec) {
    constexpr int kPer = 16 / sizeof(S);
    const int nv = L / kPer;
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (int q0 = threadIdx.x; q0 < nv; q0 += kUnroll * step) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = q0 + u * step < nv ? __ldg(sv + q0 + u * step) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * step;
        if (q >= nv) continue;
        if constexpr (std::is_same<S, V>::value) {
          reinterpret_cast<uint4*>(row)[q] = w[u];
        } else {
          const S* e = reinterpret_cast<const S*>(&w[u]);
#pragma unroll
          for (int k = 0; k < kPer; ++k) row[q * kPer + k] = from_f32<V>(to_f32(e[k]));
        }
      }
    }
  } else {
    for (int l0 = threadIdx.x; l0 < L; l0 += kUnroll * step) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = l0 + u * step < L ? ldg_f32(s + l0 + u * step) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (l0 + u * step < L) row[l0 + u * step] = from_f32<V>(v[u]);
    }
  }
}

// Rows that fit in shared memory: block (r, b) stages row r, converted to
// the value type V (the TPU's lane crossbar reads one vreg row), then
// gathers part b of the row's outputs, [b * chunk, b * chunk + chunk), from
// shared memory. An index outside [-L, L) gives NaN, as
// jnp.take_along_axis fills. Each thread keeps kUnroll loads in flight.
template <typename S, typename V, typename I>
__global__ void __launch_bounds__(kMaxThreads) row_gather_kernel(const S* __restrict__ src,   // (R, L)
                                                                 const int* __restrict__ idx,  // (R, L)
                                                                 float* __restrict__ out,      // (R, L)
                                                                 int L, int chunk, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* row = reinterpret_cast<V*>(smem);
  const long long base = (long long)blockIdx.x * L;
  stage_row(src + base, row, L, vec != 0);
  __syncthreads();
  const int step = blockDim.x;
  const int begin = blockIdx.y * chunk, end = min(L, begin + chunk);
  for (int l0 = begin + threadIdx.x; l0 < end; l0 += kUnroll * step) {
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) j[u] = l0 + u * step < end ? row_index<I>(idx, base + l0 + u * step, L) : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (l0 + u * step < end) out[base + l0 + u * step] = (j[u] >= 0 && j[u] < L) ? to_f32(row[j[u]]) : nan_f32();
  }
}

// Rows longer than shared memory holds: each thread gathers kUnroll outputs
// of a row, kThreads apart, straight from device memory through the
// read-only cache, converting to V at the load; blocks (x, y) walk rows y,
// y + gridDim.y, ...
template <typename S, typename V, typename I>
__global__ void __launch_bounds__(kThreads) row_gather_direct_kernel(const S* __restrict__ src,
                                                                     const int* __restrict__ idx,
                                                                     float* __restrict__ out, int R, int L) {
  const int l0 = blockIdx.x * (kUnroll * kThreads) + threadIdx.x;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const long long base = (long long)r * L;
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) j[u] = l0 + u * kThreads < L ? row_index<I>(idx, base + l0 + u * kThreads, L) : -1;
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = (j[u] >= 0 && j[u] < L) ? to_f32(from_f32<V>(ldg_f32(src + base + j[u]))) : nan_f32();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (l0 + u * kThreads < L) out[base + l0 + u * kThreads] = v[u];
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

// Lift the staged kernel's dynamic shared memory limit to kMaxSmem, once per
// process, instantiation and device (one bit per device index).
template <typename S, typename V, typename I>
static int opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  err = cudaFuncSetAttribute(row_gather_kernel<S, V, I>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

// The staged block: 128 threads, doubled while a thread would stage more than
// 8 values, up to 1024.
static int staged_threads(int L) {
  int t = kThreads;
  while (t < kMaxThreads && t * 8 < L) t *= 2;
  return t;
}

// Blocks a staged row is split into: enough to give the card kTargetBlocks,
// while each gathers at least kMinChunk outputs (each stages the whole row).
static int row_parts(int R, int L) {
  const int fill = (kTargetBlocks + R - 1) / R;
  return std::max(1, std::min(fill, L / kMinChunk));
}

template <typename S, typename V, typename I>
static int launch(const void* src, const void* idx, void* out, int R, int L, cudaStream_t st) {
  const size_t smem = (size_t)L * sizeof(V);
  if (smem <= (size_t)kMaxSmem) {
    if (smem > (size_t)kDefaultSmem) {
      const int err = opt_in<S, V, I>();
      if (err) return err;
    }
    const int parts = row_parts(R, L);
    const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && (size_t)L * sizeof(S) % 16 == 0;
    row_gather_kernel<S, V, I><<<dim3(R, parts), staged_threads(L), smem, st>>>(
        static_cast<const S*>(src), static_cast<const int*>(idx), static_cast<float*>(out), L,
        (L + parts - 1) / parts, vec);
  } else {
    const dim3 grid((L + kUnroll * kThreads - 1) / (kUnroll * kThreads), std::min(R, 65535));
    row_gather_direct_kernel<S, V, I><<<grid, kThreads, 0, st>>>(
        static_cast<const S*>(src), static_cast<const int*>(idx), static_cast<float*>(out), R, L);
  }
  return (int)cudaGetLastError();
}

template <typename S, typename V>
static int launch_index(const void* src, const void* idx, void* out, bool index16, int R, int L, cudaStream_t st) {
  return index16 ? launch<S, V, int16_t>(src, idx, out, R, L, st) : launch<S, V, int32_t>(src, idx, out, R, L, st);
}

template <typename S>
static int launch_value(const void* src, const void* idx, void* out, int form, int R, int L, cudaStream_t st) {
  return (form & 2) ? launch_index<S, bf16>(src, idx, out, form & 4, R, L, st)
                    : launch_index<S, float>(src, idx, out, form & 4, R, L, st);
}

// form: bit 0 a bf16 source (else fp32), bit 1 bf16 values (else fp32),
// bit 2 int16 indices (else int32).
CDS_EXPORT int row_gather_launch(const void* src, const void* idx, void* out, int form, int R, int L, void* stream) {
  if (R <= 0 || L <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (form & 1) ? launch_value<bf16>(src, idx, out, form, R, L, st)
                    : launch_value<float>(src, idx, out, form, R, L, st);
}

CDS_EXPORT int int16_arith_launch(const void* src, void* out, int L, long long n, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  int16_arith_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(src),
                                                                              static_cast<float*>(out), L, n);
  return (int)cudaGetLastError();
}
