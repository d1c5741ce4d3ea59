// K9: the plane-sweep gather, bilinear with zeros padding at given source
// coordinates. Wrapper, plain version and design note: ops/kernels/gather.py.
#include "warp.cuh"

constexpr int kThreads = 256;

// One thread per output (d, y, x): the footprint once, each corner one
// contiguous C-vector, C stores strided by D*h*w (consecutive threads store
// consecutive addresses).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const T* __restrict__ src,     // (H, W, C) channels-last source
    const float* __restrict__ px,  // (D, h, w) source-pixel x
    const float* __restrict__ py,  // (D, h, w) source-pixel y
    T* __restrict__ out,           // (C, D, h, w)
    int H, int W, long long n) {   // n = D * h * w
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Footprint f = footprint(__ldg(px + i), __ldg(py + i), H, W);
  float acc[C];
  gather<C, true>(src, f, W, acc);  // op by op, as the plain version sums
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)c * n + i] = from_f32<T>(acc[c]);
}

template <typename T>
static int launch(const void* src, const void* px, const void* py, void* out, int C, int H, int W,
                  long long n, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const T*>(src), static_cast<const float*>(px),
                                      static_cast<const float*>(py), static_cast<T*>(out), H, W, n);
  };
  switch (C) {
    case 8: args(gather_kernel<T, 8>); break;
    case 16: args(gather_kernel<T, 16>); break;
    case 32: args(gather_kernel<T, 32>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// fp32 = 1 for an fp32 source and output, 0 for bf16.
CDS_EXPORT int warp_gather_launch(const void* src, const void* px, const void* py, void* out,
                                  int fp32, int C, int H, int W, long long n, void* stream) {
  if (n <= 0) return 0;
  return fp32 ? launch<float>(src, px, py, out, C, H, W, n, stream)
              : launch<bf16>(src, px, py, out, C, H, W, n, stream);
}
