// K8: the fused plane-sweep warp from precomputed source-pixel coordinates,
// in_prod = ref * bf16(warped) and sim = sum_C f32(bf16(warped)) * f32(ref),
// for one source view or for all source views of a stage in one launch.
// Wrapper, plain version and design note: ops/kernels/warp_coords.py.
#include "warp.cuh"

// One thread per reference pixel (x, y) of view blockIdx.z loops over the
// planes; the ref vector stays in registers. The gather sums op by op as
// the plain version does (warp.cuh), so warped, and with it in_prod, equals
// the plain version's bit for bit.
template <int C>
__global__ void __launch_bounds__(128) warp_coords_kernel(
    const bf16* __restrict__ src,   // (V, H, W, C) channels-last source features
    const bf16* __restrict__ ref,   // (V, C, h, w) reference features
    const float* __restrict__ px,   // (V, D, h, w) source-pixel x
    const float* __restrict__ py,   // (V, D, h, w) source-pixel y
    bf16* __restrict__ in_prod,     // (V, C, D, h, w)
    float* __restrict__ sim,        // (V, D, h, w)
    int H, int W, int D, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const size_t v = blockIdx.z;
  if (x >= w) return;
  const size_t hw = (size_t)h * w, n = (size_t)D * hw;
  const size_t pix = (size_t)y * w + x;
  src += v * H * W * C;
  ref += v * C * hw;
  px += v * n;
  py += v * n;
  in_prod += v * C * n;
  sim += v * n;

  float refv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = bf2f(ref[c * hw + pix]);
  for (int d = 0; d < D; ++d) {
    const size_t i = d * hw + pix;
    const Footprint f = footprint(__ldg(px + i), __ldg(py + i), H, W);
    float acc[C];
    gather<C, true>(src, f, W, acc);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wq = bf2f(f2bf(acc[c]));  // warped value in the feature dtype
      in_prod[c * n + i] = f2bf(refv[c] * wq);
      s = fmaf(wq, refv[c], s);
    }
    sim[i] = s;
  }
}

CDS_EXPORT int warp_sim_coords_launch(const void* src, const void* ref, const void* px,
                                      const void* py, void* in_prod, void* sim, int V, int C,
                                      int H, int W, int D, int h, int w, void* stream) {
  if (V <= 0 || D <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h, V);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(static_cast<const bf16*>(src), static_cast<const bf16*>(ref),
                                   static_cast<const float*>(px), static_cast<const float*>(py),
                                   static_cast<bf16*>(in_prod), static_cast<float*>(sim), H, W, D,
                                   h, w);
  };
  switch (C) {
    case 8: args(warp_coords_kernel<8>); break;
    case 16: args(warp_coords_kernel<16>); break;
    case 32: args(warp_coords_kernel<32>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
