// K1 and K5's forward: fused plane-sweep warp + ref inner product, ending in
// the online softmax entropy (K1) or in the per-plane similarity (K5).
// Wrappers, plain versions and design notes: ops/kernels/warp.py (K1),
// ops/kernels/warp_vjp.py (K5).
#include "warp.cuh"

// kSim = false: out is the entropy (h, w) of softmax_D(sim).
// kSim = true:  out is sim (D, h, w).
template <int C, bool kSim>
__global__ void __launch_bounds__(128) warp_kernel(
    const bf16* __restrict__ src,      // (H, W, C) channels-last source features
    const bf16* __restrict__ ref,      // (C, h, w) reference features
    const float* __restrict__ depth,   // (D,) or (D, h, w) hypotheses
    int depth_per_pixel,
    const float* __restrict__ rt,      // (12,) rot row-major ++ trans
    bf16* __restrict__ in_prod,        // (C, D, h, w)
    float* __restrict__ out,
    int H, int W, int D, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t hw = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rt + i);
  float L[3];
  plane_rows(r, x, y, L);

  float refv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = bf2f(ref[c * hw + pix]);

  // online (max, sum e, sum sim*e): entropy = m + log s - u / s
  float m = -1e30f, s = 0.f, u = 0.f;
  for (int d = 0; d < D; ++d) {
    const float dep = depth_per_pixel ? depth[d * hw + pix] : __ldg(depth + d);
    const Footprint f = project(r, L, dep, H, W);
    float acc[C];
    gather<C, kSim>(src, f, W, acc);  // K5 gathers exactly, K1 fuses (warp.cuh)

    float sim = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wq = bf2f(f2bf(acc[c]));  // warped value in the feature dtype
      in_prod[((size_t)c * D + d) * hw + pix] = f2bf(refv[c] * wq);
      sim += wq * refv[c];
    }
    if constexpr (kSim) {
      out[d * hw + pix] = sim;
    } else {
      const float mn = fmaxf(m, sim);
      const float alpha = expf(m - mn);
      const float e = expf(sim - mn);
      s = s * alpha + e;
      u = u * alpha + sim * e;
      m = mn;
    }
  }
  if constexpr (!kSim) out[pix] = (m + logf(s)) - u / s;
}

template <bool kSim>
static int launch(const void* src, const void* ref, const void* depth, int depth_per_pixel,
                  const void* rt, void* in_prod, void* out, int C, int H, int W, int D, int h,
                  int w, void* stream) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const bf16*>(src), static_cast<const bf16*>(ref),
        static_cast<const float*>(depth), depth_per_pixel, static_cast<const float*>(rt),
        static_cast<bf16*>(in_prod), static_cast<float*>(out), H, W, D, h, w);
  };
  switch (C) {
    case 8: args(warp_kernel<8, kSim>); break;
    case 16: args(warp_kernel<16, kSim>); break;
    case 32: args(warp_kernel<32, kSim>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

CDS_EXPORT int warp_entropy_launch(const void* src, const void* ref, const void* depth,
                                   int depth_per_pixel, const void* rt, void* in_prod,
                                   void* entropy, int C, int H, int W, int D, int h, int w,
                                   void* stream) {
  return launch<false>(src, ref, depth, depth_per_pixel, rt, in_prod, entropy, C, H, W, D, h, w,
                       stream);
}

CDS_EXPORT int warp_sim_launch(const void* src, const void* ref, const void* depth,
                               int depth_per_pixel, const void* rt, void* in_prod, void* sim,
                               int C, int H, int W, int D, int h, int w, void* stream) {
  return launch<true>(src, ref, depth, depth_per_pixel, rt, in_prod, sim, C, H, W, D, h, w,
                      stream);
}
