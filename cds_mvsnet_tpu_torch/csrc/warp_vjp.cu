// K5's backward: the VJP of the fused plane-sweep warp (warp.cu, kSim) with
// respect to the source and reference features. Wrapper, plain version and
// design note: ops/kernels/warp_vjp.py.
#include "warp.cuh"

// Add v[0..C) into p[0..C) (fp32, global memory): 16-byte vector atomics,
// which sm_90 has, a quarter of the scalar ones.
template <int C>
__device__ __forceinline__ void scatter_add(float* p, const float* v, float wk) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    atomicAdd(p4 + q, make_float4(wk * v[4 * q], wk * v[4 * q + 1], wk * v[4 * q + 2],
                                  wk * v[4 * q + 3]));
  }
#else
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(p + c, wk * v[c]);
#endif
}

// One thread per reference pixel loops over the planes, as the forward.
// With gw[c] = (g_in_prod[c,d] + g_sim[d]) * ref[c], the cotangent of the
// bf16 warped value: d_src[corner_k] += w_k * gw (fp32 atomics) and
// d_ref[c] = sum_d (g_in_prod[c,d] + g_sim[d]) * warped[c,d] (registers).
template <int C>
__global__ void __launch_bounds__(128) warp_sim_backward_kernel(
    const bf16* __restrict__ src,        // (H, W, C)
    const bf16* __restrict__ ref,        // (C, h, w)
    const float* __restrict__ depth,     // (D,) or (D, h, w)
    int depth_per_pixel,
    const float* __restrict__ rt,        // (12,)
    const bf16* __restrict__ g_in_prod,  // (C, D, h, w)
    const float* __restrict__ g_sim,     // (D, h, w)
    float* __restrict__ d_src,           // (H, W, C) fp32, zeroed
    bf16* __restrict__ d_ref,            // (C, h, w)
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

  float refv[C], dref[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    refv[c] = bf2f(ref[c * hw + pix]);
    dref[c] = 0.f;
  }

  for (int d = 0; d < D; ++d) {
    const float dep = depth_per_pixel ? depth[d * hw + pix] : __ldg(depth + d);
    const Footprint f = project(r, L, dep, H, W);
    float acc[C];
    gather<C, true>(src, f, W, acc);  // recomputed: the forward kept no warped volume

    const float gs = g_sim[d * hw + pix];
    float gw[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wq = bf2f(f2bf(acc[c]));  // warped value as the forward rounded it
      const float g = bf2f(g_in_prod[((size_t)c * D + d) * hw + pix]) + gs;
      dref[c] += g * wq;
      gw[c] = g * refv[c];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!f.ok[k]) continue;
      const int xi = f.x0 + (k & 1), yi = f.y0 + (k >> 1);
      scatter_add<C>(d_src + ((size_t)yi * W + xi) * C, gw, f.wts[k]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) d_ref[c * hw + pix] = f2bf(dref[c]);
}

__global__ void to_bf16_kernel(const float* __restrict__ in, bf16* __restrict__ out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = f2bf(in[i]);
}

CDS_EXPORT int warp_sim_backward_launch(const void* src, const void* ref, const void* depth,
                                        int depth_per_pixel, const void* rt,
                                        const void* g_in_prod, const void* g_sim,
                                        void* d_src_f32, void* d_src, void* d_ref, int C, int H,
                                        int W, int D, int h, int w, void* stream) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const bf16*>(src), static_cast<const bf16*>(ref),
        static_cast<const float*>(depth), depth_per_pixel, static_cast<const float*>(rt),
        static_cast<const bf16*>(g_in_prod), static_cast<const float*>(g_sim),
        static_cast<float*>(d_src_f32), static_cast<bf16*>(d_ref), H, W, D, h, w);
  };
  switch (C) {
    case 8: args(warp_sim_backward_kernel<8>); break;
    case 16: args(warp_sim_backward_kernel<16>); break;
    case 32: args(warp_sim_backward_kernel<32>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)H * W * C;
  to_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(d_src_f32), static_cast<bf16*>(d_src), n);
  return (int)cudaGetLastError();
}
