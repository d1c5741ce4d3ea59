// K1: fused plane-sweep warp + ref inner product + online softmax entropy.
// Wrapper, plain version and design note: ops/kernels/warp.py.
#include "common.cuh"

template <int C>
__global__ void __launch_bounds__(128) warp_entropy_kernel(
    const bf16* __restrict__ src,      // (H, W, C) channels-last source features
    const bf16* __restrict__ ref,      // (C, h, w) reference features
    const float* __restrict__ depth,   // (D,) or (D, h, w) hypotheses
    int depth_per_pixel,
    const float* __restrict__ rt,      // (12,) rot row-major ++ trans
    bf16* __restrict__ in_prod,        // (C, D, h, w)
    float* __restrict__ entropy,       // (h, w)
    int H, int W, int D, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t hw = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rt + i);
  const float X = (float)x, Y = (float)y;
  const float L0 = r[0] * X + r[1] * Y + r[2];
  const float L1 = r[3] * X + r[4] * Y + r[5];
  const float L2 = r[6] * X + r[7] * Y + r[8];

  float refv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = bf2f(ref[c * hw + pix]);

  // online (max, sum e, sum sim*e): entropy = m + log s - u / s
  float m = -1e30f, s = 0.f, u = 0.f;
  for (int d = 0; d < D; ++d) {
    const float dep = depth_per_pixel ? depth[d * hw + pix] : __ldg(depth + d);
    const float z = L2 * dep + r[11] + 1e-6f;
    const float px = (L0 * dep + r[9]) / z;
    const float py = (L1 * dep + r[10]) / z;
    const float x0f = floorf(px), y0f = floorf(py);
    const float tx = px - x0f, ty = py - y0f;
    // per-corner in-bounds tests on floats: no int conversion of far-off coords
    const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
    const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
    const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
    const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
    const int x0 = (vx0 || vx1) ? (int)x0f : 0;
    const int y0 = (vy0 || vy1) ? (int)y0f : 0;

    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const float wts[4] = {(1.f - tx) * (1.f - ty), tx * (1.f - ty), (1.f - tx) * ty, tx * ty};
    const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!ok[k]) continue;
      const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
      // one corner = C contiguous bf16 = C/8 16-byte loads
      const uint4* p = reinterpret_cast<const uint4*>(src + ((size_t)yi * W + xi) * C);
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {
        float v[8];
        unpack8(__ldg(p + q), v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q * 8 + i] += v[i] * wts[k];
      }
    }

    float sim = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wq = bf2f(f2bf(acc[c]));  // warped value in the feature dtype
      in_prod[((size_t)c * D + d) * hw + pix] = f2bf(refv[c] * wq);
      sim += wq * refv[c];
    }
    const float mn = fmaxf(m, sim);
    const float alpha = expf(m - mn);
    const float e = expf(sim - mn);
    s = s * alpha + e;
    u = u * alpha + sim * e;
    m = mn;
  }
  entropy[pix] = (m + logf(s)) - u / s;
}

CDS_EXPORT int warp_entropy_launch(const void* src, const void* ref, const void* depth,
                                   int depth_per_pixel, const void* rt, void* in_prod,
                                   void* entropy, int C, int H, int W, int D, int h, int w,
                                   void* stream) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const bf16*>(src), static_cast<const bf16*>(ref),
        static_cast<const float*>(depth), depth_per_pixel, static_cast<const float*>(rt),
        static_cast<bf16*>(in_prod), static_cast<float*>(entropy), H, W, D, h, w);
  };
  switch (C) {
    case 8: args(warp_entropy_kernel<8>); break;
    case 16: args(warp_entropy_kernel<16>); break;
    case 32: args(warp_entropy_kernel<32>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
