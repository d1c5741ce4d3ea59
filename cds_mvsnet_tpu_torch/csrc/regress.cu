// K3: prob conv (3x3x3, 8->1, no bias) + softmax over D + soft-argmin depth
// over the true hypotheses + 4-plane window confidence.
// Wrapper, plain version and design note: ops/kernels/regress.py.
#include "common.cuh"

constexpr int C = 8;
constexpr int TX = 32, TY = 8;

// logit of plane d at pixel (y, x): weights in shared memory as [c][tap]
__device__ __forceinline__ float prob_logit(const bf16* __restrict__ yv, const float* ws,
                                            int d, int y, int x, int D, int h, int w) {
  const size_t hw = (size_t)h * w;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const int dz = d + kd - 1;
      if (dz < 0 || dz >= D) continue;
      const bf16* plane = yv + ((size_t)c * D + dz) * hw;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int yy = y + ky - 1;
        if (yy < 0 || yy >= h) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int xx = x + kx - 1;
          if (xx < 0 || xx >= w) continue;
          acc = fmaf(bf2f(plane[(size_t)yy * w + xx]), ws[c * 27 + kd * 9 + ky * 3 + kx], acc);
        }
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(TX * TY) exit_softargmin_kernel(
    const bf16* __restrict__ yv,     // (C, D, h, w) UNet exit (conv0 + deconv11)
    const float* __restrict__ wt,    // (1, C, 3, 3, 3) prob conv
    const float* __restrict__ hyp,   // (D,) or (D, h, w) depth hypotheses
    int hyp_per_pixel,
    float* __restrict__ depth,       // (h, w)
    float* __restrict__ conf,        // (h, w)
    int D, int h, int w) {
  __shared__ float ws[C * 27];
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < C * 27; i += TX * TY) ws[i] = wt[i];
  __syncthreads();

  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t hw = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;

  // pass 1: online max with rescaled sums of e, e*d and e*j
  float m = -1e30f, s = 0.f, sd = 0.f, sj = 0.f;
  for (int j = 0; j < D; ++j) {
    const float l = prob_logit(yv, ws, j, y, x, D, h, w);
    const float dj = hyp_per_pixel ? hyp[(size_t)j * hw + pix] : __ldg(hyp + j);
    const float mn = fmaxf(m, l);
    const float a = expf(m - mn);
    const float e = expf(l - mn);
    s = s * a + e;
    sd = sd * a + e * dj;
    sj = sj * a + e * (float)j;
    m = mn;
  }
  const float idx_f = sj / s;
  // truncation, as the upstream .long(); idx_f >= 0
  const int idx = min(max((int)idx_f, 0), D - 1);
  // pass 2: recompute the (at most 4) logits of the window [idx-1, idx+2]
  float cw = 0.f;
  for (int j = max(idx - 1, 0); j <= min(idx + 2, D - 1); ++j) {
    cw += expf(prob_logit(yv, ws, j, y, x, D, h, w) - m);
  }
  depth[pix] = sd / s;
  conf[pix] = cw / s;
}

CDS_EXPORT int exit_softargmin_launch(const void* yv, const void* wt, const void* hyp,
                                      int hyp_per_pixel, void* depth, void* conf, int D,
                                      int h, int w, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY);
  exit_softargmin_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(yv), static_cast<const float*>(wt),
      static_cast<const float*>(hyp), hyp_per_pixel, static_cast<float*>(depth),
      static_cast<float*>(conf), D, h, w);
  return (int)cudaGetLastError();
}
