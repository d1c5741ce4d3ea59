// K4: every branch of one DynamicConv layer (conv || curvature coefficients,
// bias-free) as one direct conv over a shared input tile. Each output is one
// fp32 FMA chain in (c, ky, kx) order from 0, bit for bit with the plain
// version. Wrapper, plain version and design note: ops/kernels/dynconv.py.
#include "common.cuh"

constexpr int TX = 32, TY = 8;
constexpr int MAX_BRANCHES = 4;

struct Branches {
  int n;                   // number of branches
  int k[MAX_BRANCHES];     // kernel size of each (odd)
};

// x (N, I, H, W) bf16; wts: per branch [c][ky][kx][o] fp32, branches back to
// back; out (N, n * OA, H, W) bf16. R = max(k) / 2 is the tile halo.
template <int OA>
__global__ void __launch_bounds__(TX * TY) dynconv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ wts, bf16* __restrict__ out,
    int I, int H, int W, Branches br, int R, int n_wts) {
  extern __shared__ float smem[];
  const int th = TY + 2 * R, tw = TX + 2 * R;
  float* tile = smem;                // [c][th][tw]
  float* ws = smem + I * th * tw;    // all branch weights
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TX - R, y0 = blockIdx.y * TY - R;
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.y * TX + threadIdx.x;

  const bf16* xn = x + (size_t)n * I * HW;
  for (int i = tid; i < I * th * tw; i += TX * TY) {
    const int c = i / (th * tw), rem = i % (th * tw);
    const int yy = y0 + rem / tw, xx = x0 + rem % tw;
    tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? bf2f(xn[c * HW + (size_t)yy * W + xx]) : 0.f;
  }
  for (int i = tid; i < n_wts; i += TX * TY) ws[i] = wts[i];
  __syncthreads();

  const int ox = blockIdx.x * TX + threadIdx.x;
  const int oy = blockIdx.y * TY + threadIdx.y;
  if (ox >= W || oy >= H) return;
  const size_t pix = (size_t)oy * W + ox;
  bf16* outn = out + (size_t)n * br.n * OA * HW;

  int woff = 0;
  for (int b = 0; b < br.n; ++b) {
    const int k = br.k[b];
    const int off = R - k / 2;
    float acc[OA];
#pragma unroll
    for (int o = 0; o < OA; ++o) acc[o] = 0.f;
    for (int c = 0; c < I; ++c) {
      for (int ky = 0; ky < k; ++ky) {
        const float* trow = tile + (c * th + threadIdx.y + off + ky) * tw + threadIdx.x + off;
        const float* wrow = ws + woff + ((c * k + ky) * k) * OA;
        for (int kx = 0; kx < k; ++kx) {
          const float v = trow[kx];
          const float* wp = wrow + kx * OA;
#pragma unroll
          for (int o = 0; o < OA; ++o) acc[o] = fmaf(v, wp[o], acc[o]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < OA; ++o) outn[(size_t)(b * OA + o) * HW + pix] = f2bf(acc[o]);
    woff += I * k * k * OA;
  }
}

CDS_EXPORT int dynconv_branches_launch(const void* x, const void* wts, void* out, int N, int I,
                                       int H, int W, int OA, int n_branches, const int* ks,
                                       void* stream) {
  if (n_branches < 1 || n_branches > MAX_BRANCHES) return (int)cudaErrorInvalidValue;
  Branches br;
  br.n = n_branches;
  int R = 0, n_wts = 0;
  for (int b = 0; b < MAX_BRANCHES; ++b) br.k[b] = b < n_branches ? ks[b] : 0;
  for (int b = 0; b < n_branches; ++b) {
    R = ks[b] / 2 > R ? ks[b] / 2 : R;
    n_wts += I * ks[b] * ks[b] * OA;
  }
  const size_t smem = ((size_t)I * (TY + 2 * R) * (TX + 2 * R) + n_wts) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) -> int {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, block, smem, st>>>(static_cast<const bf16*>(x), static_cast<const float*>(wts),
                                      static_cast<bf16*>(out), I, H, W, br, R, n_wts);
    return (int)cudaGetLastError();
  };
  switch (OA) {
    case 11: return launch(dynconv_kernel<11>);
    case 19: return launch(dynconv_kernel<19>);
    case 35: return launch(dynconv_kernel<35>);
    default: return (int)cudaErrorInvalidValue;
  }
}
