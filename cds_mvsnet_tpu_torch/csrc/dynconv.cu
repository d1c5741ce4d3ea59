// K4: every branch of one FeatureNet conv (a DynamicConv layer's conv ||
// curvature coefficients, or a plain conv as one branch; bias-free) as one
// direct conv over a shared input tile, register-tiled on the CUDA cores,
// at stride 1 or (one 3 x 3 branch) 2. Each output is one fp32 FMA chain in
// (c, ky, kx) order from 0, rounded once to bf16: bit for bit with the plain
// version. No MMA, no TF32. Wrapper, plain version and design note:
// ops/kernels/dynconv.py.
#include "common.cuh"

#include <algorithm>
#include <cstdint>

constexpr int TW = 32;             // output columns per block
constexpr int PX = 4;              // adjacent output columns per thread
constexpr int LX = TW / PX;        // threads across a row
constexpr int kThreads = 256;      // LX x 32 rows, or LX x 16 or 8 rows x channel-group slices
constexpr int GW = 12;             // weights per (c, ky, kx) and channel group: three float4
constexpr int MAX_BRANCHES = 4;
constexpr int kMaxSmem = 227 * 1024;

struct Branches {
  int n;                                // number of branches
  int k[MAX_BRANCHES];                  // kernel size of each: 1, 3, 5, 7 or 11
  const float* w[MAX_BRANCHES];         // the caller's (OA, I, k, k) fp32 weights
};

// OA outputs of a branch in G channel groups of at most 12; a thread keeps
// OG x PX sums. OA = 8: one group of 8; 11: one of 11; 16: 8 + 8; 19: 10 + 9;
// 32: 11 + 11 + 10; 35: 12 + 12 + 11.
template <int OA> struct Groups {
  static constexpr int G = (OA + GW - 1) / GW;
  static constexpr int OG = (OA + G - 1) / G;
};

// Shared memory: the input tile [c][th][tws] fp32, th = S (rows - 1) + 2R + 1
// input rows of tws = S (TW - 1) + 2R + 1 columns, rounded up to odd (so a
// warp's 4 rows x 8 threads fall in other banks), padded to 16 bytes, then
// each branch's weights [c][ky][kx][g][12] back to back.
__host__ __device__ inline int tile_w(int S, int R) { return (S * (TW - 1) + 2 * R + 1) | 1; }
__host__ __device__ inline int tile_h(int S, int R, int rows) { return S * (rows - 1) + 2 * R + 1; }
__host__ __device__ inline int tile_floats(int I, int rows, int R, int S) {
  return (I * tile_h(S, R, rows) * tile_w(S, R) + 3) & ~3;
}

// One branch of kernel size K at stride S: the thread's PX pixels of output
// row oy for its channel groups g0, g0 + gstep, ... (the block's z slices
// share the groups of a tile).
template <int OA, int K, int S>
__device__ __forceinline__ void branch(const float* __restrict__ tile, const float* __restrict__ ws,
                                       bf16* __restrict__ outb, int I, int th, int tws, int R, int ty, int tx,
                                       int g0, int gstep, int ox0, int oy, int Ho, int Wo, bool vec_store) {
  using Gr = Groups<OA>;
  constexpr int G = Gr::G, OG = Gr::OG, NV = (PX - 1) * S + K;
  const int off = R - K / 2;
  const size_t HW = (size_t)Ho * Wo;
  // one group (OA = 8, 11): g = 0, known at compile time
  const int gbeg = G == 1 ? 0 : g0, gnext = G == 1 ? 1 : gstep;
#pragma unroll 1
  for (int g = gbeg; g < G; g += gnext) {
    float acc[OG][PX];
#pragma unroll
    for (int o = 0; o < OG; ++o)
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[o][p] = 0.f;
#pragma unroll 1
    for (int c = 0; c < I; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* trow = tile + (c * th + ty * S + off + ky) * tws + tx * PX * S + off;
        float v[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] = trow[i];
        const float4* wq = reinterpret_cast<const float4*>(ws + ((c * K + ky) * K * G + g) * GW);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          // the 12 weights of (c, ky, kx) for this group: warp-uniform
          const float4 a = wq[kx * G * 3], b = wq[kx * G * 3 + 1], d = wq[kx * G * 3 + 2];
          const float wv[GW] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y, d.z, d.w};
#pragma unroll
          for (int o = 0; o < OG; ++o)
#pragma unroll
            for (int p = 0; p < PX; ++p) acc[o][p] = fmaf(v[kx + p * S], wv[o], acc[o][p]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < OG; ++o) {
      const int ch = g * OG + o;
      if (ch >= OA) break;
      bf16* dst = outb + ch * HW + (size_t)oy * Wo + ox0;
      if (vec_store) {
        __align__(8) bf16 q[PX];
#pragma unroll
        for (int p = 0; p < PX; ++p) q[p] = f2bf(acc[o][p]);
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
      } else {
#pragma unroll
        for (int p = 0; p < PX; ++p)
          if (ox0 + p < Wo) dst[p] = f2bf(acc[o][p]);
      }
    }
  }
}

// x (N, I, H, W) bf16; out (N, n * OA, Ho, Wo) bf16. R = max(k) / 2 is the
// tile halo (and each branch's padding is its k / 2); blockDim = (LX, rows,
// slices of the channel groups).
template <int OA, int S>
__global__ void __launch_bounds__(kThreads, 2) dynconv_kernel(
    const bf16* __restrict__ x, Branches br, bf16* __restrict__ out, int I, int H, int W, int Ho, int Wo, int R,
    int vec_load) {
  using Gr = Groups<OA>;
  constexpr int GP = Gr::G * GW;  // weights per (c, ky, kx)
  extern __shared__ __align__(16) float smem[];
  const int rows = blockDim.y;
  const int th = tile_h(S, R, rows), tws = tile_w(S, R);
  float* tile = smem;
  float* wts = smem + tile_floats(I, rows, R, S);
  const int n = blockIdx.z;
  const int bx0 = blockIdx.x * TW, by0 = blockIdx.y * rows;  // the block's first output column and row
  const int x0 = S * bx0 - R, y0 = S * by0 - R;  // image position of tile[.][0][0]
  const size_t HW = (size_t)H * W;
  const int tid = (threadIdx.z * rows + threadIdx.y) * LX + threadIdx.x, nthreads = LX * rows * blockDim.z;
  const bf16* xn = x + (size_t)n * I * HW;

  // the input tile, zeros outside the image
  if (vec_load) {
    // W % 8 == 0: the 16-byte vectors of columns [S bx0 - 8, S (bx0 + TW) + 8)
    // lie wholly inside or wholly outside each row
    // (BATCH vectors in flight per thread before any is stored)
    constexpr int NVEC = S * TW / 8 + 2, BATCH = 4;
    const int n_items = I * th * NVEC;
    for (int i0 = tid; i0 < n_items; i0 += BATCH * nthreads) {
      uint4 q[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * nthreads;
        const int c = i / (th * NVEC), rem = i % (th * NVEC);
        const int yy = y0 + rem / NVEC, v0 = S * bx0 - 8 + (rem % NVEC) * 8;
        q[u] = i < n_items && yy >= 0 && yy < H && v0 >= 0 && v0 < W
                   ? __ldg(reinterpret_cast<const uint4*>(xn + c * HW + (size_t)yy * W + v0))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= n_items) break;
        const int c = i / (th * NVEC), rem = i % (th * NVEC);
        const int r = rem / NVEC, v0 = S * bx0 - 8 + (rem % NVEC) * 8;
        float vals[8];
        unpack8(q[u], vals);
        float* trow = tile + (c * th + r) * tws;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = v0 + j - x0;
          if (col >= 0 && col < tws) trow[col] = vals[j];
        }
      }
    }
  } else {
    for (int i = tid; i < I * th * tws; i += nthreads) {
      const int c = i / (th * tws), rem = i % (th * tws);
      const int yy = y0 + rem / tws, xx = x0 + rem % tws;
      tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? bf2f(xn[c * HW + (size_t)yy * W + xx]) : 0.f;
    }
  }
  // each branch's weights, read in place: [o][c][ky][kx] -> [c][ky][kx][g][12]
  // by 4-byte asynchronous copies, zeros in the slots of no output channel
  {
    float* wb = wts;
    for (int b = 0; b < br.n; ++b) {
      const int ikk = I * br.k[b] * br.k[b];
      const float* wg = br.w[b];
      for (int i = tid; i < ikk * GP; i += nthreads) {
        const int r = i / GP, s = i % GP;
        const int j = s % GW, o = (s / GW) * Gr::OG + j;
        const bool ok = j < Gr::OG && o < OA;
        cp_async<4>(wb + i, ok ? wg + (size_t)o * ikk + r : wg, ok);
      }
      wb += ikk * GP;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int ox0 = bx0 + threadIdx.x * PX, oy = by0 + threadIdx.y;
  if (ox0 >= Wo || oy >= Ho) return;
  const bool vec_store = (Wo % PX == 0);  // then all PX columns lie inside
  const size_t HWo = (size_t)Ho * Wo;
  bf16* outn = out + (size_t)n * br.n * OA * HWo;
  const float* wb = wts;
  const int ty = threadIdx.y, tx = threadIdx.x, g0 = threadIdx.z, gs = blockDim.z;
  for (int b = 0; b < br.n; ++b) {
    const int k = br.k[b];
    bf16* outb = outn + (size_t)b * OA * HWo;
    if constexpr (S == 2) {  // the downsample layers: one 3 x 3 branch
      branch<OA, 3, 2>(tile, wb, outb, I, th, tws, R, ty, tx, g0, gs, ox0, oy, Ho, Wo, vec_store);
    } else {
      switch (k) {
        case 1: branch<OA, 1, 1>(tile, wb, outb, I, th, tws, R, ty, tx, g0, gs, ox0, oy, Ho, Wo, vec_store); break;
        case 3: branch<OA, 3, 1>(tile, wb, outb, I, th, tws, R, ty, tx, g0, gs, ox0, oy, Ho, Wo, vec_store); break;
        case 5: branch<OA, 5, 1>(tile, wb, outb, I, th, tws, R, ty, tx, g0, gs, ox0, oy, Ho, Wo, vec_store); break;
        case 7: branch<OA, 7, 1>(tile, wb, outb, I, th, tws, R, ty, tx, g0, gs, ox0, oy, Ho, Wo, vec_store); break;
        default: branch<OA, 11, 1>(tile, wb, outb, I, th, tws, R, ty, tx, g0, gs, ox0, oy, Ho, Wo, vec_store); break;
      }
    }
    wb += I * k * k * GP;
  }
}

// Shared bytes of one block at `rows` output rows (ops/kernels/dynconv.py
// mirrors this in shared_bytes).
static size_t smem_bytes(int I, int OA, int n, const int* ks, int rows, int S) {
  const int GP = ((OA + GW - 1) / GW) * GW;
  int R = 0;
  size_t wf = 0;
  for (int b = 0; b < n; ++b) {
    R = ks[b] / 2 > R ? ks[b] / 2 : R;
    wf += (size_t)I * ks[b] * ks[b] * GP;
  }
  return ((size_t)tile_floats(I, rows, R, S) + wf) * sizeof(float);
}

// Output rows per block: the most of 32, 16, 8 at which two blocks share an
// SM, else the most that fit one block; 0 if none fits.
static int pick_rows(int I, int OA, int n, const int* ks, int S) {
  for (int rows = 32; rows >= 8; rows /= 2)
    if (smem_bytes(I, OA, n, ks, rows, S) <= (size_t)kMaxSmem / 2 - 1024) return rows;
  for (int rows = 32; rows >= 8; rows /= 2)
    if (smem_bytes(I, OA, n, ks, rows, S) <= (size_t)kMaxSmem) return rows;
  return 0;
}

template <int OA, int S>
static int launch(const bf16* x, const Branches& br, bf16* out, int N, int I, int H, int W, int R, int rows,
                  size_t smem, cudaStream_t st) {
  static const cudaError_t opt_in = [] {  // once per instantiation, not per launch
    cudaError_t e =
        cudaFuncSetAttribute(dynconv_kernel<OA, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dynconv_kernel<OA, S>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int vec_load = (W % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  // the channel groups split over z where the block has fewer than
  // kThreads threads (blocks of 16 or 8 rows): more warps share the tile
  const int slices = std::min(Groups<OA>::G, kThreads / (LX * rows));
  const dim3 block(LX, rows, slices);
  const dim3 grid((Wo + TW - 1) / TW, (Ho + rows - 1) / rows, N);
  dynconv_kernel<OA, S><<<grid, block, smem, st>>>(x, br, out, I, H, W, Ho, Wo, R, vec_load);
  return (int)cudaGetLastError();
}

template <int OA>
static int launch_stride(const bf16* x, const Branches& br, bf16* out, int N, int I, int H, int W, int R,
                         int rows, size_t smem, int stride, cudaStream_t st) {
  return stride == 2 ? launch<OA, 2>(x, br, out, N, I, H, W, R, rows, smem, st)
                     : launch<OA, 1>(x, br, out, N, I, H, W, R, rows, smem, st);
}

// wts: n_branches pointers to the caller's (OA, I, k, k) fp32 weights; out
// (N, n_branches * OA, (H - 1) / stride + 1, (W - 1) / stride + 1).
CDS_EXPORT int dynconv_launch(const void* x, const void* const* wts, void* out, int N, int I, int H, int W,
                              int OA, int n_branches, const int* ks, int stride, void* stream) {
  if (n_branches < 1 || n_branches > MAX_BRANCHES) return (int)cudaErrorInvalidValue;
  if (stride != 1 && !(stride == 2 && n_branches == 1 && ks[0] == 3)) return (int)cudaErrorInvalidValue;
  Branches br = {};
  br.n = n_branches;
  int R = 0;
  for (int b = 0; b < n_branches; ++b) {
    if (ks[b] != 1 && ks[b] != 3 && ks[b] != 5 && ks[b] != 7 && ks[b] != 11) return (int)cudaErrorInvalidValue;
    br.k[b] = ks[b];
    br.w[b] = static_cast<const float*>(wts[b]);
    R = ks[b] / 2 > R ? ks[b] / 2 : R;
  }
  const int rows = pick_rows(I, OA, n_branches, ks, stride);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(I, OA, n_branches, ks, rows, stride);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (OA) {
    case 8: return launch_stride<8>(xb, br, ob, N, I, H, W, R, rows, smem, stride, st);
    case 11: return launch_stride<11>(xb, br, ob, N, I, H, W, R, rows, smem, stride, st);
    case 16: return launch_stride<16>(xb, br, ob, N, I, H, W, R, rows, smem, stride, st);
    case 19: return launch_stride<19>(xb, br, ob, N, I, H, W, R, rows, smem, stride, st);
    case 32: return launch_stride<32>(xb, br, ob, N, I, H, W, R, rows, smem, stride, st);
    case 35: return launch_stride<35>(xb, br, ob, N, I, H, W, R, rows, smem, stride, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
