// K4: every branch of one DynamicConv layer (conv || curvature coefficients,
// bias-free) as one direct conv over a shared input tile, register-tiled on
// the CUDA cores. Each output is one fp32 FMA chain in (c, ky, kx) order
// from 0, rounded once to bf16: bit for bit with the plain version. No MMA,
// no TF32. Wrapper, plain version and design note: ops/kernels/dynconv.py.
#include "common.cuh"

#include <cstdint>

constexpr int TW = 32;             // output columns per block
constexpr int PX = 4;              // adjacent output columns per thread
constexpr int LX = TW / PX;        // threads across a row
constexpr int kThreads = 256;      // LX x 32 rows; blocks of 16 or 8 rows have fewer
constexpr int GW = 12;             // weights per (c, ky, kx) and channel group: three float4
constexpr int MAX_BRANCHES = 4;
constexpr int kMaxSmem = 227 * 1024;

struct Branches {
  int n;                                // number of branches
  int k[MAX_BRANCHES];                  // kernel size of each: 1, 3, 5 or 7
  const float* w[MAX_BRANCHES];         // the caller's (OA, I, k, k) fp32 weights
};

// OA outputs of a branch in G channel groups of at most 12; a thread keeps
// OG x PX sums. OA = 11: one group of 11; 19: 10 + 9; 35: 12 + 12 + 11.
template <int OA> struct Groups {
  static constexpr int G = (OA + GW - 1) / GW;
  static constexpr int OG = (OA + G - 1) / G;
};

// Shared memory: the input tile [c][rows + 2R][TW + 2R + 1] fp32 (an odd
// row stride, so a warp's 4 rows x 8 threads hit 32 banks), padded to 16
// bytes, then each branch's weights [c][ky][kx][g][12] back to back.
__host__ __device__ inline int tile_floats(int I, int rows, int R) {
  return (I * (rows + 2 * R) * (TW + 2 * R + 1) + 3) & ~3;
}

// One branch of kernel size K: the thread's PX pixels of row oy for every
// output channel, group by group.
template <int OA, int K>
__device__ __forceinline__ void branch(const float* __restrict__ tile, const float* __restrict__ ws,
                                       bf16* __restrict__ outb, int I, int th, int tws, int R, int ty, int tx,
                                       int ox0, int oy, int H, int W, bool vec_store) {
  using Gr = Groups<OA>;
  constexpr int G = Gr::G, OG = Gr::OG, NV = K + PX - 1;
  const int off = R - K / 2;
  const size_t HW = (size_t)H * W;
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    float acc[OG][PX];
#pragma unroll
    for (int o = 0; o < OG; ++o)
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[o][p] = 0.f;
#pragma unroll 1
    for (int c = 0; c < I; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* trow = tile + (c * th + ty + off + ky) * tws + tx * PX + off;
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
            for (int p = 0; p < PX; ++p) acc[o][p] = fmaf(v[kx + p], wv[o], acc[o][p]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < OG; ++o) {
      const int ch = g * OG + o;
      if (ch >= OA) break;
      bf16* dst = outb + ch * HW + (size_t)oy * W + ox0;
      if (vec_store) {
        __align__(8) bf16 q[PX];
#pragma unroll
        for (int p = 0; p < PX; ++p) q[p] = f2bf(acc[o][p]);
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(q);
      } else {
#pragma unroll
        for (int p = 0; p < PX; ++p)
          if (ox0 + p < W) dst[p] = f2bf(acc[o][p]);
      }
    }
  }
}

// x (N, I, H, W) bf16; out (N, n * OA, H, W) bf16. R = max(k) / 2 is the
// tile halo; blockDim = (LX, rows).
template <int OA>
__global__ void __launch_bounds__(kThreads, 2) dynconv_kernel(
    const bf16* __restrict__ x, Branches br, bf16* __restrict__ out, int I, int H, int W, int R, int vec_load) {
  using Gr = Groups<OA>;
  constexpr int GP = Gr::G * GW;  // weights per (c, ky, kx)
  extern __shared__ __align__(16) float smem[];
  const int rows = blockDim.y;
  const int th = rows + 2 * R, tws = TW + 2 * R + 1;
  float* tile = smem;
  float* wts = smem + tile_floats(I, rows, R);
  const int n = blockIdx.z;
  const int bx0 = blockIdx.x * TW, by0 = blockIdx.y * rows;
  const int x0 = bx0 - R, y0 = by0 - R;  // image position of tile[.][0][0]
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.y * LX + threadIdx.x, nthreads = LX * rows;
  const bf16* xn = x + (size_t)n * I * HW;

  // the input tile, zeros outside the image
  if (vec_load) {
    // W % 8 == 0: the 16-byte vectors of columns [bx0 - 8, bx0 + TW + 8)
    // lie wholly inside or wholly outside each row
    // (BATCH vectors in flight per thread before any is stored)
    constexpr int NVEC = TW / 8 + 2, BATCH = 4;
    const int n_items = I * th * NVEC;
    for (int i0 = tid; i0 < n_items; i0 += BATCH * nthreads) {
      uint4 q[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * nthreads;
        const int c = i / (th * NVEC), rem = i % (th * NVEC);
        const int yy = y0 + rem / NVEC, v0 = bx0 - 8 + (rem % NVEC) * 8;
        q[u] = i < n_items && yy >= 0 && yy < H && v0 >= 0 && v0 < W
                   ? __ldg(reinterpret_cast<const uint4*>(xn + c * HW + (size_t)yy * W + v0))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= n_items) break;
        const int c = i / (th * NVEC), rem = i % (th * NVEC);
        const int r = rem / NVEC, v0 = bx0 - 8 + (rem % NVEC) * 8;
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
  if (ox0 >= W || oy >= H) return;
  const bool vec_store = (W % PX == 0);  // then all PX columns lie inside
  bf16* outn = out + (size_t)n * br.n * OA * HW;
  const float* wb = wts;
  for (int b = 0; b < br.n; ++b) {
    const int k = br.k[b];
    bf16* outb = outn + (size_t)b * OA * HW;
    switch (k) {
      case 1: branch<OA, 1>(tile, wb, outb, I, th, tws, R, threadIdx.y, threadIdx.x, ox0, oy, H, W, vec_store); break;
      case 3: branch<OA, 3>(tile, wb, outb, I, th, tws, R, threadIdx.y, threadIdx.x, ox0, oy, H, W, vec_store); break;
      case 5: branch<OA, 5>(tile, wb, outb, I, th, tws, R, threadIdx.y, threadIdx.x, ox0, oy, H, W, vec_store); break;
      default: branch<OA, 7>(tile, wb, outb, I, th, tws, R, threadIdx.y, threadIdx.x, ox0, oy, H, W, vec_store); break;
    }
    wb += I * k * k * GP;
  }
}

// Shared bytes of one block at `rows` output rows (ops/kernels/dynconv.py
// mirrors this in shared_bytes).
static size_t smem_bytes(int I, int OA, int n, const int* ks, int rows) {
  const int GP = ((OA + GW - 1) / GW) * GW;
  int R = 0;
  size_t wf = 0;
  for (int b = 0; b < n; ++b) {
    R = ks[b] / 2 > R ? ks[b] / 2 : R;
    wf += (size_t)I * ks[b] * ks[b] * GP;
  }
  return ((size_t)tile_floats(I, rows, R) + wf) * sizeof(float);
}

// Output rows per block: the most of 32, 16, 8 at which two blocks share an
// SM, else the most that fit one block; 0 if none fits.
static int pick_rows(int I, int OA, int n, const int* ks) {
  for (int rows = 32; rows >= 8; rows /= 2)
    if (smem_bytes(I, OA, n, ks, rows) <= (size_t)kMaxSmem / 2 - 1024) return rows;
  for (int rows = 32; rows >= 8; rows /= 2)
    if (smem_bytes(I, OA, n, ks, rows) <= (size_t)kMaxSmem) return rows;
  return 0;
}

template <int OA>
static int launch(const bf16* x, const Branches& br, bf16* out, int N, int I, int H, int W, int R, int rows,
                  size_t smem, cudaStream_t st) {
  static const cudaError_t opt_in = [] {  // once per instantiation, not per launch
    cudaError_t e = cudaFuncSetAttribute(dynconv_kernel<OA>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dynconv_kernel<OA>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int vec_load = (W % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 block(LX, rows);
  const dim3 grid((W + TW - 1) / TW, (H + rows - 1) / rows, N);
  dynconv_kernel<OA><<<grid, block, smem, st>>>(x, br, out, I, H, W, R, vec_load);
  return (int)cudaGetLastError();
}

// wts: n_branches pointers to the caller's (OA, I, k, k) fp32 weights.
CDS_EXPORT int dynconv_launch(const void* x, const void* const* wts, void* out, int N, int I, int H, int W,
                              int OA, int n_branches, const int* ks, void* stream) {
  if (n_branches < 1 || n_branches > MAX_BRANCHES) return (int)cudaErrorInvalidValue;
  Branches br = {};
  br.n = n_branches;
  int R = 0;
  for (int b = 0; b < n_branches; ++b) {
    if (ks[b] != 1 && ks[b] != 3 && ks[b] != 5 && ks[b] != 7) return (int)cudaErrorInvalidValue;
    br.k[b] = ks[b];
    br.w[b] = static_cast<const float*>(wts[b]);
    R = ks[b] / 2 > R ? ks[b] / 2 : R;
  }
  const int rows = pick_rows(I, OA, n_branches, ks);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(I, OA, n_branches, ks, rows);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (OA) {
    case 11: return launch<11>(xb, br, ob, N, I, H, W, R, rows, smem, st);
    case 19: return launch<19>(xb, br, ob, N, I, H, W, R, rows, smem, st);
    case 35: return launch<35>(xb, br, ob, N, I, H, W, R, rows, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
