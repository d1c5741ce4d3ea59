// K3: prob conv (3x3x3, 8->1, no bias) + softmax over D + soft-argmin depth
// over the true hypotheses + 4-plane window confidence.
// Wrapper, plain version and design note: ops/kernels/regress.py.
//
// A block owns a tile of TW (64, or 32 for large D) columns x TY rows and
// every plane of it. It walks the planes in chunks of DC and, within a
// chunk, the 8 channels: each (chunk, channel) is staged in shared memory as
// bf16 pairs (one plane, one row and 8 columns of halo, zeros outside) by
// 16-byte asynchronous copies issued NBUF - 1 steps ahead, so the 216-tap
// loops run without branches and the copies overlap the arithmetic. Each
// thread computes DPT planes of two adjacent pixels and keeps their logits
// in shared memory. Then GS lanes per pixel reduce max, sum e, sum e*d and
// sum e*j with shuffles, and the window's logits are read back, not
// recomputed.
#include "common.cuh"

#include <cstdint>

constexpr int C = 8;
constexpr int kThreads = 256;
constexpr int WS = 28;          // weights per channel in shared memory, 27 padded to 7 float4
constexpr int NBUF = 4;         // staged (chunk, channel) steps in the ring
constexpr int kMaxSmem = 227 * 1024;

// A tile of TW (64 or 32) columns x TY rows; DPT planes per thread.
template <int TW, int TY, int DPT>
struct Cfg {
  static constexpr int LW = TW / 2;                // threads across the tile's columns, two pixels each
  static constexpr int VECS = TW / 8 + 2;          // 16-byte vectors of a staged row: columns x0 - 8 .. x0 + TW + 7
  static constexpr int RS = 4 * VECS;              // words of a staged row
  static constexpr int PG = kThreads / (LW * TY);  // plane groups
  static constexpr int DC = PG * DPT;              // planes per chunk
  static constexpr int P = TW * TY;                // pixels of the tile
  static constexpr int GS = kThreads / P;          // lanes per pixel in the reduction
  // words between two staged planes: (TY + 2) rows, a multiple of 4 (16-byte
  // copies); at TW = 32, where a warp's two halves are two plane groups, DPT
  // planes apart are congruent to 16 mod 32, so the halves read disjoint banks
  static constexpr int plane_words() {
    int p = (TY + 2) * RS;
    while (p % 4 != 0 || (LW == 16 && (DPT * p) % 32 != 16)) ++p;
    return p;
  }
  static constexpr int PSW = plane_words();
  static constexpr int SW = (DC + 2) * PSW;        // words of one staged step
};

// Logits row length: GS * an odd number >= D, so that a warp's GS lanes of
// 32 / GS pixels hit distinct banks.
__host__ __device__ inline int logit_stride(int D, int GS) {
  int q = (D + GS - 1) / GS;
  return GS * (q | 1);
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The four columns of a thread's two pixels' 3-tap row from staged words
// p, p + 1, p + 2: the high half of the first, both of the second, the low
// half of the third
__device__ __forceinline__ void load_window(const uint32_t* p, float* out) {
  const uint32_t a = p[0], b = p[1], c = p[2];
  out[0] = hi_f(a); out[1] = lo_f(b); out[2] = hi_f(b); out[3] = lo_f(c);
}

template <int TW, int TY, int DPT>
__global__ void __launch_bounds__(kThreads, 2) exit_softargmin_kernel(
    const bf16* __restrict__ yv,     // (C, D, h, w) UNet exit (conv0 + deconv11)
    const float* __restrict__ wt,    // (1, C, 3, 3, 3) prob conv
    const float* __restrict__ hyp,   // (D,) or (D, h, w) depth hypotheses
    int hyp_per_pixel,
    float* __restrict__ depth,       // (h, w)
    float* __restrict__ conf,        // (h, w)
    int D, int h, int w, int vec_load) {
  using Cf = Cfg<TW, TY, DPT>;
  constexpr int DC = Cf::DC, PSW = Cf::PSW, GS = Cf::GS, SW = Cf::SW, VECS = Cf::VECS, RS = Cf::RS, LW = Cf::LW;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                                    // [NBUF][DC + 2][PSW]
  float* ws = reinterpret_cast<float*>(smem + NBUF * SW);   // [c][WS]
  float* lg = ws + C * WS;                                  // [P][Dpad]
  const int Dpad = logit_stride(D, GS);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TY;
  const size_t hw = (size_t)h * w;
  const unsigned short* yraw = reinterpret_cast<const unsigned short*>(yv);
  for (int i = tid; i < C * WS; i += kThreads) {
    const int t = i % WS;
    ws[i] = t < 27 ? wt[(i / WS) * 27 + t] : 0.f;
  }

  // step n stages channel n % C of the planes z0 - 1 .. z0 + DC (z0 = (n / C)
  // * DC), rows y0 - 1 .. y0 + TY, into ring[n % NBUF]: word q of a row
  // holds columns (x0 - 8 + 2q, x0 - 7 + 2q). Where w % 8 == 0 a row is VECS
  // 16-byte copies, each wholly inside or outside the image; a thread's
  // share of them is the same at every step but for the plane, so their
  // shared-memory offsets, their offsets in the volume and whether they lie
  // inside are worked out once.
  const int n_steps = (D + DC - 1) / DC * C;
  constexpr int COPIES = (DC + 2) * (TY + 2) * VECS;
  constexpr int PER_THREAD = (COPIES + kThreads - 1) / kThreads;
  int cp_dst[PER_THREAD], cp_zi[PER_THREAD];
  long long cp_src[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int i = tid + u * kThreads;
    const int v = i % VECS, row = i / VECS;
    const int ri = row % (TY + 2), zi = row / (TY + 2);
    const int yy = y0 - 1 + ri, col = x0 - 8 + 8 * v;
    const bool inside = yy >= 0 && yy < h && col >= 0 && col < w;
    cp_dst[u] = i < COPIES ? zi * PSW + ri * RS + 4 * v : -1;
    cp_zi[u] = inside ? zi : -(1 << 30);  // a plane no step finds inside
    cp_src[u] = (long long)(zi - 1) * (long long)hw + (long long)yy * w + col;
  }
  auto stage = [&](int n) {
    const int c = n % C, z0 = n / C * DC;
    uint32_t* buf = ring + (n % NBUF) * SW;
    if (vec_load) {
      const bf16* yc = yv + ((size_t)c * D + z0) * hw;
#pragma unroll
      for (int u = 0; u < PER_THREAD; ++u) {
        const int z = z0 - 1 + cp_zi[u];
        const bool ok = z >= 0 && z < D;
        if (cp_dst[u] >= 0) cp_async<16>(buf + cp_dst[u], ok ? yc + cp_src[u] : yv, ok);
      }
    } else {
      const unsigned short* yr = yraw + (size_t)c * D * hw;
      for (int i = tid; i < (DC + 2) * (TY + 2) * RS; i += kThreads) {
        const int q = i % RS, row = i / RS;
        const int ri = row % (TY + 2), zi = row / (TY + 2);
        const int z = z0 - 1 + zi, yy = y0 - 1 + ri, xa = x0 - 8 + 2 * q;
        uint32_t lo = 0, hi = 0;
        if (z >= 0 && z < D && yy >= 0 && yy < h) {
          const unsigned short* rowp = yr + (size_t)z * hw + (size_t)yy * w;
          if (xa >= 0 && xa < w) lo = rowp[xa];
          if (xa + 1 >= 0 && xa + 1 < w) hi = rowp[xa + 1];
        }
        buf[zi * PSW + ri * RS + q] = lo | (hi << 16);
      }
    }
  };
#pragma unroll
  for (int n = 0; n < NBUF - 1; ++n) {
    if (n < n_steps) stage(n);
    cp_async_commit();
  }

  // this thread's planes z0 + g*DPT + (0 .. DPT-1) at columns x0 + 2l, +1 of row r
  const int l = tid % LW, rest = tid / LW, g = rest % Cf::PG, r = rest / Cf::PG;
  float acc[DPT][2];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 1
  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait<NBUF - 2>();  // step n's copies are done (this thread's)
    __syncthreads();            // everyone's; and step n - 1's buffer is free
    if (n + NBUF - 1 < n_steps) stage(n + NBUF - 1);
    cp_async_commit();

    const int c = n % C;
    float wr[WS];
    const float4* wq = reinterpret_cast<const float4*>(ws + c * WS);
#pragma unroll
    for (int q = 0; q < WS / 4; ++q) {
      const float4 v = wq[q];
      wr[4 * q] = v.x; wr[4 * q + 1] = v.y; wr[4 * q + 2] = v.z; wr[4 * q + 3] = v.w;
    }
    // words l + 3, l + 4, l + 5 hold columns x0 + 2l - 1 .. x0 + 2l + 2
    const uint32_t* base = ring + (n % NBUF) * SW + (g * DPT) * PSW + r * RS + 3 + l;
    // three staged planes' 3 rows x 4 columns, rolled along the planes
    float win[3][3][4];
#pragma unroll
    for (int s = 0; s < DPT + 2; ++s) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) load_window(base + s * PSW + ky * RS, win[s % 3][ky]);
      if (s >= 2) {
        const int i = s - 2;  // the logits of plane i need staged planes i .. i + 2
        // each logit's chain in the order (c, kd, ky, kx) from 0
#pragma unroll
        for (int px = 0; px < 2; ++px)
#pragma unroll
          for (int kd = 0; kd < 3; ++kd)
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
              for (int kx = 0; kx < 3; ++kx)
                acc[i][px] = fmaf(win[(i + kd) % 3][ky][px + kx], wr[kd * 9 + ky * 3 + kx], acc[i][px]);
      }
    }
    if (c == C - 1) {  // the chunk's logits are complete
      const int z0 = n / C * DC;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int z = z0 + g * DPT + i;
        if (z < D) {
          lg[(r * TW + 2 * l) * Dpad + z] = acc[i][0];
          lg[(r * TW + 2 * l + 1) * Dpad + z] = acc[i][1];
        }
        acc[i][0] = acc[i][1] = 0.f;
      }
    }
  }
  __syncthreads();

  // GS lanes per pixel: the max over D, then the sums of e = exp(logit - max)
  const int p = tid / GS, k = tid % GS;
  const int py = y0 + p / TW, px = x0 + p % TW;
  const bool inside = py < h && px < w;
  const size_t pix = inside ? (size_t)py * w + px : 0;
  const float* lp = lg + p * Dpad;
  float m = __uint_as_float(0xff800000u);  // -inf
  for (int j = k; j < D; j += GS) m = fmaxf(m, lp[j]);
#pragma unroll
  for (int o = GS / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = 0.f, sd = 0.f, sj = 0.f;
  for (int j = k; j < D; j += GS) {
    const float e = expf(lp[j] - m);
    const float dj = hyp_per_pixel ? hyp[(size_t)j * hw + pix] : __ldg(hyp + j);
    s += e;
    sd += e * dj;
    sj += e * (float)j;
  }
#pragma unroll
  for (int o = GS / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sd += __shfl_xor_sync(0xffffffffu, sd, o);
    sj += __shfl_xor_sync(0xffffffffu, sj, o);
  }
  if (k == 0 && inside) {
    // truncation, as the upstream .long(); sj / s >= 0
    const int idx = min(max((int)(sj / s), 0), D - 1);
    float cw = 0.f;
    for (int j = max(idx - 1, 0); j <= min(idx + 2, D - 1); ++j) cw += expf(lp[j] - m);
    depth[pix] = sd / s;
    conf[pix] = cw / s;
  }
}

template <int TW, int TY, int DPT>
static size_t smem_bytes(int D) {
  using Cf = Cfg<TW, TY, DPT>;
  return ((size_t)NBUF * Cf::SW + C * WS + (size_t)Cf::P * logit_stride(D, Cf::GS)) * 4;
}

// Shared-memory opt-in and carveout, once per instantiation.
template <int TW, int TY, int DPT>
static cudaError_t prepare() {
  static const cudaError_t e = [] {
    cudaError_t r = cudaFuncSetAttribute(exit_softargmin_kernel<TW, TY, DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(exit_softargmin_kernel<TW, TY, DPT>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return r;
  }();
  return e;
}

template <int TW, int TY, int DPT>
static int launch(const void* yv, const void* wt, const void* hyp, int hyp_per_pixel, void* depth, void* conf,
                  int D, int h, int w, size_t smem, cudaStream_t st) {
  const cudaError_t opt_in = prepare<TW, TY, DPT>();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((w + TW - 1) / TW, (h + TY - 1) / TY);
  const int vec_load = (w % 8 == 0) && (reinterpret_cast<uintptr_t>(yv) % 16 == 0);
  exit_softargmin_kernel<TW, TY, DPT><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(yv), static_cast<const float*>(wt), static_cast<const float*>(hyp), hyp_per_pixel,
      static_cast<float*>(depth), static_cast<float*>(conf), D, h, w, vec_load);
  return (int)cudaGetLastError();
}

// out = {columns, rows, planes per thread, shared bytes, blocks resident on
// an SM (registers and shared memory both counted), registers per thread}
template <int TW, int TY, int DPT>
static int residency(size_t smem, int* out) {
  cudaError_t e = prepare<TW, TY, DPT>();
  cudaFuncAttributes attr{};
  int blocks = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, exit_softargmin_kernel<TW, TY, DPT>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, exit_softargmin_kernel<TW, TY, DPT>, kThreads, smem);
  const int vals[6] = {TW, TY, DPT, (int)smem, blocks, attr.numRegs};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return (int)e;
}

// The tile: the first of 64 x 4, 64 x 2 and 32 x 1 whose shared memory
// lets three blocks share an SM, else two, else one; -1 where none fits.
// Registers allow three too: 72-80 a thread under __launch_bounds__(256, 2)
// (exit_softargmin_tile on an H100; at (256, 3) K3 ran 0.5-3.6 % slower).
// Smaller blocks hide the staging better than larger tiles save halo (on an
// H100, tools/time_exit.py: D = 48 0.084 ms against 0.099 at 64 x 4; D = 128
// 0.081 against 0.095 at 64 x 2); the 32-column tile keeps the logits of
// large D in shared memory.
static int pick_tile(int D, size_t* smem) {
  const size_t sizes[3] = {smem_bytes<64, 4, 4>(D), smem_bytes<64, 2, 4>(D), smem_bytes<32, 1, 2>(D)};
  for (int blocks = 3; blocks >= 1; --blocks) {
    const size_t limit = blocks == 1 ? (size_t)kMaxSmem : (size_t)kMaxSmem / blocks - 1024;
    for (int t = 0; t < 3; ++t) {
      if (sizes[t] <= limit) {
        *smem = sizes[t];
        return t;
      }
    }
  }
  return -1;
}

CDS_EXPORT int exit_softargmin_launch(const void* yv, const void* wt, const void* hyp,
                                      int hyp_per_pixel, void* depth, void* conf, int D,
                                      int h, int w, void* stream) {
  size_t smem = 0;
  const int t = D < 1 ? -1 : pick_tile(D, &smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 0: return launch<64, 4, 4>(yv, wt, hyp, hyp_per_pixel, depth, conf, D, h, w, smem, st);
    case 1: return launch<64, 2, 4>(yv, wt, hyp, hyp_per_pixel, depth, conf, D, h, w, smem, st);
    case 2: return launch<32, 1, 2>(yv, wt, hyp, hyp_per_pixel, depth, conf, D, h, w, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile the launcher takes for D planes and its residency (see
// residency), for tools/time_exit.py.
CDS_EXPORT int exit_softargmin_tile(int D, int* out) {
  size_t smem = 0;
  switch (D < 1 ? -1 : pick_tile(D, &smem)) {
    case 0: return residency<64, 4, 4>(smem, out);
    case 1: return residency<64, 2, 4>(smem, out);
    case 2: return residency<32, 1, 2>(smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
