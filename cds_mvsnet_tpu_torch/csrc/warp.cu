// K1 and K5's forward: fused plane-sweep warp + ref inner product, ending in
// the online softmax entropy (K1, warp_entropy_kernel) or in the per-plane
// similarity (K5, warp_kernel). Wrappers, plain versions and design notes:
// ops/kernels/warp.py (K1), ops/kernels/warp_vjp.py (K5).
#include "warp.cuh"

// K5's forward: one thread per reference pixel loops over the D planes and
// stores sim (D, h, w); the gather rounds op by op (warp.cuh).
template <int C>
__global__ void __launch_bounds__(128) warp_kernel(
    const bf16* __restrict__ src,      // (H, W, C) channels-last source features
    const bf16* __restrict__ ref,      // (C, h, w) reference features
    const float* __restrict__ depth,   // (D,) or (D, h, w) hypotheses
    int depth_per_pixel,
    const float* __restrict__ rt,      // (12,) rot row-major ++ trans
    bf16* __restrict__ in_prod,        // (C, D, h, w)
    float* __restrict__ out,           // sim (D, h, w)
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

  for (int d = 0; d < D; ++d) {
    const float dep = depth_per_pixel ? depth[d * hw + pix] : __ldg(depth + d);
    const Footprint f = project(r, L, dep, H, W);
    float acc[C];
    gather<C, true>(src, f, W, acc);

    float sim = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wq = bf2f(f2bf(acc[c]));  // warped value in the feature dtype
      in_prod[((size_t)c * D + d) * hw + pix] = f2bf(refv[c] * wq);
      sim += wq * refv[c];
    }
    out[d * hw + pix] = sim;
  }
}

// K1. A block of 256 threads owns P consecutive pixels of the flattened
// (h, w) grid, so a ragged w wastes no lane. A pixel's C channels go to
// G = C / CL lanes of CL = 16 channels (one lane of 8 at C = 8); a lane
// gathers its channels of each corner in 16-byte loads with the
// one-thread-a-pixel K1's fused chain (gather_lane), so in_prod is bit for
// bit that kernel's, and loads the next plane's hypothesis a plane ahead.
// sim is the xor-shuffle sum of a pixel's lanes; each lane keeps the online
// (m, s, u), the pixel's first lane writes the entropy. in_prod leaves
// through shared memory: each warp writes a plane's (C, PT) bf16 sub-tile
// of its PT pixels to one of two buffers, then stores it as 16-byte
// evict-first vectors, rows of PT pixels (one or two whole 32-byte sectors)
// of in_prod's (c, d) planes; a warp waits only for itself. One block a
// tile: a persistent grid over the tiles ran 7 % slower at C = 8 (PERF.md).
namespace k1 {
constexpr int kThreads = 256;
template <int C>
struct Tile {
  static constexpr int CL = C >= 16 ? 16 : 8;        // channels a lane
  static constexpr int V = CL / 8;                   // 16-byte vectors a lane and corner
  static constexpr int G = C / CL;                   // lanes a pixel
  static constexpr int P = kThreads / G;             // pixels a block
  static constexpr int PT = 32 / G;                  // pixels a warp
  static constexpr int VROW = PT / 8;                // 16-byte vectors a sub-tile row
  static constexpr int BUF = C * PT;                 // bf16 values a sub-tile
  static constexpr int MIN_BLOCKS = C == 8 ? 4 : 2;  // resident blocks an SM the registers allow
  static_assert(BUF / 8 == 32 * V, "V 16-byte vectors of a sub-tile a lane");
};
// The 16-byte slot of vector j of sub-tile row c: row-major, bit 1 XOR-ed
// by c / CL, so that the two lanes of a C = 32 pixel (rows 16 apart) write
// to different banks.
template <int C>
__device__ __forceinline__ int slot(int c, int j) {
  return (c * Tile<C>::VROW + j) ^ (2 * (c / Tile<C>::CL));
}
}  // namespace k1

template <int C>
__global__ void __launch_bounds__(k1::kThreads, k1::Tile<C>::MIN_BLOCKS) warp_entropy_kernel(
    const bf16* __restrict__ src,      // (H, W, C) channels-last source features
    const bf16* __restrict__ ref,      // (C, h, w) reference features
    const float* __restrict__ depth,   // (D,) or (D, h, w) hypotheses
    int depth_per_pixel,
    const float* __restrict__ rt,      // (12,) rot row-major ++ trans
    bf16* __restrict__ in_prod,        // (C, D, h, w)
    float* __restrict__ entropy,       // (h, w)
    int H, int W, int D, int h, int w) {
  using T = k1::Tile<C>;
  constexpr int CL = T::CL, V = T::V;
  __shared__ __align__(16) unsigned short ring[k1::kThreads / 32][2][T::BUF];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid % T::G, pl = tid / T::G, pt = pl % T::PT, c0 = CL * g;
  const int hw = h * w, pix0 = blockIdx.x * T::P;
  const int nw = min(max(hw - pix0 - warp * T::PT, 0), T::PT);  // pixels of this warp
  const int pix = min(pix0 + pl, hw - 1);  // lanes past the end redo the last pixel and write nothing
  const bool vec = hw % 8 == 0;            // in_prod's rows start 16-byte aligned

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rt + i);
  float L[3];
  plane_rows(r, pix % w, pix / w, L);
  float refv[CL];
#pragma unroll
  for (int i = 0; i < CL; ++i) refv[i] = bf2f(ref[(size_t)(c0 + i) * hw + pix]);
  auto hyp = [&](int d) { return depth_per_pixel ? __ldg(depth + (size_t)d * hw + pix) : __ldg(depth + d); };

  // online (max, sum e, sum sim*e): entropy = m + log s - u / s
  float m = -1e30f, s = 0.f, u = 0.f;
  float dep_next = hyp(0);
  for (int d = 0; d < D; ++d) {
    const float dep = dep_next;
    if (d + 1 < D) dep_next = hyp(d + 1);
    const Footprint f = project(r, L, dep, H, W);
    float acc[CL];
    gather_lane<V>(src, f, H, W, C, c0, acc);

    unsigned short* buf = ring[warp][d & 1];
    float sim = 0.f;
#pragma unroll
    for (int i = 0; i < CL; ++i) {
      const float wq = bf2f(f2bf(acc[i]));  // warped value in the feature dtype
      buf[k1::slot<C>(c0 + i, pt / 8) * 8 + pt % 8] = __bfloat16_as_ushort(f2bf(refv[i] * wq));
      sim += wq * refv[i];
    }
#pragma unroll
    for (int o = T::G / 2; o > 0; o /= 2) sim += __shfl_xor_sync(0xffffffffu, sim, o);
    const float mn = fmaxf(m, sim);
    const float alpha = __expf(m - mn);  // ex2.approx: the entropy keeps 1e-6 of the plain one's
    const float e = __expf(sim - mn);
    s = s * alpha + e;
    u = u * alpha + sim * e;
    m = mn;

    __syncwarp();  // the sub-tile of plane d is in buf; buf's last reader (plane d - 2) is done
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int k = lane + 32 * v, sr = k / T::VROW, sj = k % T::VROW;
      const unsigned short* sv = buf + k1::slot<C>(sr, sj) * 8;
      bf16* dst = in_prod + ((size_t)sr * D + d) * hw + pix0 + warp * T::PT + 8 * sj;
      if (vec && 8 * sj + 8 <= nw) {
        __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(sv));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * sj + j < nw) __stcs(reinterpret_cast<unsigned short*>(dst) + j, sv[j]);
      }
    }
  }
  if (g == 0 && pix0 + pl < hw) entropy[pix] = (m + logf(s)) - u / s;
}

template <int C>
static int launch_entropy(const void* src, const void* ref, const void* depth, int depth_per_pixel, const void* rt,
                          void* in_prod, void* entropy, int H, int W, int D, int h, int w, void* stream) {
  constexpr int P = k1::Tile<C>::P;
  const int blocks = (h * w + P - 1) / P;
  if (blocks == 0) return 0;
  warp_entropy_kernel<C><<<blocks, k1::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(ref), static_cast<const float*>(depth),
      depth_per_pixel, static_cast<const float*>(rt), static_cast<bf16*>(in_prod), static_cast<float*>(entropy),
      H, W, D, h, w);
  return (int)cudaGetLastError();
}

CDS_EXPORT int warp_entropy_launch(const void* src, const void* ref, const void* depth,
                                   int depth_per_pixel, const void* rt, void* in_prod,
                                   void* entropy, int C, int H, int W, int D, int h, int w,
                                   void* stream) {
  switch (C) {
    case 8: return launch_entropy<8>(src, ref, depth, depth_per_pixel, rt, in_prod, entropy, H, W, D, h, w, stream);
    case 16: return launch_entropy<16>(src, ref, depth, depth_per_pixel, rt, in_prod, entropy, H, W, D, h, w, stream);
    case 32: return launch_entropy<32>(src, ref, depth, depth_per_pixel, rt, in_prod, entropy, H, W, D, h, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1's launch plan at C channels and h x w pixels, as warp_entropy_launch
// makes it: out = {lanes a pixel, pixels a block, shared bytes a block,
// blocks, registers a thread, resident blocks an SM}.
template <int C>
static int plan(int h, int w, int* out) {
  using T = k1::Tile<C>;
  cudaFuncAttributes attr;
  int per_sm = 0;
  if (cudaFuncGetAttributes(&attr, warp_entropy_kernel<C>) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_entropy_kernel<C>, k1::kThreads, 0) != cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  out[0] = T::G; out[1] = T::P; out[2] = (int)attr.sharedSizeBytes; out[3] = (h * w + T::P - 1) / T::P;
  out[4] = attr.numRegs; out[5] = per_sm;
  return 0;
}

CDS_EXPORT int warp_entropy_plan(int C, int h, int w, int* out) {
  switch (C) {
    case 8: return plan<8>(h, w, out);
    case 16: return plan<16>(h, w, out);
    case 32: return plan<32>(h, w, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

CDS_EXPORT int warp_sim_launch(const void* src, const void* ref, const void* depth,
                               int depth_per_pixel, const void* rt, void* in_prod, void* sim,
                               int C, int H, int W, int D, int h, int w, void* stream) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const bf16*>(src), static_cast<const bf16*>(ref),
        static_cast<const float*>(depth), depth_per_pixel, static_cast<const float*>(rt),
        static_cast<bf16*>(in_prod), static_cast<float*>(sim), H, W, D, h, w);
  };
  switch (C) {
    case 8: args(warp_kernel<8>); break;
    case 16: args(warp_kernel<16>); break;
    case 32: args(warp_kernel<32>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
