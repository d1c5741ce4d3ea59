// K1 and K5's forward: fused plane-sweep warp + ref inner product, ending in
// the online softmax entropy (K1, warp_entropy_kernel) or in the per-plane
// similarity (K5, warp_kernel). Wrappers, plain versions and design notes:
// ops/kernels/warp.py (K1), ops/kernels/warp_vjp.py (K5).
#include "warp.cuh"

// K5's forward. Block (x, y) owns lanes::Tile<C>::P consecutive pixels of
// the flattened (h, w) grid and planes [y * DC, y * DC + DC) (k5 in
// warp.cuh): a pixel's lanes project it at each plane of the chunk, gather
// their channels of the four corners in 16-byte loads rounding op by op
// (gather_lane<V, true>, so in_prod equals the one-thread-a-pixel kernel's
// and the plain version's bit for bit), and multiply by their ref values;
// sim is the xor-shuffle sum of the pixel's lanes, which its first lane
// stores. in_prod leaves as K1's does: a warp writes a plane's (C, PT)
// sub-tile to one of two shared buffers, then stores it as 16-byte
// evict-first vectors; a warp waits only for itself.
template <int C>
__global__ void __launch_bounds__(lanes::kThreads, C == 8 ? 6 : C == 16 ? 3 : 2) warp_kernel(
    const bf16* __restrict__ src,      // (H, W, C) channels-last source features
    const bf16* __restrict__ ref,      // (C, h, w) reference features
    const float* __restrict__ depth,   // (D,) or (D, h, w) hypotheses
    int depth_per_pixel,
    const float* __restrict__ rt,      // (12,) rot row-major ++ trans
    bf16* __restrict__ in_prod,        // (C, D, h, w)
    float* __restrict__ out,           // sim (D, h, w)
    int H, int W, int D, int h, int w, int DC) {
  using T = lanes::Tile<C>;
  constexpr int CL = T::CL, V = T::V;
  __shared__ __align__(16) unsigned short ring[lanes::kThreads / 32][2][T::BUF];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid % T::G, pl = tid / T::G, pt = pl % T::PT, c0 = CL * g;
  const int hw = h * w, pix0 = blockIdx.x * T::P;
  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  const int nw = min(max(hw - pix0 - warp * T::PT, 0), T::PT);  // pixels of this warp
  const bool live = pix0 + pl < hw;
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

  float dep_next = hyp(d0);
  for (int d = d0; d < d1; ++d) {
    const float dep = dep_next;
    if (d + 1 < d1) dep_next = hyp(d + 1);
    const Footprint f = project(r, L, dep, H, W);
    float acc[CL];
    gather_lane<V, true>(src, f, H, W, C, c0, acc);

    unsigned short* buf = ring[warp][(d - d0) & 1];
    float sim = 0.f;
#pragma unroll
    for (int i = 0; i < CL; ++i) {
      const float wq = bf2f(f2bf(acc[i]));  // warped value in the feature dtype
      buf[lanes::slot<C>(c0 + i, pt / 8) * 8 + pt % 8] = __bfloat16_as_ushort(f2bf(refv[i] * wq));
      sim += wq * refv[i];
    }
#pragma unroll
    for (int o = T::G / 2; o > 0; o /= 2) sim += __shfl_xor_sync(0xffffffffu, sim, o);
    if (g == 0 && live) out[(size_t)d * hw + pix] = sim;

    __syncwarp();  // the sub-tile of plane d is in buf; buf's last reader (plane d - 2) is done
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int k = lane + 32 * v, sr = k / T::VROW, sj = k % T::VROW;
      const unsigned short* sv = buf + lanes::slot<C>(sr, sj) * 8;
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
using lanes::kThreads;
using lanes::slot;
template <int C>
struct Tile : lanes::Tile<C> {
  static constexpr int MIN_BLOCKS = C == 8 ? 4 : 2;  // resident blocks an SM the registers allow
};
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

template <int C>
static int launch_sim(const void* src, const void* ref, const void* depth, int depth_per_pixel, const void* rt,
                      void* in_prod, void* sim, int H, int W, int D, int h, int w, void* stream) {
  const int tiles = (h * w + lanes::Tile<C>::P - 1) / lanes::Tile<C>::P;
  if (tiles == 0) return 0;
  const int DC = k5::chunk_planes(D, tiles);
  warp_kernel<C><<<dim3(tiles, (D + DC - 1) / DC), lanes::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(ref), static_cast<const float*>(depth),
      depth_per_pixel, static_cast<const float*>(rt), static_cast<bf16*>(in_prod), static_cast<float*>(sim),
      H, W, D, h, w, DC);
  return (int)cudaGetLastError();
}

CDS_EXPORT int warp_sim_launch(const void* src, const void* ref, const void* depth,
                               int depth_per_pixel, const void* rt, void* in_prod, void* sim,
                               int C, int H, int W, int D, int h, int w, void* stream) {
  switch (C) {
    case 8: return launch_sim<8>(src, ref, depth, depth_per_pixel, rt, in_prod, sim, H, W, D, h, w, stream);
    case 16: return launch_sim<16>(src, ref, depth, depth_per_pixel, rt, in_prod, sim, H, W, D, h, w, stream);
    case 32: return launch_sim<32>(src, ref, depth, depth_per_pixel, rt, in_prod, sim, H, W, D, h, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5's forward plan at C channels, D planes and h x w pixels, as
// warp_sim_launch makes it: out = {lanes a pixel, pixels a block, planes a
// chunk, chunks, blocks, registers a thread, resident blocks an SM, shared
// bytes a block}.
template <int C>
static int sim_plan(int D, int h, int w, int* out) {
  using T = lanes::Tile<C>;
  cudaFuncAttributes attr;
  int per_sm = 0;
  if (cudaFuncGetAttributes(&attr, warp_kernel<C>) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_kernel<C>, lanes::kThreads, 0) != cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  const int tiles = (h * w + T::P - 1) / T::P, DC = k5::chunk_planes(D, tiles);
  out[0] = T::G; out[1] = T::P; out[2] = DC; out[3] = (D + DC - 1) / DC; out[4] = tiles * out[3];
  out[5] = attr.numRegs; out[6] = per_sm; out[7] = (int)attr.sharedSizeBytes;
  return 0;
}

CDS_EXPORT int warp_sim_plan(int C, int D, int h, int w, int* out) {
  if (D < 1 || h * w < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: return sim_plan<8>(D, h, w, out);
    case 16: return sim_plan<16>(D, h, w, out);
    case 32: return sim_plan<32>(D, h, w, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
