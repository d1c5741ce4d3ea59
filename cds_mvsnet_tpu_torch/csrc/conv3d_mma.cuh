// The tensor-core body of a 3x3x3 conv (pad 1, stride 1) on a bf16 volume,
// shared by K2's bf16 form (conv3d.cu) and K6's conv0 (conv3d_fused.cu), so
// that the two compute every output voxel with the same operations in the
// same order: K6's out0 equals K2's output bit for bit. K7's bf16 form
// (conv3d.cu) runs the same arithmetic at stride 2 (mma_step_s2).
//
// Implicit GEMM: M = output voxels, N = O (8 or 16: one or two 8-wide
// n-tiles), K = 27·C, on mma.sync.m16n8k16 (bf16 in, fp32 accumulators).
// mma.sync and not wgmma: with N <= 16 the product is thin, the kernels are
// bound by bytes, and mma.sync's rate is far above what they need, while its
// per-warp fragments let each M row be any voxel of a shared-memory tile
// (K6's conv0 region is no multiple of a 64-row wgmma tile).
//
// K order: the volume is taken in chunks of 8 channels. A chunk is staged in
// shared memory channel-innermost, one 16-byte row of 8 bf16 per voxel of a
// halo box ([z][y][x][8]), zeros outside the volume, loaded in pairs of
// voxels along x (one four-byte load per channel for both). Within a chunk a
// 16-deep K-step covers two taps (8 channels each; the 28th tap has zero
// weights), so the chunk takes KSTEPS = 14 steps. One ldmatrix.x4 loads a
// step's A fragment: lanes 0-15 give the rows (voxels) of tap 2s, lanes
// 16-31 those of tap 2s+1, each row one 16-byte voxel row; consecutive voxels
// along x sit 16 bytes apart, so 8 rows cover 32 banks once. cp.async and TMA
// copy contiguous runs of at least 4 bytes and cannot turn the channels-first
// volume into this layout, so the halo goes through registers (load_pair8).
//
// Precision: the wrapper passes fp32 weights (eval BN folded). Each is split
// here, as it is staged, into hi = bf16(w) and lo = bf16(w - hi), and each
// K-step runs two MMAs into one fp32 accumulator, hi then lo. A bf16 x bf16
// product is exact in fp32, so what remains is w's residual below 2^-16 of
// |w| and the fp32 sums, which keeps the result within one bf16 ulp of the
// fp32 conv; bf16 weights alone miss that where the output is small. The
// TPU kernel rounds its weights to bf16 (cds_mvsnet_tpu/ops/pallas/conv3d.py,
// conv3d_front and conv3d_front_fused): an input format of its matrix unit,
// not carried over.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace conv_mma {

constexpr int CH = 8;       // channels per chunk: one 16-byte row per voxel
constexpr int TAPS = 27;
constexpr int KSTEPS = 14;  // two taps per 16-deep K-step, the 28th zero

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);  // .x: the lower k
  return *reinterpret_cast<uint32_t*>(&v);
}

// Weight fragments of every chunk and K-step, in the order a warp reads
// them: entry ((chunk * KSTEPS + s) * NT + nt) * 32 + lane holds, for
// n = nt*8 + lane/4 and channels c = chunk*8 + 2*(lane%4) + {0, 1}, the
// B fragment {b0: tap 2s, b1: tap 2s+1} once as hi and once as lo. One
// LDS.128 per lane and step; a warp's 512 bytes are contiguous.
template <int NT>
__device__ void stage_weights(uint4* wfrag, const float* __restrict__ w, int C, int tid, int nthreads) {
  const int n_entries = (C / CH) * KSTEPS * NT * 32;
  for (int i = tid; i < n_entries; i += nthreads) {
    const int lane = i % 32, rest = i / 32;
    const int nt = rest % NT, step = rest / NT;
    const int s = step % KSTEPS, chunk = step / KSTEPS;
    const int n = nt * 8 + lane / 4;
    const int c = chunk * CH + 2 * (lane % 4);
    uint32_t hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tap = 2 * s + r;
      float v0 = 0.f, v1 = 0.f;
      if (tap < TAPS) {
        v0 = __ldg(w + ((size_t)n * C + c) * TAPS + tap);
        v1 = __ldg(w + ((size_t)n * C + c + 1) * TAPS + tap);
      }
      const float h0 = bf2f(f2bf(v0)), h1 = bf2f(f2bf(v1));
      hi[r] = pack_bf16x2(h0, h1);
      lo[r] = pack_bf16x2(v0 - h0, v1 - h1);  // exact in fp32, then rounded once
    }
    wfrag[i] = make_uint4(hi[0], hi[1], lo[0], lo[1]);
  }
}

// Channels c0 .. c0+7 of voxel (z, y, x) as 8 packed bf16, zeros outside the
// volume: 8 two-byte loads, one per channel plane; neighbouring threads take
// neighbouring x, so each load of a warp reads one run of the plane.
__device__ __forceinline__ uint4 load_voxel8(const bf16* __restrict__ vol, size_t plane, int c0, int z, int y,
                                             int x, int D, int h, int w) {
  if (z < 0 || z >= D || y < 0 || y >= h || x < 0 || x >= w) return make_uint4(0, 0, 0, 0);
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(vol) + (size_t)c0 * plane + ((size_t)z * h + y) * w + x;
  uint32_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = (uint32_t)__ldg(p + (size_t)(2 * j) * plane) | ((uint32_t)__ldg(p + (size_t)(2 * j + 1) * plane) << 16);
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// Channels c0 .. c0+7 of voxels x and x+1 (x even) of row (z, y) into
// q[0] and q[1], zeros outside the volume. With `pairs` (w even and the
// volume 4-byte aligned) a four-byte load per channel takes both voxels;
// otherwise two-byte loads, one per voxel and channel.
__device__ __forceinline__ void load_pair8(uint4 (&q)[2], const bf16* __restrict__ vol, size_t plane, int c0, int z,
                                           int y, int x, int D, int h, int w, bool pairs) {
  q[0] = q[1] = make_uint4(0, 0, 0, 0);
  if (z < 0 || z >= D || y < 0 || y >= h) return;
  if (!pairs) {
    q[0] = load_voxel8(vol, plane, c0, z, y, x, D, h, w);
    q[1] = load_voxel8(vol, plane, c0, z, y, x + 1, D, h, w);
    return;
  }
  if (x < 0 || x >= w) return;  // x and w even: x + 1 is inside when x is
  const uint32_t* p = reinterpret_cast<const uint32_t*>(vol + (size_t)c0 * plane + ((size_t)z * h + y) * w + x);
  uint32_t a[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) a[c] = __ldg(p + (size_t)c * (plane / 2));
  q[0] = make_uint4(__byte_perm(a[0], a[1], 0x5410), __byte_perm(a[2], a[3], 0x5410), __byte_perm(a[4], a[5], 0x5410),
                    __byte_perm(a[6], a[7], 0x5410));
  q[1] = make_uint4(__byte_perm(a[0], a[1], 0x7632), __byte_perm(a[2], a[3], 0x7632), __byte_perm(a[4], a[5], 0x7632),
                    __byte_perm(a[6], a[7], 0x7632));
}

// The halo box (HZ, HY, HX), HX even, at corner (z0, y0, x0), x0 even, one
// chunk, in pairs of voxels along x: pair v = i*NTHREADS + tid for
// i < NTASK (v < HZ*HY*HX/2) into q[i].
template <int NTASK, int NTHREADS, int HY, int HX>
__device__ __forceinline__ void load_halo(uint4 (&q)[NTASK][2], const bf16* __restrict__ vol, size_t plane, int c0,
                                          int nv, int z0, int y0, int x0, int D, int h, int w, bool pairs,
                                          int tid) {
  static_assert(HX % 2 == 0, "the halo is loaded in pairs of voxels along x");
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    const int v = i * NTHREADS + tid;
    if (v < nv / 2) {
      const int hx = 2 * (v % (HX / 2)), hy = (v / (HX / 2)) % HY, hz = v / (HX / 2 * HY);
      load_pair8(q[i], vol, plane, c0, z0 + hz, y0 + hy, x0 + hx, D, h, w, pairs);
    }
  }
}

template <int NTASK, int NTHREADS>
__device__ __forceinline__ void store_halo(uint4* halo, const uint4 (&q)[NTASK][2], int nv, int tid) {
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    const int v = i * NTHREADS + tid;
    if (v < nv / 2) {
      halo[2 * v] = q[i][0];
      halo[2 * v + 1] = q[i][1];
    }
  }
}

// Four-byte loads of voxel pairs need an even w and a 4-byte aligned volume.
__device__ __forceinline__ bool pair_loads(const bf16* vol, int w) {
  return w % 2 == 0 && (reinterpret_cast<uintptr_t>(vol) & 3) == 0;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's ldmatrix row of an M-tile: rows 0-7 from lanes 0-7 (and
// 16-23), rows 8-15 from lanes 8-15 (and 24-31).
__device__ __forceinline__ int ldmatrix_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }

// K-step s of a chunk for the first `valid` (warp-uniform, <= MT) of this
// warp's MT M-tiles: acc[mt][nt] += the step's products, hi then lo. halo:
// shared address of the staged chunk; row[mt]: byte offset in it of the
// (-1, -1, -1) neighbour of this lane's ldmatrix row voxel; sz, sy: byte
// strides of the halo's z and y; wfrag: this chunk's fragments.
// kWide: the hi MMAs of every M-tile issue before the lo MMAs, so that an
// accumulator's two MMAs do not issue back to back (it holds MT A fragments
// at once: K2's 4 M-tiles a warp); otherwise each M-tile's hi and lo follow
// each other (K6's 7). The order of the sums is the same either way.
template <int MT, int NT, bool kWide>
__device__ __forceinline__ void mma_step(int s, float (&acc)[MT][NT][4], uint32_t halo, const uint32_t (&row)[MT],
                                         const uint4* wfrag, int sz, int sy, int lane, int valid) {
  const int t0 = 2 * s, t1 = 2 * s + 1 < TAPS ? 2 * s + 1 : 0;  // the 28th tap reads tap 0 at zero weight
  const int tap = lane >= 16 ? t1 : t0;                          // lanes 16-31 address the second tap
  const uint32_t toff = (tap / 9) * sz + ((tap / 3) % 3) * sy + (tap % 3) * 16;
  uint4 b[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) b[nt] = wfrag[(s * NT + nt) * 32 + lane];
  if constexpr (kWide) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= valid) break;
      ldmatrix_x4(a[mt], halo + row[mt] + toff);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt].x, b[nt].y);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= valid) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt].z, b[nt].w);
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= valid) break;
      uint32_t a[4];
      ldmatrix_x4(a, halo + row[mt] + toff);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(acc[mt][nt], a, b[nt].x, b[nt].y);
        mma_bf16(acc[mt][nt], a, b[nt].z, b[nt].w);
      }
    }
  }
}

// K7's K-step (stride 2): mma_step's wide form, the hi MMAs of the M-tiles,
// then their lo MMAs, on a halo stored by x parity (conv3d.cu, k7): the x
// tap kx of a row sits at parity 1 of its slot (kx = 0, px16 bytes on),
// parity 0 one slot on (kx = 1, 16 bytes) or parity 1 one slot on (kx = 2),
// not at 16·kx. The sums run as mma_step's: every voxel's step by step, hi
// then lo.
template <int MT, int NT>
__device__ __forceinline__ void mma_step_s2(int s, float (&acc)[MT][NT][4], uint32_t halo, const uint32_t (&row)[MT],
                                            const uint4* wfrag, int sz, int sy, int px16, int lane, int valid) {
  const int t0 = 2 * s, t1 = 2 * s + 1 < TAPS ? 2 * s + 1 : 0;  // the 28th tap reads tap 0 at zero weight
  const int tap = lane >= 16 ? t1 : t0;                          // lanes 16-31 address the second tap
  const int kx = tap % 3;
  const uint32_t toff = (tap / 9) * sz + ((tap / 3) % 3) * sy + (kx == 1 ? 16 : px16 + (kx == 2 ? 16 : 0));
  uint4 b[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) b[nt] = wfrag[(s * NT + nt) * 32 + lane];
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= valid) break;
    ldmatrix_x4(a[mt], halo + row[mt] + toff);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt].x, b[nt].y);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= valid) break;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt].z, b[nt].w);
  }
}

// One chunk's 14 K-steps, in order: every voxel's sum runs step by step,
// hi then lo, whichever M-tile row holds it and however the steps are
// unrolled and scheduled. kWide (K2): all 14 steps unrolled and the wide
// step; otherwise (K6) two steps at a time, which keeps 7 M-tiles a warp in
// registers.
template <int MT, int NT, bool kWide>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4], uint32_t halo, const uint32_t (&row)[MT],
                                          const uint4* wfrag, int sz, int sy, int lane, int valid = MT) {
  if constexpr (kWide) {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) mma_step<MT, NT, true>(s, acc, halo, row, wfrag, sz, sy, lane, valid);
  } else {
#pragma unroll 2
    for (int s = 0; s < KSTEPS; ++s) mma_step<MT, NT, false>(s, acc, halo, row, wfrag, sz, sy, lane, valid);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
}

// The epilogue both kernels share: relu(acc + b) rounded to bf16. acc[j] of
// an n-tile sits at row lane/4 (j < 2) or lane/4 + 8 (j >= 2), channel
// nt*8 + 2*(lane%4) + j%2.
__device__ __forceinline__ bf16 finish(float acc, float b) { return f2bf(fmaxf(acc + b, 0.f)); }

// Host side: the grid that fills the card with resident blocks of `kernel`,
// blocks per SM at this dynamic shared memory times the SMs. Both are
// queried once: the SM count per kernel, the occupancy per C / 8 (the
// weights' shared memory grows with C) in `cache`. 0 if a query fails.
template <typename Kernel>
static int resident_grid(Kernel kernel, int threads, size_t smem, int C, int (&cache)[65]) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
  }
  int& occ = cache[C / CH];
  if (occ == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem) != cudaSuccess) return 0;
  return occ * sms;
}

}  // namespace conv_mma
