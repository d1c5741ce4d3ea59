// The plane-sweep projection and bilinear gather shared by K1 and K5's forward
// (warp.cu), K5's backward (warp_vjp.cu) and K9 (gather.cu). Wrappers, plain versions and
// design notes: ops/kernels/warp.py, ops/kernels/warp_vjp.py.
#pragma once

#include "common.cuh"

// Bilinear footprint of one (plane, reference pixel) in the source view.
struct Footprint {
  int x0, y0;      // top-left corner, 0 where no corner is in bounds
  float wts[4];    // fp32 weights of corners (x0,y0) (x0+1,y0) (x0,y0+1) (x0+1,y0+1)
  bool ok[4];      // corner in bounds (zeros padding outside)
};

// The three rows of the homography at reference pixel (x, y):
// L[i] = (r[3i] * x + r[3i+1] * y) + r[3i+2].
//
// The projection and the bilinear weights round each product and sum on its
// own (__fmul_rn, __fadd_rn, no FMA contraction), in the order of the plain
// PyTorch version (ops/kernels/warp.py: project; ops/grid_sample.py), so that
// both pick the same corners with the same weights. A weight near 0 (a
// coordinate just past an integer) would otherwise differ by a large part of
// itself, and so would a gradient that gathers only such weights.
__device__ __forceinline__ void plane_rows(const float* r, int x, int y, float* L) {
  const float X = (float)x, Y = (float)y;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    L[i] = __fadd_rn(__fadd_rn(__fmul_rn(r[3 * i], X), __fmul_rn(r[3 * i + 1], Y)), r[3 * i + 2]);
}

// Bilinear footprint of the source-pixel coordinates (px, py) on the
// align_corners=True pixel grid of an H x W source. Bounds are tested on
// floats, so far-off or non-finite coordinates are never converted to int.
__device__ __forceinline__ Footprint footprint(float px, float py, int H, int W) {
  const float x0f = floorf(px), y0f = floorf(py);
  const float tx = px - x0f, ty = py - y0f;
  const bool vx0 = x0f >= 0.f && x0f <= (float)(W - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(W - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(H - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(H - 2);
  Footprint f;
  f.x0 = (vx0 || vx1) ? (int)x0f : 0;
  f.y0 = (vy0 || vy1) ? (int)y0f : 0;
  f.wts[0] = __fmul_rn(1.f - tx, 1.f - ty);
  f.wts[1] = __fmul_rn(tx, 1.f - ty);
  f.wts[2] = __fmul_rn(1.f - tx, ty);
  f.wts[3] = __fmul_rn(tx, ty);
  f.ok[0] = vy0 && vx0;
  f.ok[1] = vy0 && vx1;
  f.ok[2] = vy1 && vx0;
  f.ok[3] = vy1 && vx1;
  return f;
}

// Project with the 12 homography scalars r (row-major rotation, then the
// translation) at depth dep: z = L2*dep + t2 + 1e-6, exactly as the TPU
// kernel.
__device__ __forceinline__ Footprint project(const float* r, const float* L, float dep, int H,
                                             int W) {
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(L[2], dep), r[11]), 1e-6f);
  const float px = __fdiv_rn(__fadd_rn(__fmul_rn(L[0], dep), r[9]), z);
  const float py = __fdiv_rn(__fadd_rn(__fmul_rn(L[1], dep), r[10]), z);
  return footprint(px, py, H, W);
}

// acc[c] = sum over in-bounds corners, in corner order, of w_k * src[corner_k, c],
// for a channels-last bf16 or fp32 source. kExact rounds each product and sum
// as the plain version does, so the warped values equal its bit for bit: K8
// (warp_coords.cu), K9 (gather.cu), and K5 through the lane form below
// (forward and the backward's recompute), whose train step is held against
// the plain path's, and at random weights that step's gradients move by 0.13
// relative L2 when 2e-5 of the warped values sit one bf16 ulp off.
// Otherwise the multiply-adds fuse, as K1's gather_lane below does: the
// op-by-op gather cost K1 3-4 % of its time.
template <int C, bool kExact, typename T>
__device__ __forceinline__ void gather(const T* __restrict__ src, const Footprint& f, int W,
                                       float* acc) {
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!f.ok[k]) continue;
    const int xi = f.x0 + (k & 1), yi = f.y0 + (k >> 1);
    // one corner = C contiguous values, read 8 at a time in 16-byte loads
    const T* p = src + ((size_t)yi * W + xi) * C;
#pragma unroll
    for (int q = 0; q < C / 8; ++q) {
      float v[8];
      load8(p + q * 8, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = q * 8 + i;
        acc[c] = kExact ? __fadd_rn(acc[c], __fmul_rn(v[i], f.wts[k])) : fmaf(v[i], f.wts[k], acc[c]);
      }
    }
  }
}

// The lane-group form of gather<C, kExact>: the lane that holds channels
// c0 .. c0 + 8V - 1 of a bf16 pixel loads them from each corner in V
// 16-byte loads (addresses clamped into the image, so the loads do not wait
// for the bounds test) and sums them in corner order with the same
// arithmetic, skipping an out-of-bounds corner as gather<> does: each
// channel's value equals gather<C, kExact>'s bit for bit. K1 fuses
// (kExact = false); K5 rounds op by op.
template <int V, bool kExact = false>
__device__ __forceinline__ void gather_lane(const bf16* __restrict__ src, const Footprint& f, int H, int W, int C,
                                            int c0, float (&acc)[8 * V]) {
#pragma unroll
  for (int i = 0; i < 8 * V; ++i) acc[i] = 0.f;
  const int xa = min(max(f.x0, 0), W - 1) * C, xb = min(max(f.x0 + 1, 0), W - 1) * C;
  const bf16* rows[2] = {src + (size_t)min(max(f.y0, 0), H - 1) * W * C + c0,
                         src + (size_t)min(max(f.y0 + 1, 0), H - 1) * W * C + c0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4* p = reinterpret_cast<const uint4*>(rows[k >> 1] + (k & 1 ? xb : xa));
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 q = __ldg(p + v);
      if (!f.ok[k]) continue;
      float x[8];
      unpack8(q, x);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[8 * v + i] = kExact ? __fadd_rn(acc[8 * v + i], __fmul_rn(x[i], f.wts[k]))
                                : fmaf(x[i], f.wts[k], acc[8 * v + i]);
    }
  }
}

// The lane tile of K1 (warp_entropy_kernel) and K5 (warp_kernel,
// warp_sim_backward_kernel). A block of kThreads threads owns P consecutive
// pixels of the flattened (h, w) grid; a pixel's C channels go to G = C / CL
// lanes of CL channels (K1 and K5's forward: 16, one lane of 8 at C = 8; K5's
// backward: 8), and a warp to PT pixels. A warp passes one plane of
// (C, D, h, w) bf16 data (in_prod, or its cotangent) through a (C, PT)
// sub-tile in shared memory, so that it leaves or arrives as 16-byte
// vectors, rows of PT pixels of a (c, d) plane.
namespace lanes {
constexpr int kThreads = 256;
template <int C, int CL_ = (C >= 16 ? 16 : 8)>
struct Tile {
  static constexpr int CL = CL_;               // channels a lane
  static constexpr int V = CL / 8;             // 16-byte vectors a lane and corner
  static constexpr int G = C / CL;             // lanes a pixel
  static constexpr int P = kThreads / G;       // pixels a block
  static constexpr int PT = 32 / G;            // pixels a warp
  static constexpr int VROW = PT / 8;          // 16-byte vectors a sub-tile row
  static constexpr int BUF = C * PT;           // bf16 values a sub-tile
  static_assert(BUF / 8 == 32 * V, "V 16-byte vectors of a sub-tile a lane");
};
// The 16-byte slot of vector j of sub-tile row c: row-major, XOR-ed with
// 2 * (c / CL), so that the lanes of a pixel (rows CL apart) reach
// different banks.
template <int C, int CL = Tile<C>::CL>
__device__ __forceinline__ int slot(int c, int j) {
  return (c * Tile<C, CL>::VROW + j) ^ (2 * (c / CL));
}
}  // namespace lanes

// K5's grid: pixel tiles x plane chunks of DC planes, as many chunks as
// give at least kTargetBlocks blocks (two waves of two 256-thread blocks on
// each of the H100's 132 SMs) where D allows: with want = min(D,
// ceil(kTargetBlocks / tiles)), DC = floor(D / want) and ceil(D / DC) >= want
// chunks, the last one ragged. Mirrored by
// ops/kernels/warp_vjp.py::launch_plan.
namespace k5 {
constexpr int kTargetBlocks = 2 * 2 * 132;
inline int chunk_planes(int D, int tiles) {
  int want = (kTargetBlocks + tiles - 1) / tiles;
  want = want < D ? want : D;
  return D / want;
}
}  // namespace k5
