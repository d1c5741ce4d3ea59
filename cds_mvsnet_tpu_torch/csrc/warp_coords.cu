// K8: the fused plane-sweep warp from precomputed source-pixel coordinates,
// in_prod = ref * bf16(warped) and sim = sum_C f32(bf16(warped)) * f32(ref),
// for one source view or for all source views of a stage in one launch.
// Wrapper, plain version and design note: ops/kernels/warp_coords.py.
#include <stdint.h>

#include "warp.cuh"

// K8's grid: pixel tiles of kThreads consecutive pixels of the flattened
// (h, w) grid, one thread a pixel, x plane chunks x views. A chunk holds
// as many planes as still give kTargetBlocks blocks over all views (K5's
// k5::chunk_planes rule with a larger target), but at least kMinPlanes
// where D allows. The tile, the chunk rule and the registers are the
// fastest the card measured (PERF.md): 256-thread blocks ran up to 5 %
// slower, and channel lanes with in_prod staged through shared memory (K1's
// and K5's forward tile) 7-25 % slower. Mirrored by
// ops/kernels/warp_coords.py::launch_plan.
namespace k8 {
constexpr int kThreads = 128, kTargetBlocks = 64 * 132, kMinPlanes = 8;
// resident blocks an SM the registers allow: 7 at C = 8 and 16 (up to 73
// registers), 4 at C = 32
template <int C>
constexpr int min_blocks() { return C == 32 ? 4 : 7; }

inline int chunk_planes(int D, int blocks) {
  int want = (kTargetBlocks + blocks - 1) / blocks;
  want = want < D ? want : D;
  const int DC = D / want;
  return DC >= kMinPlanes ? DC : D < kMinPlanes ? D : kMinPlanes;
}

// Two floats rounded to bf16 in one cvt.rn.bf16x2.f32: a in the low half.
__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }
}  // namespace k8

// Block (x, y, z) owns pixels [x * kThreads, x * kThreads + kThreads) of
// view z and planes [y * DC, y * DC + DC). A thread loads its pixel's px and
// py a plane ahead, takes the corners and weights with footprint(), gathers
// the C channels of each corner in 16-byte loads rounding op by op
// (gather_lane<C / 8, true>: warped, and with it in_prod, equals the plain
// version bit for bit), rounds each pair of warped values and of in_prod
// values with one cvt.rn.bf16x2.f32 and unpacks them by shift and mask. A
// warp's 32 threads are 32 consecutive pixels, so each of its 2-byte
// evict-first in_prod stores writes 64 contiguous bytes of a (c, d) row, and
// each sim store 128.
template <int C>
__global__ void __launch_bounds__(k8::kThreads, k8::min_blocks<C>()) warp_coords_kernel(
    const bf16* __restrict__ src,   // (V, H, W, C) channels-last source features
    const bf16* __restrict__ ref,   // (V, C, h, w) reference features
    const float* __restrict__ px,   // (V, D, h, w) source-pixel x
    const float* __restrict__ py,   // (V, D, h, w) source-pixel y
    bf16* __restrict__ in_prod,     // (V, C, D, h, w)
    float* __restrict__ sim,        // (V, D, h, w)
    int H, int W, int D, int h, int w, int DC) {
  const int hw = h * w, pix = blockIdx.x * k8::kThreads + threadIdx.x;
  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  if (pix >= hw) return;
  const size_t view = blockIdx.z, n = (size_t)D * hw;
  src += view * H * W * C;
  ref += view * C * hw;
  px += view * n;
  py += view * n;
  in_prod += view * C * n;
  sim += view * n;

  float refv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) refv[c] = bf2f(ref[(size_t)c * hw + pix]);

  float x_next = __ldg(px + (size_t)d0 * hw + pix), y_next = __ldg(py + (size_t)d0 * hw + pix);
  for (int d = d0; d < d1; ++d) {
    const float x = x_next, y = y_next;
    if (d + 1 < d1) {
      x_next = __ldg(px + (size_t)(d + 1) * hw + pix);
      y_next = __ldg(py + (size_t)(d + 1) * hw + pix);
    }
    const Footprint f = footprint(x, y, H, W);
    float acc[C];
    gather_lane<C / 8, true>(src, f, H, W, C, 0, acc);

    unsigned short* out = reinterpret_cast<unsigned short*>(in_prod) + (size_t)d * hw + pix;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const uint32_t wq = k8::pack_rn(acc[c], acc[c + 1]);  // warped values in the feature dtype
      const float w0 = k8::lo(wq), w1 = k8::hi(wq);
      const uint32_t ip = k8::pack_rn(refv[c] * w0, refv[c + 1] * w1);
      __stcs(out + (size_t)c * n, (unsigned short)ip);
      __stcs(out + (size_t)(c + 1) * n, (unsigned short)(ip >> 16));
      s += w0 * refv[c];
      s += w1 * refv[c + 1];
    }
    sim[(size_t)d * hw + pix] = s;
  }
}

// The grid over V views of D planes and h x w pixels: pixel tiles, plane
// chunks of DC planes, views.
static dim3 coords_grid(int V, int D, int h, int w, int& DC) {
  const int tiles = (h * w + k8::kThreads - 1) / k8::kThreads;
  DC = k8::chunk_planes(D, tiles * V);
  return dim3(tiles, (D + DC - 1) / DC, V);
}

template <int C>
static int launch(const void* src, const void* ref, const void* px, const void* py, void* in_prod, void* sim, int V,
                  int H, int W, int D, int h, int w, void* stream) {
  int DC;
  const dim3 grid = coords_grid(V, D, h, w, DC);
  warp_coords_kernel<C><<<grid, k8::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(ref), static_cast<const float*>(px),
      static_cast<const float*>(py), static_cast<bf16*>(in_prod), static_cast<float*>(sim), H, W, D, h, w, DC);
  return (int)cudaGetLastError();
}

CDS_EXPORT int warp_sim_coords_launch(const void* src, const void* ref, const void* px,
                                      const void* py, void* in_prod, void* sim, int V, int C,
                                      int H, int W, int D, int h, int w, void* stream) {
  if (V <= 0 || D <= 0 || h <= 0 || w <= 0) return 0;
  switch (C) {
    case 8: return launch<8>(src, ref, px, py, in_prod, sim, V, H, W, D, h, w, stream);
    case 16: return launch<16>(src, ref, px, py, in_prod, sim, V, H, W, D, h, w, stream);
    case 32: return launch<32>(src, ref, px, py, in_prod, sim, V, H, W, D, h, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8's launch plan over V views at C channels, D planes and h x w pixels,
// as warp_sim_coords_launch makes it: out = {pixels a block, planes a chunk,
// chunks, blocks, registers a thread, resident blocks an SM}.
template <int C>
static int plan(int V, int D, int h, int w, int* out) {
  cudaFuncAttributes attr;
  int per_sm = 0;
  if (cudaFuncGetAttributes(&attr, warp_coords_kernel<C>) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_coords_kernel<C>, k8::kThreads, 0) != cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  int DC;
  const dim3 grid = coords_grid(V, D, h, w, DC);
  out[0] = k8::kThreads; out[1] = DC; out[2] = grid.y; out[3] = grid.x * grid.y * grid.z;
  out[4] = attr.numRegs; out[5] = per_sm;
  return 0;
}

CDS_EXPORT int warp_sim_coords_plan(int V, int C, int D, int h, int w, int* out) {
  if (V < 1 || D < 1 || h * w < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: return plan<8>(V, D, h, w, out);
    case 16: return plan<16>(V, D, h, w, out);
    case 32: return plan<32>(V, D, h, w, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
