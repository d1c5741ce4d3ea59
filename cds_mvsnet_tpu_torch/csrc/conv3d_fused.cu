// K6: cost-regularisation conv0 (3x3x3, stride 1, C -> 8) and the stride-2
// conv1 (8 -> 16) in one pass, each with bias and ReLU. conv1 reads conv0
// rounded to the stored type, with conv0's zero padding. Wrapper, plain
// version and design note: ops/kernels/conv3d_fused.py.
//
// bf16: conv3d_fused_mma_kernel, conv0 on conv3d_mma.cuh's tensor-core body
// (K2's, so out0 equals K2's output bit for bit). fp32:
// conv3d_fused_tf32_kernel, conv0 on conv3d_tf32.cuh's 3xTF32 products in
// K2-fp32's order (so out0 equals K2-fp32's output bit for bit). Both run
// conv1 on K7-fp32's step (conv3d_tf32.cuh, down_step) from the conv0 tile
// in shared memory, so out1 equals K7-fp32 on out0 (in bf16 on
// out0.float(), rounded to bf16) bit for bit.
#include "conv3d_mma.cuh"
#include "conv3d_tf32.cuh"

#include <type_traits>

constexpr int O0 = 8;  // conv0's outputs; conv1 has 16

// K6 in bf16. A tile is TD x TY x TX conv1 outputs; its conv0 region, the
// (2t+1) values per axis that the tile reads from 2*t0-1 on, holds
// RZ x RY x RX = 1485 voxels for 4 x 8 x 32 owned ones (1.45x of conv0
// computed; the low-side halo belongs to the tile before). Phase 1 takes the
// region in two passes along z, planes 0-2 and 3-4 (56 and 38 M-tiles of 16
// flattened voxels; warp k takes M-tiles k, k+8, ..., at most 7), each pass
// chunk by chunk over its own input halo of 5 or 4 planes of 11 x 36
// voxels: the passes keep the accumulators in registers at 2 blocks per SM,
// for 9 halo planes staged per chunk instead of 7. Shared memory at C = 32:
// the conv0 weight fragments 28.0 KB, the halo 30.9 KB, conv1's 3xTF32
// weight fragments 27.0 KB and the bf16 conv0 tile 23.2 KB: 109.1 KB, two
// resident blocks of 8 warps per SM. A block stays resident and walks the
// tiles blockIdx.x, +gridDim.x, ...; its weights are staged once, and as in
// K2 the halo of the next (tile, pass, chunk) is loaded into registers
// before the MMAs of the current one.
namespace k6 {
constexpr int TD = 2, TY = 4, TX = 16;
constexpr int RZ = 2 * TD + 1, RY = 2 * TY + 1, RX = 2 * TX + 1;
constexpr int R = RZ * RY * RX;
constexpr int HY = RY + 2, HX = RX + 3;  // x from 2*x1_0 - 2, one past the region: pairs of voxels
constexpr int PZ = 3;                // region planes of the first pass; the second takes RZ - PZ
constexpr int HV = (PZ + 2) * HY * HX;  // the larger pass's halo: 1980 voxels
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int MT = (PZ * RY * RX + 16 * kWarps - 1) / (16 * kWarps);  // 7 M-tiles per warp at most
constexpr int NTASK = (HV / 2 + kThreads - 1) / kThreads;               // 4 halo voxel pairs per thread
constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ void tile_origin(int tile, int tiles_x, int tiles_y, int& d1_0, int& y1_0, int& x1_0) {
  x1_0 = (tile % tiles_x) * TX;
  y1_0 = ((tile / tiles_x) % tiles_y) * TY;
  d1_0 = (tile / (tiles_x * tiles_y)) * TD;
}

// the region planes of a pass: from pass * PZ, PZ or RZ - PZ of them
__device__ __forceinline__ int pass_planes(int pass) { return pass == 0 ? PZ : RZ - PZ; }

// The halo of (tile, pass, chunk) into registers: input planes from
// 2*d1_0 - 2 + pass*PZ, rows from 2*y1_0 - 2, columns from 2*x1_0 - 2.
__device__ __forceinline__ void load_unit(uint4 (&q)[NTASK][2], const bf16* __restrict__ vol, size_t plane, int tile,
                                          int pass, int chunk, int tiles_x, int tiles_y, int D, int h, int w,
                                          bool pairs, int tid) {
  int d1_0, y1_0, x1_0;
  tile_origin(tile, tiles_x, tiles_y, d1_0, y1_0, x1_0);
  conv_mma::load_halo<NTASK, kThreads, HY, HX>(q, vol, plane, chunk * conv_mma::CH,
                                               (pass_planes(pass) + 2) * HY * HX, 2 * d1_0 - 2 + pass * PZ,
                                               2 * y1_0 - 2, 2 * x1_0 - 2, D, h, w, pairs, tid);
}

// out0: the voxels a tile owns (region-local 1 .. 2t per axis) from the
// conv0 tile [o0][R], two along x per store: x is even and so is w, so a
// pair is in or out whole.
template <typename T>
__device__ __forceinline__ void store_out0(T* __restrict__ out0, const T* tile0, int dz0, int yy0, int xx0, int D,
                                           int h, int w, int tid, int nthreads) {
  using T2 = typename std::conditional<std::is_same<T, float>::value, float2, __nv_bfloat162>::type;
  const size_t plane = (size_t)D * h * w, hw = (size_t)h * w;
  for (int k = tid; k < O0 * 2 * TD * 2 * TY * TX; k += nthreads) {
    const int px = k % TX, ly = 1 + (k / TX) % (2 * TY), lz = 1 + (k / (TX * 2 * TY)) % (2 * TD);
    const int o = k / (TX * 2 * TY * 2 * TD), lx = 1 + 2 * px;
    const int d = dz0 + lz, y = yy0 + ly, x = xx0 + lx;
    if (d >= D || y >= h || x >= w) continue;
    const T* src = tile0 + o * R + (lz * RY + ly) * RX + lx;
    T2 pair;
    pair.x = src[0];
    pair.y = src[1];
    *reinterpret_cast<T2*>(out0 + o * plane + (size_t)d * hw + (size_t)y * w + x) = pair;
  }
}

// conv1 of a tile from the conv0 tile [o0][R] on K7-fp32's step, in its
// order: warp k < 8 owns the output row (td, ty) = (k / TY, k % TY), its
// 16 x one M-tile (warps past 8 have none); output (d1, y1, x1) reads conv0 at 2*d1-1 .. 2*d1+1,
// region-local 2*td .. 2*td+2 (likewise y and x). wfrag1: conv1's fragments
// (tf32::stage_weights<2>).
template <typename T>
__device__ __forceinline__ void conv1_phase(T* __restrict__ out1, const T* tile0, const uint4* wfrag1,
                                            const float* __restrict__ b1, int d1_0, int y1_0, int x1_0, int D,
                                            int h, int w, int warp, int lane) {
  static_assert(TD * TY == kWarps && TX == 16, "one M-tile of 16 x for each of 8 warps");
  if (warp >= TD * TY) return;
  const int td = warp / TY, ty = warp % TY, g = lane / 4;
  float acc[1][2][4];
  conv_mma::zero(acc);
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int ky = s / 3, kx = s % 3;
    tf32::down_step<1, 2>(acc, ky, kx, wfrag1, lane, [&](uint32_t(&a)[4], int hz) {
      const int r = ((2 * td + hz) * RY + 2 * ty + ky) * RX + 2 * g + kx;  // output x g; x g + 8 is 16 on
      tf32::gather_a(a, tile0, r, r + 16, R, lane);
    });
  }
  const int D1 = D / 2, h1 = h / 2, w1 = w / 2, d1 = d1_0 + td, y1 = y1_0 + ty;
  if (d1 >= D1 || y1 >= h1) return;
  const size_t plane1 = (size_t)D1 * h1 * w1, at = ((size_t)d1 * h1 + y1) * w1;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int x1 = x1_0 + g + 8 * hf;
    if (x1 >= w1) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * (lane % 4) + e;
        out1[n * plane1 + at + x1] = from_f32<T>(fmaxf(acc[0][nt][2 * hf + e] + __ldg(b1 + n), 0.f));
      }
  }
}
}  // namespace k6

__global__ void __launch_bounds__(k6::kThreads, 2) conv3d_fused_mma_kernel(
    const bf16* __restrict__ vol,  // (C, D, h, w), C a multiple of 8
    const float* __restrict__ w0,  // (O0, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ b0,  // (O0,)
    const float* __restrict__ w1,  // (O1, O0, 3, 3, 3), eval BN folded in
    const float* __restrict__ b1,  // (O1,)
    bf16* __restrict__ out0,       // (O0, D, h, w)
    bf16* __restrict__ out1,       // (O1, D/2, h/2, w/2)
    int C, int D, int h, int w, int tiles_x, int tiles_y, int n_tiles) {
  using namespace conv_mma;
  constexpr int RY = k6::RY, RX = k6::RX, R = k6::R;
  constexpr int HY = k6::HY, HX = k6::HX, HV = k6::HV, PZ = k6::PZ;
  constexpr int kThreads = k6::kThreads, kWarps = k6::kWarps, MT = k6::MT, NTASK = k6::NTASK;
  extern __shared__ uint4 smem16[];  // 16-byte aligned
  const int nchunks = C / CH;
  uint4* wfrag = smem16;
  uint4* halo = wfrag + nchunks * KSTEPS * 32;
  uint4* wfrag1 = halo + HV;  // conv1's 3xTF32 fragments
  bf16* tile0 = reinterpret_cast<bf16*>(wfrag1 + TAPS * 2 * 32);  // [o0][R]: conv0 as stored, 0 outside the volume
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  stage_weights<1>(wfrag, w0, C, tid, kThreads);
  tf32::stage_weights<2>(wfrag1, w1, O0, 1, tid, kThreads);

  float bv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) bv[e] = __ldg(b0 + 2 * (lane % 4) + e);
  const size_t plane = (size_t)D * h * w;
  const uint32_t halo_s = smem_addr(halo);
  float acc[MT][1][4];
  uint32_t row[MT];
  uint4 q[NTASK][2];
  const bool pairs = pair_loads(vol, w);
  k6::load_unit(q, vol, plane, blockIdx.x, 0, 0, tiles_x, tiles_y, D, h, w, pairs, tid);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int d1_0, y1_0, x1_0;
    k6::tile_origin(tile, tiles_x, tiles_y, d1_0, y1_0, x1_0);
    const int dz0 = 2 * d1_0 - 1, yy0 = 2 * y1_0 - 1, xx0 = 2 * x1_0 - 1;  // conv0 index of region-local 0

    // Phase 1: conv0 of the region, pass by pass and chunk by chunk, as K2
    // computes it
    for (int pass = 0; pass < 2; ++pass) {
      const int nvox = k6::pass_planes(pass) * RY * RX;  // the pass's voxels, from region index pass*PZ*RY*RX
      const int valid = ((nvox + 15) / 16 - warp + kWarps - 1) / kWarps;  // this warp's M-tiles
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        int i = (warp + j * kWarps) * 16 + ldmatrix_row(lane);
        if (i >= nvox) i = 0;  // past the pass: computed, never stored
        row[j] = (((i / (RY * RX)) * HY + (i / RX) % RY) * HX + i % RX) * 16;
      }
      zero(acc);
      for (int chunk = 0; chunk < nchunks; ++chunk) {
        __syncthreads();  // the last chunk's MMAs and the last tile's conv1 are done
        store_halo<NTASK, kThreads>(halo, q, (k6::pass_planes(pass) + 2) * HY * HX, tid);
        __syncthreads();
        int next = tile, next_pass = pass, next_chunk = chunk + 1;
        if (next_chunk == nchunks) {
          next_chunk = 0;
          if (++next_pass == 2) next_pass = 0, next += gridDim.x;
        }
        if (next < n_tiles)
          k6::load_unit(q, vol, plane, next, next_pass, next_chunk, tiles_x, tiles_y, D, h, w, pairs, tid);
        mma_chunk<MT, 1, false>(acc, halo_s, row, wfrag + chunk * KSTEPS * 32, HY * HX * 16, HX * 16, lane, valid);
      }
      // conv0 into the shared tile: bias, ReLU, bf16; out of the volume it
      // is conv1's zero padding (low side) or unread (high side: D, h, w even)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j >= valid) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (warp + j * kWarps) * 16 + lane / 4 + 8 * half;
          if (p >= nvox) continue;
          const int i = pass * PZ * RY * RX + p;  // region index
          const int d = dz0 + i / (RY * RX), y = yy0 + (i / RX) % RY, x = xx0 + i % RX;
          const bool inside = d >= 0 && d < D && y >= 0 && y < h && x >= 0 && x < w;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tile0[(2 * (lane % 4) + e) * R + i] = inside ? finish(acc[j][0][2 * half + e], bv[e]) : f2bf(0.f);
        }
      }
    }
    __syncthreads();

    k6::store_out0(out0, tile0, dz0, yy0, xx0, D, h, w, tid, kThreads);
    k6::conv1_phase(out1, tile0, wfrag1, b1, d1_0, y1_0, x1_0, D, h, w, warp, lane);
  }
}

static int launch_mma(const void* vol, const void* w0, const void* b0, const void* w1, const void* b1, void* out0,
                      void* out1, int C, int D, int h, int w, void* stream) {
  constexpr int kMaxC = 64 * conv_mma::CH;
  if (D % 2 || h % 2 || w % 2 || C % conv_mma::CH || C > kMaxC) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(C / conv_mma::CH) * conv_mma::KSTEPS * 32 + k6::HV + conv_mma::TAPS * 2 * 32) *
                          sizeof(uint4) + (size_t)O0 * k6::R * sizeof(bf16);
  if (smem > (size_t)k6::kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t opt_in =  // once, not per launch
      cudaFuncSetAttribute(conv3d_fused_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k6::kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  static int occupancy[64 + 1] = {};
  const int limit = conv_mma::resident_grid(conv3d_fused_mma_kernel, k6::kThreads, smem, C, occupancy);
  if (limit == 0) return (int)cudaErrorInvalidConfiguration;
  const int tiles_x = (w / 2 + k6::TX - 1) / k6::TX, tiles_y = (h / 2 + k6::TY - 1) / k6::TY;
  const int n_tiles = tiles_x * tiles_y * ((D / 2 + k6::TD - 1) / k6::TD);
  const int grid = n_tiles < limit ? n_tiles : limit;
  conv3d_fused_mma_kernel<<<grid, k6::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(vol), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<bf16*>(out0),
      static_cast<bf16*>(out1), C, D, h, w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

// K6 in fp32. The tile is K6-bf16's (2 x 4 x 16 conv1 outputs, a conv0
// region of RZ x RY x RX = 5 x 9 x 33 voxels), in one pass: every chunk
// stages the whole input halo, 7 x 11 x 35 voxels of 32 bytes, as two
// half-halos (channels 0-3, channels 4-7) of 16 bytes a voxel, so that an
// ldmatrix phase's 8 consecutive voxels meet no bank twice and the address
// of any tap is a row's offset plus a constant. Phase 1 runs K2-fp32's
// arithmetic on it in K2-fp32's walk: a region plane's 297 voxels,
// flattened, are 19 M-tiles of 16 rows, and column p stacks M-tile p of the
// 5 planes along z; per chunk and (ky, kx), one A fragment of halo plane
// hz, split once, feeds the M-tiles hz - kd of the three depth taps, and
// each sum runs (ky, kx) by (ky, kx), kd ascending, the three TF32 products
// a tap (conv3d_tf32.cuh), so out0 equals K2-fp32's output bit for bit.
// 12 warps take the 19 columns, one or two a warp, at most 5 on an SM
// sub-partition (10 warps put 6 on one and ran 5-10 % slower; 20 warps of
// one column spilled 216 bytes at 96 registers). Phase 2 is K6-bf16's conv1 on an
// fp32 conv0 tile (8 of the 12 warps). The halo of the next (tile, chunk)
// is loaded into registers (8 voxels a thread) during the current MMAs.
// Shared memory at C = 32: the conv0 fragments 54 KB, the halo 84.2 KB,
// conv1's fragments 27 KB, the conv0 tile 46.4 KB: 211.6 KB, one resident
// block an SM. C is at most 40.
namespace k6f {
using k6::TD; using k6::TY; using k6::TX; using k6::RZ; using k6::RY; using k6::RX; using k6::R;
constexpr int kThreads = 384, kWarps = kThreads / 32;
constexpr int HZ = RZ + 2, HY = RY + 2, HX = RX + 2;  // from 2*d1_0 - 2, 2*y1_0 - 2, 2*x1_0 - 2
constexpr int HV = HZ * HY * HX;                      // 2695 voxels
constexpr int HALF = HV * 16;                         // bytes of a half-halo
constexpr int PLANE = RY * RX;                        // 297 voxels of a region plane
constexpr int COLS = (PLANE + 15) / 16;               // 19 columns of RZ M-tiles
constexpr int CW = (COLS + kWarps - 1) / kWarps;      // 2 columns a warp at most
constexpr int NTASK = (HV + kThreads - 1) / kThreads;  // 8 halo voxels a thread
constexpr int kMaxSmem = 227 * 1024;
static_assert(kWarps >= TD * TY, "conv1 takes 8 warps");

// Channels c0 .. c0+7 (zeros past C) of halo voxels v = i*kThreads + tid of
// the tile at conv1 origin (d1_0, y1_0, x1_0), zeros outside the volume.
__device__ __forceinline__ void load_halo(float (&q)[NTASK][8], const float* __restrict__ vol, size_t plane, int tile,
                                          int chunk, int C, int tiles_x, int tiles_y, int D, int h, int w, int tid) {
  int d1_0, y1_0, x1_0;
  k6::tile_origin(tile, tiles_x, tiles_y, d1_0, y1_0, x1_0);
  const int c0 = chunk * tf32::CH;
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    const int v = i * kThreads + tid;
    const int z = 2 * d1_0 - 2 + v / (HX * HY), y = 2 * y1_0 - 2 + (v / HX) % HY, x = 2 * x1_0 - 2 + v % HX;
    const bool in = v < HV && z >= 0 && z < D && y >= 0 && y < h && x >= 0 && x < w;
    const float* p = vol + (in ? (size_t)c0 * plane + ((size_t)z * h + y) * w + x : 0);
#pragma unroll
    for (int c = 0; c < 8; ++c) q[i][c] = in && c0 + c < C ? __ldg(p + c * plane) : 0.f;
  }
}

__device__ __forceinline__ void store_halo(char* halo, const float (&q)[NTASK][8], int tid) {
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    const int v = i * kThreads + tid;
    if (v < HV) {
      *reinterpret_cast<float4*>(halo + v * 16) = make_float4(q[i][0], q[i][1], q[i][2], q[i][3]);
      *reinterpret_cast<float4*>(halo + HALF + v * 16) = make_float4(q[i][4], q[i][5], q[i][6], q[i][7]);
    }
  }
}
}  // namespace k6f

__global__ void __launch_bounds__(k6f::kThreads, 1) conv3d_fused_tf32_kernel(
    const float* __restrict__ vol,  // (C, D, h, w)
    const float* __restrict__ w0,   // (O0, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ b0,   // (O0,)
    const float* __restrict__ w1,   // (O1, O0, 3, 3, 3), eval BN folded in
    const float* __restrict__ b1,   // (O1,)
    float* __restrict__ out0,       // (O0, D, h, w)
    float* __restrict__ out1,       // (O1, D/2, h/2, w/2)
    int C, int D, int h, int w, int tiles_x, int tiles_y, int n_tiles) {
  using namespace k6f;
  constexpr int TAPS = tf32::TAPS;
  extern __shared__ uint4 smem16[];  // 16-byte aligned
  const int nchunks = (C + tf32::CH - 1) / tf32::CH;
  uint4* wfrag0 = smem16;
  uint4* wfrag1 = wfrag0 + nchunks * TAPS * 32;
  char* halo = reinterpret_cast<char*>(wfrag1 + TAPS * 2 * 32);
  float* tile0 = reinterpret_cast<float*>(halo + 2 * HALF);  // [o0][R]: conv0, 0 outside the volume
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  tf32::stage_weights<1>(wfrag0, w0, C, nchunks, tid, kThreads);
  tf32::stage_weights<2>(wfrag1, w1, O0, 1, tid, kThreads);

  float bv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) bv[e] = __ldg(b0 + 2 * (lane % 4) + e);
  // column c of this warp: M-tile p = warp + c*kWarps of each region plane;
  // row[c]: byte offset of this lane's ldmatrix row (plane voxel p*16 +
  // mrow, channels 4·half ..) at tap (0, 0, 0) of plane 0
  const int mrow = conv_mma::ldmatrix_row(lane), half = lane >> 4;
  const int ncols = (COLS - warp + kWarps - 1) / kWarps;
  uint32_t row[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    int pq = (warp + c * kWarps) * 16 + mrow;
    if (pq >= PLANE) pq = 0;  // past the plane: computed, never stored
    row[c] = half * HALF + ((pq / RX) * HX + pq % RX) * 16;
  }
  const size_t plane = (size_t)D * h * w;
  const uint32_t halo_s = conv_mma::smem_addr(halo);
  float acc[CW][RZ][4];
  float q[NTASK][8];
  load_halo(q, vol, plane, blockIdx.x, 0, C, tiles_x, tiles_y, D, h, w, tid);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int d1_0, y1_0, x1_0;
    k6::tile_origin(tile, tiles_x, tiles_y, d1_0, y1_0, x1_0);
    const int dz0 = 2 * d1_0 - 1, yy0 = 2 * y1_0 - 1, xx0 = 2 * x1_0 - 1;  // conv0 index of region-local 0

    // Phase 1: conv0 of the region, chunk by chunk, as K2-fp32 computes it
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int m = 0; m < RZ; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[c][m][k] = 0.f;
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      __syncthreads();  // the last chunk's MMAs and the last tile's conv1 are done
      store_halo(halo, q, tid);
      __syncthreads();
      int next = tile, next_chunk = chunk + 1;
      if (next_chunk == nchunks) next += gridDim.x, next_chunk = 0;
      if (next < n_tiles) load_halo(q, vol, plane, next, next_chunk, C, tiles_x, tiles_y, D, h, w, tid);
      const uint4* wf = wfrag0 + chunk * TAPS * 32;
#pragma unroll 1
      for (int s = 0; s < 9; ++s) {  // (ky, kx); then the planes hz and kd = hz - m: K2-fp32's order
        const int ky = s / 3, kx = s % 3;
        uint4 b[3];
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) b[kd] = wf[(kd * 9 + s) * 32 + lane];
        const uint32_t toff = halo_s + (ky * HX + kx) * 16;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (c >= ncols) break;
#pragma unroll
          for (int hz = 0; hz < HZ; ++hz) {
            uint32_t a[4], hi[4], lo[4];
            conv_mma::ldmatrix_x4(a, toff + row[c] + hz * HY * HX * 16);
#pragma unroll
            for (int k = 0; k < 4; ++k) tf32::split(__uint_as_float(a[k]), hi[k], lo[k]);
#pragma unroll
            for (int kd = 0; kd < 3; ++kd) {
              const int m = hz - kd;
              if (m < 0 || m >= RZ) continue;
              tf32::mma3(acc[c][m], hi, lo, b[kd]);
            }
          }
        }
      }
    }
    // conv0 into the shared tile: bias, ReLU; out of the volume it is
    // conv1's zero padding (low side) or unread (high side: D, h, w even)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      if (c >= ncols) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int pq = (warp + c * kWarps) * 16 + lane / 4 + 8 * hf;  // plane voxel
        if (pq >= PLANE) continue;
        const int y = yy0 + pq / RX, x = xx0 + pq % RX;
#pragma unroll
        for (int m = 0; m < RZ; ++m) {
          const int d = dz0 + m, i = m * PLANE + pq;  // region index
          const bool inside = d >= 0 && d < D && y >= 0 && y < h && x >= 0 && x < w;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tile0[(2 * (lane % 4) + e) * R + i] = inside ? fmaxf(acc[c][m][2 * hf + e] + bv[e], 0.f) : 0.f;
        }
      }
    }
    __syncthreads();

    k6::store_out0(out0, tile0, dz0, yy0, xx0, D, h, w, tid, kThreads);
    k6::conv1_phase(out1, tile0, wfrag1, b1, d1_0, y1_0, x1_0, D, h, w, warp, lane);
  }
}

static size_t tf32_smem(int C) {
  const int nchunks = (C + tf32::CH - 1) / tf32::CH;
  return ((size_t)nchunks * tf32::TAPS * 32 + tf32::TAPS * 2 * 32) * sizeof(uint4) + 2 * (size_t)k6f::HALF +
         (size_t)O0 * k6::R * sizeof(float);
}

// K6-fp32's resident blocks at C channels (0 if the shared memory does not
// fit or a query fails); per_sm: an SM's.
static int tf32_resident(int C, int& per_sm) {
  if (C <= 0 || tf32_smem(C) > (size_t)k6f::kMaxSmem) return 0;
  static const cudaError_t opt_in =  // once, not per launch
      cudaFuncSetAttribute(conv3d_fused_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k6f::kMaxSmem);
  if (opt_in != cudaSuccess) return 0;
  static int occupancy[64 + 1] = {};
  const int chunks8 = (C + tf32::CH - 1) / tf32::CH * tf32::CH;
  const int limit = conv_mma::resident_grid(conv3d_fused_tf32_kernel, k6f::kThreads, tf32_smem(C), chunks8, occupancy);
  per_sm = occupancy[chunks8 / tf32::CH];
  return limit;
}

static int launch_tf32(const void* vol, const void* w0, const void* b0, const void* w1, const void* b1, void* out0,
                       void* out1, int C, int D, int h, int w, void* stream) {
  if (D % 2 || h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const int limit = tf32_resident(C, per_sm);
  if (limit == 0) return (int)cudaErrorInvalidValue;
  const int tiles_x = (w / 2 + k6::TX - 1) / k6::TX, tiles_y = (h / 2 + k6::TY - 1) / k6::TY;
  const int n_tiles = tiles_x * tiles_y * ((D / 2 + k6::TD - 1) / k6::TD);
  if (n_tiles == 0) return 0;
  conv3d_fused_tf32_kernel<<<n_tiles < limit ? n_tiles : limit, k6f::kThreads, tf32_smem(C),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<float*>(out0),
      static_cast<float*>(out1), C, D, h, w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

// K6-fp32's resources at C input channels: out = {registers a thread,
// resident blocks an SM, dynamic shared bytes a block}.
CDS_EXPORT int conv3d_fused_tf32_plan(int C, int* out) {
  int per_sm = 0;
  cudaFuncAttributes attr;
  if (tf32_resident(C, per_sm) == 0 || cudaFuncGetAttributes(&attr, conv3d_fused_tf32_kernel) != cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  out[2] = (int)tf32_smem(C);
  return 0;
}

// fp32 = 1 for an fp32 volume and outputs, 0 for bf16.
CDS_EXPORT int conv3d_front_fused_launch(const void* vol, const void* w0, const void* b0,
                                         const void* w1, const void* b1, void* out0, void* out1,
                                         int fp32, int C, int D, int h, int w, void* stream) {
  return fp32 ? launch_tf32(vol, w0, b0, w1, b1, out0, out1, C, D, h, w, stream)
              : launch_mma(vol, w0, b0, w1, b1, out0, out1, C, D, h, w, stream);
}
