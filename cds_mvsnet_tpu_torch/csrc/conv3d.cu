// K2 and K7: 3x3x3 conv (pad 1, stride 1 for K2, 2 for K7) + bias + ReLU,
// 8 or 16 output channels. Wrappers, plain versions and design note:
// ops/kernels/conv3d.py.
//
// K2 on a bf16 volume runs conv3d_mma_kernel: the tensor-core implicit GEMM
// of conv3d_mma.cuh, which K6's conv0 shares. K2 on an fp32 volume (the fp32
// route) runs conv3d_tf32_kernel, the same GEMM in 3xTF32 on
// mma.sync.m16n8k8 (conv3d_tf32.cuh, which K6-fp32's conv0 shares). The
// stride-2 K7 runs conv3d_down_mma_kernel in bf16, the GEMM of
// conv3d_mma.cuh at stride 2, and conv3d_down_tf32_kernel in fp32, the
// 3xTF32 GEMM at stride 2, whose step K6's conv1 runs in both dtypes.
#include "conv3d_mma.cuh"
#include "conv3d_tf32.cuh"

// K2 in bf16: conv3d_mma.cuh's body over output tiles of MZ x MY x MX
// voxels, each row of 16 along x one M-tile. A block stays resident and
// walks the tiles blockIdx.x, +gridDim.x, ...; its weights are staged once.
// The halo of the next (tile, chunk) is loaded into registers before the
// MMAs of the current one and stored after them, so the loads of one chunk
// overlap the tensor work of the last.
namespace k2 {
constexpr int MZ = 4, MY = 4, MX = 32;
constexpr int HZ = MZ + 2, HY = MY + 2, HX = MX + 4;  // x from x0 - 2: pairs of voxels stay aligned
constexpr int HV = HZ * HY * HX;  // 1296 voxels, 20.3 KB per chunk
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int MT = MZ * MY * (MX / 16) / kWarps;       // 4 M-tiles per warp
constexpr int NTASK = (HV / 2 + kThreads - 1) / kThreads;  // 3 halo voxel pairs per thread
constexpr int kMaxSmem = 100 * 1024;

__device__ __forceinline__ void tile_origin(int tile, int tiles_x, int tiles_y, int& z0, int& y0, int& x0) {
  x0 = (tile % tiles_x) * MX;
  y0 = ((tile / tiles_x) % tiles_y) * MY;
  z0 = (tile / (tiles_x * tiles_y)) * MZ;
}
}  // namespace k2

// NT: output channels / 8.
template <int NT>
__global__ void __launch_bounds__(k2::kThreads, 2) conv3d_mma_kernel(
    const bf16* __restrict__ vol,   // (C, D, h, w), C a multiple of 8
    const float* __restrict__ wt,   // (8*NT, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ bias, // (8*NT,)
    bf16* __restrict__ out,         // (8*NT, D, h, w)
    int C, int D, int h, int w, int tiles_x, int tiles_y, int n_tiles) {
  using namespace conv_mma;
  using namespace k2;
  extern __shared__ uint4 smem[];
  const int nchunks = C / CH;
  uint4* wfrag = smem;
  uint4* halo = smem + nchunks * KSTEPS * NT * 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  stage_weights<NT>(wfrag, wt, C, tid, kThreads);

  // M-tile m = warp*MT + j sits at tile-local (m / (2*MY), (m/2) % MY, (m%2)*16);
  // tile-local x is halo x + 2, and row[] points at the (-1, -1, -1) neighbour
  uint32_t row[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = warp * MT + j;
    row[j] = (((m / (2 * MY)) * HY + (m / 2) % MY) * HX + (m % 2) * 16 + 1 + ldmatrix_row(lane)) * 16;
  }
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nt][e] = __ldg(bias + nt * 8 + 2 * (lane % 4) + e);
  const size_t plane = (size_t)D * h * w, hw = (size_t)h * w;
  const uint32_t halo_s = smem_addr(halo);
  const bool pairs = pair_loads(vol, w);

  int tile = blockIdx.x, z0, y0, x0;
  uint4 q[NTASK][2];
  tile_origin(tile, tiles_x, tiles_y, z0, y0, x0);
  load_halo<NTASK, kThreads, HY, HX>(q, vol, plane, 0, HV, z0 - 1, y0 - 1, x0 - 2, D, h, w, pairs, tid);
  float acc[MT][NT][4];
  for (;;) {
    tile_origin(tile, tiles_x, tiles_y, z0, y0, x0);
    zero(acc);
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      __syncthreads();  // every warp is done with the last chunk (and the weights are staged)
      store_halo<NTASK, kThreads>(halo, q, HV, tid);
      __syncthreads();
      int next = tile, next_chunk = chunk + 1;
      if (next_chunk == nchunks) next += gridDim.x, next_chunk = 0;
      if (next < n_tiles) {
        int nz, ny, nx;
        tile_origin(next, tiles_x, tiles_y, nz, ny, nx);
        load_halo<NTASK, kThreads, HY, HX>(q, vol, plane, next_chunk * CH, HV, nz - 1, ny - 1, nx - 2, D, h, w,
                                           pairs, tid);
      }
      mma_chunk<MT, NT, true>(acc, halo_s, row, wfrag + chunk * KSTEPS * NT * 32, HY * HX * 16, HX * 16, lane);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int m = warp * MT + j;
      const int z = z0 + m / (2 * MY), y = y0 + (m / 2) % MY;
      if (z >= D || y >= h) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = x0 + (m % 2) * 16 + lane / 4 + 8 * half;
        if (x >= w) continue;
        const size_t at = (size_t)z * hw + (size_t)y * w + x;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out[(size_t)(nt * 8 + 2 * (lane % 4) + e) * plane + at] = finish(acc[j][nt][2 * half + e], bv[nt][e]);
      }
    }
    tile += gridDim.x;
    if (tile >= n_tiles) break;
  }
}

template <int NT>
static int launch_mma(const void* vol, const void* wt, const void* bias, void* out, int C, int D, int h, int w,
                      void* stream) {
  using namespace k2;
  constexpr int kMaxC = 64 * conv_mma::CH;
  if (C % conv_mma::CH || C > kMaxC) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(C / conv_mma::CH) * conv_mma::KSTEPS * NT * 32 + HV) * sizeof(uint4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t opt_in =  // once per instantiation, not per launch
      cudaFuncSetAttribute(conv3d_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  static int occupancy[64 + 1] = {};
  const int limit = conv_mma::resident_grid(conv3d_mma_kernel<NT>, kThreads, smem, C, occupancy);
  if (limit == 0) return (int)cudaErrorInvalidConfiguration;
  const int tiles_x = (w + MX - 1) / MX, tiles_y = (h + MY - 1) / MY, tiles_z = (D + MZ - 1) / MZ;
  const int n_tiles = tiles_x * tiles_y * tiles_z;
  conv3d_mma_kernel<NT><<<n_tiles < limit ? n_tiles : limit, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(vol), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<bf16*>(out), C, D, h, w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

// K7 in bf16: conv3d_mma.cuh's implicit GEMM at stride 2 (mma_step_s2: the
// same hi/lo MMAs and order as K2's), over output tiles of MZ x MY x MX
// voxels, each row of 16 along x one M-tile, MT M-tiles a warp. A block
// stays resident and walks the tiles blockIdx.x, +gridDim.x, ...
//
// The input box of a tile and chunk of 8 channels: 2·MZ+1 planes and 2·MY+1
// rows from 2·z0-1 and 2·y0-1, x from 2·x0-2 over 2·MX+2 voxels; zeros
// outside the volume. It is stored channel-innermost, 16 bytes a voxel,
// split by x parity: a row is [parity][x/2][8], PX = MX+1 voxels a parity,
// then 16 bytes of padding. Output x (tile-local ox) reads box x 2·ox+kx+1:
// parity 1 at ox for kx = 0, parity 0 at ox+1 for kx = 1, parity 1 at ox+1
// for kx = 2; so the 8 rows of an ldmatrix (8 consecutive ox) are 8
// consecutive 16-byte rows of one parity sub-row and meet no bank twice,
// where the stride-1 layout would put them 32 bytes apart.
//
// Loads: w a multiple of 8 (every route shape) and a 16-byte aligned
// volume take 16-byte loads, 8 voxels along x of one channel plane; a task
// is one row and one such vector of all 8 channels, transposed 8 x 8 in
// registers (byte_perm) into 8 voxel rows, or the row's left voxel pair
// (four-byte loads; only x = 2·x0-1 is stored). Otherwise two-byte loads,
// one a voxel and channel. A warp's 32 vector tasks are 4 rows x the 8
// vectors of a row (whole 128-byte lines), and a store phase's 8 lanes 4
// rows x 2 neighbouring vectors: with a row of an odd number of 16-byte
// slots their stores meet no bank twice. The box is double buffered: a
// thread's tasks of the next (tile, chunk) are loaded one at a time, each
// before a share of the current MMAs and stored into the other buffer
// after them (32 registers in flight, not a whole box's), one barrier a
// step. A tile's outputs leave through the box just read (a second
// barrier): a warp writes its two M-tiles as [16 channels][32 x] rows and
// stores them as 16-byte vectors, 64 contiguous bytes a channel, where the
// fragment layout alone would store 16-byte pieces (5 % of the time).
namespace k7 {
constexpr int kThreads = 256, kWarps = kThreads / 32;
struct T {
  static constexpr int MZ = 2, MY = 4, MX = 32;
  static constexpr int HZ = 2 * MZ + 1, HY = 2 * MY + 1, ROWS = HZ * HY;
  static constexpr int PX = MX + 1;                 // voxels of a parity sub-row
  static constexpr int RS = (2 * PX + 1) * 16;      // bytes a row: an odd number of 16-byte slots
  static constexpr int HALO = ROWS * RS;            // bytes of one buffer
  static constexpr int MTILES = MZ * MY * (MX / 16);
  static constexpr int MT = MTILES / kWarps;        // M-tiles a warp
  static constexpr int VECS = MX / 4;               // 16-byte vectors a row: x 2·x0 .. 2·x0+2·MX-1
  static constexpr int NVEC = (ROWS + 3) / 4 * 32;  // vector task slots, 4 rows a warp; then ROWS left pairs
  static constexpr int NTASK = (NVEC + ROWS + kThreads - 1) / kThreads;
  static_assert(MTILES % kWarps == 0 && VECS == 8, "whole M-tiles a warp, 8 vectors a row");
  static_assert(MT <= 2, "a warp's M-tiles share z and y, so the inside ones come first");
  static_assert(conv_mma::KSTEPS % NTASK == 0, "the K-steps split evenly between a thread's tasks");
};
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void tile_origin(int tile, int tiles_x, int tiles_y, int& z0, int& y0, int& x0) {
  x0 = (tile % tiles_x) * T::MX;
  y0 = ((tile / tiles_x) % tiles_y) * T::MY;
  z0 = (tile / (tiles_x * tiles_y)) * T::MZ;
}

// Word i of a 16-byte vector.
__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Channel pairs of voxel `odd` (0 or 1) of eight two-voxel words, one a
// channel: a 16-byte voxel row.
__device__ __forceinline__ uint4 voxel_row(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3, uint32_t c4,
                                           uint32_t c5, uint32_t c6, uint32_t c7, bool odd) {
  const uint32_t sel = odd ? 0x7632 : 0x5410;
  return make_uint4(__byte_perm(c0, c1, sel), __byte_perm(c2, c3, sel), __byte_perm(c4, c5, sel),
                    __byte_perm(c6, c7, sel));
}

// Two-byte loads of channels c0 .. c0+7 of n voxels from x, zeros outside
// the volume, packed as 16-byte loads would give them (voxel pairs a word).
__device__ __forceinline__ void load_scalar(uint4 (&q)[8], const bf16* __restrict__ vol, size_t plane, int c0,
                                            size_t at, int x, int n, int w) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(vol) + (size_t)c0 * plane + at;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < n && x + k >= 0 && x + k < w) word[k / 2] |= (uint32_t)__ldg(p + c * plane + k) << (16 * (k % 2));
    q[c] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// Task slot v's row and first box x (a vector: 2 + 8·j; a left pair: 0);
// false for a slot without a task.
__device__ __forceinline__ bool task(int v, int& row, int& hx) {
  if (v < T::NVEC) {
    const int l = v % 32;
    row = v / 32 * 4 + (l % 8) / 2;
    hx = 2 + 8 * (2 * (l / 8) + l % 2);
  } else {
    row = v - T::NVEC;
    hx = 0;
  }
  return row < T::ROWS;
}

// Task slot v of the chunk at channel c0 of the tile at output origin
// (z0, y0, x0), into q (channel c's words in q[c]).
__device__ __forceinline__ void load_task(uint4 (&q)[8], int v, const bf16* __restrict__ vol, size_t plane, int c0,
                                          int z0, int y0, int x0, int D, int h, int w, bool vec) {
#pragma unroll
  for (int c = 0; c < 8; ++c) q[c] = make_uint4(0, 0, 0, 0);
  int row, hx;
  if (!task(v, row, hx)) return;
  const int z = 2 * z0 - 1 + row / T::HY, y = 2 * y0 - 1 + row % T::HY, x = 2 * x0 - 2 + hx;
  if (z < 0 || z >= D || y < 0 || y >= h) return;
  const size_t at = ((size_t)z * h + y) * w + x;
  if (!vec) {
    load_scalar(q, vol, plane, c0, at, x, hx ? 8 : 2, w);
  } else if (hx == 0) {  // the left pair: x even, so both voxels are in or out
    if (x < 0) return;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(vol + (size_t)c0 * plane + at);
#pragma unroll
    for (int c = 0; c < 8; ++c) q[c].x = __ldg(p + c * (plane / 2));
  } else if (x < w) {  // x and w multiples of 8: the vector is in or out whole
    const uint4* p = reinterpret_cast<const uint4*>(vol + (size_t)c0 * plane + at);
#pragma unroll
    for (int c = 0; c < 8; ++c) q[c] = __ldg(p + c * (plane / 8));
  }
}

// Task slot v's voxel rows into the box at `box`.
__device__ __forceinline__ void store_task(char* box, const uint4 (&a)[8], int v) {
  int row, hx;
  if (!task(v, row, hx)) return;
  char* r = box + row * T::RS;
  if (hx == 0) {  // box x 1 (parity 1, slot 0); box x 0 is never read
    *reinterpret_cast<uint4*>(r + T::PX * 16) =
        voxel_row(a[0].x, a[1].x, a[2].x, a[3].x, a[4].x, a[5].x, a[6].x, a[7].x, true);
    return;
  }
  const int slot = hx / 2;  // box x hx + k: parity k % 2, slot hx/2 + k/2
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<uint4*>(r + ((k % 2) * T::PX + slot + k / 2) * 16) =
        voxel_row(word(a[0], k / 2), word(a[1], k / 2), word(a[2], k / 2), word(a[3], k / 2), word(a[4], k / 2),
                  word(a[5], k / 2), word(a[6], k / 2), word(a[7], k / 2), k % 2);
}
}  // namespace k7

// NT: output channels / 8.
template <int NT>
__global__ void __launch_bounds__(k7::kThreads, 2) conv3d_down_mma_kernel(
    const bf16* __restrict__ vol,   // (C, D, h, w), C a multiple of 8
    const float* __restrict__ wt,   // (8*NT, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ bias, // (8*NT,)
    bf16* __restrict__ out,         // (8*NT, Do, ho, wo)
    int C, int D, int h, int w, int tiles_x, int tiles_y, int n_tiles) {
  using namespace conv_mma;
  using k7::T;
  extern __shared__ uint4 smem[];
  const int nchunks = C / CH;
  uint4* wfrag = smem;
  char* box = reinterpret_cast<char*>(smem + nchunks * KSTEPS * NT * 32);  // two buffers of T::HALO bytes
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  stage_weights<NT>(wfrag, wt, C, tid, k7::kThreads);

  // the warp's M-tiles m = warp*MT + j: output (m / (2*MY), (m/2) % MY,
  // (m%2)*16) of the tile; row[j]: byte offset of this lane's ldmatrix row
  // at tap (0, 0, parity 0), box plane 2·mz, row 2·my, slot ox
  uint32_t row[T::MT];
  int mz[T::MT], my[T::MT], mx[T::MT];
#pragma unroll
  for (int j = 0; j < T::MT; ++j) {
    const int m = warp * T::MT + j;
    mz[j] = m / (2 * T::MY), my[j] = (m / 2) % T::MY, mx[j] = (m % 2) * 16;
    row[j] = (2 * mz[j] * T::HY + 2 * my[j]) * T::RS + (mx[j] + ldmatrix_row(lane)) * 16;
  }
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nt][e] = __ldg(bias + nt * 8 + 2 * (lane % 4) + e);
  const int Do = (D - 1) / 2 + 1, ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const size_t plane = (size_t)D * h * w, plane_o = (size_t)Do * ho * wo, hwo = (size_t)ho * wo;
  const bool vec = w % 8 == 0 && (reinterpret_cast<uintptr_t>(vol) & 15) == 0;
  const bool vec_out = wo % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  int tile = blockIdx.x, chunk = 0, z0, y0, x0;
  k7::tile_origin(tile, tiles_x, tiles_y, z0, y0, x0);
#pragma unroll
  for (int i = 0; i < T::NTASK; ++i) {
    uint4 q[8];
    k7::load_task(q, i * k7::kThreads + tid, vol, plane, 0, z0, y0, x0, D, h, w, vec);
    k7::store_task(box, q, i * k7::kThreads + tid);
  }
  __syncthreads();  // the weights and the first box are staged
  float acc[T::MT][NT][4];
  zero(acc);
  for (int cur = 0;; cur ^= 1) {
    int next = tile, next_chunk = chunk + 1, nz = 0, ny = 0, nx = 0;
    if (next_chunk == nchunks) next += gridDim.x, next_chunk = 0;
    const bool more = next < n_tiles;
    if (more) k7::tile_origin(next, tiles_x, tiles_y, nz, ny, nx);
    // M-tiles of this warp inside the output: warp-uniform, the x-halves last
    int valid = 0;
#pragma unroll
    for (int j = 0; j < T::MT; ++j) valid += z0 + mz[j] < Do && y0 + my[j] < ho && x0 + mx[j] < wo;
    const uint32_t box_s = smem_addr(box + cur * T::HALO);
    const uint4* wf = wfrag + chunk * KSTEPS * NT * 32;
    char* next_box = box + (cur ^ 1) * T::HALO;
#pragma unroll
    for (int i = 0; i < T::NTASK; ++i) {  // task i of the next box in flight during a share of the K-steps
      uint4 q[8];
      if (more) k7::load_task(q, i * k7::kThreads + tid, vol, plane, next_chunk * CH, nz, ny, nx, D, h, w, vec);
#ifndef CDS_K7_LOADS_ONLY  // tools/time_conv3d.py --loads-only: the loads and stores alone
#pragma unroll
      for (int s = i * KSTEPS / T::NTASK; s < (i + 1) * KSTEPS / T::NTASK; ++s)
        mma_step_s2<T::MT, NT>(s, acc, box_s, row, wf, T::HY * T::RS, T::RS, T::PX * 16, lane, valid);
#endif
      if (more) k7::store_task(next_box, q, i * k7::kThreads + tid);
    }
    if (chunk == nchunks - 1) {
      // the tile's outputs through this warp's 1280 bytes of the box just
      // read: [16 channels][80-byte row of its 32 x], then 16-byte stores
      // (the 16-byte padding of a row spreads a phase's lanes over the banks)
      __syncthreads();  // every warp is done with this box
      char* stage = box + cur * T::HALO + warp * (16 * 80);
#pragma unroll
      for (int j = 0; j < T::MT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<bf16*>(stage + (nt * 8 + 2 * (lane % 4) + e) * 80 +
                                       (mx[j] + lane / 4 + 8 * half) * 2) = finish(acc[j][nt][2 * half + e], bv[nt][e]);
      __syncwarp();
      const int z = z0 + mz[0], y = y0 + my[0];
      if (z < Do && y < ho) {
#pragma unroll
        for (int k = 0; k < NT; ++k) {  // 8·NT channels x 4 vectors: NT a lane
          const int v = lane + 32 * k, ch = v / 4, x = x0 + 8 * (v % 4);
          const uint4 q = *reinterpret_cast<const uint4*>(stage + ch * 80 + (v % 4) * 16);
          bf16* dst = out + (size_t)ch * plane_o + (size_t)z * hwo + (size_t)y * wo + x;
          if (vec_out && x + 8 <= wo) {
            *reinterpret_cast<uint4*>(dst) = q;
          } else {
            const bf16* e8 = reinterpret_cast<const bf16*>(&q);
#pragma unroll
            for (int t = 0; t < 8; ++t)
              if (x + t < wo) dst[t] = e8[t];
          }
        }
      }
      zero(acc);
    }
    if (!more) break;
    __syncthreads();  // the next box is stored; every warp is done with this one
    tile = next, chunk = next_chunk, z0 = nz, y0 = ny, x0 = nx;
  }
}

template <int NT>
static size_t down_smem(int C) {
  return (size_t)(C / conv_mma::CH) * conv_mma::KSTEPS * NT * 32 * sizeof(uint4) + 2 * (size_t)k7::T::HALO;
}

// The card's resident blocks of conv3d_down_mma_kernel<NT> at C channels (0
// if C is no multiple of 8, the shared memory does not fit or a query
// fails); per_sm: an SM's.
template <int NT>
static int down_resident(int C, int& per_sm) {
  constexpr int kMaxC = 64 * conv_mma::CH;
  if (C % conv_mma::CH || C <= 0 || C > kMaxC || down_smem<NT>(C) > (size_t)k7::kMaxSmem) return 0;
  static const cudaError_t opt_in =  // once per instantiation, not per launch
      cudaFuncSetAttribute(conv3d_down_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, k7::kMaxSmem);
  if (opt_in != cudaSuccess) return 0;
  static int occupancy[64 + 1] = {};
  const int limit = conv_mma::resident_grid(conv3d_down_mma_kernel<NT>, k7::kThreads, down_smem<NT>(C), C, occupancy);
  per_sm = occupancy[C / conv_mma::CH];
  return limit;
}

static void down_tiles(int D, int h, int w, int& tiles_x, int& tiles_y, int& n_tiles) {
  using k7::T;
  const int Do = (D - 1) / 2 + 1, ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  tiles_x = (wo + T::MX - 1) / T::MX, tiles_y = (ho + T::MY - 1) / T::MY;
  n_tiles = tiles_x * tiles_y * ((Do + T::MZ - 1) / T::MZ);
}

template <int NT>
static int launch_down_mma(const void* vol, const void* wt, const void* bias, void* out, int C, int D, int h, int w,
                           void* stream) {
  int per_sm = 0;
  const int limit = down_resident<NT>(C, per_sm);
  if (limit == 0) return (int)cudaErrorInvalidValue;
  int tiles_x, tiles_y, n_tiles;
  down_tiles(D, h, w, tiles_x, tiles_y, n_tiles);
  if (D <= 0 || h <= 0 || w <= 0) return 0;
  conv3d_down_mma_kernel<NT><<<n_tiles < limit ? n_tiles : limit, k7::kThreads, down_smem<NT>(C),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(vol), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<bf16*>(out), C, D, h, w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

// K7-bf16's launch plan at O output and C input channels and input D x h x
// w, as conv3d_down_launch makes it: out = {tile z, y, x (output voxels),
// tiles, blocks, registers a thread, resident blocks an SM, dynamic shared
// bytes a block}.
CDS_EXPORT int conv3d_down_plan(int O, int C, int D, int h, int w, int* out) {
  if (O != 8 && O != 16) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaFuncAttributes attr;
  const int limit = O == 8 ? down_resident<1>(C, per_sm) : down_resident<2>(C, per_sm);
  if (limit == 0 ||
      cudaFuncGetAttributes(&attr, O == 8 ? conv3d_down_mma_kernel<1> : conv3d_down_mma_kernel<2>) != cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  int tiles_x, tiles_y, n_tiles;
  down_tiles(D, h, w, tiles_x, tiles_y, n_tiles);
  out[0] = k7::T::MZ; out[1] = k7::T::MY; out[2] = k7::T::MX;
  out[3] = n_tiles; out[4] = n_tiles < limit ? n_tiles : limit;
  out[5] = attr.numRegs; out[6] = per_sm;
  out[7] = (int)(O == 8 ? down_smem<1>(C) : down_smem<2>(C));
  return 0;
}

// K2 in fp32: the implicit GEMM (M = output voxels, N = O, K = 27·C) on
// mma.sync.m16n8k8 with TF32 inputs, as three products into one fp32 sum:
// each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna's rounding: 10 mantissa bits, ties away from zero), and a K-step
// runs hi·hi, hi·lo and lo·hi (conv3d_tf32.cuh, shared with K7-fp32 and
// K6). The dropped lo·lo and the roundings of lo leave about 2^-21 of each
// |term|, far inside the fp32 route's tolerance of 1e-5 of the sum of
// |terms| (tests/test_torch_conv3d_tf32.py models it); one TF32 product
// alone, or hi·hi + hi·lo, misses it.
//
// The tiling is K2-bf16's (k2 above): a resident block of 8 warps walks
// 4x4x32 output tiles; the halo of 8 channels (a chunk, zeros past C) is
// loaded into registers before the MMAs of the last chunk and stored after
// them, channel-innermost, 32 bytes a voxel, its two 16-byte halves swapped
// where bit 2 of the halo x is set, so that the eight rows of an ldmatrix
// (consecutive x) cover the 32 banks once. ldmatrix.x4 reads a 16-voxel x
// 8-channel fp32 A fragment as four 8x8 b16 matrices, which is exactly the
// m16n8k8 TF32 layout. The weights are split hi/lo as they are staged, once
// a block. A warp owns one (y, 16-x) column of 4 M-tiles stacked along z:
// the input rows of plane hz feed the M-tiles hz - kd of the depth taps kd,
// so each A fragment is loaded and split once for up to three taps.
namespace k2f {
using k2::MZ; using k2::MY; using k2::MX; using k2::kThreads;
constexpr int HZ = MZ + 2, HY = MY + 2, HX = MX + 2;  // x from x0 - 1
constexpr int HV = HZ * HY * HX;                      // 1224 voxels, 39 KB a chunk
constexpr int NTASK = (HV + kThreads - 1) / kThreads;  // 5 halo voxels a thread
constexpr int kMaxSmem = 227 * 1024;

// Channels c0 .. c0+7 (zeros past C) of halo voxels v = i*kThreads + tid of
// the box at (z0, y0, x0), zeros outside the volume.
__device__ __forceinline__ void load_halo(float (&q)[NTASK][8], const float* __restrict__ vol, size_t plane, int c0,
                                          int C, int z0, int y0, int x0, int D, int h, int w, int tid) {
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    const int v = i * kThreads + tid;
    const int hx = v % HX, hy = (v / HX) % HY, hz = v / (HX * HY);
    const int z = z0 + hz, y = y0 + hy, x = x0 + hx;
    const bool in = v < HV && z >= 0 && z < D && y >= 0 && y < h && x >= 0 && x < w;
    const float* p = vol + (in ? (size_t)c0 * plane + ((size_t)z * h + y) * w + x : 0);
#pragma unroll
    for (int c = 0; c < 8; ++c) q[i][c] = in && c0 + c < C ? __ldg(p + c * plane) : 0.f;
  }
}

// Voxel v's channels 0-3 go to half s = bit 2 of its halo x, 4-7 to 1 - s.
__device__ __forceinline__ void store_halo(float4* halo, const float (&q)[NTASK][8], int tid) {
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    const int v = i * kThreads + tid;
    if (v < HV) {
      const int s = ((v % HX) >> 2) & 1;
      halo[2 * v + s] = make_float4(q[i][0], q[i][1], q[i][2], q[i][3]);
      halo[2 * v + (s ^ 1)] = make_float4(q[i][4], q[i][5], q[i][6], q[i][7]);
    }
  }
}

// One chunk: for each (ky, kx), the B fragments of the three depth taps,
// then per input plane hz one A fragment, split, into the M-tiles hz - kd.
// lane_off[kx]: byte offset in the halo of this lane's ldmatrix row at plane
// 0, row ky = 0 and tap kx.
template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[MZ][NT][4], uint32_t halo, const uint32_t (&lane_off)[3],
                                          const uint4* wfrag, int lane) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint4 b[3][NT];
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[kd][nt] = wfrag[((kd * 9 + ky * 3 + kx) * NT + nt) * 32 + lane];
#pragma unroll
      for (int hz = 0; hz < HZ; ++hz) {
        uint32_t a[4], hi[4], lo[4];
        conv_mma::ldmatrix_x4(a, halo + lane_off[kx] + (hz * HY + ky) * HX * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32::split(__uint_as_float(a[j]), hi[j], lo[j]);
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const int m = hz - kd;
          if (m < 0 || m >= MZ) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) tf32::mma3(acc[m][nt], hi, lo, b[kd][nt]);
        }
      }
    }
  }
}
}  // namespace k2f

// NT: output channels / 8. Two resident blocks an SM at O = 8.
template <int NT>
__global__ void __launch_bounds__(k2::kThreads, NT == 1 ? 2 : 1) conv3d_tf32_kernel(
    const float* __restrict__ vol,  // (C, D, h, w)
    const float* __restrict__ wt,   // (8*NT, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ bias, // (8*NT,)
    float* __restrict__ out,        // (8*NT, D, h, w)
    int C, int D, int h, int w, int tiles_x, int tiles_y, int n_tiles) {
  using namespace k2f;
  extern __shared__ uint4 smem[];
  const int nchunks = (C + conv_mma::CH - 1) / conv_mma::CH;
  uint4* wfrag = smem;
  float4* halo = reinterpret_cast<float4*>(smem + nchunks * conv_mma::TAPS * NT * 32);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  tf32::stage_weights<NT>(wfrag, wt, C, nchunks, tid, kThreads);

  // warp -> output row y = warp / 2, x from (warp % 2) * 16, M-tiles z = 0..3;
  // lane -> ldmatrix matrix lane / 8: rows (lane % 8) + 8 * (matrix & 1),
  // channels 4 * (matrix >> 1) .. + 3
  const int wy = warp / 2, wx = (warp % 2) * 16;
  const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
  uint32_t lane_off[3];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    const int hx = wx + mrow + kx;
    lane_off[kx] = (wy * HX + hx) * 32 + 16 * (half ^ ((hx >> 2) & 1));
  }
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nt][e] = __ldg(bias + nt * 8 + 2 * (lane % 4) + e);
  const size_t plane = (size_t)D * h * w, hw = (size_t)h * w;
  const uint32_t halo_s = conv_mma::smem_addr(halo);

  int tile = blockIdx.x, z0, y0, x0;
  float q[NTASK][8];
  k2::tile_origin(tile, tiles_x, tiles_y, z0, y0, x0);
  load_halo(q, vol, plane, 0, C, z0 - 1, y0 - 1, x0 - 1, D, h, w, tid);
  float acc[MZ][NT][4];
  for (;;) {
    k2::tile_origin(tile, tiles_x, tiles_y, z0, y0, x0);
    conv_mma::zero(acc);
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      __syncthreads();  // every warp is done with the last chunk (and the weights are staged)
      store_halo(halo, q, tid);
      __syncthreads();
      int next = tile, next_chunk = chunk + 1;
      if (next_chunk == nchunks) next += gridDim.x, next_chunk = 0;
      if (next < n_tiles) {
        int nz, ny, nx;
        k2::tile_origin(next, tiles_x, tiles_y, nz, ny, nx);
        load_halo(q, vol, plane, next_chunk * conv_mma::CH, C, nz - 1, ny - 1, nx - 1, D, h, w, tid);
      }
      mma_chunk<NT>(acc, halo_s, lane_off, wfrag + chunk * conv_mma::TAPS * NT * 32, lane);
    }
    const int y = y0 + wy;
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
      const int z = z0 + m;
      if (z >= D || y >= h) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int x = x0 + wx + lane / 4 + 8 * hf;
        if (x >= w) continue;
        const size_t at = (size_t)z * hw + (size_t)y * w + x;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out[(size_t)(nt * 8 + 2 * (lane % 4) + e) * plane + at] = fmaxf(acc[m][nt][2 * hf + e] + bv[nt][e], 0.f);
      }
    }
    tile += gridDim.x;
    if (tile >= n_tiles) break;
  }
}

template <int NT>
static size_t tf32_smem(int C) {
  const int nchunks = (C + conv_mma::CH - 1) / conv_mma::CH;
  return (size_t)nchunks * conv_mma::TAPS * NT * 32 * sizeof(uint4) + (size_t)k2f::HV * 32;
}

// The card's resident blocks of conv3d_tf32_kernel<NT> at C channels (0 if
// the shared memory does not fit or a query fails); per_sm: an SM's.
template <int NT>
static int tf32_resident(int C, int& per_sm) {
  const size_t smem = tf32_smem<NT>(C);
  if (smem > (size_t)k2f::kMaxSmem) return 0;
  static const cudaError_t opt_in =  // once per instantiation, not per launch
      cudaFuncSetAttribute(conv3d_tf32_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, k2f::kMaxSmem);
  if (opt_in != cudaSuccess) return 0;
  static int occupancy[64 + 1] = {};
  const int chunks8 = (C + conv_mma::CH - 1) / conv_mma::CH * conv_mma::CH;
  if (chunks8 > 64 * conv_mma::CH) return 0;
  const int limit = conv_mma::resident_grid(conv3d_tf32_kernel<NT>, k2::kThreads, smem, chunks8, occupancy);
  per_sm = occupancy[chunks8 / conv_mma::CH];
  return limit;
}

template <int NT>
static int launch_tf32(const void* vol, const void* wt, const void* bias, void* out, int C, int D, int h, int w,
                       void* stream) {
  using namespace k2;
  int per_sm = 0;
  const int limit = tf32_resident<NT>(C, per_sm);
  if (limit == 0) return (int)cudaErrorInvalidConfiguration;
  const int tiles_x = (w + MX - 1) / MX, tiles_y = (h + MY - 1) / MY, tiles_z = (D + MZ - 1) / MZ;
  const int n_tiles = tiles_x * tiles_y * tiles_z;
  if (n_tiles == 0) return 0;
  conv3d_tf32_kernel<NT><<<n_tiles < limit ? n_tiles : limit, kThreads, tf32_smem<NT>(C),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<float*>(out), C, D, h, w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

// K2-fp32's resources at O output and C input channels: out = {registers a
// thread, resident blocks an SM, dynamic shared bytes a block}.
CDS_EXPORT int conv3d_tf32_plan(int O, int C, int* out) {
  if (O != 8 && O != 16) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaFuncAttributes attr;
  const int limit = O == 8 ? tf32_resident<1>(C, per_sm) : tf32_resident<2>(C, per_sm);
  if (limit == 0 ||
      cudaFuncGetAttributes(&attr, O == 8 ? conv3d_tf32_kernel<1> : conv3d_tf32_kernel<2>) != cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  out[2] = (int)(O == 8 ? tf32_smem<1>(C) : tf32_smem<2>(C));
  return 0;
}

// K7 in fp32: the implicit GEMM at stride 2 in 3xTF32 (down_step of
// conv3d_tf32.cuh: K2-fp32's products and order), over K7-bf16's output
// tiles of MZ x MY x MX = 2 x 4 x 32 voxels. A block of 8 warps stays
// resident and walks the tiles; a warp owns one (y, 16-x) column of its
// tile, the M-tiles of its output planes stacked along z (2 at MY = 4), so
// that each A fragment of input plane hz is loaded and split once for the
// taps 2m + kd = hz.
//
// The input box of a tile and chunk of 8 channels: 2·MZ+1 planes and 2·MY+1
// rows from 2·z0-1 and 2·y0-1, box x 1 .. 2·MX+1 (input x from 2·x0-2 at
// box x 0), zeros outside the volume and past C; fp32, 32 bytes a voxel,
// stored as two half-boxes (channels 0-3, channels 4-7) of 16 bytes a voxel,
// each row split by x parity as K7-bf16's ([parity][x/2], PX = MX+1 slots a
// parity, padded to an odd number of 16-byte slots a row). Output x ox reads
// box x 2·ox+kx+1: parity 1 at slot ox (kx = 0), parity 0 at ox+1 (kx = 1),
// parity 1 at ox+1 (kx = 2); the 8 rows of an ldmatrix phase are 8
// consecutive 16-byte slots of one half-row and meet no bank twice, and the
// address of any tap is the lane's offset plus a constant.
//
// Loads: w a multiple of 4 (every route shape) and a 16-byte aligned volume
// take 16-byte loads, 4 voxels along x of one channel plane; a task is one
// row and one such vector of all 8 channels (8 loads, 32 registers), or the
// row's left voxel (box x 1). A warp's 32 vector tasks are 2 rows x the 16
// vectors of a row; a store phase's 8 lanes are 2 rows x 4 neighbouring
// vectors, which with a row of an odd number of slots meet no bank twice.
// Otherwise four-byte loads, one a voxel and channel. The box is double
// buffered: a thread's tasks of the next (tile, chunk) are loaded one at a
// time, each before a share of the current (ky, kx) steps and stored into
// the other buffer after them, one barrier a step. The fp32 outputs leave
// from the fragments (8 lanes write 32 contiguous bytes of a channel).
//
// Shared memory: the weight fragments of every chunk (13.5 KB a chunk and
// n-tile) and two boxes of 94.2 KB: one resident block an SM. Where the
// fragments take more than two chunk-n-tiles (C > 8 at O = 16), the tile is
// 2 x 2 x 32 (MY = 2; a warp one M-tile) and a box 52.3 KB.
namespace k7f {
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
template <int MY_>
struct T {
  static constexpr int MZ = 2, MY = MY_, MX = 32;
  static constexpr int HZ = 2 * MZ + 1, HY = 2 * MY + 1, ROWS = HZ * HY;
  static constexpr int PX = MX + 1;                  // slots of a parity sub-row
  static constexpr int RS = (2 * PX + 1) * 16;       // bytes a half-row: an odd number of 16-byte slots
  static constexpr int HALF = ROWS * RS;             // bytes of a half-box
  static constexpr int BOX = 2 * HALF;               // bytes of one buffer
  static constexpr int COLS = MY * (MX / 16);        // warp columns of 16 x
  static constexpr int MZW = MZ * COLS / kWarps;     // M-tiles a warp, stacked along z
  static constexpr int VECS = MX / 2;                // 4-voxel vectors a row: box x 2 .. 2·MX+1
  static constexpr int NVEC = (ROWS + 1) / 2 * 32;   // vector task slots, 2 rows a warp; then ROWS left voxels
  static constexpr int NTASK = (NVEC + ROWS + kThreads - 1) / kThreads;
  static_assert(VECS == 16 && MZW >= 1 && MZ * COLS % kWarps == 0, "2 rows of 16 vectors a warp; whole columns");
};

template <typename G>
__device__ __forceinline__ void tile_origin(int tile, int tiles_x, int tiles_y, int& z0, int& y0, int& x0) {
  x0 = (tile % tiles_x) * G::MX;
  y0 = ((tile / tiles_x) % tiles_y) * G::MY;
  z0 = (tile / (tiles_x * tiles_y)) * G::MZ;
}

// Task slot v's box row and vector j (box x 2 + 4j .. 5 + 4j), or j = -1 for
// the row's left voxel (box x 1); false for a slot without a task.
template <typename G>
__device__ __forceinline__ bool task(int v, int& row, int& j) {
  if (v < G::NVEC) {
    const int l = v % 32;
    row = v / 32 * 2 + (l % 8) / 4;
    j = (l / 8) * 4 + l % 4;
  } else {
    row = v - G::NVEC;
    j = -1;
  }
  return row < G::ROWS;
}

__device__ __forceinline__ float lane4(const float4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Task slot v of the chunk at channel c0 of the tile at output origin
// (z0, y0, x0), into q: channel c's voxels in q[c] (the left voxel in .x).
template <typename G>
__device__ __forceinline__ void load_task(float4 (&q)[8], int v, const float* __restrict__ vol, size_t plane, int c0,
                                          int C, int z0, int y0, int x0, int D, int h, int w, bool vec) {
#pragma unroll
  for (int c = 0; c < 8; ++c) q[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  int row, j;
  if (!task<G>(v, row, j)) return;
  const int z = 2 * z0 - 1 + row / G::HY, y = 2 * y0 - 1 + row % G::HY, x = j < 0 ? 2 * x0 - 1 : 2 * x0 + 4 * j;
  if (z < 0 || z >= D || y < 0 || y >= h || x < 0 || x >= w) return;
  const float* p = vol + (size_t)c0 * plane + ((size_t)z * h + y) * w + x;
  if (j < 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + c < C) q[c].x = __ldg(p + c * plane);
  } else if (vec) {  // x and w multiples of 4: the vector is in or out whole
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + c < C) q[c] = __ldg(reinterpret_cast<const float4*>(p + c * plane));
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + c < C) {
        const float* pc = p + c * plane;
        q[c] = make_float4(__ldg(pc), x + 1 < w ? __ldg(pc + 1) : 0.f, x + 2 < w ? __ldg(pc + 2) : 0.f,
                           x + 3 < w ? __ldg(pc + 3) : 0.f);
      }
  }
}

// Byte offset of box x bx's slot in a half-row.
template <typename G>
__device__ __forceinline__ int slot_offset(int bx) {
  return ((bx % 2) * G::PX + bx / 2) * 16;
}

// Task slot v's voxels into the box at `box`: voxel k of a vector (box x
// 2 + 4j + k), channels 0-3 to the first half-box, 4-7 to the second.
template <typename G>
__device__ __forceinline__ void store_task(char* box, const float4 (&q)[8], int v) {
  int row, j;
  if (!task<G>(v, row, j)) return;
  char* r = box + row * G::RS;
  if (j < 0) {
    const int at = slot_offset<G>(1);
    *reinterpret_cast<float4*>(r + at) = make_float4(q[0].x, q[1].x, q[2].x, q[3].x);
    *reinterpret_cast<float4*>(r + G::HALF + at) = make_float4(q[4].x, q[5].x, q[6].x, q[7].x);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int at = slot_offset<G>(2 + 4 * j + k);
    *reinterpret_cast<float4*>(r + at) = make_float4(lane4(q[0], k), lane4(q[1], k), lane4(q[2], k), lane4(q[3], k));
    *reinterpret_cast<float4*>(r + G::HALF + at) =
        make_float4(lane4(q[4], k), lane4(q[5], k), lane4(q[6], k), lane4(q[7], k));
  }
}
}  // namespace k7f

// NT: output channels / 8; MY: the output tile's rows.
template <int NT, int MY>
__global__ void __launch_bounds__(k7f::kThreads, 1) conv3d_down_tf32_kernel(
    const float* __restrict__ vol,  // (C, D, h, w)
    const float* __restrict__ wt,   // (8*NT, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ bias, // (8*NT,)
    float* __restrict__ out,        // (8*NT, Do, ho, wo)
    int C, int D, int h, int w, int tiles_x, int tiles_y, int n_tiles) {
  using G = k7f::T<MY>;
  constexpr int kThreads = k7f::kThreads, MZW = G::MZW, NTASK = G::NTASK, STEPS = 9;
  extern __shared__ uint4 smem[];
  const int nchunks = (C + tf32::CH - 1) / tf32::CH;
  uint4* wfrag = smem;
  char* box = reinterpret_cast<char*>(smem + nchunks * tf32::TAPS * NT * 32);  // two buffers of G::BOX bytes
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  tf32::stage_weights<NT>(wfrag, wt, C, nchunks, tid, kThreads);

  // the warp's column: output row my, x from mx, planes zw .. zw+MZW-1 of
  // the tile; lane_off[kx]: byte offset of this lane's ldmatrix row (output
  // x mx + mrow, channels 4·half ..) at box plane 2·zw, row 2·my and tap kx
  const int col = warp % G::COLS, zw = warp / G::COLS * MZW, my = col / 2, mx = (col % 2) * 16;
  const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
  uint32_t lane_off[3];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
    lane_off[kx] = half * G::HALF + (2 * zw * G::HY + 2 * my) * G::RS + k7f::slot_offset<G>(2 * (mx + mrow) + kx + 1);
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nt][e] = __ldg(bias + nt * 8 + 2 * (lane % 4) + e);
  const int Do = (D - 1) / 2 + 1, ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const size_t plane = (size_t)D * h * w, plane_o = (size_t)Do * ho * wo, hwo = (size_t)ho * wo;
  const bool vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(vol) & 15) == 0;

  int tile = blockIdx.x, chunk = 0, z0, y0, x0;
  k7f::tile_origin<G>(tile, tiles_x, tiles_y, z0, y0, x0);
#pragma unroll
  for (int i = 0; i < NTASK; ++i) {
    float4 q[8];
    k7f::load_task<G>(q, i * kThreads + tid, vol, plane, 0, C, z0, y0, x0, D, h, w, vec);
    k7f::store_task<G>(box, q, i * kThreads + tid);
  }
  __syncthreads();  // the weights and the first box are staged
  float acc[MZW][NT][4];
  conv_mma::zero(acc);
  for (int cur = 0;; cur ^= 1) {
    int next = tile, next_chunk = chunk + 1, nz = 0, ny = 0, nx = 0;
    if (next_chunk == nchunks) next += gridDim.x, next_chunk = 0;
    const bool more = next < n_tiles;
    if (more) k7f::tile_origin<G>(next, tiles_x, tiles_y, nz, ny, nx);
    const uint32_t box_s = conv_mma::smem_addr(box + cur * G::BOX);
    const uint4* wf = wfrag + chunk * tf32::TAPS * NT * 32;
    char* next_box = box + (cur ^ 1) * G::BOX;
#pragma unroll
    for (int i = 0; i < NTASK; ++i) {  // task i of the next box in flight during a share of the steps
      float4 q[8];
      if (more) k7f::load_task<G>(q, i * kThreads + tid, vol, plane, next_chunk * tf32::CH, C, nz, ny, nx, D, h, w, vec);
#pragma unroll
      for (int s = i * STEPS / NTASK; s < (i + 1) * STEPS / NTASK; ++s) {
        const int ky = s / 3, kx = s % 3;
        tf32::down_step<MZW, NT>(acc, ky, kx, wf, lane, [&](uint32_t(&a)[4], int hz) {
          conv_mma::ldmatrix_x4(a, box_s + lane_off[kx] + (hz * G::HY + ky) * G::RS);
        });
      }
      if (more) k7f::store_task<G>(next_box, q, i * kThreads + tid);
    }
    if (chunk == nchunks - 1) {
      const int y = y0 + my;
#pragma unroll
      for (int m = 0; m < MZW; ++m) {
        const int z = z0 + zw + m;
        if (z >= Do || y >= ho) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = x0 + mx + lane / 4 + 8 * hf;
          if (x >= wo) continue;
          const size_t at = (size_t)z * hwo + (size_t)y * wo + x;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              out[(size_t)(nt * 8 + 2 * (lane % 4) + e) * plane_o + at] = fmaxf(acc[m][nt][2 * hf + e] + bv[nt][e], 0.f);
        }
      }
      conv_mma::zero(acc);
    }
    if (!more) break;
    __syncthreads();  // the next box is stored; every warp is done with this one
    tile = next, chunk = next_chunk, z0 = nz, y0 = ny, x0 = nx;
  }
}

template <int NT, int MY>
static size_t down_tf32_smem(int C) {
  const int nchunks = (C + tf32::CH - 1) / tf32::CH;
  return (size_t)nchunks * tf32::TAPS * NT * 32 * sizeof(uint4) + 2 * (size_t)k7f::T<MY>::BOX;
}

// The card's resident blocks of conv3d_down_tf32_kernel<NT, MY> at C
// channels (0 if the shared memory does not fit or a query fails); per_sm:
// an SM's.
template <int NT, int MY>
static int down_tf32_resident(int C, int& per_sm) {
  const size_t smem = down_tf32_smem<NT, MY>(C);
  if (C <= 0 || smem > (size_t)k7f::kMaxSmem) return 0;
  static const cudaError_t opt_in =  // once per instantiation, not per launch
      cudaFuncSetAttribute(conv3d_down_tf32_kernel<NT, MY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k7f::kMaxSmem);
  if (opt_in != cudaSuccess) return 0;
  static int occupancy[64 + 1] = {};
  const int chunks8 = (C + tf32::CH - 1) / tf32::CH * tf32::CH;
  if (chunks8 > 64 * tf32::CH) return 0;
  const int limit = conv_mma::resident_grid(conv3d_down_tf32_kernel<NT, MY>, k7f::kThreads, smem, chunks8, occupancy);
  per_sm = occupancy[chunks8 / tf32::CH];
  return limit;
}

// The tile rows K7-fp32 takes: 4 where the fragments of every chunk and
// n-tile fit beside two 2x4x32 boxes (at most two chunk-n-tiles), else 2.
static int down_tf32_rows(int O, int C) { return (C + tf32::CH - 1) / tf32::CH * (O / 8) <= 2 ? 4 : 2; }

template <int MY>
static void down_tf32_tiles(int D, int h, int w, int& tiles_x, int& tiles_y, int& n_tiles) {
  using G = k7f::T<MY>;
  const int Do = (D - 1) / 2 + 1, ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  tiles_x = (wo + G::MX - 1) / G::MX, tiles_y = (ho + G::MY - 1) / G::MY;
  n_tiles = tiles_x * tiles_y * ((Do + G::MZ - 1) / G::MZ);
}

template <int NT, int MY>
static int launch_down_tf32(const void* vol, const void* wt, const void* bias, void* out, int C, int D, int h, int w,
                            void* stream) {
  int per_sm = 0;
  const int limit = down_tf32_resident<NT, MY>(C, per_sm);
  if (limit == 0) return (int)cudaErrorInvalidValue;
  if (D <= 0 || h <= 0 || w <= 0) return 0;
  int tiles_x, tiles_y, n_tiles;
  down_tf32_tiles<MY>(D, h, w, tiles_x, tiles_y, n_tiles);
  conv3d_down_tf32_kernel<NT, MY><<<n_tiles < limit ? n_tiles : limit, k7f::kThreads, down_tf32_smem<NT, MY>(C),
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<float*>(out), C, D, h, w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

// K7-fp32's launch plan at O output and C input channels and input D x h x
// w, as conv3d_down_launch makes it: out = {tile z, y, x (output voxels),
// tiles, blocks, registers a thread, resident blocks an SM, dynamic shared
// bytes a block}.
CDS_EXPORT int conv3d_down_tf32_plan(int O, int C, int D, int h, int w, int* out) {
  if (O != 8 && O != 16) return (int)cudaErrorInvalidValue;
  const int MY = down_tf32_rows(O, C);
  int per_sm = 0, limit = 0, tiles_x, tiles_y, n_tiles;
  size_t smem = 0;
  cudaFuncAttributes attr;
  cudaError_t err;
  if (MY == 4) {
    limit = O == 8 ? down_tf32_resident<1, 4>(C, per_sm) : down_tf32_resident<2, 4>(C, per_sm);
    smem = O == 8 ? down_tf32_smem<1, 4>(C) : down_tf32_smem<2, 4>(C);
    err = cudaFuncGetAttributes(&attr, O == 8 ? conv3d_down_tf32_kernel<1, 4> : conv3d_down_tf32_kernel<2, 4>);
    down_tf32_tiles<4>(D, h, w, tiles_x, tiles_y, n_tiles);
  } else {
    limit = O == 8 ? down_tf32_resident<1, 2>(C, per_sm) : down_tf32_resident<2, 2>(C, per_sm);
    smem = O == 8 ? down_tf32_smem<1, 2>(C) : down_tf32_smem<2, 2>(C);
    err = cudaFuncGetAttributes(&attr, O == 8 ? conv3d_down_tf32_kernel<1, 2> : conv3d_down_tf32_kernel<2, 2>);
    down_tf32_tiles<2>(D, h, w, tiles_x, tiles_y, n_tiles);
  }
  if (limit == 0 || err != cudaSuccess) return (int)cudaErrorInvalidConfiguration;
  out[0] = 2; out[1] = MY; out[2] = 32;
  out[3] = n_tiles; out[4] = n_tiles < limit ? n_tiles : limit;
  out[5] = attr.numRegs; out[6] = per_sm; out[7] = (int)smem;
  return 0;
}

template <int S>
static int dispatch(const void* vol, const void* wt, const void* bias, void* out, int fp32, int O, int C, int D,
                    int h, int w, void* stream) {
  if (O != 8 && O != 16) return (int)cudaErrorInvalidValue;
  if (!fp32) {
    if constexpr (S == 1)  // K2 in bf16: the tensor-core body
      return O == 8 ? launch_mma<1>(vol, wt, bias, out, C, D, h, w, stream)
                    : launch_mma<2>(vol, wt, bias, out, C, D, h, w, stream);
    else  // K7 in bf16: the same body at stride 2
      return O == 8 ? launch_down_mma<1>(vol, wt, bias, out, C, D, h, w, stream)
                    : launch_down_mma<2>(vol, wt, bias, out, C, D, h, w, stream);
  }
  if constexpr (S == 1)  // K2 in fp32: 3xTF32 on the tensor cores
    return O == 8 ? launch_tf32<1>(vol, wt, bias, out, C, D, h, w, stream)
                  : launch_tf32<2>(vol, wt, bias, out, C, D, h, w, stream);
  // K7 in fp32: 3xTF32 at stride 2 (K6's conv1 runs the same step)
  if (down_tf32_rows(O, C) == 4)
    return O == 8 ? launch_down_tf32<1, 4>(vol, wt, bias, out, C, D, h, w, stream)
                  : launch_down_tf32<2, 4>(vol, wt, bias, out, C, D, h, w, stream);
  return O == 8 ? launch_down_tf32<1, 2>(vol, wt, bias, out, C, D, h, w, stream)
                : launch_down_tf32<2, 2>(vol, wt, bias, out, C, D, h, w, stream);
}

// K2, stride 1. fp32 = 1 for an fp32 volume and output, 0 for bf16; O in {8, 16}.
CDS_EXPORT int conv3d_bn_relu_launch(const void* vol, const void* wt, const void* bias, void* out,
                                     int fp32, int O, int C, int D, int h, int w, void* stream) {
  return dispatch<1>(vol, wt, bias, out, fp32, O, C, D, h, w, stream);
}

// K7, stride 2; arguments as K2's, (C, D, h, w) the input's shape.
CDS_EXPORT int conv3d_down_launch(const void* vol, const void* wt, const void* bias, void* out,
                                  int fp32, int O, int C, int D, int h, int w, void* stream) {
  return dispatch<2>(vol, wt, bias, out, fp32, O, C, D, h, w, stream);
}
