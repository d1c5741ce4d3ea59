// K6: cost-regularisation conv0 (3x3x3, stride 1, C -> 8) and the stride-2
// conv1 (8 -> 16) in one pass, each with bias and ReLU. conv1 reads conv0
// rounded to the stored type, with conv0's zero padding. Wrapper, plain
// version and design note: ops/kernels/conv3d_fused.py.
//
// bf16: conv3d_fused_mma_kernel, conv0 on conv3d_mma.cuh's tensor-core body
// (K2's, so out0 equals K2's output bit for bit), conv1 with the fp32 FMAs
// of K7's fp32 form in its order (so out1 equals K7's fp32 form on
// out0.float(), rounded to bf16, bit for bit). fp32: conv3d_fused_kernel,
// the direct body of K2's and K7's fp32 forms.
#include "conv3d_mma.cuh"

constexpr int O0 = 8, O1 = 16;
// conv1 outputs per block, and the conv0 values they read: 2t+1 per axis,
// from 2*t0-1 (the low halo, which the block before owns) to 2*(t0+t)-1
constexpr int TD = 4, TY = 4, TX = 16;
constexpr int ND = 2 * TD + 1, NY = 2 * TY + 1, NX = 2 * TX + 1;
constexpr int NV = ND * NY * NX;
constexpr int kThreads = TD * TY * TX;  // 256: one conv1 output each

template <typename T>
__global__ void __launch_bounds__(kThreads) conv3d_fused_kernel(
    const T* __restrict__ vol,     // (C, D, h, w)
    const float* __restrict__ w0,  // (O0, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ b0,  // (O0,)
    const float* __restrict__ w1,  // (O1, O0, 3, 3, 3), eval BN folded in
    const float* __restrict__ b1,  // (O1,)
    T* __restrict__ out0,          // (O0, D, h, w)
    T* __restrict__ out1,          // (O1, D/2, h/2, w/2)
    int C, int D, int h, int w) {
  extern __shared__ float smem[];
  float* ws0 = smem;                  // [c][tap][o0]
  float* ws1 = ws0 + C * 27 * O0;     // [o0][tap][o1]
  T* tile = reinterpret_cast<T*>(ws1 + O0 * 27 * O1);  // [o0][ND][NY][NX], conv0 as stored
  const int tid = threadIdx.x;
  for (int i = tid; i < C * 27 * O0; i += kThreads) ws0[i] = w0[(i % O0) * C * 27 + i / O0];
  for (int i = tid; i < O0 * 27 * O1; i += kThreads) ws1[i] = w1[(i % O1) * O0 * 27 + i / O1];
  __syncthreads();

  const int x1_0 = blockIdx.x * TX, y1_0 = blockIdx.y * TY, d1_0 = blockIdx.z * TD;
  const int dz0 = 2 * d1_0 - 1, yy0 = 2 * y1_0 - 1, xx0 = 2 * x1_0 - 1;  // conv0 index of local 0
  const size_t hw = (size_t)h * w;

  // Phase 1: the conv0 values of the tile, as K2 computes them, rounded to
  // T. Out of the volume they are conv1's zero padding (low side) or unread
  // (high side: D, h, w are even, so no valid conv1 output reads there).
  // Each voxel of out0 is stored by the one block whose conv1 tile owns it:
  // local index 1 .. 2t, not the low halo.
  for (int i = tid; i < NV; i += kThreads) {
    const int lx = i % NX, ly = (i / NX) % NY, ld = i / (NX * NY);
    const int d = dz0 + ld, y = yy0 + ly, x = xx0 + lx;
    if (d < 0 || d >= D || y < 0 || y >= h || x < 0 || x >= w) {
#pragma unroll
      for (int o = 0; o < O0; ++o) tile[o * NV + i] = from_f32<T>(0.f);
      continue;
    }
    float acc[O0];
#pragma unroll
    for (int o = 0; o < O0; ++o) acc[o] = 0.f;
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int dz = d + kd - 1;
        if (dz < 0 || dz >= D) continue;
        const T* plane = vol + ((size_t)c * D + dz) * hw;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int yy = y + ky - 1;
          if (yy < 0 || yy >= h) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int xx = x + kx - 1;
            if (xx < 0 || xx >= w) continue;
            const float v = to_f32(plane[(size_t)yy * w + xx]);
            const float* wp = ws0 + (c * 27 + kd * 9 + ky * 3 + kx) * O0;
#pragma unroll
            for (int o = 0; o < O0; ++o) acc[o] = fmaf(v, wp[o], acc[o]);
          }
        }
      }
    }
    const bool owned = ld > 0 && ly > 0 && lx > 0;
    const size_t at = (size_t)d * hw + (size_t)y * w + x;
#pragma unroll
    for (int o = 0; o < O0; ++o) {
      const T v = from_f32<T>(fmaxf(acc[o] + __ldg(b0 + o), 0.f));
      tile[o * NV + i] = v;
      if (owned) out0[(size_t)o * D * hw + at] = v;
    }
  }
  __syncthreads();

  // Phase 2: conv1 from shared memory. Output (d1, y1, x1) reads conv0 at
  // 2*d1-1 .. 2*d1+1, which is local 2*td .. 2*td+2 (likewise y and x).
  const int tx = tid % TX, ty = (tid / TX) % TY, td = tid / (TX * TY);
  const int D1 = D / 2, h1 = h / 2, w1_ = w / 2;
  const int x1 = x1_0 + tx, y1 = y1_0 + ty, d1 = d1_0 + td;
  if (x1 >= w1_ || y1 >= h1 || d1 >= D1) return;
  float acc[O1];
#pragma unroll
  for (int o = 0; o < O1; ++o) acc[o] = 0.f;
  for (int c = 0; c < O0; ++c) {
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const T* row = tile + c * NV + ((2 * td + kd) * NY + 2 * ty + ky) * NX + 2 * tx;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = to_f32(row[kx]);
          const float* wp = ws1 + (c * 27 + kd * 9 + ky * 3 + kx) * O1;
#pragma unroll
          for (int o = 0; o < O1; ++o) acc[o] = fmaf(v, wp[o], acc[o]);
        }
      }
    }
  }
  const size_t hw1 = (size_t)h1 * w1_, at1 = (size_t)d1 * hw1 + (size_t)y1 * w1_ + x1;
#pragma unroll
  for (int o = 0; o < O1; ++o) {
    out1[(size_t)o * D1 * hw1 + at1] = from_f32<T>(fmaxf(acc[o] + __ldg(b1 + o), 0.f));
  }
}

template <typename T>
static int launch_direct(const void* vol, const void* w0, const void* b0, const void* w1, const void* b1,
                  void* out0, void* out1, int C, int D, int h, int w, void* stream) {
  if (D % 2 || h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)C * 27 * O0 + O0 * 27 * O1) * sizeof(float) + (size_t)O0 * NV * sizeof(T);
  if ((size_t)C * 27 * O0 * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  static const cudaError_t opt_in =  // once per instantiation, not per launch
      cudaFuncSetAttribute(conv3d_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((w / 2 + TX - 1) / TX, (h / 2 + TY - 1) / TY, (D / 2 + TD - 1) / TD);
  conv3d_fused_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vol), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<T*>(out0),
      static_cast<T*>(out1), C, D, h, w);
  return (int)cudaGetLastError();
}

// K6 in bf16. A tile is TD x TY x TX conv1 outputs; its conv0 region, the
// (2t+1) values per axis that the tile reads from 2*t0-1 on, holds
// RZ x RY x RX = 1485 voxels for 4 x 8 x 32 owned ones (1.45x of conv0
// computed; the low-side halo belongs to the tile before). Phase 1 takes the
// region in two passes along z, planes 0-2 and 3-4 (56 and 38 M-tiles of 16
// flattened voxels; warp k takes M-tiles k, k+8, ..., at most 7), each pass
// chunk by chunk over its own input halo of 5 or 4 planes of 11 x 36
// voxels: the passes keep the accumulators in registers at 2 blocks per SM,
// for 9 halo planes staged per chunk instead of 7. Shared memory at C = 32:
// the conv0 weight fragments 28.0 KB, the halo 30.9 KB, conv1's fp32 weights
// 13.5 KB and the bf16 conv0 tile 23.2 KB: 95.6 KB, two resident blocks of
// 8 warps per SM. A block stays resident and walks the tiles blockIdx.x,
// +gridDim.x, ...; its weights are staged once, and as in K2 the halo of the
// next (tile, pass, chunk) is loaded into registers before the MMAs of the
// current one.
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
  constexpr int TD = k6::TD, TY = k6::TY, TX = k6::TX, RY = k6::RY, RX = k6::RX, R = k6::R;
  constexpr int HY = k6::HY, HX = k6::HX, HV = k6::HV, PZ = k6::PZ;
  constexpr int kThreads = k6::kThreads, kWarps = k6::kWarps, MT = k6::MT, NTASK = k6::NTASK;
  extern __shared__ uint4 smem16[];  // 16-byte aligned
  const int nchunks = C / CH;
  uint4* wfrag = smem16;
  uint4* halo = wfrag + nchunks * KSTEPS * 32;
  float* ws1 = reinterpret_cast<float*>(halo + HV);  // [o0][tap][o1]
  bf16* tile0 = reinterpret_cast<bf16*>(ws1 + O0 * 27 * O1);  // [o0][R]: conv0 as stored, 0 outside the volume
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  stage_weights<1>(wfrag, w0, C, tid, kThreads);
  for (int i = tid; i < O0 * 27 * O1; i += kThreads) ws1[i] = w1[(i % O1) * O0 * 27 + i / O1];

  float bv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) bv[e] = __ldg(b0 + 2 * (lane % 4) + e);
  const size_t plane = (size_t)D * h * w, hw = (size_t)h * w;
  const int D1 = D / 2, h1 = h / 2, w1_ = w / 2;
  const size_t hw1 = (size_t)h1 * w1_;
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

    // out0: the voxels this tile owns (region-local 1 .. 2t per axis), two
    // along x per store: x is even and so is w, so a pair is in or out whole
    for (int k = tid; k < O0 * 2 * TD * 2 * TY * TX; k += kThreads) {
      const int px = k % TX, ly = 1 + (k / TX) % (2 * TY), lz = 1 + (k / (TX * 2 * TY)) % (2 * TD);
      const int o = k / (TX * 2 * TY * 2 * TD), lx = 1 + 2 * px;
      const int d = dz0 + lz, y = yy0 + ly, x = xx0 + lx;
      if (d >= D || y >= h || x >= w) continue;
      const bf16* src = tile0 + o * R + (lz * RY + ly) * RX + lx;
      __nv_bfloat162 pair;
      pair.x = src[0];
      pair.y = src[1];
      *reinterpret_cast<__nv_bfloat162*>(out0 + o * plane + (size_t)d * hw + (size_t)y * w + x) = pair;
    }

    // Phase 2: conv1 from the shared tile with K7-fp32's FMAs in its order; a
    // thread takes one output and 8 of its 16 channels. Output (d1, y1, x1)
    // reads conv0 at 2*d1-1 .. 2*d1+1, region-local 2*td .. 2*td+2.
    const int k = tid % (TD * TY * TX), oh = tid / (TD * TY * TX);
    const int tx = k % TX, ty = (k / TX) % TY, td = k / (TX * TY);
    const int x1 = x1_0 + tx, y1 = y1_0 + ty, d1 = d1_0 + td;
    if (x1 < w1_ && y1 < h1 && d1 < D1) {
      float acc1[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) acc1[o] = 0.f;
      for (int c = 0; c < O0; ++c) {
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const bf16* src = tile0 + c * R + ((2 * td + kd) * RY + 2 * ty + ky) * RX + 2 * tx;
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float v = bf2f(src[kx]);
              const float* wp = ws1 + (c * 27 + kd * 9 + ky * 3 + kx) * O1 + oh * 8;
#pragma unroll
              for (int o = 0; o < 8; ++o) acc1[o] = fmaf(v, wp[o], acc1[o]);
            }
          }
        }
      }
      const size_t at1 = (size_t)d1 * hw1 + (size_t)y1 * w1_ + x1;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int n = oh * 8 + o;
        out1[(size_t)n * D1 * hw1 + at1] = f2bf(fmaxf(acc1[o] + __ldg(b1 + n), 0.f));
      }
    }
  }
}

static int launch_mma(const void* vol, const void* w0, const void* b0, const void* w1, const void* b1, void* out0,
                      void* out1, int C, int D, int h, int w, void* stream) {
  constexpr int kMaxC = 64 * conv_mma::CH;
  if (D % 2 || h % 2 || w % 2 || C % conv_mma::CH || C > kMaxC) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(C / conv_mma::CH) * conv_mma::KSTEPS * 32 + k6::HV) * sizeof(uint4) +
                      O0 * 27 * O1 * sizeof(float) + (size_t)O0 * k6::R * sizeof(bf16);
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

// fp32 = 1 for an fp32 volume and outputs, 0 for bf16.
CDS_EXPORT int conv3d_front_fused_launch(const void* vol, const void* w0, const void* b0,
                                         const void* w1, const void* b1, void* out0, void* out1,
                                         int fp32, int C, int D, int h, int w, void* stream) {
  return fp32 ? launch_direct<float>(vol, w0, b0, w1, b1, out0, out1, C, D, h, w, stream)
              : launch_mma(vol, w0, b0, w1, b1, out0, out1, C, D, h, w, stream);
}
