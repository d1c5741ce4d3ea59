// K2 and K7: 3x3x3 conv (pad 1, stride 1 for K2, 2 for K7) + bias + ReLU,
// 8 or 16 output channels. Wrappers, plain versions and design note:
// ops/kernels/conv3d.py.
//
// K2 on a bf16 volume runs conv3d_mma_kernel: the tensor-core implicit GEMM
// of conv3d_mma.cuh, which K6's conv0 shares. The fp32 volume (K2's fp32
// route) and the stride-2 K7 run the direct body conv3d_bn_relu_kernel.
#include "conv3d_mma.cuh"

constexpr int TX = 32, TY = 8;

// T: the volume's and the output's type, bf16 or fp32; the sums are fp32.
// O: output channels; S: stride. The output is (O, (D-1)/S+1, (h-1)/S+1,
// (w-1)/S+1); output voxel (d, y, x) reads input voxels S*d-1 .. S*d+1 along
// each axis, zeros outside.
template <typename T, int O, int S>
__global__ void __launch_bounds__(TX * TY) conv3d_bn_relu_kernel(
    const T* __restrict__ vol,      // (C, D, h, w)
    const float* __restrict__ wt,   // (O, C, 3, 3, 3), eval BN folded in
    const float* __restrict__ bias, // (O,)
    T* __restrict__ out,            // (O, Do, ho, wo)
    int C, int D, int h, int w) {
  extern __shared__ float ws[];  // [c][tap][o]: the O weights of one tap side by side
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < C * 27 * O; i += TX * TY) {
    const int o = i % O, ct = i / O;  // ct = c * 27 + tap
    ws[i] = wt[o * C * 27 + ct];
  }
  __syncthreads();

  const int Do = (D - 1) / S + 1, ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int d = blockIdx.z;
  if (x >= wo || y >= ho) return;
  const size_t hw = (size_t)h * w;

  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = 0.f;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const int dz = S * d + kd - 1;
      if (dz < 0 || dz >= D) continue;
      const T* plane = vol + ((size_t)c * D + dz) * hw;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int yy = S * y + ky - 1;
        if (yy < 0 || yy >= h) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int xx = S * x + kx - 1;
          if (xx < 0 || xx >= w) continue;
          const float v = to_f32(plane[(size_t)yy * w + xx]);
          const float* wp = ws + (c * 27 + kd * 9 + ky * 3 + kx) * O;
#pragma unroll
          for (int o = 0; o < O; ++o) acc[o] = fmaf(v, wp[o], acc[o]);
        }
      }
    }
  }
  const size_t pix = (size_t)y * wo + x, hwo = (size_t)ho * wo;
#pragma unroll
  for (int o = 0; o < O; ++o) {
    out[((size_t)o * Do + d) * hwo + pix] = from_f32<T>(fmaxf(acc[o] + __ldg(bias + o), 0.f));
  }
}

template <typename T, int O, int S>
static int launch(const void* vol, const void* wt, const void* bias, void* out, int C, int D,
                  int h, int w, void* stream) {
  const int Do = (D - 1) / S + 1, ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const dim3 block(TX, TY);
  const dim3 grid((wo + TX - 1) / TX, (ho + TY - 1) / TY, Do);
  const size_t smem = (size_t)C * 27 * O * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  conv3d_bn_relu_kernel<T, O, S><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vol), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<T*>(out), C, D, h, w);
  return (int)cudaGetLastError();
}

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

template <int S>
static int dispatch(const void* vol, const void* wt, const void* bias, void* out, int fp32, int O, int C, int D,
                    int h, int w, void* stream) {
  if (O != 8 && O != 16) return (int)cudaErrorInvalidValue;
  if (!fp32) {
    if constexpr (S == 1)  // K2 in bf16: the tensor-core body
      return O == 8 ? launch_mma<1>(vol, wt, bias, out, C, D, h, w, stream)
                    : launch_mma<2>(vol, wt, bias, out, C, D, h, w, stream);
    else
      return O == 8 ? launch<bf16, 8, S>(vol, wt, bias, out, C, D, h, w, stream)
                    : launch<bf16, 16, S>(vol, wt, bias, out, C, D, h, w, stream);
  }
  return O == 8 ? launch<float, 8, S>(vol, wt, bias, out, C, D, h, w, stream)
                : launch<float, 16, S>(vol, wt, bias, out, C, D, h, w, stream);
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
