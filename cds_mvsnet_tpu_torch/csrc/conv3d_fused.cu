// K6: cost-regularisation conv0 (3x3x3, stride 1, C -> 8) and the stride-2
// conv1 (8 -> 16) in one pass, each with bias and ReLU. conv1 reads conv0
// rounded to the stored type, with conv0's zero padding. Wrapper, plain
// version and design note: ops/kernels/conv3d_fused.py.
#include "common.cuh"

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
static int launch(const void* vol, const void* w0, const void* b0, const void* w1, const void* b1,
                  void* out0, void* out1, int C, int D, int h, int w, void* stream) {
  if (D % 2 || h % 2 || w % 2) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)C * 27 * O0 + O0 * 27 * O1) * sizeof(float) + (size_t)O0 * NV * sizeof(T);
  if ((size_t)C * 27 * O0 * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3d_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w / 2 + TX - 1) / TX, (h / 2 + TY - 1) / TY, (D / 2 + TD - 1) / TD);
  conv3d_fused_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vol), static_cast<const float*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<T*>(out0),
      static_cast<T*>(out1), C, D, h, w);
  return (int)cudaGetLastError();
}

// fp32 = 1 for an fp32 volume and outputs, 0 for bf16.
CDS_EXPORT int conv3d_front_fused_launch(const void* vol, const void* w0, const void* b0,
                                         const void* w1, const void* b1, void* out0, void* out1,
                                         int fp32, int C, int D, int h, int w, void* stream) {
  return fp32 ? launch<float>(vol, w0, b0, w1, b1, out0, out1, C, D, h, w, stream)
              : launch<bf16>(vol, w0, b0, w1, b1, out0, out1, C, D, h, w, stream);
}
