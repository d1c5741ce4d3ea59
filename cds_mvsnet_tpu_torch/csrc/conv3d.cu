// K2 and K7: direct 3x3x3 conv (pad 1, stride 1 for K2, 2 for K7) + bias +
// ReLU, 8 or 16 output channels. Wrappers, plain versions and design note:
// ops/kernels/conv3d.py.
#include "common.cuh"

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

template <int S>
static int dispatch(const void* vol, const void* wt, const void* bias, void* out, int fp32, int O,
                    int C, int D, int h, int w, void* stream) {
  if (O == 8)
    return fp32 ? launch<float, 8, S>(vol, wt, bias, out, C, D, h, w, stream)
                : launch<bf16, 8, S>(vol, wt, bias, out, C, D, h, w, stream);
  if (O == 16)
    return fp32 ? launch<float, 16, S>(vol, wt, bias, out, C, D, h, w, stream)
                : launch<bf16, 16, S>(vol, wt, bias, out, C, D, h, w, stream);
  return (int)cudaErrorInvalidValue;
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
