// Shared helpers of the port's CUDA kernels (plain C interface, built by
// ops/kernels/_build.py with nvcc for sm_90a and loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

#define CDS_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// round to nearest even, as torch's float -> bfloat16 cast
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// Unpack 8 bf16 held in one 16-byte vector.
__device__ __forceinline__ void unpack8(const uint4 q, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

CDS_EXPORT const char* cds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
