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

// Eight consecutive values, 16-byte aligned, as fp32: one 16-byte load of
// bf16, two of fp32.
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Asynchronous copies into shared memory (cp.async): `bytes` (4 or 16) from
// global `src` to shared `dst`, or zeros there where `valid` is false (no
// read then: src-size 0). cp_async_wait_all waits for this thread's copies.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  static_assert(bytes == 4 || bytes == 16, "cp.async copies 4 or 16 bytes here");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Close this thread's group of copies; wait until at most `pending` of its
// groups are still in flight.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// A stored value as fp32, and fp32 rounded to the stored type.
__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return f2bf(v); }
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

CDS_EXPORT const char* cds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
