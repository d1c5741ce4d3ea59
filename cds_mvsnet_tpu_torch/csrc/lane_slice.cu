// P1: the sum of nseg 128-wide column slices of a band, at slice starts read
// from device memory. Wrapper, plain version and design note:
// ops/kernels/lane_slice.py.
#include <cstdint>

#include "common.cuh"

constexpr int kLanes = 128;
constexpr int kGroup = 8;     // lanes a block owns: one 32-byte sector of each slice
constexpr int kChunk = 128;   // slices a stage of the ring holds
constexpr int kStages = 8;    // stages of the ring (32 KB): kStages - 1 in flight while one is summed
constexpr int kLoaders = 128; // threads that copy: warps 1 to 4
constexpr int kThreads = 32 + kLoaders;
constexpr int kBatch = 16;    // shared-memory reads a summing thread has in flight

// The start of slice i: floored to a multiple of 128, clamped into the band.
__device__ __forceinline__ int slice_start(const int* __restrict__ offs, int i, int width) {
  const int o = __ldg(offs + i);
  return o < 0 ? 0 : min((o / kLanes) * kLanes, width - kLanes);
}

// Block (g, r) owns lanes [8g, 8g + 8) of row r. Warps 1 to 4 bring those
// lanes of the slices, 128 slices a stage, into a ring of shared memory
// with cp.async, kStages - 1 stages ahead: two 16-byte copies a slice where
// the band is 16-byte aligned (kVec), else eight 4-byte ones; each loader
// reads its slices' starts first, then makes its copies. Lanes 0 to 7 of
// warp 0 sum their lane over each stage as it lands, in slice order, kBatch
// reads at a time ahead of their adds.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) lane_slice_kernel(const float* __restrict__ x,   // (R, 128 * nseg)
                                                             const int* __restrict__ offs,  // (nseg,)
                                                             float* __restrict__ out,       // (R, 128)
                                                             int nseg) {
  constexpr int kWidth = kVec ? 4 : 1;                        // floats a copy moves
  constexpr int kCopies = kChunk * kGroup / kWidth / kLoaders;  // copies a loader makes a stage
  __shared__ __align__(16) float ring[kStages][kChunk * kGroup];
  const int width = kLanes * nseg;
  const float* row = x + (long long)blockIdx.y * width + blockIdx.x * kGroup;
  const int chunks = (nseg + kChunk - 1) / kChunk;
  const int t = threadIdx.x - 32;  // loader index; < 0 in warp 0
  auto load = [&](int c) {  // stage c % kStages <- slices [c * kChunk, c * kChunk + kChunk)
    if (t < 0 || c >= chunks) return;
    int start[kCopies];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int i = c * kChunk + (t + j * kLoaders) * kWidth / kGroup;
      start[j] = i < nseg ? slice_start(offs, i, width) : -1;
    }
    float* stage = ring[c % kStages];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int e = (t + j * kLoaders) * kWidth;  // float of the stage: slice e / 8, lane e % 8
      if (start[j] >= 0) cp_async<4 * kWidth>(stage + e, row + start[j] + e % kGroup, true);
    }
  };
  for (int c = 0; c < kStages - 1; ++c) {
    load(c);
    cp_async_commit();
  }
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage c have landed
    __syncthreads();               // everyone's have, and stage c - 1 has been summed
    load(c + kStages - 1);
    cp_async_commit();
    if (threadIdx.x < kGroup) {
      const float* stage = ring[c % kStages] + threadIdx.x;
      const int n = min(kChunk, nseg - c * kChunk);
      int k = 0;
      for (; k + kBatch <= n; k += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = stage[(k + u) * kGroup];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc += v[u];
      }
      for (; k < n; ++k) acc += stage[k * kGroup];
    }
  }
  if (threadIdx.x < kGroup) out[blockIdx.y * kLanes + blockIdx.x * kGroup + threadIdx.x] = acc;
}

CDS_EXPORT int lane_slice_launch(const void* x, const void* offs, void* out, int R, int nseg, void* stream) {
  if (R < 1 || R > 65535 || nseg < 1 || nseg > (1 << 30) / kLanes) return (int)cudaErrorInvalidValue;
  const dim3 grid(kLanes / kGroup, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), static_cast<const int*>(offs),
                                      static_cast<float*>(out), nseg);
  };
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0)
    go(lane_slice_kernel<true>);
  else
    go(lane_slice_kernel<false>);
  return (int)cudaGetLastError();
}
