// P1: the sum of nseg 128-wide column slices of a band, at slice starts read
// from device memory. Wrapper, plain version and design note:
// ops/kernels/lane_slice.py.
#include <cstdint>

#include "common.cuh"

constexpr int kLanes = 128;
constexpr int kMaxSmem = 232448;  // what one block may opt in to on the H100

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One block of R * 128 threads, thread (r, l) = (tid / 128, tid % 128). One
// thread starts a single bulk copy (TMA's 1-D form) of the whole band into
// shared memory that completes on an mbarrier; meanwhile the block reads and
// clamps the slice starts. Then each thread sums its lane over the slices,
// in slice order.
__global__ void lane_slice_kernel(const float* __restrict__ x,     // (R, 128 * nseg)
                                  const int* __restrict__ offs,    // (nseg,)
                                  float* __restrict__ out,         // (R, 128)
                                  int nseg) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  const int width = kLanes * nseg;
  float* band = reinterpret_cast<float*>(smem);                     // (R, width)
  int* starts = reinterpret_cast<int*>(band + (size_t)blockDim.x * nseg);  // (nseg,)
  const uint32_t bytes = (uint32_t)blockDim.x * (uint32_t)nseg * 4u;
  const uint32_t b = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(band)),
        "l"(x), "r"(bytes), "r"(b)
        : "memory");
  }
  // slice starts: floored to a multiple of 128, clamped into the band
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) {
    const int o = __ldg(offs + i);
    starts[i] = o < 0 ? 0 : min((o / kLanes) * kLanes, width - kLanes);
  }
  __syncthreads();
  uint32_t done = 0;
  do {  // phase 0 completes when all bytes of the band have landed
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
  const float* row = band + (size_t)(threadIdx.x / kLanes) * width + threadIdx.x % kLanes;
  float acc = 0.f;
  for (int i = 0; i < nseg; ++i) acc += row[starts[i]];
  out[threadIdx.x] = acc;
}

CDS_EXPORT int lane_slice_launch(const void* x, const void* offs, void* out, int R, int nseg, void* stream) {
  const size_t smem = (size_t)R * kLanes * nseg * 4 + (size_t)nseg * 4;
  if (R < 1 || R * kLanes > 1024 || nseg < 1 || smem + 16 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lane_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lane_slice_kernel<<<1, R * kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(offs), static_cast<float*>(out), nseg);
  return (int)cudaGetLastError();
}
