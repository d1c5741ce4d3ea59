// K9: the plane-sweep gather, bilinear with zeros padding at given source
// coordinates. Wrapper, plain version and design note: ops/kernels/gather.py.
//
// A pixel wider than 32 bytes (fp32 at C = 32, 16; bf16 at C = 32) is taken
// by a lane group: G = C * sizeof(T) / 32 lanes, each loading two 16-byte
// pieces of each corner, so a group reads each corner vector whole and a
// warp's loads touch one line per corner and pixel. A pixel of at most 32
// bytes is taken by one thread, each corner in one or two 16-byte loads.
// Either way every lane computes the pixel's footprint, issues its loads
// before it sums, sums its channels op by op as the plain version does
// (fetch_pieces and sum_pieces below, or gather<C, true> of warp.cuh) and
// rounds once. Coordinates are read and outputs written with evict-first
// hints, so the source stays in L2 while the output streams past it.
#include "warp.cuh"

constexpr int kThreads = 256;

// K9's lane-group form of gather<C, true>: the lane that holds piece j of a
// pixel (channels j*VEC .. j*VEC + VEC - 1, VEC = 16 / sizeof(T)) sums only
// those channels, in corner order, op by op, as gather<C, true> sums them.
// fetch_pieces loads the four corners' piece j as raw 16-byte vectors from
// addresses clamped into the image, without a branch, so that a lane issues
// the loads of all its pieces before it sums any; sum_pieces then skips an
// out-of-bounds corner as gather<> skips it.
template <typename T>
__device__ __forceinline__ void fetch_pieces(uint4 (&q)[4], const T* __restrict__ src, const Footprint& f, int H,
                                             int W, int C, int j) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = min(max(f.x0 + (k & 1), 0), W - 1), yi = min(max(f.y0 + (k >> 1), 0), H - 1);
    q[k] = __ldg(reinterpret_cast<const uint4*>(src + ((size_t)yi * W + xi) * C) + j);
  }
}

__device__ __forceinline__ void unpack_piece(const uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y); v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack_piece(const uint4 q, float (&v)[8]) { unpack8(q, v); }

template <int VEC>
__device__ __forceinline__ void sum_pieces(const uint4 (&q)[4], const Footprint& f, float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!f.ok[k]) continue;
    float v[VEC];
    unpack_piece(q[k], v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], f.wts[k]));
  }
}

template <typename T, int C>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);        // channels of a 16-byte piece
  static constexpr int G = C / (2 * VEC);           // lanes a pixel, 32 bytes each; below 2, one thread
  static constexpr int P = kThreads / (G > 1 ? G : 1);  // pixels a block
};

__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store(bf16* p, bf16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const T* __restrict__ src,     // (H, W, C) channels-last source
    const float* __restrict__ px,  // (D, h, w) source-pixel x
    const float* __restrict__ py,  // (D, h, w) source-pixel y
    T* __restrict__ out,           // (C, D, h, w)
    int H, int W, long long n) {   // n = D * h * w
  using L = Lanes<T, C>;
  if constexpr (L::G < 2) {
    // a pixel of at most 32 bytes: one thread takes it whole, each corner in
    // one or two 16-byte loads, and stores its C values strided by n
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const Footprint f = footprint(__ldcs(px + i), __ldcs(py + i), H, W);
    float acc[C];
    gather<C, true>(src, f, W, acc);  // op by op, as the plain version sums
#pragma unroll
    for (int c = 0; c < C; ++c) store(out + (size_t)c * n + i, from_f32<T>(acc[c]));
  } else {
    // lane j of a group of G: pieces 2j and 2j + 1 of each corner, loaded
    // before any sum
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) / L::G;
    const int j = threadIdx.x % L::G;
    if (i >= n) return;
    const Footprint f = footprint(__ldcs(px + i), __ldcs(py + i), H, W);
    uint4 q[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) fetch_pieces<T>(q[h], src, f, H, W, C, 2 * j + h);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc[L::VEC];
      sum_pieces<L::VEC>(q[h], f, acc);
#pragma unroll
      for (int v = 0; v < L::VEC; ++v) store(out + (size_t)((2 * j + h) * L::VEC + v) * n + i, from_f32<T>(acc[v]));
    }
  }
}

template <typename T>
static int launch(const void* src, const void* px, const void* py, void* out, int C, int H, int W,
                  long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel, int pixels) {
    const dim3 grid((unsigned)((n + pixels - 1) / pixels));
    kernel<<<grid, kThreads, 0, st>>>(static_cast<const T*>(src), static_cast<const float*>(px),
                                      static_cast<const float*>(py), static_cast<T*>(out), H, W, n);
  };
  switch (C) {
    case 8: args(gather_kernel<T, 8>, Lanes<T, 8>::P); break;
    case 16: args(gather_kernel<T, 16>, Lanes<T, 16>::P); break;
    case 32: args(gather_kernel<T, 32>, Lanes<T, 32>::P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// fp32 = 1 for an fp32 source and output, 0 for bf16.
CDS_EXPORT int warp_gather_launch(const void* src, const void* px, const void* py, void* out,
                                  int fp32, int C, int H, int W, long long n, void* stream) {
  if (n <= 0) return 0;
  return fp32 ? launch<float>(src, px, py, out, C, H, W, n, stream)
              : launch<bf16>(src, px, py, out, C, H, W, n, stream);
}
