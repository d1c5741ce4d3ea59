// K5's backward: the VJP of the fused plane-sweep warp (warp.cu,
// warp_kernel) with respect to the source and reference features. Wrapper,
// plain version and design note: ops/kernels/warp_vjp.py.
#include <algorithm>

#include "warp.cuh"

// d_src in fixed point. The sums into a source pixel come from many blocks
// (every pixel tile whose projections land on it, in every plane chunk), and
// fp32 atomics add them in whatever order the blocks run, so their last bits
// changed from run to run. Here each addend is scaled by a power of two 2^S
// and rounded to a 64-bit integer, and the integers are added with 64-bit
// atomics: integer addition is associative, so every order gives the same
// bits. S is chosen on the device, with no host sync, from the largest
// magnitudes of the inputs (warp_sim_backward_max_kernel): every term w_k * g
// * ref of a source pixel and channel is at most max|g| * max|ref| (the
// bilinear weights are at most 1, and a pixel and plane adds at most one term
// to a source pixel: its four corners are four different pixels), so with
// B = D * h * w * (max|g_in_prod| + max|g_sim|) * max|ref| >= the sum of
// |terms| of any source value, S = 61 - ilogb(B) is the largest S with
// B * 2^S < 2^62, and no sum of rounded addends (each off by at most 1/2)
// reaches 2^63. The resolution 2^-S is about B * 2^-62: far below one bf16
// ulp of any value that is not 2^-50 times smaller than B.
namespace k5 {
// The four 32-bit words after d_src's sums in the launcher's int64 scratch:
// the bit patterns of max|g_in_prod|, max|g_sim| and max|ref| (non-negative
// floats order as their bit patterns, and a NaN's pattern lies above
// infinity's), and a flag set where a flushed sum is not finite.
enum { kMaxGIn = 0, kMaxGSim = 1, kMaxRef = 2, kNonFinite = 3, kWords = 4 };

struct Fixed {
  double scale, inv;  // 2^S and 2^-S
  bool finite;        // false: the inputs hold an infinity or a NaN
};

__device__ __forceinline__ Fixed fixed_point(const unsigned* words, int D, int hw) {
  const double g = (double)__uint_as_float(words[kMaxGIn]) + (double)__uint_as_float(words[kMaxGSim]);
  const double b = (double)D * (double)hw * g * (double)__uint_as_float(words[kMaxRef]);
  Fixed f;
  f.finite = isfinite(b);
  const int S = f.finite && b > 0.0 ? 61 - ilogb(b) : 0;
  f.scale = ldexp(1.0, S);
  f.inv = ldexp(1.0, -S);
  return f;
}

// The largest |x| of a bf16 pair, as the bit pattern of an fp32 value.
__device__ __forceinline__ unsigned abs_bits2(unsigned u) {
  return max((u & 0x7fffu) << 16, u & 0x7fff0000u);
}

// max|bf16| over p[0..n), 8 values a 16-byte load where p is aligned.
__device__ __forceinline__ unsigned bf16_abs_max(const bf16* p, size_t n, size_t t0, size_t stride) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned m = 0;
  size_t head = 0;
  if ((reinterpret_cast<size_t>(q) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(q);
    head = n / 8;
    for (size_t i = t0; i < head; i += stride) {
      const uint4 u = __ldcs(v + i);
      m = max(m, max(max(abs_bits2(u.x), abs_bits2(u.y)), max(abs_bits2(u.z), abs_bits2(u.w))));
    }
    head *= 8;
  }
  for (size_t i = head + t0; i < n; i += stride) m = max(m, (unsigned)(q[i] & 0x7fffu) << 16);
  return m;
}
}  // namespace k5

// The first pass: max|g_in_prod|, max|g_sim| and max|ref| into the words
// (zeroed by the launcher), one atomicMax a warp and quantity.
__global__ void __launch_bounds__(256) warp_sim_backward_max_kernel(const bf16* __restrict__ g_in_prod, size_t n_ip,
                                                                    const float* __restrict__ g_sim, size_t n_sim,
                                                                    const bf16* __restrict__ ref, size_t n_ref,
                                                                    unsigned* __restrict__ words) {
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x, stride = (size_t)gridDim.x * blockDim.x;
  unsigned m_sim = 0;
  for (size_t i = t0; i < n_sim; i += stride) m_sim = max(m_sim, __float_as_uint(__ldcs(g_sim + i)) & 0x7fffffffu);
  const unsigned m_ip = __reduce_max_sync(0xffffffffu, k5::bf16_abs_max(g_in_prod, n_ip, t0, stride));
  const unsigned m_ref = __reduce_max_sync(0xffffffffu, k5::bf16_abs_max(ref, n_ref, t0, stride));
  m_sim = __reduce_max_sync(0xffffffffu, m_sim);
  if (threadIdx.x % 32 == 0) {
    atomicMax(words + k5::kMaxGIn, m_ip);
    atomicMax(words + k5::kMaxGSim, m_sim);
    atomicMax(words + k5::kMaxRef, m_ref);
  }
}

// Add the fp32 sum v to *p in fixed point; a non-finite sum sets the flag
// instead, and the finishing kernel then writes NaN.
__device__ __forceinline__ void add_fixed(unsigned long long* p, float v, const k5::Fixed& fx, unsigned* words) {
  if (v == 0.f) return;
  if (!isfinite(v)) {
    atomicOr(words + k5::kNonFinite, 1u);
    return;
  }
  atomicAdd(p, (unsigned long long)__double2ll_rn((double)v * fx.scale));
}

// The backward's lane width: 8 channels, so that a lane's four pending
// corner sums (below) fit in its registers.
namespace k5 {
template <int C>
using BwdTile = lanes::Tile<C, 8>;
}  // namespace k5

// The forward's decomposition (warp.cu, warp_kernel), in lanes of 8
// channels: block (x, y) owns BwdTile<C>::P consecutive pixels and the planes
// of chunk y. A warp brings a plane's (C, PT) sub-tile of g_in_prod in as
// 16-byte streaming loads through one of two shared buffers, the mirror of
// the forward's store path; each lane recomputes its warped values as the
// forward rounded them (gather_lane<1, true>). With g = g_in_prod[c, d] +
// g_sim[d], the cotangent of the bf16 warped value is gw = g * ref:
// d_src[corner_k] += w_k * gw, and d_ref's partial sum over the chunk's
// planes, sum_d g * warped, stays in registers and is written to chunk y's
// slice of the fp32 scratch d_ref_part (chunks, C, h, w): no atomics, so
// d_ref does not depend on the run.
//
// The d_src sums: global atomics run at about 80 G a second on the H100, and
// a kernel that adds each pixel and plane's four corners spent most of its
// time in them (PERF.md). But a pixel's projection moves by a fraction
// of a source pixel from one plane to the next, so its four corners mostly
// stay the same over the chunk: each lane keeps the sums w_k * gw of its four
// corners in registers while its corner cell (x0, y0 and which corners are in
// bounds) stays the same, and adds them to d_src only when the cell changes
// and after the last plane: in fixed point (above), one 64-bit integer
// atomic a channel, so that d_src is the same in every run.
template <int C>
__global__ void __launch_bounds__(lanes::kThreads, 2) warp_sim_backward_kernel(
    const bf16* __restrict__ src,        // (H, W, C)
    const bf16* __restrict__ ref,        // (C, h, w)
    const float* __restrict__ depth,     // (D,) or (D, h, w)
    int depth_per_pixel,
    const float* __restrict__ rt,        // (12,)
    const bf16* __restrict__ g_in_prod,  // (C, D, h, w)
    const float* __restrict__ g_sim,     // (D, h, w)
    unsigned long long* __restrict__ d_src,  // (H, W, C) fixed point (two's complement), zeroed
    unsigned* __restrict__ words,        // k5::kWords words, the maxima set
    float* __restrict__ d_ref_part,      // (chunks, C, h, w) fp32
    int H, int W, int D, int h, int w, int DC) {
  using T = k5::BwdTile<C>;
  constexpr int CL = T::CL;
  __shared__ __align__(16) unsigned short ring[lanes::kThreads / 32][2][T::BUF];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid % T::G, pl = tid / T::G, pt = pl % T::PT, c0 = CL * g;
  const int hw = h * w, pix0 = blockIdx.x * T::P;
  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  const int nw = min(max(hw - pix0 - warp * T::PT, 0), T::PT);  // pixels of this warp
  const bool live = pix0 + pl < hw;
  const int pix = min(pix0 + pl, hw - 1);  // lanes past the end redo the last pixel and add nothing
  const bool vec = hw % 8 == 0;            // g_in_prod's rows start 16-byte aligned
  const k5::Fixed fx = k5::fixed_point(words, D, hw);

  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = __ldg(rt + i);
  float L[3];
  plane_rows(r, pix % w, pix / w, L);
  float refv[CL], dref[CL];
#pragma unroll
  for (int i = 0; i < CL; ++i) {
    refv[i] = bf2f(ref[(size_t)(c0 + i) * hw + pix]);
    dref[i] = 0.f;
  }
  auto hyp = [&](int d) { return depth_per_pixel ? __ldg(depth + (size_t)d * hw + pix) : __ldg(depth + d); };

  // the pending sums of the current corner cell: corner k's at sum[k]
  float sum[4][CL];
  int cx = 0, cy = 0, cok = 0;  // the cell; cok: bit k set where corner k is in bounds
  auto flush = [&]() {
    if (!fx.finite) return;  // d_src is NaN (the finishing kernel)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(cok >> k & 1)) continue;
      unsigned long long* p = d_src + ((size_t)(cy + (k >> 1)) * W + cx + (k & 1)) * C + c0;
#pragma unroll
      for (int i = 0; i < CL; ++i) add_fixed(p + i, sum[k][i], fx, words);
    }
  };

  for (int d = d0; d < d1; ++d) {
    unsigned short* buf = ring[warp][(d - d0) & 1];
    {
      const int sr = lane / T::VROW, sj = lane % T::VROW;  // one 16-byte vector a lane
      const bf16* gp = g_in_prod + ((size_t)sr * D + d) * hw + pix0 + warp * T::PT + 8 * sj;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (vec && 8 * sj + 8 <= nw) {
        q = __ldcs(reinterpret_cast<const uint4*>(gp));
      } else {
        unsigned short* e = reinterpret_cast<unsigned short*>(&q);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * sj + j < nw) e[j] = __ldcs(reinterpret_cast<const unsigned short*>(gp) + j);
      }
      *reinterpret_cast<uint4*>(buf + lanes::slot<C, CL>(sr, sj) * 8) = q;
    }
    const float gs = __ldcs(g_sim + (size_t)d * hw + pix);
    const Footprint f = project(r, L, hyp(d), H, W);
    float acc[CL];
    gather_lane<1, true>(src, f, H, W, C, c0, acc);  // recomputed: the forward kept no warped volume

    const int ok = f.ok[0] | f.ok[1] << 1 | f.ok[2] << 2 | f.ok[3] << 3;
    if (d == d0 || f.x0 != cx || f.y0 != cy || ok != cok) {
      if (d != d0 && live) flush();
      cx = f.x0, cy = f.y0, cok = ok;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < CL; ++i) sum[k][i] = 0.f;
    }
    __syncwarp();  // the sub-tile of plane d is in buf; buf's last reader (plane d - 2) is done
#pragma unroll
    for (int i = 0; i < CL; ++i) {
      const float wq = bf2f(f2bf(acc[i]));  // warped value as the forward rounded it
      const float gv = bf2f(__ushort_as_bfloat16(buf[lanes::slot<C, CL>(c0 + i, pt / 8) * 8 + pt % 8])) + gs;
      dref[i] += gv * wq;
      const float gw = gv * refv[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[k][i] += f.wts[k] * gw;
    }
  }
  // The last cell's sums. Corners 1 and 3 of the pixel to the left (lane -
  // G, same channels) are this pixel's corners 0 and 2 when its cell sits
  // one column to the left: this lane adds them in and the left lane leaves
  // them out, which halves the last flush's atomics at stage 1.
  const int lx = __shfl_up_sync(0xffffffffu, cx, T::G), ly = __shfl_up_sync(0xffffffffu, cy, T::G);
  const int lok = __shfl_up_sync(0xffffffffu, live ? cok : 0, T::G);
  const bool next_to_left = pt > 0 && live && lx + 1 == cx && ly == cy;
  const bool take1 = next_to_left && (lok >> 1 & cok & 1), take3 = next_to_left && (lok >> 3 & cok >> 2 & 1);
#pragma unroll
  for (int i = 0; i < CL; ++i) {
    const float s1 = __shfl_up_sync(0xffffffffu, sum[1][i], T::G);
    const float s3 = __shfl_up_sync(0xffffffffu, sum[3][i], T::G);
    if (take1) sum[0][i] += s1;
    if (take3) sum[2][i] += s3;
  }
  const int given = __shfl_down_sync(0xffffffffu, take1 | take3 << 1, T::G);  // taken by the pixel to the right
  if (pt < T::PT - 1) cok &= ~((given & 1) << 1 | (given >> 1 & 1) << 3);
  if (live) {
    flush();
#pragma unroll
    for (int i = 0; i < CL; ++i) d_ref_part[((size_t)blockIdx.y * C + c0 + i) * hw + pix] = dref[i];
  }
}

// d_ref = bf16 of the sum of the chunks' partials, in chunk order, and
// d_src = bf16 of the fp32 value of its fixed-point sum (int64 -> fp32, one
// rounding, then the exact scaling by 2^-S; NaN where the inputs or a flushed
// sum were not finite); four values a thread (n_ref4 and n_src4 groups of
// four).
__global__ void warp_sim_backward_finish_kernel(const float4* __restrict__ part, int chunks, size_t n_ref4,
                                                uint2* __restrict__ d_ref, const longlong2* __restrict__ d_src_fixed,
                                                const unsigned* __restrict__ words, int D, int hw,
                                                uint2* __restrict__ d_src, size_t n_src4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float4 s;
  uint2* out;
  if (i < n_ref4) {
    s = __ldcs(part + i);
    for (int ch = 1; ch < chunks; ++ch) {
      const float4 t = __ldcs(part + (size_t)ch * n_ref4 + i);
      s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
    }
    out = d_ref + i;
  } else if (i - n_ref4 < n_src4) {
    const size_t j = i - n_ref4;
    const k5::Fixed fx = k5::fixed_point(words, D, hw);
    const longlong2 a = __ldcs(d_src_fixed + 2 * j), b = __ldcs(d_src_fixed + 2 * j + 1);
    auto value = [&](long long v) { return (float)((double)__ll2float_rn(v) * fx.inv); };
    s = make_float4(value(a.x), value(a.y), value(b.x), value(b.y));
    if (!fx.finite || words[k5::kNonFinite]) {
      const float nan = __int_as_float(0x7fc00000);
      s = make_float4(nan, nan, nan, nan);
    }
    out = d_src + j;
  } else {
    return;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y), hi = __floats2bfloat162_rn(s.z, s.w);
  *out = make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

template <int C>
static int plan_of(int D, int h, int w, int* tiles, int* DC) {
  *tiles = (h * w + k5::BwdTile<C>::P - 1) / k5::BwdTile<C>::P;
  *DC = k5::chunk_planes(D, *tiles);
  return (D + *DC - 1) / *DC;
}

// Zero the fixed-point d_src and the words after it, then the maxima, the
// main kernel and the finishing kernel, all on `stream`. `d_src_fixed` holds
// H * W * C int64 sums and k5::kWords 32-bit words (H * W * C + 2 int64).
// `chunks` is the caller's count of d_ref_part's chunks, which must be the
// launch plan's.
template <int C>
static int launch_backward(const void* src, const void* ref, const void* depth, int depth_per_pixel, const void* rt,
                           const void* g_in_prod, const void* g_sim, void* d_src_fixed, void* d_ref_part, int chunks,
                           void* d_src, void* d_ref, int H, int W, int D, int h, int w, cudaStream_t st) {
  int tiles, DC;
  if (plan_of<C>(D, h, w, &tiles, &DC) != chunks) return (int)cudaErrorInvalidValue;
  const size_t n_src = (size_t)H * W * C, n_ip = (size_t)C * D * h * w;
  unsigned long long* sums = static_cast<unsigned long long*>(d_src_fixed);
  unsigned* words = reinterpret_cast<unsigned*>(sums + n_src);
  cudaError_t err = cudaMemsetAsync(d_src_fixed, 0, n_src * sizeof(long long) + k5::kWords * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned max_blocks = (unsigned)std::min<size_t>((n_ip / 8 + 255) / 256 + 1, 2 * 132);
  warp_sim_backward_max_kernel<<<max_blocks, 256, 0, st>>>(
      static_cast<const bf16*>(g_in_prod), n_ip, static_cast<const float*>(g_sim), (size_t)D * h * w,
      static_cast<const bf16*>(ref), (size_t)C * h * w, words);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  warp_sim_backward_kernel<C><<<dim3(tiles, chunks), lanes::kThreads, 0, st>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(ref), static_cast<const float*>(depth),
      depth_per_pixel, static_cast<const float*>(rt), static_cast<const bf16*>(g_in_prod),
      static_cast<const float*>(g_sim), sums, words, static_cast<float*>(d_ref_part), H, W, D, h, w, DC);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_ref4 = (size_t)C * h * w / 4, n_src4 = n_src / 4;  // C is a multiple of 8
  warp_sim_backward_finish_kernel<<<(unsigned)((n_ref4 + n_src4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(d_ref_part), chunks, n_ref4, static_cast<uint2*>(d_ref),
      static_cast<const longlong2*>(d_src_fixed), words, D, h * w, static_cast<uint2*>(d_src), n_src4);
  return (int)cudaGetLastError();
}

CDS_EXPORT int warp_sim_backward_launch(const void* src, const void* ref, const void* depth,
                                        int depth_per_pixel, const void* rt,
                                        const void* g_in_prod, const void* g_sim,
                                        void* d_src_fixed, void* d_ref_part, int chunks, void* d_src,
                                        void* d_ref, int C, int H, int W, int D, int h, int w,
                                        void* stream) {
  if (D < 1 || h * w < 1 || H * W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K5_BWD_ARGS src, ref, depth, depth_per_pixel, rt, g_in_prod, g_sim, d_src_fixed, d_ref_part, chunks, d_src, \
                    d_ref, H, W, D, h, w, st
  switch (C) {
    case 8: return launch_backward<8>(K5_BWD_ARGS);
    case 16: return launch_backward<16>(K5_BWD_ARGS);
    case 32: return launch_backward<32>(K5_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K5_BWD_ARGS
}

// K5's backward plan, as warp_sim_backward_launch makes it: out = {lanes a
// pixel, pixels a block, planes a chunk, chunks, blocks, registers a thread,
// resident blocks an SM, shared bytes a block, d_ref_part's bytes}.
template <int C>
static int backward_plan(int D, int h, int w, int* out) {
  cudaFuncAttributes attr;
  int per_sm = 0;
  if (cudaFuncGetAttributes(&attr, warp_sim_backward_kernel<C>) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_sim_backward_kernel<C>, lanes::kThreads, 0) !=
          cudaSuccess)
    return (int)cudaErrorInvalidConfiguration;
  int tiles, DC;
  const int chunks = plan_of<C>(D, h, w, &tiles, &DC);
  out[0] = k5::BwdTile<C>::G; out[1] = k5::BwdTile<C>::P; out[2] = DC; out[3] = chunks; out[4] = tiles * chunks;
  out[5] = attr.numRegs; out[6] = per_sm; out[7] = (int)attr.sharedSizeBytes; out[8] = chunks * C * h * w * 4;
  return 0;
}

CDS_EXPORT int warp_sim_backward_plan(int C, int D, int h, int w, int* out) {
  if (D < 1 || h * w < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 8: return backward_plan<8>(D, h, w, out);
    case 16: return backward_plan<16>(D, h, w, out);
    case 32: return backward_plan<32>(D, h, w, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
