// K5's backward: the VJP of the fused plane-sweep warp (warp.cu,
// warp_kernel) with respect to the source and reference features. Wrapper,
// plain version and design note: ops/kernels/warp_vjp.py.
#include "warp.cuh"

// Add v into p[0..4) (fp32, global memory): one 16-byte vector atomic,
// which sm_90 has.
__device__ __forceinline__ void add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x), atomicAdd(p + 1, v.y), atomicAdd(p + 2, v.z), atomicAdd(p + 3, v.w);
#endif
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
// The d_src sums: 16-byte global atomics run at about 80 G a second on the
// H100, and a kernel that adds each pixel and plane's four corners spent most
// of its time in them (PERF.md). But a pixel's projection moves by a fraction
// of a source pixel from one plane to the next, so its four corners mostly
// stay the same over the chunk: each lane keeps the sums w_k * gw of its four
// corners in registers while its corner cell (x0, y0 and which corners are in
// bounds) stays the same, and adds them to d_src, 16 bytes an atomic, only
// when the cell changes and after the last plane. The fp32 sums' order still
// varies from run to run.
template <int C>
__global__ void __launch_bounds__(lanes::kThreads, 2) warp_sim_backward_kernel(
    const bf16* __restrict__ src,        // (H, W, C)
    const bf16* __restrict__ ref,        // (C, h, w)
    const float* __restrict__ depth,     // (D,) or (D, h, w)
    int depth_per_pixel,
    const float* __restrict__ rt,        // (12,)
    const bf16* __restrict__ g_in_prod,  // (C, D, h, w)
    const float* __restrict__ g_sim,     // (D, h, w)
    float* __restrict__ d_src,           // (H, W, C) fp32, zeroed
    float* __restrict__ d_ref_part,      // (chunks, C, h, w) fp32
    int H, int W, int D, int h, int w, int DC) {
  using T = k5::BwdTile<C>;
  constexpr int CL = T::CL;
  static_assert(CL == 8, "flush adds a corner's sums as two 16-byte vectors");
  __shared__ __align__(16) unsigned short ring[lanes::kThreads / 32][2][T::BUF];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid % T::G, pl = tid / T::G, pt = pl % T::PT, c0 = CL * g;
  const int hw = h * w, pix0 = blockIdx.x * T::P;
  const int d0 = blockIdx.y * DC, d1 = min(D, d0 + DC);
  const int nw = min(max(hw - pix0 - warp * T::PT, 0), T::PT);  // pixels of this warp
  const bool live = pix0 + pl < hw;
  const int pix = min(pix0 + pl, hw - 1);  // lanes past the end redo the last pixel and add nothing
  const bool vec = hw % 8 == 0;            // g_in_prod's rows start 16-byte aligned

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
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(cok >> k & 1)) continue;
      float* p = d_src + ((size_t)(cy + (k >> 1)) * W + cx + (k & 1)) * C + c0;
      add4(p, make_float4(sum[k][0], sum[k][1], sum[k][2], sum[k][3]));
      add4(p + 4, make_float4(sum[k][4], sum[k][5], sum[k][6], sum[k][7]));
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
// d_src = bf16 of the fp32 sums; four values a thread (n_ref4 and n_src4
// groups of four).
__global__ void warp_sim_backward_finish_kernel(const float4* __restrict__ part, int chunks, size_t n_ref4,
                                                uint2* __restrict__ d_ref, const float4* __restrict__ d_src_f32,
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
    s = __ldcs(d_src_f32 + (i - n_ref4));
    out = d_src + (i - n_ref4);
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

// Zero the fp32 d_src, then the main kernel, then the finishing kernel, all
// on `stream`. `chunks` is the caller's count of d_ref_part's chunks, which
// must be the launch plan's.
template <int C>
static int launch_backward(const void* src, const void* ref, const void* depth, int depth_per_pixel, const void* rt,
                           const void* g_in_prod, const void* g_sim, void* d_src_f32, void* d_ref_part, int chunks,
                           void* d_src, void* d_ref, int H, int W, int D, int h, int w, cudaStream_t st) {
  int tiles, DC;
  if (plan_of<C>(D, h, w, &tiles, &DC) != chunks) return (int)cudaErrorInvalidValue;
  const size_t n_src = (size_t)H * W * C;
  cudaError_t err = cudaMemsetAsync(d_src_f32, 0, n_src * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  warp_sim_backward_kernel<C><<<dim3(tiles, chunks), lanes::kThreads, 0, st>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(ref), static_cast<const float*>(depth),
      depth_per_pixel, static_cast<const float*>(rt), static_cast<const bf16*>(g_in_prod),
      static_cast<const float*>(g_sim), static_cast<float*>(d_src_f32), static_cast<float*>(d_ref_part), H, W, D, h,
      w, DC);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_ref4 = (size_t)C * h * w / 4, n_src4 = n_src / 4;  // C is a multiple of 8
  warp_sim_backward_finish_kernel<<<(unsigned)((n_ref4 + n_src4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(d_ref_part), chunks, n_ref4, static_cast<uint2*>(d_ref),
      static_cast<const float4*>(d_src_f32), static_cast<uint2*>(d_src), n_src4);
  return (int)cudaGetLastError();
}

CDS_EXPORT int warp_sim_backward_launch(const void* src, const void* ref, const void* depth,
                                        int depth_per_pixel, const void* rt,
                                        const void* g_in_prod, const void* g_sim,
                                        void* d_src_f32, void* d_ref_part, int chunks, void* d_src,
                                        void* d_ref, int C, int H, int W, int D, int h, int w,
                                        void* stream) {
  if (D < 1 || h * w < 1 || H * W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K5_BWD_ARGS src, ref, depth, depth_per_pixel, rt, g_in_prod, g_sim, d_src_f32, d_ref_part, chunks, d_src, \
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
