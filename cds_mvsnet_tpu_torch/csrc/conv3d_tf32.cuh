// The 3xTF32 arithmetic of the fp32 convs on the tensor cores, shared by
// K2-fp32 (conv3d.cu, conv3d_tf32_kernel), K7-fp32 (conv3d.cu,
// conv3d_down_tf32_kernel) and both forms of K6 (conv3d_fused.cu), so that
// K6's out0 equals K2-fp32's output and K6's out1 equals K7-fp32's output on
// out0 bit for bit.
//
// mma.sync.m16n8k8 with TF32 inputs: each fp32 operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) (cvt.rna's rounding: 10 mantissa bits, ties
// away from zero), and a K-step adds hi·hi, hi·lo and lo·hi (activation
// first, weight second) into one fp32 accumulator, in that order. A K-step
// is one tap of one chunk of 8 channels. Every output sums its K-steps chunk
// by chunk, then (ky, kx) by (ky, kx), kd ascending within: the order of
// K2-fp32's z-stacked walk, which down_step below keeps at stride 2. The
// dropped lo·lo and the roundings of lo leave about 2^-21 of each |term|,
// inside the fp32 route's tolerance of 1e-5 of the sum of |terms|
// (tests/test_torch_conv3d_tf32.py models it).
#pragma once

#include <stdint.h>

#include "conv3d_mma.cuh"

namespace tf32 {

using conv_mma::CH;
using conv_mma::TAPS;

// cvt.rna.tf32.f32 on a finite x, as two integer operations: half of the 13
// dropped bits' weight added to the magnitude, then the bits cleared (ties
// away from zero). The instruction itself also tests for NaN and ran 12 %
// slower here (PERF.md).
__device__ __forceinline__ uint32_t rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna(x);
  lo = rna(x - __uint_as_float(hi));  // x - hi is exact in fp32
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A K-step's three products into one accumulator: hi·hi, hi·lo, lo·hi. b:
// the weight fragment {hi b0, hi b1, lo b0, lo b1} (stage_weights).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&hi)[4], const uint32_t (&lo)[4], uint4 b) {
  mma(d, hi, b.x, b.y);
  mma(d, hi, b.z, b.w);
  mma(d, lo, b.x, b.y);
}

// Entry ((chunk * 27 + tap) * NT + nt) * 32 + lane: for n = nt*8 + lane/4 and
// c = chunk*8 + lane%4, the B fragment {b0: channel c, b1: channel c + 4} of
// the tap, once as hi and once as lo; zeros past C.
template <int NT>
__device__ void stage_weights(uint4* wfrag, const float* __restrict__ w, int C, int nchunks, int tid, int nthreads) {
  const int n_entries = nchunks * TAPS * NT * 32;
  for (int i = tid; i < n_entries; i += nthreads) {
    const int lane = i % 32, rest = i / 32;
    const int nt = rest % NT, step = rest / NT;
    const int tap = step % TAPS, chunk = step / TAPS;
    const int n = nt * 8 + lane / 4, c = chunk * CH + lane % 4;
    const float v0 = c < C ? __ldg(w + ((size_t)n * C + c) * TAPS + tap) : 0.f;
    const float v1 = c + 4 < C ? __ldg(w + ((size_t)n * C + c + 4) * TAPS + tap) : 0.f;
    uint4 e;
    split(v0, e.x, e.z);
    split(v1, e.y, e.w);
    wfrag[i] = e;
  }
}

// The four fp32 values of this lane's A fragment of an M-tile, as an fp32
// ldmatrix.x4 gives them: rows lane/4 and lane/4 + 8, channels lane%4 and
// lane%4 + 4. row[r]: element offset of row r's voxel (channel 0) in a tile
// stored channel-major, `cs` elements a channel; a bf16 tile's values are
// exact in fp32. For the conv1 phase of K6, whose conv0 tile is [8][R].
template <typename T>
__device__ __forceinline__ void gather_a(uint32_t (&a)[4], const T* tile, int row0, int row8, int cs, int lane) {
  const int c = lane % 4;
  a[0] = __float_as_uint(to_f32(tile[c * cs + row0]));
  a[1] = __float_as_uint(to_f32(tile[c * cs + row8]));
  a[2] = __float_as_uint(to_f32(tile[(c + 4) * cs + row0]));
  a[3] = __float_as_uint(to_f32(tile[(c + 4) * cs + row8]));
}

// One (ky, kx) step of a stride-2 3x3x3 conv over one chunk of 8 channels,
// the K-steps of the three depth taps, for MZ M-tiles of one warp stacked
// along output z (planes m = 0 .. MZ-1 of a column): the B fragments of kd
// = 0, 1, 2, then for each input plane hz = 0 .. 2·MZ one A fragment,
// load_a(a, hz) (its raw fp32 bits), split once, into the M-tiles m with
// 2m + kd = hz. Each accumulator's K-steps run kd ascending, so a whole
// chunk called (ky, kx) by (ky, kx) sums in K2-fp32's order whatever MZ and
// whatever loader: K7-fp32 (MZ = 2, ldmatrix on its box) and K6's conv1
// (MZ = 1, gather_a on its conv0 tile) compute each output alike.
// wfrag: this chunk's fragments (stage_weights).
template <int MZ, int NT, typename LoadA>
__device__ __forceinline__ void down_step(float (&acc)[MZ][NT][4], int ky, int kx, const uint4* wfrag, int lane,
                                          LoadA&& load_a) {
  uint4 b[3][NT];
#pragma unroll
  for (int kd = 0; kd < 3; ++kd)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[kd][nt] = wfrag[((kd * 9 + ky * 3 + kx) * NT + nt) * 32 + lane];
#pragma unroll
  for (int hz = 0; hz < 2 * MZ + 1; ++hz) {
    uint32_t a[4], hi[4], lo[4];
    load_a(a, hz);
#pragma unroll
    for (int j = 0; j < 4; ++j) split(__uint_as_float(a[j]), hi[j], lo[j]);
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      if ((hz - kd) % 2 != 0) continue;
      const int m = (hz - kd) / 2;
      if (m < 0 || m >= MZ) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma3(acc[m][nt], hi, lo, b[kd][nt]);
    }
  }
}

}  // namespace tf32
