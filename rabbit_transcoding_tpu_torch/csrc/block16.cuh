// What the port's 16x16 block kernels share (transcode_gops.cu,
// transcode_mc_intra.cu): the DCT matrix as immediates, the 16-term
// products in the reference's summation order, the per-half-warp transpose
// through shared memory, and the rounding, quantisation and int16 packing
// of the plain chains (ops/transcode.py, ops/rbv_tools.py), bit for bit.
// transcode_gops.cu's header says why each is written the way it is.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 16;
constexpr int kPad = 20;                      // tile row stride, floats
constexpr int kTile = kB * kPad;              // 320 floats
constexpr int kHalfOff = kTile + 16;          // second half-warp: other banks
constexpr int kBufOff = 2 * kHalfOff;         // the second tile of a pair
constexpr int kWarpFloats = 2 * kBufOff;      // 1344 floats per warp

// D[row][col], the orthonormal DCT-II matrix (rows are the basis
// functions): the float32 values of ops/dct.py:dct_matrix(16), bit for bit,
// as exact hexadecimal literals (tests/test_torch_transcode.py holds them
// against that function; transcode_gops.cu's launch checks them against
// the caller's matrix once per process).  Called with constant indices
// only, so every value becomes an FMA's immediate operand.
__host__ __device__ __forceinline__ float dct(int row, int col) {
  constexpr float kD[kB * kB] = {
      0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,
      0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,
      0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,
      0x1p-2f, 0x1p-2f, 0x1p-2f, 0x1p-2f,
      0x1.684b9cp-2f, 0x1.5a730cp-2f, 0x1.3f4a24p-2f, 0x1.17dc14p-2f,
      0x1.cb598cp-3f, 0x1.5553e4p-3f, 0x1.a4608ap-4f, 0x1.1be352p-5f,
      -0x1.1be352p-5f, -0x1.a4608ap-4f, -0x1.5553e4p-3f, -0x1.cb598cp-3f,
      -0x1.17dc14p-2f, -0x1.3f4a24p-2f, -0x1.5a730cp-2f, -0x1.684b9cp-2f,
      0x1.63150cp-2f, 0x1.2d062ep-2f, 0x1.92469cp-3f, 0x1.1a855ep-4f,
      -0x1.1a855ep-4f, -0x1.92469cp-3f, -0x1.2d062ep-2f, -0x1.63150cp-2f,
      -0x1.63150cp-2f, -0x1.2d062ep-2f, -0x1.92469cp-3f, -0x1.1a855ep-4f,
      0x1.1a855ep-4f, 0x1.92469cp-3f, 0x1.2d062ep-2f, 0x1.63150cp-2f,
      0x1.5a730cp-2f, 0x1.cb598cp-3f, 0x1.1be352p-5f, -0x1.5553e4p-3f,
      -0x1.3f4a24p-2f, -0x1.684b9cp-2f, -0x1.17dc14p-2f, -0x1.a4608ap-4f,
      0x1.a4608ap-4f, 0x1.17dc14p-2f, 0x1.684b9cp-2f, 0x1.3f4a24p-2f,
      0x1.5553e4p-3f, -0x1.1be352p-5f, -0x1.cb598cp-3f, -0x1.5a730cp-2f,
      0x1.4e7aeap-2f, 0x1.1517a8p-3f, -0x1.1517a8p-3f, -0x1.4e7aeap-2f,
      -0x1.4e7aeap-2f, -0x1.1517a8p-3f, 0x1.1517a8p-3f, 0x1.4e7aeap-2f,
      0x1.4e7aeap-2f, 0x1.1517a8p-3f, -0x1.1517a8p-3f, -0x1.4e7aeap-2f,
      -0x1.4e7aeap-2f, -0x1.1517a8p-3f, 0x1.1517a8p-3f, 0x1.4e7aeap-2f,
      0x1.3f4a24p-2f, 0x1.1be352p-5f, -0x1.17dc14p-2f, -0x1.5a730cp-2f,
      -0x1.a4608ap-4f, 0x1.cb598cp-3f, 0x1.684b9cp-2f, 0x1.5553e4p-3f,
      -0x1.5553e4p-3f, -0x1.684b9cp-2f, -0x1.cb598cp-3f, 0x1.a4608ap-4f,
      0x1.5a730cp-2f, 0x1.17dc14p-2f, -0x1.1be352p-5f, -0x1.3f4a24p-2f,
      0x1.2d062ep-2f, -0x1.1a855ep-4f, -0x1.63150cp-2f, -0x1.92469cp-3f,
      0x1.92469cp-3f, 0x1.63150cp-2f, 0x1.1a855ep-4f, -0x1.2d062ep-2f,
      -0x1.2d062ep-2f, 0x1.1a855ep-4f, 0x1.63150cp-2f, 0x1.92469cp-3f,
      -0x1.92469cp-3f, -0x1.63150cp-2f, -0x1.1a855ep-4f, 0x1.2d062ep-2f,
      0x1.17dc14p-2f, -0x1.5553e4p-3f, -0x1.5a730cp-2f, 0x1.1be352p-5f,
      0x1.684b9cp-2f, 0x1.a4608ap-4f, -0x1.3f4a24p-2f, -0x1.cb598cp-3f,
      0x1.cb598cp-3f, 0x1.3f4a24p-2f, -0x1.a4608ap-4f, -0x1.684b9cp-2f,
      -0x1.1be352p-5f, 0x1.5a730cp-2f, 0x1.5553e4p-3f, -0x1.17dc14p-2f,
      0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,
      0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,
      0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,
      0x1p-2f, -0x1p-2f, -0x1p-2f, 0x1p-2f,
      0x1.cb598cp-3f, -0x1.3f4a24p-2f, -0x1.a4608ap-4f, 0x1.684b9cp-2f,
      -0x1.1be352p-5f, -0x1.5a730cp-2f, 0x1.5553e4p-3f, 0x1.17dc14p-2f,
      -0x1.17dc14p-2f, -0x1.5553e4p-3f, 0x1.5a730cp-2f, 0x1.1be352p-5f,
      -0x1.684b9cp-2f, 0x1.a4608ap-4f, 0x1.3f4a24p-2f, -0x1.cb598cp-3f,
      0x1.92469cp-3f, -0x1.63150cp-2f, 0x1.1a855ep-4f, 0x1.2d062ep-2f,
      -0x1.2d062ep-2f, -0x1.1a855ep-4f, 0x1.63150cp-2f, -0x1.92469cp-3f,
      -0x1.92469cp-3f, 0x1.63150cp-2f, -0x1.1a855ep-4f, -0x1.2d062ep-2f,
      0x1.2d062ep-2f, 0x1.1a855ep-4f, -0x1.63150cp-2f, 0x1.92469cp-3f,
      0x1.5553e4p-3f, -0x1.684b9cp-2f, 0x1.cb598cp-3f, 0x1.a4608ap-4f,
      -0x1.5a730cp-2f, 0x1.17dc14p-2f, 0x1.1be352p-5f, -0x1.3f4a24p-2f,
      0x1.3f4a24p-2f, -0x1.1be352p-5f, -0x1.17dc14p-2f, 0x1.5a730cp-2f,
      -0x1.a4608ap-4f, -0x1.cb598cp-3f, 0x1.684b9cp-2f, -0x1.5553e4p-3f,
      0x1.1517a8p-3f, -0x1.4e7aeap-2f, 0x1.4e7aeap-2f, -0x1.1517a8p-3f,
      -0x1.1517a8p-3f, 0x1.4e7aeap-2f, -0x1.4e7aeap-2f, 0x1.1517a8p-3f,
      0x1.1517a8p-3f, -0x1.4e7aeap-2f, 0x1.4e7aeap-2f, -0x1.1517a8p-3f,
      -0x1.1517a8p-3f, 0x1.4e7aeap-2f, -0x1.4e7aeap-2f, 0x1.1517a8p-3f,
      0x1.a4608ap-4f, -0x1.17dc14p-2f, 0x1.684b9cp-2f, -0x1.3f4a24p-2f,
      0x1.5553e4p-3f, 0x1.1be352p-5f, -0x1.cb598cp-3f, 0x1.5a730cp-2f,
      -0x1.5a730cp-2f, 0x1.cb598cp-3f, -0x1.1be352p-5f, -0x1.5553e4p-3f,
      0x1.3f4a24p-2f, -0x1.684b9cp-2f, 0x1.17dc14p-2f, -0x1.a4608ap-4f,
      0x1.1a855ep-4f, -0x1.92469cp-3f, 0x1.2d062ep-2f, -0x1.63150cp-2f,
      0x1.63150cp-2f, -0x1.2d062ep-2f, 0x1.92469cp-3f, -0x1.1a855ep-4f,
      -0x1.1a855ep-4f, 0x1.92469cp-3f, -0x1.2d062ep-2f, 0x1.63150cp-2f,
      -0x1.63150cp-2f, 0x1.2d062ep-2f, -0x1.92469cp-3f, 0x1.1a855ep-4f,
      0x1.1be352p-5f, -0x1.a4608ap-4f, 0x1.5553e4p-3f, -0x1.cb598cp-3f,
      0x1.17dc14p-2f, -0x1.3f4a24p-2f, 0x1.5a730cp-2f, -0x1.684b9cp-2f,
      0x1.684b9cp-2f, -0x1.5a730cp-2f, 0x1.3f4a24p-2f, -0x1.17dc14p-2f,
      0x1.cb598cp-3f, -0x1.5553e4p-3f, 0x1.a4608ap-4f, -0x1.1be352p-5f,
  };
  return kD[row * kB + col];
}

// out[x] = sum_k D[k][x] v[k]: both products of the IDCT (the left one
// D^T C on a column of C, the right one T D on a row of T).  D[k][15 - x] =
// (-1)^k D[k][x], and the partial sum s_r runs over k = r (mod 4), all of
// r's parity, so the partial sums of out[15 - x] are s0, -s1, s2, -s3 bit
// for bit (rounding to nearest is symmetric; only the sign of a zero sum
// can differ, and no later step turns a zero's sign into a value): half
// the FMAs.
__device__ __forceinline__ void mul_dt(const float (&v)[kB],
                                       float (&out)[kB]) {
#pragma unroll
  for (int x = 0; x < kB / 2; ++x) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int k = 0; k < kB; k += 4) {
      s0 = fmaf(dct(k + 0, x), v[k + 0], s0);
      s1 = fmaf(dct(k + 1, x), v[k + 1], s1);
      s2 = fmaf(dct(k + 2, x), v[k + 2], s2);
      s3 = fmaf(dct(k + 3, x), v[k + 3], s3);
    }
    out[x] = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
    out[kB - 1 - x] = __fadd_rn(__fsub_rn(s0, s1), __fsub_rn(s2, s3));
  }
}

// out[x] = sum_k D[x][k] v[k]: both products of the DCT (the left one D X
// on a column of X, the right one T D^T on a row of T).
__device__ __forceinline__ void mul_d(const float (&v)[kB],
                                      float (&out)[kB]) {
#pragma unroll
  for (int x = 0; x < kB; ++x) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int k = 0; k < kB; k += 4) {
      s0 = fmaf(dct(x, k + 0), v[k + 0], s0);
      s1 = fmaf(dct(x, k + 1), v[k + 1], s1);
      s2 = fmaf(dct(x, k + 2), v[k + 2], s2);
      s3 = fmaf(dct(x, k + 3), v[k + 3], s3);
    }
    out[x] = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
  }
}

// The 16 threads of a block position hold its 16 rows (thread t: row t,
// in v).  Afterwards thread t holds column t.  The same call turns columns
// back into rows.  `mask`: the lanes that meet at the __syncwarp (the
// whole warp, or the half-warp of the block position).
__device__ __forceinline__ void transpose(float* tile, float (&v)[kB], int t,
                                          unsigned mask = 0xffffffffu) {
  float4* row = reinterpret_cast<float4*>(tile + t * kPad);
#pragma unroll
  for (int c = 0; c < kB / 4; ++c) {
    row[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
  __syncwarp(mask);
#pragma unroll
  for (int k = 0; k < kB; ++k) v[k] = tile[k * kPad + t];
}

__device__ __forceinline__ float clip_round(float x, float maxval) {
  return fminf(fmaxf(rintf(x), 0.f), maxval);
}

// clamp(sign(c) * floor(|c| / qs + dz), -32767, 32767): floor(...) >= 0,
// so it is clamped above and then takes c's sign (a -0 never changes a
// later sum, which starts from +0).  c = 0 gives floor(dz) = 0 without the
// division (launch() takes only 0 <= dz < 1): a zero dividend sends
// __fdiv_rn down its slow path, and exact zeros are common (flat blocks,
// P-frame residuals of static content).
__device__ __forceinline__ float quantize(float c, float qs, float dz) {
  const float a = fabsf(c);
  const float q = __fdiv_rn(a != 0.f ? a : qs, qs);
  const float m = a != 0.f ? floorf(__fadd_rn(q, dz)) : 0.f;
  return copysignf(fminf(m, 32767.f), c);
}

__device__ __forceinline__ void unpack(uint4 lo, uint4 hi, float qs,
                                       float (&v)[kB]) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[2 * i] = __fmul_rn(static_cast<float>(static_cast<int16_t>(w[i])), qs);
    v[2 * i + 1] =
        __fmul_rn(static_cast<float>(static_cast<int16_t>(w[i] >> 16)), qs);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (static_cast<uint32_t>(__float2int_rn(a)) & 0xffffu) |
         (static_cast<uint32_t>(__float2int_rn(b)) << 16);
}

}  // namespace
