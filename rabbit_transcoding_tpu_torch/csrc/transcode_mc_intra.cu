// RBV transcode of streams with motion compensation and intra prediction,
// for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this branch as XLA programs
// (rbv._decode_impl_mc with the intra mosaic, then _reencode_with_mv), and
// the port ran it as its plain PyTorch chains (ops/transcode.py:
// decode_chain + encode_chain with the tools of ops/rbv_tools.py, reached
// through video/rbv.py:transcode_chains): some 4,000 small launches and
// 124 host-blocking copies per GOF.  The plain chains stay as this file's
// twin; it computes what they compute, bit for bit, for 16x16 blocks, no
// deblocking, no coefficient threshold, the output GOP equal to the
// input's (motion vectors are bound to it).  Per GOP of `gop` frames, with
// the stream's motion vectors mv_f and intra mode map:
//
//   decode I   mu = c[0,0] * (qs_in / 16) per block (the mosaic); pred = mu
//              (DC) or the two-tap linear resize of the mosaic (planar), by
//              the mode map; dec_0 = clip(rint((pred + (mu - mean(pred)))
//              + IDCT(c * qs_in, c[0,0] = 0)), 0, maxval)
//   encode I   dc_q = quant(sum(dec_0) / 16, qs_out, 1/2) per block, mu' =
//              dc_q * (qs_out / 16); both predictions from mu'; residual
//              DCT, quant at 1/2, [0,0] = 0; planar only where its
//              rate_proxy is strictly lower; rec_0 as decode I from the
//              chosen q; q[0,0] = dc_q
//   P, k >= 1  dec_k = clip(rint(mc(dec_{k-1}, mv) + IDCT(c * qs_in)));
//              q_k = quant(DCT(dec_k - mc(rec_{k-1}, mv)), qs_out, 1/3);
//              rec_k = clip(rint(mc(rec_{k-1}, mv) + IDCT(q_k * qs_out)))
//              where a later frame of the GOP predicts from it
//
// quant(c) = clamp(sign(c) floor(|c| / qs + dz), +-32767); mc() gathers the
// previous frame at (y + dy, x + dx), both clamped to the padded plane.
//
// Launches.  The encoder's I frame needs its neighbours' mu' (the planar
// resize reaches one block each way), and each P frame's motion gathers
// reach +-6 px into neighbouring blocks of the frame before: so one launch
// per step over every GOP of the call (every stacked stream's too), gop + 1
// launches in all, 3 at GOP 2.  Between launches the decoded and the
// closed-loop planes live in device memory as 16-bit samples (<= maxval,
// exact), two of each at GOP > 2, in turn.
//
// Numerics.  Those of transcode_gops.cu (block16.cuh) for the transforms,
// the quantiser and the rounding, and the plain chains' own orders where
// they fix one: the mosaic's two products and their FMA forms
// (rbv_tools.mosaic_planar; `h_first` and `fused` come from the host), the
// DC block mean as 31 sequential adds of mu then * 8 / 256, the planar
// block mean as one sequential row-major sum of the 256 predictions (the
// chains run under the per-GOP vmap), __fmaf_rn where rbv_tools.fma
// contracts, rate_proxy from the float's exponent (8192 counts as 2^12).
// Sums of integer samples (the encoder's block sums, the rate sums) are
// exact in any order and reduce across the half-warp.
//
// Design.  A half-warp owns one block position of one frame, a thread one
// row, as in transcode_gops.cu: transforms are transpose -> product ->
// transpose -> product through two per-half-warp shared tiles, and every
// barrier is the half-warp's own (__syncwarp of its 16 lanes), so the two
// half-warps of a warp may take different branches (DC or planar, a frame
// past the end).  The planar block mean runs on lane 0 of the half-warp
// from the tile (255 dependent adds, I frames only).
//
// Bound.  Bytes: at a 1024x1024 plane of 32 frames, GOP 2, the int16
// coefficients in and out, the motion vectors and the modes are 135 MB,
// 40 us at 3.35 TB/s (chip_smoke.py's mc_intra_kernel phase reports the
// time against these); the 16-bit planes between launches add 64 MB
// written and ~96 MB read (88 us with them).  The arithmetic is 6
// transforms per block and GOP against transcode_gops.cu's 5, ~59 us at
// the fp32 peak by its count.  Measured on an H100 80GB HBM3 at 700 W:
// ~0.36 ms of device time for that plane, 1.34 ms for four stacked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block16.cuh"

namespace {

constexpr int kHalves = 4;                 // block positions per CTA
constexpr int kThreads = 16 * kHalves;

// Everything a launch reads, and the outputs it writes.
struct Plan {
  const int16_t* q_in;    // (frames, nby, nbx, 16, 16)
  int16_t* q_out;         // the same shape
  uint8_t* mode_out;      // (n_gops, nby, nbx)
  const int32_t* mv;      // (frames, nby, nbx), indices into the 7x7 offsets
  const uint8_t* imode;   // (n_gops, nby, nbx), non-zero = planar
  float* dcq;             // (n_gops, nby, nbx): the encoder's dc_q
  const int4* taps_h;     // (H,): i0, i1, w0, w1 (bits) of the resize over H
  const int4* taps_w;     // (W,): the same over W
  const float* qs_in_f;   // (frames,) steps, or null: qs_in for all
  const float* qs_out_f;
  float qs_in, qs_out, maxval, dz_intra, dz_inter;
  int frames, nby, nbx, gop, n_gops;
  bool h_first, fused;
};

// The unit of a thread: the block position of one GOP that its half-warp
// owns, its row t, its lanes' mask and its two tiles.
struct Unit {
  int64_t g;       // GOP
  int b, by, bx;   // block position
  int t;           // row
  unsigned mask;   // this half-warp's lanes
  float* tile_a;
  float* tile_b;
};

__device__ __forceinline__ bool unit_of(const Plan& p, float* smem, Unit& u) {
  const int half = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;
  const int64_t nb = static_cast<int64_t>(p.nby) * p.nbx;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kHalves + half;
  if (unit >= p.n_gops * nb) return false;
  u.g = unit / nb;
  u.b = static_cast<int>(unit % nb);
  u.by = u.b / p.nbx;
  u.bx = u.b % p.nbx;
  u.t = threadIdx.x & 15;
  u.mask = 0xffffu << (lane & 16);
  u.tile_a = smem + (threadIdx.x >> 5) * kWarpFloats + (lane >> 4) * kHalfOff;
  u.tile_b = u.tile_a + kBufOff;
  return true;
}

__device__ __forceinline__ float step(const float* per_frame, float all,
                                      int64_t f) {
  return per_frame != nullptr ? per_frame[f] : all;
}

// v: row t of C -> row t of D^T C D
__device__ __forceinline__ void idct_rows(const Unit& u, float (&v)[kB]) {
  float w[kB];
  transpose(u.tile_a, v, u.t, u.mask);
  mul_dt(v, w);
  transpose(u.tile_b, w, u.t, u.mask);
  mul_dt(w, v);
}

// v: row t of X -> row t of D X D^T
__device__ __forceinline__ void dct_rows(const Unit& u, float (&v)[kB]) {
  float w[kB];
  transpose(u.tile_a, v, u.t, u.mask);
  mul_d(v, w);
  transpose(u.tile_b, w, u.t, u.mask);
  mul_d(w, v);
}

__device__ __forceinline__ float half_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o, 16);
  return x;
}

__device__ __forceinline__ int half_sum(int x, unsigned mask) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o, 16);
  return x;
}

// --- int16 coefficient rows and 16-bit sample rows -------------------------
__device__ __forceinline__ int64_t block_base(const Plan& p, int64_t f,
                                              int b) {
  return (f * p.nby * p.nbx + b) * kB * kB;
}

// 16 integer values (int16 coefficients or 16-bit samples) -> 32 bytes at
// `at`, 16-byte aligned
__device__ __forceinline__ void store_row(void* at, const float (&v)[kB]) {
  uint4* dst = static_cast<uint4*>(at);
  dst[0] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                      pack2(v[4], v[5]), pack2(v[6], v[7]));
  dst[1] = make_uint4(pack2(v[8], v[9]), pack2(v[10], v[11]),
                      pack2(v[12], v[13]), pack2(v[14], v[15]));
}

__device__ __forceinline__ void load_coeffs(const int16_t* q, int64_t base,
                                            int t, float qs,
                                            float (&v)[kB]) {
  const uint4* src = reinterpret_cast<const uint4*>(q + base + t * kB);
  unpack(__ldg(src), __ldg(src + 1), qs, v);
}

// Row t of the unit's block in the plane of its GOP: (n_gops, H, W) 16-bit
// samples, H = nby * 16, W = nbx * 16.
template <typename T>
__device__ __forceinline__ T* sample_row(const Plan& p, T* planes,
                                         const Unit& u) {
  const int64_t w = static_cast<int64_t>(p.nbx) * kB;
  return planes + ((u.g * p.nby + u.by) * kB + u.t) * w + u.bx * kB;
}

__device__ __forceinline__ void load_samples(const uint16_t* at,
                                             float (&v)[kB]) {
  const uint4* src = reinterpret_cast<const uint4*>(at);
  const uint4 lo = __ldg(src), hi = __ldg(src + 1);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[2 * i] = static_cast<float>(w[i] & 0xffffu);
    v[2 * i + 1] = static_cast<float>(w[i] >> 16);
  }
}

// rbv_tools.mc_predict on row t: the previous plane at (y + dy, x + dx),
// each clamped to the plane.  dx is even, so an unclamped row is eight
// aligned 4-byte loads.
__device__ __forceinline__ void gather(const Plan& p, const uint16_t* planes,
                                       const Unit& u, int dy, int dx,
                                       float (&v)[kB]) {
  const int h = p.nby * kB, w = p.nbx * kB;
  const int y = min(max(u.by * kB + u.t + dy, 0), h - 1);
  const int x0 = u.bx * kB + dx;
  const uint16_t* row = planes + (u.g * h + y) * w;
  if (x0 >= 0 && x0 + kB <= w) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(row + x0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t pair = __ldg(src + i);
      v[2 * i] = static_cast<float>(pair & 0xffffu);
      v[2 * i + 1] = static_cast<float>(pair >> 16);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      v[j] = static_cast<float>(__ldg(row + min(max(x0 + j, 0), w - 1)));
    }
  }
}

// --- the intra mosaic -------------------------------------------------------
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap tap(const int4* taps, int o) {
  const int4 v = __ldg(taps + o);
  return {v.x, v.y, __int_as_float(v.z), __int_as_float(v.w)};
}

// a, b, c by i = 0, 1, 2 (a mosaic index relative to the block's, + 1)
__device__ __forceinline__ float sel3(float a, float b, float c, int i) {
  return i <= 0 ? a : (i == 1 ? b : c);
}

// The mosaic around block (by, bx), m[r][c] at (by + r - 1, bx + c - 1),
// clamped at the edges (the resize's taps never reach a clamped entry):
// scale(c[0,0] or dc_q) * a.
template <typename Load>
__device__ __forceinline__ void mosaic(const Plan& p, const Unit& u,
                                       Load load, float a,
                                       float (&m)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int y = min(max(u.by + r - 1, 0), p.nby - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int x = min(max(u.bx + c - 1, 0), p.nbx - 1);
      m[r][c] = __fmul_rn(load(y * p.nbx + x), a);
    }
  }
}

// rbv_tools.mosaic_planar on row t of the block: two two-tap products, the
// first an FMA chain fma(a1, w1, a0 * w0), the second that chain (`fused`)
// or the sum of the two rounded products.
__device__ __forceinline__ void planar_row(const Plan& p, const Unit& u,
                                           const float (&m)[3][3],
                                           float (&out)[kB]) {
  const Tap th = tap(p.taps_h, u.by * kB + u.t);
  const int r0 = th.i0 - u.by + 1, r1 = th.i1 - u.by + 1;
  float row0[3], row1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    row0[c] = sel3(m[0][c], m[1][c], m[2][c], r0);
    row1[c] = sel3(m[0][c], m[1][c], m[2][c], r1);
  }
  if (p.h_first) {
    float col[3];  // the first product (over H) at row y, columns bx-1..bx+1
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[c] = __fmaf_rn(row1[c], th.w1, __fmul_rn(row0[c], th.w0));
    }
#pragma unroll
    for (int x = 0; x < kB; ++x) {
      const Tap tw = tap(p.taps_w, u.bx * kB + x);
      const float lo =
          __fmul_rn(sel3(col[0], col[1], col[2], tw.i0 - u.bx + 1), tw.w0);
      const float hi = sel3(col[0], col[1], col[2], tw.i1 - u.bx + 1);
      out[x] = p.fused ? __fmaf_rn(hi, tw.w1, lo)
                       : __fadd_rn(lo, __fmul_rn(hi, tw.w1));
    }
  } else {
#pragma unroll
    for (int x = 0; x < kB; ++x) {
      const Tap tw = tap(p.taps_w, u.bx * kB + x);
      const int c0 = tw.i0 - u.bx + 1, c1 = tw.i1 - u.bx + 1;
      // the first product (over W) at rows i0 and i1 of the taps over H
      const float t0 =
          __fmaf_rn(sel3(row0[0], row0[1], row0[2], c1), tw.w1,
                    __fmul_rn(sel3(row0[0], row0[1], row0[2], c0), tw.w0));
      const float t1 =
          __fmaf_rn(sel3(row1[0], row1[1], row1[2], c1), tw.w1,
                    __fmul_rn(sel3(row1[0], row1[1], row1[2], c0), tw.w0));
      const float lo = __fmul_rn(t0, th.w0);
      out[x] = p.fused ? __fmaf_rn(t1, th.w1, lo)
                       : __fadd_rn(lo, __fmul_rn(t1, th.w1));
    }
  }
}

// The mean of a DC block's prediction: 8 lanes of 32 adds of mu, reduced
// by exact doublings (rbv_tools._prediction_means).
__device__ __forceinline__ float dc_mean(float mu) {
  float acc = mu;
#pragma unroll
  for (int i = 0; i < kB * kB / 8 - 1; ++i) acc = __fadd_rn(acc, mu);
  return __fdiv_rn(__fmul_rn(acc, 8.f), 256.f);
}

// The mean of a planar block's prediction (row t in `pl`): one sequential
// sum in row-major order, on lane 0 of the half-warp.
__device__ __forceinline__ float planar_mean(const Unit& u,
                                             const float (&pl)[kB]) {
  __syncwarp(u.mask);
  float4* row = reinterpret_cast<float4*>(u.tile_a + u.t * kPad);
#pragma unroll
  for (int c = 0; c < kB / 4; ++c) {
    row[c] = make_float4(pl[4 * c], pl[4 * c + 1], pl[4 * c + 2],
                         pl[4 * c + 3]);
  }
  __syncwarp(u.mask);
  float s = 0.f;
  if (u.t == 0) {
    s = u.tile_a[0];
#pragma unroll 16
    for (int i = 1; i < kB * kB; ++i) {
      s = __fadd_rn(s, u.tile_a[(i >> 4) * kPad + (i & 15)]);
    }
  }
  s = __shfl_sync(u.mask, s, 0, 16);
  __syncwarp(u.mask);
  return __fdiv_rn(s, 256.f);
}

// rbv_tools.rate_proxy's bits of one quantised value: 2 floor(log2 |q|) + 3
// for a non-zero, with XLA's floor(log2) of 12 at 8192 and 14 at 32768.
__device__ __forceinline__ int rate_bits(float q) {
  const float a = fabsf(q);
  if (a == 0.f) return 0;
  int e = static_cast<int>((__float_as_uint(a) >> 23) & 0xffu) - 127;
  if (a == 8192.f || a == 32768.f) e -= 1;
  return 2 * e + 3;
}

// --- the launches -----------------------------------------------------------
// 1. Decode each GOP's I frame (dec_0) and the encoder's dc_q of it.
__global__ void __launch_bounds__(kThreads)
intra_decode_kernel(Plan p, uint16_t* __restrict__ dec) {
  __shared__ __align__(16) float smem[kThreads / 32 * kWarpFloats];
  Unit u;
  if (!unit_of(p, smem, u)) return;
  const int64_t f0 = u.g * p.gop;
  const float qs_in = step(p.qs_in_f, p.qs_in, f0);
  const float qs_out = step(p.qs_out_f, p.qs_out, f0);
  const int64_t frame = block_base(p, f0, 0);
  float m[3][3];
  mosaic(p, u, [&](int b) {
    return static_cast<float>(p.q_in[frame + int64_t{b} * kB * kB]);
  }, __fdiv_rn(qs_in, 16.f), m);
  const float mu = m[1][1];
  const bool planar = p.imode[u.g * p.nby * p.nbx + u.b] != 0;
  float pl[kB];
  float mean;
  if (planar) {
    planar_row(p, u, m, pl);
    mean = planar_mean(u, pl);
  } else {
    mean = dc_mean(mu);
  }
  const float corr = __fsub_rn(mu, mean);
  float v[kB];
  load_coeffs(p.q_in, block_base(p, f0, u.b), u.t, qs_in, v);
  if (u.t == 0) v[0] = 0.f;  // the DC is rebuilt from the mosaic
  idct_rows(u, v);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    v[j] = clip_round(__fadd_rn(__fadd_rn(planar ? pl[j] : mu, corr), v[j]),
                      p.maxval);
    sum += v[j];  // integers: exact in any order
  }
  store_row(sample_row(p, dec, u), v);
  sum = half_sum(sum, u.mask);
  if (u.t == 0) {
    // block_means(dec_0) * 16 = sum / 16, exact
    p.dcq[u.g * p.nby * p.nbx + u.b] =
        quantize(__fmul_rn(sum, 0.0625f), qs_out, p.dz_intra);
  }
}

// 2. Re-code each I frame through the mosaic predictors; the closed-loop
// recon (rec_0) where a P frame follows.
__global__ void __launch_bounds__(kThreads)
intra_encode_kernel(Plan p, const uint16_t* __restrict__ dec,
                    uint16_t* __restrict__ rec) {
  __shared__ __align__(16) float smem[kThreads / 32 * kWarpFloats];
  Unit u;
  if (!unit_of(p, smem, u)) return;
  const int64_t f0 = u.g * p.gop;
  const float qs_out = step(p.qs_out_f, p.qs_out, f0);
  const float* dcq = p.dcq + u.g * p.nby * p.nbx;
  float m[3][3];
  mosaic(p, u, [&](int b) { return dcq[b]; }, __fdiv_rn(qs_out, 16.f), m);
  const float mu = m[1][1];
  float x[kB], pl[kB], cd[kB], cp[kB];
  load_samples(sample_row(p, dec, u), x);
  planar_row(p, u, m, pl);
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    cd[j] = __fsub_rn(x[j], mu);
    cp[j] = __fsub_rn(x[j], pl[j]);
  }
  dct_rows(u, cd);
  dct_rows(u, cp);
  int bits_dc = 0, bits_pl = 0;
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    cd[j] = quantize(cd[j], qs_out, p.dz_intra);
    cp[j] = quantize(cp[j], qs_out, p.dz_intra);
  }
  if (u.t == 0) cd[0] = cp[0] = 0.f;  // the residual DC is never coded
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    bits_dc += rate_bits(cd[j]);
    bits_pl += rate_bits(cp[j]);
  }
  const bool planar =
      half_sum(bits_pl, u.mask) < half_sum(bits_dc, u.mask);
  float q[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) q[j] = planar ? cp[j] : cd[j];
  if (p.gop > 1) {
    const float corr = __fsub_rn(mu, planar ? planar_mean(u, pl)
                                            : dc_mean(mu));
    float v[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) v[j] = __fmul_rn(q[j], qs_out);
    idct_rows(u, v);
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      v[j] = clip_round(
          __fadd_rn(__fadd_rn(planar ? pl[j] : mu, corr), v[j]), p.maxval);
    }
    store_row(sample_row(p, rec, u), v);
  }
  if (u.t == 0) {
    q[0] = dcq[u.b];
    p.mode_out[u.g * p.nby * p.nbx + u.b] = planar;
  }
  store_row(p.q_out + block_base(p, f0, u.b) + u.t * kB, q);
}

// 3. P frame k of every GOP: decode it against dec_{k-1}, re-code it against
// rec_{k-1}, both moved by the frame's motion vectors.
__global__ void __launch_bounds__(kThreads)
inter_kernel(Plan p, int k, const uint16_t* __restrict__ dec_prev,
             const uint16_t* __restrict__ rec_prev,
             uint16_t* __restrict__ dec_next,
             uint16_t* __restrict__ rec_next) {
  __shared__ __align__(16) float smem[kThreads / 32 * kWarpFloats];
  Unit u;
  if (!unit_of(p, smem, u)) return;
  const int64_t f = u.g * p.gop + k;
  if (f >= p.frames) return;  // past a ragged last GOP: never output
  const float qs_in = step(p.qs_in_f, p.qs_in, f);
  const float qs_out = step(p.qs_out_f, p.qs_out, f);
  const int mv = p.mv[f * p.nby * p.nbx + u.b];
  const int dy = (mv / 7) * 2 - 6, dx = (mv % 7) * 2 - 6;  // MC_OFFSETS
  float pd[kB], pe[kB], v[kB];
  gather(p, dec_prev, u, dy, dx, pd);
  gather(p, rec_prev, u, dy, dx, pe);
  const int64_t base = block_base(p, f, u.b);
  load_coeffs(p.q_in, base, u.t, qs_in, v);
  idct_rows(u, v);
  const bool more = k + 1 < p.gop && f + 1 < p.frames;
#pragma unroll
  for (int j = 0; j < kB; ++j) v[j] = clip_round(__fadd_rn(pd[j], v[j]),
                                                 p.maxval);
  if (more) store_row(sample_row(p, dec_next, u), v);
#pragma unroll
  for (int j = 0; j < kB; ++j) v[j] = __fsub_rn(v[j], pe[j]);
  dct_rows(u, v);
#pragma unroll
  for (int j = 0; j < kB; ++j) v[j] = quantize(v[j], qs_out, p.dz_inter);
  store_row(p.q_out + base + u.t * kB, v);
  if (more) {
#pragma unroll
    for (int j = 0; j < kB; ++j) v[j] = __fmul_rn(v[j], qs_out);
    idct_rows(u, v);
#pragma unroll
    for (int j = 0; j < kB; ++j) v[j] = clip_round(__fadd_rn(pe[j], v[j]),
                                                   p.maxval);
    store_row(sample_row(p, rec_next, u), v);
  }
}

}  // namespace

// q_in/q_out: int16 (frames, nby, nbx, 16, 16); mode_out, imode: uint8
// (n_gops, nby, nbx), n_gops = ceil(frames / gop); mv: int32 (frames, nby,
// nbx); dcq: float32 (n_gops, nby, nbx) scratch; planes: 16-bit (2 or, at
// gop > 2, 4, n_gops, nby * 16, nbx * 16) scratch (dec, rec, then the
// second pair); taps_h/taps_w: int32 (nby * 16, 4) / (nbx * 16, 4), each
// sample's i0, i1 and the float32 bits of w0, w1; qs_in_f/qs_out_f: float32
// (frames,) steps or null for qs_in/qs_out.  Everything contiguous, 16-byte
// aligned and on CUDA device `device`.  Selects `device`, makes gop + 1
// launches on `stream`, restores the caller's device; never synchronises.
// Returns the cudaError_t (cudaErrorInvalidValue for arguments it refuses).
extern "C" int rbv_transcode_mc_intra(
    const void* q_in, void* q_out, void* mode_out, const void* mv,
    const void* imode, void* dcq, void* planes, const void* taps_h,
    const void* taps_w, int frames, int nby, int nbx, int gop, int h_first,
    int fused, const void* qs_in_f, const void* qs_out_f, float qs_in,
    float qs_out, float maxval, float dz_intra, float dz_inter, int device,
    void* stream) {
  if (frames <= 0 || nby <= 0 || nbx <= 0 || gop <= 0 ||
      static_cast<int64_t>(nby) * kB * nbx * kB > 0x7fffffff ||
      !(dz_intra >= 0.f && dz_intra < 1.f && dz_inter >= 0.f &&
        dz_inter < 1.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(q_in) | reinterpret_cast<uintptr_t>(q_out) |
       reinterpret_cast<uintptr_t>(planes)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Plan p;
  p.q_in = static_cast<const int16_t*>(q_in);
  p.q_out = static_cast<int16_t*>(q_out);
  p.mode_out = static_cast<uint8_t*>(mode_out);
  p.mv = static_cast<const int32_t*>(mv);
  p.imode = static_cast<const uint8_t*>(imode);
  p.dcq = static_cast<float*>(dcq);
  p.taps_h = static_cast<const int4*>(taps_h);
  p.taps_w = static_cast<const int4*>(taps_w);
  p.qs_in_f = static_cast<const float*>(qs_in_f);
  p.qs_out_f = static_cast<const float*>(qs_out_f);
  p.qs_in = qs_in;
  p.qs_out = qs_out;
  p.maxval = maxval;
  p.dz_intra = dz_intra;
  p.dz_inter = dz_inter;
  p.frames = frames;
  p.nby = nby;
  p.nbx = nbx;
  p.gop = gop;
  p.n_gops = (frames + gop - 1) / gop;
  p.h_first = h_first != 0;
  p.fused = fused != 0;
  const int64_t n_units = static_cast<int64_t>(p.n_gops) * nby * nbx;
  if ((n_units + kHalves - 1) / kHalves > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n_units + kHalves - 1) / kHalves));
  const int64_t plane = static_cast<int64_t>(p.n_gops) * nby * kB * nbx * kB;
  uint16_t* buf = static_cast<uint16_t*>(planes);
  // dec and rec of frame k - 1 in pair (k - 1) % 2, of frame k in k % 2
  uint16_t* dec[2] = {buf, buf + 2 * plane};
  uint16_t* rec[2] = {buf + plane, buf + 3 * plane};

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  intra_decode_kernel<<<grid, kThreads, 0, s>>>(p, dec[0]);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    intra_encode_kernel<<<grid, kThreads, 0, s>>>(p, dec[0], rec[0]);
    err = cudaGetLastError();
  }
  for (int k = 1; k < gop && err == cudaSuccess; ++k) {
    inter_kernel<<<grid, kThreads, 0, s>>>(p, k, dec[(k - 1) % 2],
                                           rec[(k - 1) % 2], dec[k % 2],
                                           rec[k % 2]);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}
