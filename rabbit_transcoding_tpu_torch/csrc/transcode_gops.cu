// Fused RBV GOP transcode for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel rabbit_transcoding_tpu/ops/pallas_transcode.py
// (transcode_gops_pallas, body _make_kernel) and computes what the
// reference's rbv._transcode_impl_fused computes without deblocking or a
// coefficient threshold:
//
//   decode chain (GOP gop_in):  pix_f = clip(rint([prev +] IDCT(c_f * qs_in)), 0, maxval)
//   encode chain (GOP gop_out): q_f   = quant(DCT(pix_f [- rec_{f-1}]), qs_out, dz)
//                               rec_f = clip(rint([rec_{f-1} +] IDCT(q_f * qs_out)), 0, maxval)
//   quant(c) = clamp(sign(c) * floor(|c| / qs + dz), -32767, 32767),
//   dz = 0.5 on I frames, 1/3 on P frames; IDCT = D^T C D, DCT = D X D^T.
//
// Any (gop_in, gop_out): the decode chain restarts at f % gop_in == 0 and
// the encode chain at f % gop_out == 0.
//
// Streams.  The batched entry point takes S streams of one shape stacked on
// a leading axis, (S, frames, n_blocks, 16, 16), with one (qs_in, qs_out)
// pair per stream in device memory (the batched multi-stream transcode, one
// launch per plane for the whole group).  Grid y is the stream: each CTA
// reads its stream's steps once and runs the single-stream body unchanged,
// so the output equals S single-stream launches bit for bit.
//
// Numerics (the reference's CPU order, bit for bit): every element of every
// 16-term product sums in four FMA partial sums over k = 0, 1, 2, 3 (mod 4),
// in k order, combined as (s0 + s1) + (s2 + s3); the left product before
// the right one (IDCT: D^T C, then .D; DCT: D X, then .D^T); a true IEEE
// division |c| / qs (__fdiv_rn, never the reciprocal), __fadd_rn for + dz,
// rintf (round half to even), no contraction of the other products and
// sums.  Tensor cores (mma.sync, wgmma, 3xTF32) take TF32 operands and add
// in their own order, so they cannot give these bits: the kernel stays on
// the fp32 CUDA cores.
//
// Bound.  At the main path's luma plane (32 frames of 64x64 blocks, GOP 2
// to GOP 2) there are 80 transforms per block (32 decode IDCTs, 32 DCTs, 16
// closed-loop IDCTs).  Counted densely (2 x 16^3 FMAs each) they are 2.68 G
// FMA, 80 us at the 67 TFLOP/s fp32 peak of an H100 SXM.  But chains of
// equal or opposite coefficients give equal or opposite sums bit for bit,
// so the function needs fewer operations: 213 FLOP per row of a product
// with D^T, 468 per row of one with D, with the sums of the partial sums
// (ops/transcode.py:row_flops), 49 us.  Device memory (each coefficient
// read and written once, 134 MB) takes 40 us at 3.35 TB/s.  So fp32
// arithmetic bounds it.
//
// Design.  The earlier one (a CTA of 256 threads per block position, one
// pixel per thread, one shared-memory load per FMA, ten CTA-wide barriers
// per frame) ran at ~14% of that bound.  Here every FMA takes its D operand
// as an immediate and its data from a register:
// * A thread owns one 16-value row of a block: 16 threads per block
//   position, two block positions per warp, kWarps warps per CTA.  The
//   frame loop keeps both recons (decode and closed-loop) in registers.
// * Work units: both chains restart at every multiple of lcm(gop_in,
//   gop_out), so each block position splits into independent segments of
//   that many frames (16 per block at GOP 2 over 32 frames).  One unit is
//   one block over one segment: 16x the warps of one unit per block, which
//   the card needs to hide latency.
// * D is a table of hexadecimal float literals (dct() in block16.cuh), the
//   float32 bits of ops/dct.py:dct_matrix(16); the cosines are never
//   recomputed here.  Every product is fully unrolled, so each FMA carries
//   its D value as an immediate: no load at all.  (With D as a kernel
//   argument, ptxas loaded each value with an LDC before its FMA, and those
//   loads held the kernel at ~20% of the bound.)
// * A product along the row a thread owns (the right product) is FMAs on
//   registers: 256 with D, 128 with D^T (mul_dt).  The left product
//   contracts over the other index, so the block is transposed first
//   through a per-half-warp shared tile: four 16-byte stores of the
//   thread's row, sixteen 4-byte loads of its column.  Each transform is
//   transpose -> product -> transpose -> product, 8-13 FMAs per
//   shared-memory instruction instead of 1.  Rows of 20
//   floats and a 16-float offset between the two half-warps' tiles keep
//   both the stores and the loads free of bank conflicts.  Two tiles are
//   used in turn, so one __syncwarp per transpose orders them; there is no
//   CTA-wide barrier.
// * Global memory: a row of 16 int16 is two 16-byte loads and two 16-byte
//   stores; the next frame's row is loaded one frame ahead into registers.
// * The ragged edge: a unit past the last one computes on zeros, and a
//   frame past the end of a short last segment recomputes the previous
//   frame's row (nothing is loaded for it); neither stores anything, and
//   both still take part in __syncwarp.  Warps wholly past the last unit
//   return at once.
// What bounds it now: instruction issue.  The frame loop holds 2,011
// instructions: 1,012 FFMA and 32 FMUL (ptxas shares a few more equal
// partial products, e.g. those of D's constant first row, but not the 35
// per row of a product with D^T that row_flops counts as shareable), 352
// FADD (mostly the 3 adds per output that combine the partial sums), the
// IEEE division (~10 instructions per pixel), rounding, clamps,
// conversions and the transposes (96 LDS, 24 STS).  The closed-loop IDCT
// runs every other frame at GOP 2.  Measured on an H100 80GB HBM3 at
// 700 W (apps/kernel_ab.py, chip_smoke.py): ~0.14 ms of device time at the
// main path's luma plane (~0.16 ms around the wrapper call), a third of
// the 49 us bound, 96 registers, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>

#include "block16.cuh"

namespace {

constexpr int kWarps = 2;                     // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kPositions = 2 * kWarps;        // block positions per CTA

// One unit of work is one block position over one segment of seg_len
// frames: both chains restart at every multiple of lcm(gop_in, gop_out), so
// the segments are independent (16 per block position at GOP 2 over 32
// frames), which gives the card 16x more warps than one per block.  Units
// run block-major within a segment, so a warp's two half-warps read
// neighbouring blocks.  Every thread runs seg_len iterations (a unit past
// n_units computes on zeros, a frame past the end on the previous frame's
// row; neither stores), so the warp's __syncwarp calls always match.
// qs_in_s / qs_out_s: per-stream steps (S,) in device memory, or null for
// one stream at the scalar steps qs_in / qs_out.
__global__ void __launch_bounds__(kThreads)
transcode_gops_kernel(const int16_t* __restrict__ in,
                      int16_t* __restrict__ out, int frames, int n_blocks,
                      int64_t n_units, int seg_len, int gop_in, int gop_out,
                      const float* __restrict__ qs_in_s,
                      const float* __restrict__ qs_out_s, float qs_in,
                      float qs_out, float maxval, float dz_intra,
                      float dz_inter) {
  __shared__ __align__(16) float smem[kWarps * kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 15;
  const int half = lane >> 4;
  const int64_t unit0 =
      static_cast<int64_t>(blockIdx.x) * kPositions + 2 * warp;
  if (unit0 >= n_units) return;  // the whole warp is past the edge
  const int64_t unit = unit0 + half;
  const bool in_range = unit < n_units;
  const int64_t block = in_range ? unit % n_blocks : 0;
  const int first = in_range ? static_cast<int>(unit / n_blocks) * seg_len
                             : frames;  // the segment's first frame
  if (qs_in_s != nullptr) {
    qs_in = qs_in_s[blockIdx.y];
    qs_out = qs_out_s[blockIdx.y];
  }
  float* tile_a = smem + warp * kWarpFloats + half * kHalfOff;
  float* tile_b = tile_a + kBufOff;

  const int64_t frame_stride = static_cast<int64_t>(n_blocks) * kB * kB;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.y) * frames + (in_range ? first : 0)) *
          frame_stride +
      block * kB * kB + t * kB;
  const uint4* src = reinterpret_cast<const uint4*>(in + base);
  uint4* dst = reinterpret_cast<uint4*>(out + base);
  const int64_t step = frame_stride / 8;  // uint4 per frame

  uint4 next_lo = make_uint4(0, 0, 0, 0), next_hi = next_lo;
  if (first < frames) {
    next_lo = src[0];
    next_hi = src[1];
  }
  float dec_prev[kB], enc_prev[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) dec_prev[k] = enc_prev[k] = 0.f;

  // f % gop_in and f % gop_out, kept as counters (a segment starts at a
  // multiple of both GOPs)
  int dec_phase = 0, enc_phase = 0;
  for (int f = 0; f < seg_len; ++f, src += step, dst += step) {
    float v[kB], u[kB];
    unpack(next_lo, next_hi, qs_in, v);
    const bool active = first + f < frames;  // this frame exists
    if (first + f + 1 < frames && f + 1 < seg_len) {
      next_lo = src[step];
      next_hi = src[step + 1];
    }
    // decode at qs_in: IDCT of row t, then the input's I/P chain
    transpose(tile_a, v, t);  // column t of C
    mul_dt(v, u);             // column t of D^T C
    transpose(tile_b, u, t);  // row t of D^T C
    mul_dt(u, v);             // row t of D^T C D
    const bool dec_intra = dec_phase == 0;
    const bool enc_intra = enc_phase == 0;
    if (++dec_phase == gop_in) dec_phase = 0;
    if (++enc_phase == gop_out) enc_phase = 0;
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      dec_prev[k] =
          clip_round(dec_intra ? v[k] : __fadd_rn(dec_prev[k], v[k]), maxval);
      v[k] = enc_intra ? dec_prev[k] : __fsub_rn(dec_prev[k], enc_prev[k]);
    }
    // re-encode at qs_out against the closed-loop recon
    transpose(tile_a, v, t);  // column t of X
    mul_d(v, u);              // column t of D X
    transpose(tile_b, u, t);  // row t of D X
    mul_d(u, v);              // row t of D X D^T
    const float dz = enc_intra ? dz_intra : dz_inter;
#pragma unroll
    for (int k = 0; k < kB; ++k) v[k] = quantize(v[k], qs_out, dz);
    if (active) {
      dst[0] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                          pack2(v[4], v[5]), pack2(v[6], v[7]));
      dst[1] = make_uint4(pack2(v[8], v[9]), pack2(v[10], v[11]),
                          pack2(v[12], v[13]), pack2(v[14], v[15]));
    }
    // the next frame predicts from this recon only inside the output GOP
    if (enc_phase != 0 && f + 1 < seg_len) {
#pragma unroll
      for (int k = 0; k < kB; ++k) v[k] = __fmul_rn(v[k], qs_out);
      transpose(tile_a, v, t);
      mul_dt(v, u);
      transpose(tile_b, u, t);
      mul_dt(u, v);
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        enc_prev[k] = clip_round(
            enc_intra ? v[k] : __fadd_rn(enc_prev[k], v[k]), maxval);
      }
    }
  }
}

// The first launch of the process holds the caller's float32 matrix (on
// the device) against the kernel's literals, bit for bit.  The package has
// one DCT matrix (ops/dct.py:dct_tensor(16)), the same on every device.
std::mutex dct_mutex;
bool dct_checked = false;

cudaError_t check_dct(const void* dmat, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(dct_mutex);
  if (!dct_checked) {
    float host[kB * kB];
    cudaError_t err = cudaMemcpyAsync(host, dmat, sizeof(host),
                                      cudaMemcpyDeviceToHost, stream);
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < kB * kB; ++i) {
      const float want = dct(i / kB, i % kB);
      if (std::memcmp(&host[i], &want, sizeof(float)) != 0) {
        return cudaErrorInvalidValue;
      }
    }
    dct_checked = true;
  }
  return cudaSuccess;
}

// Selects `device`, launches on `stream`, restores the caller's device.
int launch(const void* in, void* out, const void* dmat, int streams,
           int frames, int n_blocks, int gop_in, int gop_out,
           const float* qs_in_s, const float* qs_out_s, float qs_in,
           float qs_out, float maxval, float dz_intra, float dz_inter,
           int device, void* stream) {
  if (streams <= 0 || streams > 65535 || frames <= 0 || n_blocks <= 0 ||
      gop_in <= 0 || gop_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // quantize() maps c = 0 to 0, which is floor(dz) only for 0 <= dz < 1
  if (!(dz_intra >= 0.f && dz_intra < 1.f && dz_inter >= 0.f &&
        dz_inter < 1.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // both chains restart every lcm(gop_in, gop_out) frames
  int64_t gcd = gop_in;
  for (int64_t b = gop_out; b != 0;) {
    const int64_t r = gcd % b;
    gcd = b;
    b = r;
  }
  int64_t seg_len = gop_in / gcd * gop_out;
  if (seg_len > frames) seg_len = frames;
  const int64_t n_units =
      static_cast<int64_t>(n_blocks) * ((frames + seg_len - 1) / seg_len);
  if ((n_units + kPositions - 1) / kPositions > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) {
    err = cudaSetDevice(device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = check_dct(dmat, s);
  if (err == cudaSuccess) {
    const dim3 grid(
        static_cast<unsigned>((n_units + kPositions - 1) / kPositions),
        streams);
    transcode_gops_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int16_t*>(in), static_cast<int16_t*>(out), frames,
        n_blocks, n_units, static_cast<int>(seg_len), gop_in, gop_out,
        qs_in_s, qs_out_s, qs_in, qs_out, maxval, dz_intra,
        dz_inter);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) {
      err = restore;
    }
  }
  return static_cast<int>(err);
}

}  // namespace

// in/out: int16 (frames, n_blocks, 16, 16) contiguous and 16-byte aligned;
// dmat: float32 (16, 16) orthonormal DCT-II matrix; all three and `stream`
// live on CUDA device `device`.  This library links its own CUDA runtime,
// so it selects `device` for the launch itself and then restores the
// thread's current device (which the caller's runtime shares).  Launches on
// `stream` and returns the cudaError_t (0 on success; cudaErrorInvalidValue
// for a dead zone outside [0, 1)); never synchronises, except that the
// process's first launch copies dmat to the host.
extern "C" int rbv_transcode_gops(const void* in, void* out, const void* dmat,
                                  int frames, int n_blocks, int gop_in,
                                  int gop_out, float qs_in, float qs_out,
                                  float maxval, float dz_intra,
                                  float dz_inter, int device, void* stream) {
  return launch(in, out, dmat, 1, frames, n_blocks, gop_in, gop_out, nullptr,
                nullptr, qs_in, qs_out, maxval, dz_intra, dz_inter, device,
                stream);
}

// The same for `streams` streams stacked on a leading axis: in/out int16
// (streams, frames, n_blocks, 16, 16) contiguous; qs_in/qs_out float32
// (streams,) on the device, one step pair per stream.
extern "C" int rbv_transcode_gops_batched(
    const void* in, void* out, const void* dmat, int streams, int frames,
    int n_blocks, int gop_in, int gop_out, const void* qs_in,
    const void* qs_out, float maxval, float dz_intra, float dz_inter,
    int device, void* stream) {
  if (qs_in == nullptr || qs_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(in, out, dmat, streams, frames, n_blocks, gop_in, gop_out,
                static_cast<const float*>(qs_in),
                static_cast<const float*>(qs_out), 0.f, 0.f, maxval,
                dz_intra, dz_inter, device, stream);
}

extern "C" const char* rbv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
