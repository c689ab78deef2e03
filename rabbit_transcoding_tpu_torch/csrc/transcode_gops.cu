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
// launch per plane for the whole group).  Grid (n_blocks, S): each CTA reads
// its stream's steps once and runs the single-stream body unchanged, so the
// output equals S single-stream launches bit for bit.
//
// Design.  Without motion compensation or deblocking, every 16x16 block
// position is independent across the whole frame sequence, so the TPU's
// schedule (one program per (GOP, block row) with the row resident in
// VMEM) is not carried over.  Instead: one CTA per block position, 256
// threads, one per pixel; a loop over frames keeps the decode recon and the
// closed-loop encode recon in registers.  Each thread keeps the four
// 16-vectors of D its dot products need in registers, and the separable
// transforms pass through one 16x16 fp32 tile in shared memory (rows of 16
// floats: the row and column reads below are bank-conflict free).
//
// Bound: not device memory.  Each coefficient crosses it once each way
// (4 bytes), 128 MiB for a 1024x1024x32-frame plane, ~40 us at 3.35 TB/s.
// The ~80 FMAs per pixel and frame (two 16-term products per transform,
// 2.5 transforms per frame at GOP 2) each read one operand from shared
// memory: ~84 M warp-wide shared loads per such plane, ~0.32 ms at one per
// clock per SM on 132 SMs.  The kernel takes ~0.54 ms there on an H100, so
// shared-memory load issue bounds it.  The D vectors live in registers
// (one shared load per FMA instead of two) and the next frame's
// coefficient is loaded one iteration ahead.  Register-blocked products or
// wgmma are later work.
//
// Numerics follow the reference: fp32 throughout, rintf (round half to
// even), a true IEEE division |c| / qs (never the reciprocal), no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 16;
constexpr int kThreads = kB * kB;

// The 16-term sums run in the reference's order (see ops/dct.py): four
// FMA partial sums over k = 0, 1, 2, 3 (mod 4), combined as
// (s0 + s1) + (s2 + s3).  The four chains are independent, which also
// hides the FMA latency.

// out[i][j] = sum_k a[k] * tile[k][j]
__device__ __forceinline__ float left_product(float (*tile)[kB],
                                              const float* a, int j) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kB; ++k) s[k % 4] = fmaf(a[k], tile[k][j], s[k % 4]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// out[i][j] = sum_k tile[i][k] * a[k]
__device__ __forceinline__ float right_product(float (*tile)[kB],
                                               const float* a, int i) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kB; ++k) s[k % 4] = fmaf(tile[i][k], a[k], s[k % 4]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Separable transform of the CTA's block, left product with `first`, then
// right product with `second`.  Every thread passes in its own element and
// gets its own element of the result back.
__device__ __forceinline__ float transform2(float (*tile)[kB], float v,
                                            const float* first,
                                            const float* second, int i,
                                            int j) {
  tile[i][j] = v;
  __syncthreads();
  const float t = left_product(tile, first, j);
  __syncthreads();
  tile[i][j] = t;
  __syncthreads();
  const float out = right_product(tile, second, i);
  __syncthreads();
  return out;
}

__device__ __forceinline__ float clip_round(float x, float maxval) {
  return fminf(fmaxf(rintf(x), 0.f), maxval);
}

__device__ __forceinline__ float quantize(float c, float qs, float dz) {
  const float s = (c > 0.f) ? 1.f : ((c < 0.f) ? -1.f : 0.f);
  const float v = s * floorf(__fadd_rn(__fdiv_rn(fabsf(c), qs), dz));
  return fminf(fmaxf(v, -32767.f), 32767.f);
}

// qs_in_s / qs_out_s: per-stream steps (S,) in device memory, or null for
// one stream at the scalar steps qs_in / qs_out.
__global__ void __launch_bounds__(kThreads)
transcode_gops_kernel(const int16_t* __restrict__ in,
                      int16_t* __restrict__ out,
                      const float* __restrict__ dmat, int frames,
                      int n_blocks, int gop_in, int gop_out,
                      const float* __restrict__ qs_in_s,
                      const float* __restrict__ qs_out_s, float qs_in,
                      float qs_out, float maxval, float dz_intra,
                      float dz_inter) {
  __shared__ float tile[kB][kB];
  if (qs_in_s != nullptr) {
    qs_in = qs_in_s[blockIdx.y];
    qs_out = qs_out_s[blockIdx.y];
  }
  const int i = threadIdx.x / kB;
  const int j = threadIdx.x % kB;
  // IDCT = D^T C D: left with column i of D, right with column j.
  // DCT  = D X D^T: left with row i of D, right with row j.
  float col_i[kB], col_j[kB], row_i[kB], row_j[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    col_i[k] = dmat[k * kB + i];
    col_j[k] = dmat[k * kB + j];
    row_i[k] = dmat[i * kB + k];
    row_j[k] = dmat[j * kB + k];
  }
  const int64_t frame_stride = static_cast<int64_t>(n_blocks) * kThreads;
  int64_t off = static_cast<int64_t>(blockIdx.y) * frames * frame_stride +
                static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float dec_prev = 0.f;
  float enc_prev = 0.f;
  int16_t next = in[off];
  for (int f = 0; f < frames; ++f, off += frame_stride) {
    const int16_t cur = next;
    if (f + 1 < frames) next = in[off + frame_stride];
    // decode at qs_in and rebuild the input's I/P chain
    const bool dec_intra = (f % gop_in) == 0;
    const float res = transform2(tile, static_cast<float>(cur) * qs_in,
                                 col_i, col_j, i, j);
    const float pix = clip_round(dec_intra ? res : dec_prev + res, maxval);
    dec_prev = pix;
    // re-encode at qs_out against the closed-loop recon
    const bool enc_intra = (f % gop_out) == 0;
    const float target = enc_intra ? pix : pix - enc_prev;
    const float y = transform2(tile, target, row_i, row_j, i, j);
    const float q = quantize(y, qs_out, enc_intra ? dz_intra : dz_inter);
    out[off] = static_cast<int16_t>(__float2int_rn(q));
    // the next frame predicts from this recon only inside the output GOP
    if ((f + 1) % gop_out != 0 && f + 1 < frames) {
      const float r = transform2(tile, q * qs_out, col_i, col_j, i, j);
      enc_prev = clip_round(enc_intra ? r : enc_prev + r, maxval);
    }
  }
}

}  // namespace

namespace {

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
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) {
    err = cudaSetDevice(device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  transcode_gops_kernel<<<dim3(n_blocks, streams), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out),
      static_cast<const float*>(dmat), frames, n_blocks, gop_in, gop_out,
      qs_in_s, qs_out_s, qs_in, qs_out, maxval, dz_intra, dz_inter);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) {
      err = restore;
    }
  }
  return static_cast<int>(err);
}

}  // namespace

// in/out: int16 (frames, n_blocks, 16, 16) contiguous; dmat: float32 (16, 16)
// orthonormal DCT-II matrix; all three and `stream` live on CUDA device
// `device`.  This library links its own CUDA runtime, so it selects
// `device` for the launch itself and then restores the thread's current
// device (which the caller's runtime shares).  Launches on `stream` and
// returns the cudaError_t (0 on success); never synchronises.
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
