// The grid geometry-smoothing filter (the decoder's smoothPointCloud
// post-processing, SEI method 1), for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's grid_smooth
// (rabbit_transcoding_tpu/ops/smoothing.py) is XLA code, a scatter-add and
// 27 gathers.  The port ran it as plain PyTorch (ops/smoothing.py:
// grid_smooth, this file's twin): some 330 launches and 30 host-blocking
// copies a batch of clouds.  It computes what the twin computes, bit for
// bit, for every point of a batch of clouds (each cloud its own grid of
// grid_dim^3 cells of grid_size units a side):
//
//   pass 1   per point, its cell c = clamp(floor(p / grid_size), 0,
//            grid_dim - 1) in its cloud's grid; the cell's (sum x, sum y,
//            sum z, count) += (x, y, z, 1), int32 atomics
//   pass 2   per point, the 27 cells around c (clamped at the grid's faces,
//            in the twin's _OFFSETS order) summed; count, centroid = sum /
//            max(count, 1), diff = p - centroid, d2 = fma(dz, dz, fma(dy,
//            dy, dx * dx)); keep = count > min_neighbors; move = keep &
//            eligible & d2 > threshold & count > 4; the new position is
//            rint(centroid) (half to even) where move, else p
//
// Numerics.  The sums are integers: exact in any order, and equal to the
// twin's float32 sums while every 27-cell sum stays below 2^24 (27 cells
// of 512 distinct points at grid size 8 and 10-bit coordinates reach
// 1.4e7); int32 holds them to 2^31.  Each float step is the twin's with
// one rounding: __fdiv_rn, __fsub_rn, __fmul_rn and __fmaf_rn (the
// correctly rounded fma that rbv_tools.fma emulates), written out so that
// nvcc contracts nothing.
//
// Design.  One thread a point in both passes; the batch's clouds are a
// table of point offsets passed by value (no per-point cloud index, no
// upload), each cloud's grid following the previous one's.  Pass 2 reads
// each 27-cell neighbourhood as 16-byte cells through the read-only path;
// the neighbours of consecutive points (neighbouring pixels of one patch)
// are mostly the same cells, so they come from L1 and L2.
//
// Bound.  Bytes.  The function reads the points (12 bytes a point) and the
// eligible flags (1) and writes the new positions (12) and both masks (2):
// 27 bytes a point, at the decode cell's batch of 8 x 458,000 points 99 MB,
// 0.030 ms at 3.35 TB/s.  This design moves more: it zeroes the grid
// (groups * grid_dim^3 * 16 bytes, 268 MB for 8 clouds at 128^3) and reads
// the points twice, 0.41 GB or 0.12 ms in all.  The arithmetic is a few
// dozen operations a point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// ops/smoothing.py: _BATCH_CLOUDS, the clouds of a batch
constexpr int kMaxClouds = 8;

// The first point of each cloud of the batch; past the last cloud, the
// number of points (start[groups]) and then INT64_MAX.
struct Clouds {
  int64_t start[kMaxClouds + 1];
};

__device__ __forceinline__ int cloud_of(const Clouds& clouds, int64_t i) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxClouds; ++j) k += i >= clouds.start[j];
  return k;
}

__device__ __forceinline__ int cell_of(int v, int size, int dim) {
  return v < 0 ? 0 : min(v / size, dim - 1);
}

__global__ void __launch_bounds__(kThreads)
grid_sum_kernel(const int* __restrict__ points, int* __restrict__ grid,
                const Clouds clouds, int64_t n, int size, int dim) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
  const int64_t cells = static_cast<int64_t>(dim) * dim * dim;
  const int64_t flat =
      cloud_of(clouds, i) * cells +
      (static_cast<int64_t>(cell_of(x, size, dim)) * dim +
       cell_of(y, size, dim)) * dim + cell_of(z, size, dim);
  int* cell = grid + 4 * flat;
  atomicAdd(cell, x);
  atomicAdd(cell + 1, y);
  atomicAdd(cell + 2, z);
  atomicAdd(cell + 3, 1);
}

__global__ void __launch_bounds__(kThreads)
grid_filter_kernel(const int* __restrict__ points,
                   const uint8_t* __restrict__ eligible,
                   const int4* __restrict__ grid, int* __restrict__ out,
                   uint8_t* __restrict__ keep, uint8_t* __restrict__ move,
                   const Clouds clouds, int64_t n, int size, int dim,
                   float threshold, float min_neighbors) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
  const int c[3] = {cell_of(p[0], size, dim), cell_of(p[1], size, dim),
                    cell_of(p[2], size, dim)};
  const int4* cloud =
      grid + cloud_of(clouds, i) * static_cast<int64_t>(dim) * dim * dim;
  int sx = 0, sy = 0, sz = 0, count = 0;
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = min(max(c[0] + dx, 0), dim - 1);
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = min(max(c[1] + dy, 0), dim - 1);
      const int4* row = cloud + (static_cast<int64_t>(nx) * dim + ny) * dim;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const int4 s = __ldg(row + min(max(c[2] + dz, 0), dim - 1));
        sx += s.x;
        sy += s.y;
        sz += s.z;
        count += s.w;
      }
    }
  }
  const float cnt = static_cast<float>(count);
  const float div = fmaxf(cnt, 1.f);
  const float cx = __fdiv_rn(static_cast<float>(sx), div);
  const float cy = __fdiv_rn(static_cast<float>(sy), div);
  const float cz = __fdiv_rn(static_cast<float>(sz), div);
  const float dx = __fsub_rn(static_cast<float>(p[0]), cx);
  const float dy = __fsub_rn(static_cast<float>(p[1]), cy);
  const float dz = __fsub_rn(static_cast<float>(p[2]), cz);
  const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
  const bool kept = cnt > min_neighbors;
  const bool moved = kept && eligible[i] && d2 > threshold && cnt > 4.f;
  out[3 * i] = moved ? __float2int_rn(cx) : p[0];
  out[3 * i + 1] = moved ? __float2int_rn(cy) : p[1];
  out[3 * i + 2] = moved ? __float2int_rn(cz) : p[2];
  keep[i] = kept;
  move[i] = moved;
}

}  // namespace

// points: int32 (n, 3); eligible, keep, move: bool (n,) as bytes; out:
// int32 (n, 3); grid: int32 scratch of groups * grid_dim^3 * 4, 16-byte
// aligned, zeroed here; starts: host int64 (groups + 1,), the first point
// of each cloud and n last.  Every pointer but `starts` lives on CUDA
// device `device`.  Selects `device` for the launches and restores the
// caller's current device; launches on `stream` (a memset and two
// kernels) and returns the cudaError_t (cudaErrorInvalidValue for groups
// outside [1, 8] or a table that is not ascending from 0 to n); never
// synchronises.
extern "C" int rbv_grid_smooth(const void* points, const void* eligible,
                               void* grid, void* out, void* keep, void* move,
                               const int64_t* starts, int groups, int64_t n,
                               int grid_size, int grid_dim, float threshold,
                               float min_neighbors, int device, void* stream) {
  if (groups < 1 || groups > kMaxClouds || n < 0 || grid_size < 1 ||
      grid_dim < 1 || grid_dim > 1024 || starts[0] != 0 ||
      starts[groups] != n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Clouds clouds;
  for (int j = 0; j <= kMaxClouds; ++j) {
    clouds.start[j] = j <= groups ? starts[j] : INT64_MAX;
    if (j && j <= groups && starts[j] < starts[j - 1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (reinterpret_cast<uintptr_t>(grid) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t cells = static_cast<int64_t>(grid_dim) * grid_dim * grid_dim;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(grid, 0, groups * cells * 16, s);
  if (err == cudaSuccess && n > 0) {
    grid_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(points), static_cast<int*>(grid), clouds, n,
        grid_size, grid_dim);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && n > 0) {
    grid_filter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(points),
        static_cast<const uint8_t*>(eligible),
        static_cast<const int4*>(grid), static_cast<int*>(out),
        static_cast<uint8_t*>(keep), static_cast<uint8_t*>(move), clouds, n,
        grid_size, grid_dim, threshold, min_neighbors);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}
