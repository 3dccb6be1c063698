// K3: nearest-neighbour squared distances for the Chamfer metric, sm_90a.
//
// Replaces the Pallas TPU kernel im23d_tpu/metrics/chamfer.py _nn_kernel:
// rows[b, n] = min_m d(n, m), d = dz^2 + dy^2 + dx^2 with (dz, dy, dx) =
// y[b, m] - x[b, n], points (z, y, x).  One kernel, two modes: rows only
// (nn_dist2), or both directions (chamfer_distance), where every pair is
// evaluated once and also updates cols[b, m] = min_n d(n, m).  The square
// of x - y equals that of y - x bit for bit, so both outputs are the
// values of the one-thread-a-point kernel this replaced, launched once
// each way.
//
// The direct difference form is kept on purpose.  The expanded form
// |x|^2 + |y|^2 - 2 x.y could run on the tensor cores, but it cancels: at
// these clouds' nearest-neighbour distances (d ~ 1e-4 to 1e-3) its float32
// error of ~1e-7 |x|^2 is a ~1e-4 relative error (the JAX XLA path takes
// that form and needs max(., 0), im23d_tpu/metrics/chamfer.py:50), and
// TF32 keeps far fewer digits still.
//
// What bounds it on the H100: FP32 issue.  A pair costs 3 subtractions,
// 1 product, 2 FMAs and 2 mins (the row's and the column's): 8 issue
// slots, 24 x 8000 x 2048 x 8 / (132 x 128 lanes x 1.98 GHz) = 0.095 ms
// at the real-data eval's shape (7 with the three-input mins below); the
// inputs are under 3 MB.  Design:
//   - a warp owns 256 x points, 8 a lane in registers, for its whole run,
//     and walks the y points of its group of blocks, 128 a block staged as
//     float4 in the warp's own shared-memory slice (4 a lane);
//   - in each of a block's 32 steps lane l takes the 4 y points of set
//     (l + s) mod 32 (points t * 32 + set, so a step's 16-byte loads are
//     conflict-free) and the column minima of that set travel with it:
//     after the step each lane takes its right neighbour's 4 by a shuffle,
//     so after 32 steps lane l holds its own set's minima over the warp's
//     256 points.  Per 32 pairs a lane spends 4 loads and 4 shuffles;
//   - the minima are taken on the distances' bits as signed integers by
//     Hopper's three-input min (__vimin3_s32, DPX): half the instructions
//     of two-input fminf, and the same result here, since a distance is
//     >= +0 and a NaN result has the canonical bits 0x7fffffff, which
//     order above +inf (the start of every minimum), as fminf ignores it;
//   - rows that a warp's group of y blocks completes are stored; otherwise
//     (the y points split over groups) each group's minima are combined by
//     atomicMin on the float's bits as an unsigned int, into an output
//     filled with 0xff bytes first (one memset): a partial is at most
//     +inf, whose bits order below 0xffffffff.  Columns likewise across the warps of a cloud.
//     A min is exact, so launches are bit-equal whatever the order;
//   - ragged ends are padded with +inf coordinates: a padded pair's d is
//     +inf or NaN, which the minima ignore.  The host-side plan
//     (metrics/chamfer.py chamfer_plan) picks the blocks a group from the
//     shape so that every multiprocessor gets the same number of CTAs of 8
//     warps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLaneRows = 8;                  // x points a lane
constexpr int kLaneCols = 4;                  // y points a lane a step
constexpr int kWarpRows = 32 * kLaneRows;     // x points a warp
constexpr int kBlockCols = 32 * kLaneCols;    // y points a block
constexpr int kWarps = 8;                     // warps a CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInf = 0x7f800000;  // +inf's bits

// v: the bits of a distance (a float >= +0, or +inf)
__device__ __forceinline__ void put(float* out, size_t i, int v, int red) {
  if (red)
    atomicMin(reinterpret_cast<unsigned*>(out) + i, static_cast<unsigned>(v));
  else
    out[i] = __int_as_float(v);
}

// grid: ceil(B * XW * YG / kWarps) CTAs of kWarps warps; warp g is (b, yg,
// xw) with xw fastest.  XW = ceil(N / kWarpRows); y blocks of a group: ny.
__global__ void __launch_bounds__(32 * kWarps, 3)
    chamfer_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ rows, float* __restrict__ cols, int B,
                   int N, int M, int XW, int YG, int ny, int row_red,
                   int col_red) {
  __shared__ float4 stage[kWarps][kBlockCols];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + wib;
  if (g >= static_cast<long long>(B) * XW * YG) return;  // whole warps
  const int xw = static_cast<int>(g % XW);
  const long long r = g / XW;
  const int yg = static_cast<int>(r % YG);
  const int b = static_cast<int>(r / YG);
  const float* xb = x + static_cast<size_t>(b) * N * 3;
  const float* yb = y + static_cast<size_t>(b) * M * 3;

  float xz[kLaneRows], xy[kLaneRows], xx[kLaneRows];
  int best[kLaneRows];  // minima as the bits of floats >= +0
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
    const int n = xw * kWarpRows + i * 32 + lane;
    const bool in = n < N;
    xz[i] = in ? xb[3 * static_cast<size_t>(n)] : INFINITY;
    xy[i] = in ? xb[3 * static_cast<size_t>(n) + 1] : INFINITY;
    xx[i] = in ? xb[3 * static_cast<size_t>(n) + 2] : INFINITY;
    best[i] = kInf;
  }

  float4* ys = stage[wib];
  const int nyb = (M + kBlockCols - 1) / kBlockCols;
  const int j1 = min(nyb, (yg + 1) * ny);
  for (int jb = yg * ny; jb < j1; ++jb) {
    const int m0 = jb * kBlockCols;
    __syncwarp();  // the previous block's loads are done
#pragma unroll
    for (int t = 0; t < kLaneCols; ++t) {
      const int m = m0 + t * 32 + lane;
      ys[t * 32 + lane] =
          m < M ? make_float4(yb[3 * static_cast<size_t>(m)],
                              yb[3 * static_cast<size_t>(m) + 1],
                              yb[3 * static_cast<size_t>(m) + 2], 0.f)
                : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    }
    __syncwarp();
    int acc[kLaneCols];
#pragma unroll
    for (int t = 0; t < kLaneCols; ++t) acc[t] = kInf;
    for (int s = 0; s < 32; ++s) {
      const int set = (lane + s) & 31;
      int dprev[kLaneRows];  // a step's distances at t - 1, for the rows
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) {
        const float4 q = ys[t * 32 + set];
        int dd[kLaneRows];
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) {
          // the expression of the kernel this replaced, for the same bits
          const float dz = q.x - xz[i], dy = q.y - xy[i], dx = q.z - xx[i];
          dd[i] = __float_as_int(dz * dz + dy * dy + dx * dx);
          if (t & 1) best[i] = __vimin3_s32(best[i], dprev[i], dd[i]);
          dprev[i] = dd[i];
        }
        int m = __vimin3_s32(dd[0], dd[1], dd[2]);
        m = __vimin3_s32(m, dd[3], dd[4]);
        m = __vimin3_s32(m, dd[5], dd[6]);
        acc[t] = __vimin3_s32(m, dd[7], acc[t]);
      }
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t)
        acc[t] = __shfl_sync(kFull, acc[t], (lane + 1) & 31);
    }
    if (cols != nullptr) {
#pragma unroll
      for (int t = 0; t < kLaneCols; ++t) {
        const int m = m0 + t * 32 + lane;
        if (m < M) put(cols, static_cast<size_t>(b) * M + m, acc[t], col_red);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
    const int n = xw * kWarpRows + i * 32 + lane;
    if (n < N) put(rows, static_cast<size_t>(b) * N + n, best[i], row_red);
  }
}

}  // namespace

// rows (B, N) and, unless cols is null, cols (B, M); ny y blocks a group
// (the plan's).  Outputs combined across warps are filled with 0xff bytes
// here first.
extern "C" int im23d_chamfer(const void* x, const void* y, void* rows,
                             void* cols, int B, int N, int M, int ny,
                             void* stream) {
  if (B < 1 || N < 1 || M < 1 || ny < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int XW = (N + kWarpRows - 1) / kWarpRows;
  const int nyb = (M + kBlockCols - 1) / kBlockCols;
  const int YG = (nyb + ny - 1) / ny;
  const long long warps = static_cast<long long>(B) * XW * YG;
  const long long ctas = (warps + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int row_red = YG > 1, col_red = cols != nullptr && XW > 1;
  cudaError_t err = cudaSuccess;
  if (row_red)
    err = cudaMemsetAsync(rows, 0xff, static_cast<size_t>(B) * N * 4, st);
  if (err == cudaSuccess && col_red)
    err = cudaMemsetAsync(cols, 0xff, static_cast<size_t>(B) * M * 4, st);
  if (err != cudaSuccess) return err;
  chamfer_kernel<<<static_cast<unsigned>(ctas), 32 * kWarps, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(rows), static_cast<float*>(cols), B, N, M, XW, YG,
      ny, row_red, col_red);
  return cudaGetLastError();
}

// The plan's limits: the card's multiprocessors, then this file's warps a
// CTA, x points a warp and y points a block.
extern "C" int im23d_chamfer_limits(int dev, int* out) {
  out[1] = kWarps;
  out[2] = kWarpRows;
  out[3] = kBlockCols;
  return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
}
