// Device code shared by the splat-family kernels K6 and K7 (splat.cu):
//   splat_axes:        one point's clamped corner indices along z, y and x
//                      and its 8 trilinear weights;
//   splat_corners:     the same as flat indices into an (S, S, S) grid;
//   splat_kernel:      one thread per point, its 8 corners added by
//                      atomicAdd into a zeroed (B, S, S, S) grid in device
//                      memory;
//   blur_yx_t_kernel:  one block per (cloud, z-plane), the transpose of the
//                      Y/X blur times the clamp's mask;
//   splat_grad_kernel: the splat's transpose as a gather, one thread per
//                      point reading its 8 corners (no atomics), returning
//                      d(gz, gy, gx) and, where asked, d c.
// Corner indices are clamped to the grid, as the plain version
// (ops/voxel.py:splat_grid) clamps them; for a point inside the grid that
// changes nothing.  The clamp's mask is 0 <= raw <= 1 (torch.clamp's VJP:
// ties pass), for weights of either sign.  Each file that includes this
// header gets its own copy (anonymous namespace).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxTaps = 64;
constexpr int kBlurThreads = 256;
constexpr int kPointThreads = 256;
// a block's dynamic shared memory without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int clamp_index(int i, int S) {
  return min(max(i, 0), S - 1);
}

// point (pz, py, px) of weight w: its clamped corner indices along z, y
// and x and its 8 trilinear weights times w, in (dz, dy, dx) order
__device__ __forceinline__ void splat_axes(float pz, float py, float px,
                                           float w, int S, int (&z)[2],
                                           int (&y)[2], int (&x)[2],
                                           float (&v)[8]) {
  const float fz = floorf(pz), fy = floorf(py), fx = floorf(px);
  const int iz = static_cast<int>(fz), iy = static_cast<int>(fy),
            ix = static_cast<int>(fx);
  const float tz = pz - fz, ty = py - fy, tx = px - fx;
  const float wz[2] = {1.f - tz, tz};
  const float wy[2] = {1.f - ty, ty};
  const float wx[2] = {1.f - tx, tx};
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    z[d] = clamp_index(iz + d, S);
    y[d] = clamp_index(iy + d, S);
    x[d] = clamp_index(ix + d, S);
  }
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wzy = w * wz[dz] * wy[dy];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) v[4 * dz + 2 * dy + dx] = wzy * wx[dx];
    }
  }
}

// the same corners as flat indices into an S^3 grid
__device__ __forceinline__ void splat_corners(float pz, float py, float px,
                                              float w, int S, int (&idx)[8],
                                              float (&v)[8]) {
  int z[2], y[2], x[2];
  splat_axes(pz, py, px, w, S, z, y, x, v);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    idx[q] = (z[q >> 2] * S + y[(q >> 1) & 1]) * S + x[q & 1];
}

// the clamp's mask on a raw splat sum: torch.clamp(raw, 0, 1)'s gradient
// passes where 0 <= raw <= 1, ties included
__device__ __forceinline__ bool clamp_passes(float raw) {
  return raw >= 0.f && raw <= 1.f;
}

__global__ void splat_kernel(const float* __restrict__ gz,
                             const float* __restrict__ gy,
                             const float* __restrict__ gx,
                             const float* __restrict__ c,
                             float* __restrict__ grid, int B, int N, int S) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * N) return;
  const float w = c[i];
  if (w == 0.f) return;  // culled or dropped point
  const int b = static_cast<int>(i / N);
  float* g = grid + static_cast<size_t>(b) * S * S * S;
  int idx[8];
  float v[8];
  splat_corners(gz[i], gy[i], gx[i], w, S, idx, v);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (v[q] != 0.f) atomicAdd(g + idx[q], v[q]);
}

int splat_launch(const float* gz, const float* gy, const float* gx,
                 const float* c, float* grid, int B, int N, int S,
                 cudaStream_t st) {
  const long long n_pts = static_cast<long long>(B) * N;
  const int blocks = static_cast<int>((n_pts + kPointThreads - 1) /
                                      kPointThreads);
  if (blocks == 0) return cudaSuccess;
  splat_kernel<<<blocks, kPointThreads, 0, st>>>(gz, gy, gx, c, grid, B, N,
                                                 S);
  return cudaGetLastError();
}

// The transpose of the zero-padded 'same' correlation with the taps, on
// one strided line at position i: sum_t k[t] * line[i - t + half] (the
// forward is sum_t k[t] * line[i + t - half]).  The band of taps is not
// assumed symmetric.
__device__ __forceinline__ float correlate_t(const float* line, int stride,
                                             int i, const float* k, int K,
                                             int S) {
  const int half = K / 2;
  const int t0 = max(0, i + half - S + 1), t1 = min(K, i + half + 1);
  float acc = 0.f;
  for (int t = t0; t < t1; ++t) acc += k[t] * line[(i - t + half) * stride];
  return acc;
}

// grid: blockIdx.x = z-plane, blockIdx.y = cloud; 2 S^2 floats of dynamic
// shared memory.  The block reads its whole plane before it writes, so src
// may alias dst.  dst = blur_y^T(blur_x^T(src)) where keep (the raw splat)
// passes the clamp (clamp_passes).
__global__ void blur_yx_t_kernel(const float* src, float* dst,
                                 const float* __restrict__ keep,
                                 const float* __restrict__ taps, int K,
                                 int S) {
  extern __shared__ float planes[];  // [2][S][S]
  __shared__ float k[kMaxTaps];
  float* plane = planes;
  float* tmp = planes + S * S;
  const int SS = S * S;
  const size_t off = (static_cast<size_t>(blockIdx.y) * S + blockIdx.x) * SS;
  for (int t = threadIdx.x; t < K; t += blockDim.x) k[t] = taps[t];
  for (int i = threadIdx.x; i < SS; i += blockDim.x) plane[i] = src[off + i];
  __syncthreads();
  for (int i = threadIdx.x; i < SS; i += blockDim.x) {
    const int y = i / S, x = i - y * S;
    tmp[i] = correlate_t(plane + x, S, y, k, K, S);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SS; i += blockDim.x) {
    const int y = i / S, x = i - y * S;
    const float v = correlate_t(tmp + y * S, 1, x, k, K, S);
    dst[off + i] = clamp_passes(keep[off + i]) ? v : 0.f;
  }
}

size_t blur_yx_smem(int S) {
  return 2 * static_cast<size_t>(S) * S * sizeof(float);
}

int blur_yx_t_launch(const float* src, float* dst, const float* keep,
                     const float* taps, int K, int B, int S,
                     cudaStream_t st) {
  const size_t smem = blur_yx_smem(S);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&blur_yx_t_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blur_yx_t_kernel<<<dim3(S, B), kBlurThreads, smem, st>>>(src, dst, keep,
                                                           taps, K, S);
  return cudaGetLastError();
}

// One thread per point: d(gz, gy, gx) = c * sum over the 8 corners of
// dvox * the derivative of the trilinear weight (d tz / d gz = 1; the floor
// has no gradient, as in the plain chain), and, with dc given, dc = sum of
// dvox * the trilinear weight at the point's own corners, for every point
// (a zero-weight point too).  With keep given, dvox counts only where keep
// (the raw splat) passes the clamp (clamp_passes).  Without dc, zero-weight
// points skip the reads (their coordinate gradients are 0).
__global__ void splat_grad_kernel(const float* __restrict__ gz,
                                  const float* __restrict__ gy,
                                  const float* __restrict__ gx,
                                  const float* __restrict__ c,
                                  const float* __restrict__ dvox,
                                  const float* __restrict__ keep,
                                  float* __restrict__ dgz,
                                  float* __restrict__ dgy,
                                  float* __restrict__ dgx,
                                  float* __restrict__ dc, int B, int N,
                                  int S) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * N) return;
  const float w = c[i];
  float sz = 0.f, sy = 0.f, sx = 0.f, sc = 0.f;
  if (w != 0.f || dc != nullptr) {
    const int b = static_cast<int>(i / N);
    const float pz = gz[i], py = gy[i], px = gx[i];
    const float fz = floorf(pz), fy = floorf(py), fx = floorf(px);
    const int iz = static_cast<int>(fz), iy = static_cast<int>(fy),
              ix = static_cast<int>(fx);
    const float tz = pz - fz, ty = py - fy, tx = px - fx;
    const float wz[2] = {1.f - tz, tz};
    const float wy[2] = {1.f - ty, ty};
    const float wx[2] = {1.f - tx, tx};
    const float dw[2] = {-1.f, 1.f};
    const size_t base = static_cast<size_t>(b) * S * S * S;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const int z = clamp_index(iz + dz, S);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = clamp_index(iy + dy, S);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int x = clamp_index(ix + dx, S);
          const size_t at = base + (z * S + y) * S + x;
          float v = dvox[at];
          if (keep != nullptr && !clamp_passes(keep[at])) v = 0.f;
          sz += v * dw[dz] * wy[dy] * wx[dx];
          sy += v * wz[dz] * dw[dy] * wx[dx];
          sx += v * wz[dz] * wy[dy] * dw[dx];
          sc += v * wz[dz] * wy[dy] * wx[dx];
        }
      }
    }
  }
  dgz[i] = w * sz;
  dgy[i] = w * sy;
  dgx[i] = w * sx;
  if (dc != nullptr) dc[i] = sc;
}

int splat_grad_launch(const float* gz, const float* gy, const float* gx,
                      const float* c, const float* dvox, const float* keep,
                      float* dgz, float* dgy, float* dgx, float* dc, int B,
                      int N, int S, cudaStream_t st) {
  const long long n_pts = static_cast<long long>(B) * N;
  const int blocks = static_cast<int>((n_pts + kPointThreads - 1) /
                                      kPointThreads);
  if (blocks == 0) return cudaSuccess;
  splat_grad_kernel<<<blocks, kPointThreads, 0, st>>>(
      gz, gy, gx, c, dvox, keep, dgz, dgy, dgx, dc, B, N, S);
  return cudaGetLastError();
}

}  // namespace
