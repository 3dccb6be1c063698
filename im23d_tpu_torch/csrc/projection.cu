// K1: rendering-free projection forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel im23d_tpu/ops/splat_pallas.py
// _proj_sorted_fwd_kernel (and its dense twin _proj_fwd_kernel).  Per cloud:
//   splat (8 trilinear corners, weight c) -> clamp <= 1 -> Y, X, Z blur by
//   the Gaussian taps (zero-padded 'same', no edge renormalisation)
//   -> x scale, clamp <= 1 -> clip [eps, 1-eps] -> termination recurrence
//   -> depth sum, written flipped along Y.
//
// What bounds it on the H100: the 64^3 f32 grid of a cloud is 1 MiB, far
// above a block's 227 KB of shared memory, so the grid lives in device memory
// (B x 1 MiB, 503 MB at the 480-cloud candidate sweep) and the work is
// memory- and shared-memory-bandwidth bound, not FLOP bound.  The TPU design's
// hat-function matmuls (a workaround for serialised scatters) and the z-sort
// (which only cut those matmuls' FLOPs) have no purpose here.  Design: three
// launches that each touch the grid once or twice:
//   (a) splat_kernel: one thread per point, 8 atomicAdds into the zeroed grid;
//   (b) blur_yx_kernel: one block per (cloud, z-plane); the S x S plane sits
//       in shared memory, is clamped, blurred along Y then X, written back;
//   (c) zblur_term_kernel: one thread per (cloud, y, x) ray; a block stages
//       its rays' z-columns in shared memory, blurs along Z, scales, clamps
//       and runs the termination recurrence in registers.
// Atomic accumulation order varies between runs, so results agree with the
// plain chain to float rounding, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kMaxS = 64;
constexpr int kMaxTaps = 64;
constexpr int kBlurThreads = 256;
constexpr int kRayThreads = 128;

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
  const float pz = gz[i], py = gy[i], px = gx[i];
  const float fz = floorf(pz), fy = floorf(py), fx = floorf(px);
  const int iz = static_cast<int>(fz), iy = static_cast<int>(fy),
            ix = static_cast<int>(fx);
  const float tz = pz - fz, ty = py - fy, tx = px - fx;
  const float wz[2] = {1.f - tz, tz};
  const float wy[2] = {1.f - ty, ty};
  const float wx[2] = {1.f - tx, tx};
  float* g = grid + static_cast<size_t>(b) * S * S * S;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = iz + dz;
    if (z < 0 || z >= S) continue;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = iy + dy;
      if (y < 0 || y >= S) continue;
      const float wzy = w * wz[dz] * wy[dy];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = ix + dx;
        if (x < 0 || x >= S) continue;
        const float v = wzy * wx[dx];
        if (v != 0.f) atomicAdd(&g[(z * S + y) * S + x], v);
      }
    }
  }
}

// grid: blockIdx.x = z-plane, blockIdx.y = cloud.
__global__ void blur_yx_kernel(float* __restrict__ grid,
                               const float* __restrict__ taps, int K, int S) {
  __shared__ float plane[kMaxS * kMaxS];
  __shared__ float tmp[kMaxS * kMaxS];
  __shared__ float k[kMaxTaps];
  const int SS = S * S;
  float* p = grid + (static_cast<size_t>(blockIdx.y) * S + blockIdx.x) * SS;
  for (int t = threadIdx.x; t < K; t += blockDim.x) k[t] = taps[t];
  for (int i = threadIdx.x; i < SS; i += blockDim.x)
    plane[i] = fminf(p[i], 1.f);  // splat sums are >= 0: only the top binds
  __syncthreads();
  const int half = K / 2;
  for (int i = threadIdx.x; i < SS; i += blockDim.x) {
    const int y = i / S, x = i - y * S;
    const int t0 = max(0, half - y), t1 = min(K, S + half - y);
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc += k[t] * plane[(y + t - half) * S + x];
    tmp[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SS; i += blockDim.x) {
    const int y = i / S, x = i - y * S;
    const int t0 = max(0, half - x), t1 = min(K, S + half - x);
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc += k[t] * tmp[y * S + x + t - half];
    p[i] = acc;
  }
}

// block (S, R): threadIdx.x = x, threadIdx.y picks one of R rows;
// blockIdx.x = row group, blockIdx.y = cloud.
__global__ void zblur_term_kernel(const float* __restrict__ grid,
                                  const float* __restrict__ taps, int K,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, int S, float eps) {
  extern __shared__ float col[];  // [R][Z][X]
  __shared__ float k[kMaxTaps];
  const int x = threadIdx.x;
  const int y = blockIdx.x * blockDim.y + threadIdx.y;
  const int b = blockIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < K; t += blockDim.x * blockDim.y) k[t] = taps[t];
  float* c = col + static_cast<size_t>(threadIdx.y) * S * S;
  const float* g = grid + static_cast<size_t>(b) * S * S * S;
  if (y < S)
    for (int z = 0; z < S; ++z) c[z * S + x] = g[(z * S + y) * S + x];
  __syncthreads();
  if (y >= S) return;
  const float sc = scale[b];
  const int half = K / 2;
  float sil = 0.f, cum = 0.f;
  for (int z = 0; z < S; ++z) {
    const int t0 = max(0, half - z), t1 = min(K, S + half - z);
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc += k[t] * c[(z + t - half) * S + x];
    const float o = fminf(fmaxf(fminf(acc * sc, 1.f), eps), 1.f - eps);
    // leading plane: exp(eps + log o0), not o0 (reference termination_probs)
    sil += expf((z == 0 ? eps : cum) + logf(o));
    cum += log1pf(-o);
  }
  out[(static_cast<size_t>(b) * S + (S - 1 - y)) * S + x] = sil;
}

}  // namespace

extern "C" int im23d_projection_fwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K,
                                    const void* scale, void* grid, void* out,
                                    int B, int N, int S, float eps,
                                    void* stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_pts = static_cast<long long>(B) * N;
  const int splat_blocks = static_cast<int>((n_pts + 255) / 256);
  if (splat_blocks > 0) {
    splat_kernel<<<splat_blocks, 256, 0, st>>>(
        static_cast<const float*>(gz), static_cast<const float*>(gy),
        static_cast<const float*>(gx), static_cast<const float*>(c),
        static_cast<float*>(grid), B, N, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  blur_yx_kernel<<<dim3(S, B), kBlurThreads, 0, st>>>(
      static_cast<float*>(grid), static_cast<const float*>(taps), K, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = std::max(1, kRayThreads / S);
  const size_t smem = static_cast<size_t>(rows) * S * S * sizeof(float);
  zblur_term_kernel<<<dim3((S + rows - 1) / rows, B), dim3(S, rows), smem,
                      st>>>(
      static_cast<const float*>(grid), static_cast<const float*>(taps), K,
      static_cast<const float*>(scale), static_cast<float*>(out), S, eps);
  return cudaGetLastError();
}
