// K1 and K2: rendering-free projection forward and backward for Hopper
// (sm_90a).  K2 is described where its kernels begin, below.
//
// K1 replaces the Pallas TPU kernel im23d_tpu/ops/splat_pallas.py
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
// plain chain to float rounding, not bit for bit.  The splat, the Y/X blur
// and the gather are shared with K6 and K7 (splat_common.cuh).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "splat_common.cuh"

namespace {

constexpr int kMaxS = 64;
constexpr int kRayThreads = 128;

// block (S, R): threadIdx.x = x, threadIdx.y picks one of R rows;
// blockIdx.x = row group, blockIdx.y = cloud.  Each thread stages its own
// ray's z-column in shared memory (neighbouring threads, neighbouring x:
// coalesced loads) and reads only that column.
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
  float sil = 0.f, cum = 0.f;
  for (int z = 0; z < S; ++z) {
    const float acc = correlate<false>(c + x, S, z, k, K, S);
    const float o = fminf(fmaxf(fminf(acc * sc, 1.f), eps), 1.f - eps);
    // leading plane: exp(eps + log o0), not o0 (reference termination_probs)
    sil += expf((z == 0 ? eps : cum) + logf(o));
    cum += log1pf(-o);
  }
  out[(static_cast<size_t>(b) * S + (S - 1 - y)) * S + x] = sil;
}

// ---- K2: the projection backward ------------------------------------------
//
// Replaces the Pallas TPU kernel im23d_tpu/ops/splat_pallas.py
// _proj_sorted_bwd_kernel (and its dense twin _proj_bwd_kernel).  Given the
// silhouette cotangent gsil it recomputes the forward and returns d(gz, gy,
// gx) and dscale; the splat weights c are constants (no dc).  Same bounds as
// K1 (two 1 MiB grids per cloud in device memory, bandwidth bound), and the
// same design, five launches:
//   (a) splat_kernel into the zeroed raw grid, kept for the clamp mask;
//       blur_yx_kernel<false> raw -> work;
//   (b) term_bwd_kernel: per ray, the Z blur zb (unscaled), the termination
//       probabilities front to back, their VJP back to front into du,
//       dscale += sum du * zb, then work <- scale * zblur^T(du);
//   (c) blur_yx_kernel<true> work -> work, times (raw <= 1);
//   (d) splat_grad_kernel: splat transpose as a gather, one thread per
//       point reading its 8 corners; no atomics.
// The only atomics are the splat's and one per block for dscale, so the
// gradients agree with the plain chain to float rounding, except where a
// clamp mask (raw <= 1, u <= 1, eps <= o <= 1 - eps) sits within rounding
// of its bound and flips.

// block (S, R) as zblur_term_kernel.  In: work = Y/X-blurred occupancies.
// Out: work = scale * zblur^T(du), with du the cotangent of u = scale *
// zblur(work) before its clamps; dscale[b] += sum of du * zblur(work).
__global__ void term_bwd_kernel(float* __restrict__ work,
                                const float* __restrict__ taps, int K,
                                const float* __restrict__ scale,
                                const float* __restrict__ gsil,
                                float* __restrict__ dscale, int S, float eps) {
  extern __shared__ float col[];  // [R][Z][X]
  __shared__ float k[kMaxTaps];
  __shared__ float partial[kRayThreads];
  const int x = threadIdx.x;
  const int y = blockIdx.x * blockDim.y + threadIdx.y;
  const int b = blockIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int t = tid; t < K; t += nthreads) k[t] = taps[t];
  float* c = col + static_cast<size_t>(threadIdx.y) * S * S;
  float* g = work + static_cast<size_t>(b) * S * S * S;
  const bool live = y < S;
  if (live)
    for (int z = 0; z < S; ++z) c[z * S + x] = g[(z * S + y) * S + x];
  __syncthreads();
  float ds = 0.f;
  if (live) {
    const float sc = scale[b];
    // the silhouette is written flipped along Y
    const float gs = gsil[(static_cast<size_t>(b) * S + (S - 1 - y)) * S + x];
    // pass 1, front to back: the termination probabilities p_z, kept in
    // this ray's own column of work
    float cum = 0.f;
    for (int z = 0; z < S; ++z) {
      const float zb = correlate<false>(c + x, S, z, k, K, S);
      const float o = fminf(fmaxf(fminf(zb * sc, 1.f), eps), 1.f - eps);
      g[(z * S + y) * S + x] = expf((z == 0 ? eps : cum) + logf(o));
      cum += log1pf(-o);
    }
    // pass 2, back to front: dsil/dlog o_z = p_z and dsil/dlog(1 - o_z) =
    // sum_{j > z} p_j, through the clips and the top clamp of u into du_z.
    // The tail sum runs from the back, as the plain chain's cumsum backward
    // does: a total minus a prefix (the TPU kernel's form) cancels where the
    // tail is small, and 1 / (1 - o) magnifies that by up to 1 / eps.
    float tail = 0.f;
    for (int z = S - 1; z >= 0; --z) {
      const float zb = correlate<false>(c + x, S, z, k, K, S);
      const float u = zb * sc;
      const float sv = fminf(u, 1.f);
      const float o = fminf(fmaxf(sv, eps), 1.f - eps);
      const float p = g[(z * S + y) * S + x];
      const bool pass = u <= 1.f && sv >= eps && sv <= 1.f - eps;
      const float du = pass ? gs * p / o - gs * tail / (1.f - o) : 0.f;
      tail += p;
      ds += du * zb;
      g[(z * S + y) * S + x] = du;  // this thread's own column
    }
    // dzb = scale * du, then the Z blur's transpose
    for (int z = 0; z < S; ++z) c[z * S + x] = g[(z * S + y) * S + x];
    for (int z = 0; z < S; ++z)
      g[(z * S + y) * S + x] = sc * correlate<true>(c + x, S, z, k, K, S);
  }
  partial[tid] = ds;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int t = 0; t < nthreads; ++t) sum += partial[t];
    atomicAdd(&dscale[b], sum);
  }
}

// ray kernels: R rows of S threads per block, R = max(1, kRayThreads / S)
dim3 ray_blocks(int S) {
  const int rows = std::max(1, kRayThreads / S);
  return dim3(S, rows);
}

size_t ray_smem(int S) {
  return static_cast<size_t>(ray_blocks(S).y) * S * S * sizeof(float);
}

}  // namespace

extern "C" int im23d_projection_fwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K,
                                    const void* scale, void* grid, void* out,
                                    int B, int N, int S, float eps,
                                    void* stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(taps);
  float* g = static_cast<float*>(grid);
  int err = splat_launch(static_cast<const float*>(gz),
                         static_cast<const float*>(gy),
                         static_cast<const float*>(gx),
                         static_cast<const float*>(c), g, B, N, S, st);
  if (err != cudaSuccess) return err;
  err = blur_yx_launch<false>(g, g, nullptr, k, K, B, S, st);
  if (err != cudaSuccess) return err;
  const dim3 threads = ray_blocks(S);
  zblur_term_kernel<<<dim3((S + threads.y - 1) / threads.y, B), threads,
                      ray_smem(S), st>>>(
      g, k, K, static_cast<const float*>(scale), static_cast<float*>(out), S,
      eps);
  return cudaGetLastError();
}

// raw must be zeroed; work needs no initial value; dscale must be zeroed.
extern "C" int im23d_projection_bwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K,
                                    const void* scale, const void* gsil,
                                    void* raw, void* work, void* dscale,
                                    void* dgz, void* dgy, void* dgx, int B,
                                    int N, int S, float eps, void* stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxTaps) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pz = static_cast<const float*>(gz);
  const float* py = static_cast<const float*>(gy);
  const float* px = static_cast<const float*>(gx);
  const float* w = static_cast<const float*>(c);
  const float* k = static_cast<const float*>(taps);
  float* a = static_cast<float*>(raw);
  float* v = static_cast<float*>(work);
  // (a) recompute: raw splat, then its clamped Y/X blur
  int err = splat_launch(pz, py, px, w, a, B, N, S, st);
  if (err != cudaSuccess) return err;
  err = blur_yx_launch<false>(a, v, nullptr, k, K, B, S, st);
  if (err != cudaSuccess) return err;
  // (b) termination VJP and the Z blur's transpose, per ray
  const dim3 threads = ray_blocks(S);
  term_bwd_kernel<<<dim3((S + threads.y - 1) / threads.y, B), threads,
                    ray_smem(S), st>>>(
      v, k, K, static_cast<const float*>(scale),
      static_cast<const float*>(gsil), static_cast<float*>(dscale), S, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // (c) the Y/X blur's transpose and the splat clamp's mask
  err = blur_yx_launch<true>(v, v, a, k, K, B, S, st);
  if (err != cudaSuccess) return err;
  // (d) the splat's transpose, gathered per point
  return splat_grad_launch(pz, py, px, w, v, nullptr,
                           static_cast<float*>(dgz), static_cast<float*>(dgy),
                           static_cast<float*>(dgx), nullptr, B, N, S, st);
}
