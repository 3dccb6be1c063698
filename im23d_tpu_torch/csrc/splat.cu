// K6 and K7: the standalone trilinear splat and the fused splat + clamp +
// Y/X blur, forward and backward, for Hopper (sm_90a).
//
// K6 replaces the Pallas TPU kernels im23d_tpu/ops/splat_pallas.py
// _fwd_kernel / _bwd_kernel (trilinear_splat_pallas): per cloud the
// (S, S, S) grid of the points' trilinear weights times c, clamped to 1;
// its VJP returns d(gz, gy, gx) and d c.  K7 replaces _fused_fwd_kernel /
// _fused_bwd_kernel (splat_blur_pallas): the same splat, clamped, then
// blurred along Y and X by the Gaussian taps (zero-padded 'same'); the Z
// blur, the scale and the last clip stay outside, as in the JAX package.
//
// What bounds them on the H100: bytes.  The TPU kernels build hat-function
// matmuls because XLA on a TPU serialises scatters; here a point scatters
// its 8 corners with atomicAdd and gathers them back in the backward, so
// the work is the grid's traffic (4 S^3 bytes a cloud written, more read
// by the blur and the backward) and a few operations per voxel.  Design, on
// the device code of K1 and K2 (splat_common.cuh):
//   K6 forward:  splat into the zeroed output, then clamp it in place;
//   K6 backward: splat into a zeroed scratch grid (the clamp's mask, raw
//                <= 1, is taken per corner there), then the gather;
//   K7 forward:  splat into the zeroed output, then the clamped Y/X blur
//                of each z-plane in place, two S^2 planes in dynamic shared
//                memory: S <= 170 on an H100 (227 KB a block);
//   K7 backward: splat into a zeroed scratch grid, the Y/X blur's
//                transpose of the cotangent times (raw <= 1) into a second
//                one, then the gather.
// The gather returns d c at each point's own corners for every point, a
// zero-weight one too (the JAX wrappers pin zero-weight points to voxel 0
// before the kernel, splat_pallas.py:487-488 and :538-539; the port does
// not).  Atomic accumulation order varies between runs, so results agree
// with the plain versions to float rounding, not bit for bit.
#include <cuda_runtime.h>

#include "splat_common.cuh"

namespace {

constexpr int kMaxSplatS = 1024;

__global__ void clamp_top_kernel(float* __restrict__ v, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    v[i] = fminf(v[i], 1.f);  // splat sums are >= 0
}

int clamp_top_launch(float* v, long long n, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  const long long want = (n + kPointThreads - 1) / kPointThreads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  clamp_top_kernel<<<blocks, kPointThreads, 0, st>>>(v, n);
  return cudaGetLastError();
}

bool bad_sizes(int S, int K) {
  return S < 1 || S > kMaxSplatS || K < 1 || K > kMaxTaps;
}

}  // namespace

// out must be zeroed.
extern "C" int im23d_splat_fwd(const void* gz, const void* gy,
                               const void* gx, const void* c, void* out,
                               int B, int N, int S, void* stream) {
  if (bad_sizes(S, 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int err = splat_launch(static_cast<const float*>(gz),
                               static_cast<const float*>(gy),
                               static_cast<const float*>(gx),
                               static_cast<const float*>(c), o, B, N, S, st);
  if (err != cudaSuccess) return err;
  return clamp_top_launch(o, static_cast<long long>(B) * S * S * S, st);
}

// raw must be zeroed.
extern "C" int im23d_splat_bwd(const void* gz, const void* gy,
                               const void* gx, const void* c, const void* g,
                               void* raw, void* dgz, void* dgy, void* dgx,
                               void* dc, int B, int N, int S, void* stream) {
  if (bad_sizes(S, 1)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pz = static_cast<const float*>(gz);
  const float* py = static_cast<const float*>(gy);
  const float* px = static_cast<const float*>(gx);
  const float* w = static_cast<const float*>(c);
  float* a = static_cast<float*>(raw);
  const int err = splat_launch(pz, py, px, w, a, B, N, S, st);
  if (err != cudaSuccess) return err;
  return splat_grad_launch(pz, py, px, w, static_cast<const float*>(g), a,
                           static_cast<float*>(dgz), static_cast<float*>(dgy),
                           static_cast<float*>(dgx), static_cast<float*>(dc),
                           B, N, S, st);
}

// out must be zeroed.
extern "C" int im23d_splat_blur_fwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K, void* out, int B,
                                    int N, int S, void* stream) {
  if (bad_sizes(S, K)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int err = splat_launch(static_cast<const float*>(gz),
                               static_cast<const float*>(gy),
                               static_cast<const float*>(gx),
                               static_cast<const float*>(c), o, B, N, S, st);
  if (err != cudaSuccess) return err;
  return blur_yx_launch<false>(o, o, nullptr, static_cast<const float*>(taps),
                               K, B, S, st);
}

// raw must be zeroed; work needs no initial value.
extern "C" int im23d_splat_blur_bwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K, const void* g,
                                    void* raw, void* work, void* dgz,
                                    void* dgy, void* dgx, void* dc, int B,
                                    int N, int S, void* stream) {
  if (bad_sizes(S, K)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pz = static_cast<const float*>(gz);
  const float* py = static_cast<const float*>(gy);
  const float* px = static_cast<const float*>(gx);
  const float* w = static_cast<const float*>(c);
  float* a = static_cast<float*>(raw);
  float* v = static_cast<float*>(work);
  int err = splat_launch(pz, py, px, w, a, B, N, S, st);
  if (err != cudaSuccess) return err;
  err = blur_yx_launch<true>(static_cast<const float*>(g), v, a,
                             static_cast<const float*>(taps), K, B, S, st);
  if (err != cudaSuccess) return err;
  return splat_grad_launch(pz, py, px, w, v, nullptr,
                           static_cast<float*>(dgz), static_cast<float*>(dgy),
                           static_cast<float*>(dgx), static_cast<float*>(dc),
                           B, N, S, st);
}
