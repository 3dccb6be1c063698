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
// the device code in splat_common.cuh:
//   K6 forward:  two paths, chosen by the host-side plan (ops/splat.py
//                splat_plan) from the shape alone.  Shared (S^3 floats
//                within a block's shared memory, S <= 38 on an H100: the
//                3D IoU's 32^3 is 131,072 bytes): one launch, a cluster
//                of k CTAs a cloud, each holding a whole copy of the grid
//                in dynamic shared memory and splatting its 1/k of the
//                points into it by shared-memory atomics (a float add
//                there is a compare-and-swap loop); after a cluster
//                barrier CTA r sums its share of the voxels over the k
//                copies in rank order (distributed shared memory), clamps
//                to [0, 1] and writes each voxel once with 16-byte stores:
//                no memset, no global atomic, no clamp pass.  Generic
//                (larger grids, e.g. the sweep's 64^3): splat into the
//                zeroed output, then clamp it in place;
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplatS = 1024;

__global__ void clamp_top_kernel(float* __restrict__ v, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    v[i] = fminf(fmaxf(v[i], 0.f), 1.f);
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

constexpr int kSharedThreads = 1024;   // threads of a shared-path CTA
constexpr int kSharedMaxCluster = 8;   // the portable cluster size

// grid: B x k CTAs in clusters of k, cluster b the cloud b; S^3 floats of
// dynamic shared memory.  vec: S^3 % 4 == 0 and out 16-byte aligned.
__global__ void __launch_bounds__(kSharedThreads, 1)
    splat_shared_kernel(const float* __restrict__ gz,
                        const float* __restrict__ gy,
                        const float* __restrict__ gx,
                        const float* __restrict__ c, float* __restrict__ out,
                        int N, int S, int vec) {
  extern __shared__ float4 copy4[];
  float* g = reinterpret_cast<float*>(copy4);
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = static_cast<int>(blockIdx.x) / k;
  const int n = S * S * S;
  for (int i = threadIdx.x; i < n / 4; i += kSharedThreads)
    copy4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = n / 4 * 4 + threadIdx.x; i < n; i += kSharedThreads) g[i] = 0.f;
  __syncthreads();
  const size_t off = static_cast<size_t>(b) * N;
  for (int i = rank * kSharedThreads + static_cast<int>(threadIdx.x); i < N;
       i += k * kSharedThreads) {
    const float w = c[off + i];
    if (w == 0.f) continue;  // culled or dropped point
    int idx[8];
    float v[8];
    splat_corners(gz[off + i], gy[off + i], gx[off + i], w, S, idx, v);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (v[q] != 0.f) atomicAdd(g + idx[q], v[q]);
  }
  cluster.sync();  // every CTA's copy complete

  // CTA r sums its share of the voxels over the k copies in rank order,
  // clamps to [0, 1] and writes each once
  float* o = out + static_cast<size_t>(b) * n;
  const int units = vec ? n / 4 : n;
  const int lo = static_cast<int>(static_cast<long long>(units) * rank / k);
  const int hi = static_cast<int>(static_cast<long long>(units) * (rank + 1) /
                                  k);
  if (vec) {
    for (int i = lo + static_cast<int>(threadIdx.x); i < hi;
         i += kSharedThreads) {
      float4 v = cluster.map_shared_rank(copy4, 0)[i];
      for (int r = 1; r < k; ++r) {
        const float4 u = cluster.map_shared_rank(copy4, r)[i];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      reinterpret_cast<float4*>(o)[i] =
          make_float4(fminf(fmaxf(v.x, 0.f), 1.f), fminf(fmaxf(v.y, 0.f), 1.f),
                      fminf(fmaxf(v.z, 0.f), 1.f), fminf(fmaxf(v.w, 0.f), 1.f));
    }
  } else {
    for (int i = lo + static_cast<int>(threadIdx.x); i < hi;
         i += kSharedThreads) {
      float v = cluster.map_shared_rank(g, 0)[i];
      for (int r = 1; r < k; ++r) v += cluster.map_shared_rank(g, r)[i];
      o[i] = fminf(fmaxf(v, 0.f), 1.f);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its copy
}

}  // namespace

// K6 forward: out (B, S, S, S) = the splat of the (B, N) planes, clamped to
// [0, 1].  cluster 0: the generic path, out zeroed by the caller.  cluster
// k >= 1: the shared path, k CTAs a cloud, smem = S^3 4 bytes a CTA, out
// written whole (no initial value); the plan (splat_plan) chooses, and a
// plan this file cannot run is refused.
extern "C" int im23d_splat_fwd(const void* gz, const void* gy,
                               const void* gx, const void* c, void* out,
                               int B, int N, int S, int cluster,
                               long long smem, void* stream) {
  if (bad_sizes(S, 1) || B < 0 || N < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pz = static_cast<const float*>(gz);
  const auto* py = static_cast<const float*>(gy);
  const auto* px = static_cast<const float*>(gx);
  const auto* w = static_cast<const float*>(c);
  float* o = static_cast<float*>(out);
  if (cluster == 0) {
    const int err = splat_launch(pz, py, px, w, o, B, N, S, st);
    if (err != cudaSuccess) return err;
    return clamp_top_launch(o, static_cast<long long>(B) * S * S * S, st);
  }
  const long long n = static_cast<long long>(S) * S * S;
  if (cluster < 1 || cluster > kSharedMaxCluster || smem != n * 4 ||
      static_cast<long long>(B) * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&splat_shared_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cluster), 1, 1);
  cfg.blockDim = dim3(kSharedThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, splat_shared_kernel, pz, py, px, w, o, N, S,
                           vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shared path's limits, for the host-side plan: the card's opt-in
// shared memory a block (bytes) and its multiprocessors, then this file's
// largest cluster and threads a CTA.
extern "C" int im23d_splat_limits(int dev, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, dev);
  out[2] = kSharedMaxCluster;
  out[3] = kSharedThreads;
  return err;
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
