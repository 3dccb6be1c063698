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
//   K6 backward: splat into a zeroed scratch grid (the clamp's mask,
//                0 <= raw <= 1, is taken per corner there), then the
//                gather;
//   K7 forward:  one launch, no memset: a CTA a slab of a cloud's z-planes
//                (the host-side plan, ops/splat.py splat_blur_plan: one
//                plane a CTA at the meshing shapes, slabs of up to 5 planes
//                at the chairs sweep's 480 x 64^3), each plane and a
//                temporary in dynamic shared memory at an odd row stride
//                (S | 1, or S where that does not fit: S = 170).  The CTA
//                reads its cloud's z coordinates and weights from L2 and
//                lists the points with a clamped z corner in the slab (in
//                the temporary, a chunk at a time), then the listed points,
//                spread evenly over its threads, add those corners by
//                shared-memory atomics (a slab may hold many times the
//                mean: a chair's seat; adding in the scanning loop would
//                leave a warp waiting on a few lanes' dependent loads and
//                compare-and-swap adds), then per plane blurs along X
//                (lanes along y, the [0, 1] clamp applied as the line is
//                read) into the temporary and along Y (lanes along x) into
//                device memory: each voxel is written once, by coalesced
//                128-byte warp stores.  A thread computes a run of 16
//                neighbouring outputs of a line from a register window of
//                the line and the taps in registers (instances of 8, 16,
//                21, 24, 32 and 64 taps, zero-padded past K), not a loop of
//                shared loads per output.  X before Y, as the plain version
//                (ops/voxel.py blur_3d, axes (3, 2)); the order of the two
//                passes changes only the rounding;
//   K7 backward: splat into a zeroed scratch grid, the Y/X blur's
//                transpose of the cotangent times the clamp's mask into a
//                second one, then the gather.
// The gather returns d c at each point's own corners for every point, a
// zero-weight one too (the JAX wrappers pin zero-weight points to voxel 0
// before the kernel, splat_pallas.py:487-488 and :538-539; the port does
// not).  The clamp is to [0, 1] and its mask 0 <= raw <= 1 for weights of
// either sign; the JAX Pallas kernels assume a splat >= 0 and clamp only
// the top (splat_pallas.py:230, :248).  Float atomics add in an order that
// varies between runs, so results agree with the plain versions to float
// rounding, not bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "splat_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplatS = 1024;

__global__ void clamp_kernel(float* __restrict__ v, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    v[i] = fminf(fmaxf(v[i], 0.f), 1.f);
}

int clamp_launch(float* v, long long n, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  const long long want = (n + kPointThreads - 1) / kPointThreads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  clamp_kernel<<<blocks, kPointThreads, 0, st>>>(v, n);
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

constexpr int kSlabThreads = 512;  // threads of a K7 forward CTA
constexpr int kRun = 16;           // outputs of a line a thread computes
constexpr int kScanUnroll = 8;     // points a thread reads at once
constexpr int kScanStep = kSlabThreads * kScanUnroll;
constexpr int kListMin = 4096;     // entries of the point list at least
constexpr int kListUnroll = 4;     // listed points a thread reads at once

// acc[r] = sum_t k[t] * line(r + t): kRun outputs of a line, each window
// value read once (load(j)) and used by every output it reaches, the taps
// in registers; each output sums its taps in ascending order
template <int KT, typename Load>
__device__ __forceinline__ void run_taps(const float (&k)[KT], Load load,
                                         float (&acc)[kRun]) {
#pragma unroll
  for (int r = 0; r < kRun; ++r) acc[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kRun + KT - 1; ++j) {
    const float v = load(j);
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (j - r >= 0 && j - r < KT) acc[r] += k[j - r] * v;
  }
}

// the floats after a slab's planes: the temporary plane, which holds the
// splat's point list first
__host__ __device__ __forceinline__ int slab_tail(int plane) {
  return plane > kListMin ? plane : kListMin;
}

// grid: B * slabs CTAs, CTA (b, j) the z-planes [j P, min(j P + P, S)) of
// cloud b; dynamic shared memory: P planes of S rows of `stride` floats,
// then slab_tail(S stride) floats.  KT >= K taps, zero past K.
template <int KT>
__global__ void __launch_bounds__(kSlabThreads)
    splat_blur_slab_kernel(const float* __restrict__ gz,
                           const float* __restrict__ gy,
                           const float* __restrict__ gx,
                           const float* __restrict__ c,
                           const float* __restrict__ taps, int K,
                           float* __restrict__ out, int N, int S, int P,
                           int slabs, int stride) {
  extern __shared__ float4 smem4[];
  __shared__ int count;
  float* buf = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(blockIdx.x) / slabs;
  const int z0 = (static_cast<int>(blockIdx.x) - b * slabs) * P;
  const int np = min(P, S - z0);
  const int plane = S * stride;
  float* tmp = buf + np * plane;
  int* list = reinterpret_cast<int*>(tmp);
  const int nz = np * plane;
  for (int i = threadIdx.x; i < nz / 4; i += kSlabThreads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = nz / 4 * 4 + threadIdx.x; i < nz; i += kSlabThreads)
    buf[i] = 0.f;
  float k[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) k[t] = t < K ? taps[t] : 0.f;
  __syncthreads();  // the planes zeroed

  // the splat, a chunk of points at a time: (1) every thread reads z and
  // the weight of kScanUnroll points at once and lists those with a
  // weight and a clamped z corner in the slab (a warp-aggregated count);
  // (2) the listed points, spread evenly over the threads (kListUnroll a
  // thread at once, their loads issued together), add their corners in
  // the slab.  So a point outside the slab costs two coalesced loads, and
  // no warp waits on a few lanes' dependent loads and adds: a slab can
  // hold far more points than the mean (a chair's seat).
  const size_t off = static_cast<size_t>(b) * N;
  const int chunk = slab_tail(plane) / kScanStep * kScanStep;
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int c1 = min(N, c0 + chunk);
    if (threadIdx.x == 0) count = 0;
    __syncthreads();  // the last chunk's list consumed
    for (int base = c0; base < c1; base += kScanStep) {
      float pz[kScanUnroll], w[kScanUnroll];
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int i = base + u * kSlabThreads + static_cast<int>(threadIdx.x);
        pz[u] = i < c1 ? gz[off + i] : 0.f;
        w[u] = i < c1 ? c[off + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int i = base + u * kSlabThreads + static_cast<int>(threadIdx.x);
        const int iz = static_cast<int>(floorf(pz[u]));
        const unsigned za = clamp_index(iz, S) - z0;
        const unsigned zb = clamp_index(iz + 1, S) - z0;
        // w == 0: a culled or dropped point
        const bool hit = i < c1 && w[u] != 0.f &&
                         (za < static_cast<unsigned>(np) ||
                          zb < static_cast<unsigned>(np));
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m != 0u) {
          int at = 0;
          if (lane == 0) at = atomicAdd(&count, __popc(m));
          at = __shfl_sync(0xffffffffu, at, 0);
          if (hit) list[at + __popc(m & ((1u << lane) - 1u))] = i;
        }
      }
    }
    __syncthreads();
    const int listed = count;
    for (int e0 = threadIdx.x; e0 < listed; e0 += kListUnroll * kSlabThreads) {
      int at[kListUnroll];
      float p[kListUnroll][4];  // z, y, x, weight
#pragma unroll
      for (int u = 0; u < kListUnroll; ++u) {
        const int e = e0 + u * kSlabThreads;
        at[u] = e < listed ? list[e] : -1;
      }
#pragma unroll
      for (int u = 0; u < kListUnroll; ++u) {
        const size_t i = off + (at[u] < 0 ? 0 : at[u]);
        p[u][0] = gz[i];
        p[u][1] = gy[i];
        p[u][2] = gx[i];
        p[u][3] = c[i];
      }
#pragma unroll
      for (int u = 0; u < kListUnroll; ++u) {
        if (at[u] < 0) continue;
        int z[2], y[2], x[2];
        float v[8];
        splat_axes(p[u][0], p[u][1], p[u][2], p[u][3], S, z, y, x, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const unsigned zl = z[q >> 2] - z0;
          if (zl < static_cast<unsigned>(np) && v[q] != 0.f)
            atomicAdd(buf + zl * plane + y[(q >> 1) & 1] * stride + x[q & 1],
                      v[q]);
        }
      }
    }
    __syncthreads();  // the splat's adds done, the list read
  }

  const int half = K / 2;
  const int items = S * ((S + kRun - 1) / kRun);
  for (int p = 0; p < np; ++p) {
    const float* src = buf + p * plane;
    // X: lanes along y (odd stride: no bank conflicts); clamp to [0, 1]
    for (int it = threadIdx.x; it < items; it += kSlabThreads) {
      const int yy = it % S, x0 = it / S * kRun;
      const float* line = src + yy * stride;
      float acc[kRun];
      run_taps<KT>(
          k,
          [&](int j) {
            const int xi = x0 - half + j;
            return xi >= 0 && xi < S ? fminf(fmaxf(line[xi], 0.f), 1.f)
                                     : 0.f;
          },
          acc);
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        if (x0 + r < S) tmp[yy * stride + x0 + r] = acc[r];
    }
    __syncthreads();
    // Y: lanes along x, each output written once to device memory
    float* o = out + (static_cast<size_t>(b) * S + z0 + p) * S * S;
    for (int it = threadIdx.x; it < items; it += kSlabThreads) {
      const int xx = it % S, y0 = it / S * kRun;
      float acc[kRun];
      run_taps<KT>(
          k,
          [&](int j) {
            const int yi = y0 - half + j;
            return yi >= 0 && yi < S ? tmp[yi * stride + xx] : 0.f;
          },
          acc);
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        if (y0 + r < S) o[static_cast<size_t>(y0 + r) * S + xx] = acc[r];
    }
    __syncthreads();  // the temporary is the next plane's
  }
}

constexpr int kMaxDevices = 64;

// The dynamic shared memory an instance may take on a device is raised
// only when a launch needs more than it was set to, not on every launch
// (cudaFuncSetAttribute is a few microseconds of the wrapper's host
// time).
template <int KT>
int slab_launch(const float* gz, const float* gy, const float* gx,
                const float* c, const float* taps, int K, float* out, int B,
                int N, int S, int P, int slabs, int stride, size_t smem,
                cudaStream_t st) {
  static std::atomic<size_t> opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem && smem > opted[dev].load()) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&splat_blur_slab_kernel<KT>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    size_t seen = opted[dev].load();
    while (smem > seen && !opted[dev].compare_exchange_weak(seen, smem)) {
    }
  }
  splat_blur_slab_kernel<KT><<<B * slabs, kSlabThreads, smem, st>>>(
      gz, gy, gx, c, taps, K, out, N, S, P, slabs, stride);
  return cudaGetLastError();
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
    return clamp_launch(o, static_cast<long long>(B) * S * S * S, st);
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

// K7 forward: out (B, S, S, S) written whole (no initial value).  planes
// and stride are the plan's (splat_blur_plan), smem = (planes S stride +
// slab_tail(S stride)) 4 bytes; a plan this file cannot run is refused.
extern "C" int im23d_splat_blur_fwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K, void* out, int B,
                                    int N, int S, int planes, int stride,
                                    long long smem, void* stream) {
  if (bad_sizes(S, K) || B < 0 || N < 0 || planes < 1 || planes > S ||
      (stride != S && stride != (S | 1)) ||
      smem != (static_cast<long long>(planes) * S * stride +
               slab_tail(S * stride)) * 4)
    return cudaErrorInvalidValue;
  const int slabs = (S + planes - 1) / planes;
  if (static_cast<long long>(B) * slabs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* pz = static_cast<const float*>(gz);
  const auto* py = static_cast<const float*>(gy);
  const auto* px = static_cast<const float*>(gx);
  const auto* w = static_cast<const float*>(c);
  const auto* k = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
#define IM23D_SLAB(KT)                                                      \
  return slab_launch<KT>(pz, py, px, w, k, K, o, B, N, S, planes, slabs,   \
                         stride, bytes, st)
  if (K == 21) IM23D_SLAB(21);
  if (K <= 8) IM23D_SLAB(8);
  if (K <= 16) IM23D_SLAB(16);
  if (K <= 24) IM23D_SLAB(24);
  if (K <= 32) IM23D_SLAB(32);
  IM23D_SLAB(64);
#undef IM23D_SLAB
}

// K7 forward's limits, for the host-side plan: the card's opt-in shared
// memory a block (bytes) and its multiprocessors, then the least entries
// of the point list.
extern "C" int im23d_splat_blur_limits(int dev, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, dev);
  out[2] = kListMin;
  return err;
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
  err = blur_yx_t_launch(static_cast<const float*>(g), v, a,
                         static_cast<const float*>(taps), K, B, S, st);
  if (err != cudaSuccess) return err;
  return splat_grad_launch(pz, py, px, w, v, nullptr,
                           static_cast<float*>(dgz), static_cast<float*>(dgy),
                           static_cast<float*>(dgx), static_cast<float*>(dc),
                           B, N, S, st);
}
