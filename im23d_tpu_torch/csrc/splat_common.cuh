// Device code shared by the splat-family kernels K6 and K7 (splat.cu):
//   splat_axes:    one point's clamped corner indices along z, y and x and
//                  its 8 trilinear weights;
//   splat_corners: the same as flat indices into an (S, S, S) grid;
//   splat_kernel:  one thread per point, its 8 corners added by atomicAdd
//                  into a zeroed (B, S, S, S) grid in device memory (K6
//                  forward's generic path);
//   scan_list:     a CTA's threads read a cloud's points, a step of
//                  kUnroll a thread at once, and list those a test picks
//                  (a warp-aggregated count); the slab kernels' first pass;
//   for_listed:    the listed points spread evenly over the CTA's threads,
//                  kUnroll a thread with their loads issued together;
//   fixed_frac_bits, fixed_units, fixed_passes: the backward's raw splat
//                  in 32-bit fixed point and the clamp's mask on it;
//   opt_in_smem:   a kernel's dynamic shared memory raised to the card's
//                  opt-in limit once a device.
// Corner indices are clamped to the grid, as the plain version
// (ops/voxel.py:splat_grid) clamps them; for a point inside the grid that
// changes nothing.  The clamp's mask is 0 <= raw <= 1 (torch.clamp's VJP:
// ties pass), for weights of either sign.  Each file that includes this
// header gets its own copy (anonymous namespace).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxTaps = 64;
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

// Lists in list[0, cap) the points i in [c0, c1) of the cloud at off for
// which hit(i, z, y, w) returns an entry >= 0 (the entry is stored), and
// counts every hit in *count, also those past cap (a count above cap: the
// list overflowed).  rows: the test reads gy too (y 0 otherwise).  Every
// thread of a block of kThreads calls it, the caller zeroes *count and
// synchronises before, and synchronises after.  A thread tests kUnroll
// points at once, runs of 4 neighbours read by 16-byte loads, a warp sums
// its hits by shuffles and takes their places with one shared atomic a
// step (the list's order is the warp's order of arrival, then the lanes',
// then each lane's points): a point outside the test costs its share of
// coalesced loads.
template <int kThreads, int kUnroll, typename Hit>
__device__ __forceinline__ void scan_list(const float* __restrict__ gz,
                                          const float* __restrict__ gy,
                                          const float* __restrict__ c,
                                          size_t off, int c0, int c1,
                                          bool rows, int* list, int cap,
                                          int* count, Hit hit) {
  static_assert(kUnroll % 4 == 0, "a thread reads float4s of points");
  const int lane = threadIdx.x & 31;
  // a thread's kUnroll points are kUnroll / 4 runs of 4, each one 16-byte
  // load of z and of the weight where the cloud's start is aligned
  const bool vec = (off + c0) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(gz) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  for (int base = c0; base < c1; base += kThreads * kUnroll) {
    float pz[kUnroll], py[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u += 4) {
      const int i =
          base + (u / 4 * kThreads + static_cast<int>(threadIdx.x)) * 4;
      if (vec && i + 3 < c1) {
        const float4 z4 = *reinterpret_cast<const float4*>(gz + off + i);
        const float4 w4 = *reinterpret_cast<const float4*>(c + off + i);
        const float4 y4 =
            rows ? *reinterpret_cast<const float4*>(gy + off + i)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        pz[u] = z4.x, pz[u + 1] = z4.y, pz[u + 2] = z4.z, pz[u + 3] = z4.w;
        w[u] = w4.x, w[u + 1] = w4.y, w[u + 2] = w4.z, w[u + 3] = w4.w;
        py[u] = y4.x, py[u + 1] = y4.y, py[u + 2] = y4.z, py[u + 3] = y4.w;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          pz[u + v] = i + v < c1 ? gz[off + i + v] : 0.f;
          py[u + v] = rows && i + v < c1 ? gy[off + i + v] : 0.f;
          w[u + v] = i + v < c1 ? c[off + i + v] : 0.f;
        }
      }
    }
    int e[kUnroll];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base +
                    (u / 4 * kThreads + static_cast<int>(threadIdx.x)) * 4 +
                    u % 4;
      e[u] = i < c1 ? hit(i, pz[u], py[u], w[u]) : -1;
      mine += e[u] >= 0;
    }
    // the warp's inclusive sum of its lanes' hits
    int upto = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += v;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    if (total == 0) continue;
    int at = 0;
    if (lane == 31) at = atomicAdd(count, total);
    at = __shfl_sync(0xffffffffu, at, 31) + upto - mine;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e[u] >= 0) {
        if (at < cap) list[at] = e[u];
        ++at;
      }
  }
}

// fn(z, y, x, w) for each point index list[0, n) of the cloud at off,
// spread evenly over a block of kThreads, kUnroll a thread at once with
// their loads issued together (a slab may hold many times the mean: a
// chair's seat; one point a thread at a time would leave a warp waiting
// on a few lanes' dependent loads).
template <int kThreads, int kUnroll, typename Fn>
__device__ __forceinline__ void for_listed(const int* list, int n,
                                           const float* __restrict__ gz,
                                           const float* __restrict__ gy,
                                           const float* __restrict__ gx,
                                           const float* __restrict__ c,
                                           size_t off, Fn fn) {
  for (int e0 = threadIdx.x; e0 < n; e0 += kUnroll * kThreads) {
    int at[kUnroll];
    float p[kUnroll][4];  // z, y, x, weight
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      at[u] = e < n ? list[e] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = off + (at[u] < 0 ? 0 : at[u]);
      p[u][0] = gz[i];
      p[u][1] = gy[i];
      p[u][2] = gx[i];
      p[u][3] = c[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (at[u] >= 0) fn(at[u], p[u][0], p[u][1], p[u][2], p[u][3]);
  }
}

// The backward kernels rebuild the raw splat of a tile in shared memory
// only for the clamp's mask.  A tile whose splatted weights are all >= 0
// (every keep mask and cull) sums it exactly in 32-bit fixed point with k
// fraction bits: a native integer atomicAdd in shared memory, where a float
// one is a compare-and-swap loop on sm_90a.  A corner weight v rounds to
// the nearest 2^-k, but never to 0: one below half a unit counts one unit
// (fixed_units), so that a voxel at exactly 1 that a tiny weight also
// reaches (a point within rounding of a grid plane gives its far corners
// weights of ~1e-7) leaves the mask, as in the plain version's float sum.
// Range: k is the largest <= kMaxFrac with n (m 2^k + 8) < 2^31, n the
// tile's points of weight != 0 and m the largest |weight| among them.  A
// point's corner weights (|v| <= |w|) add at most |w| to a voxel, and at
// most 8 units of rounding, so no partial sum of any order can overflow
// and the sum does not depend on the order of the adds: launches are
// bit-equal.  The mask reads 0 <= q <= 2^k on the integer sum q; with
// weights >= 0 it cannot differ from the float sum's at 0, and at 1 only
// for a voxel within ~n 2^-k of 1.  A tile with a negative weight, or
// outside the range (k below kMinFrac: n m >= 2^15, e.g. 32,768 points of
// weight 1 in one tile; m not finite), adds floats instead
// (fixed_frac_bits returns -1), in an order that varies: near 0 a sum of
// tiny weights of either sign needs a float's relative precision to keep
// its sign, which a fixed step does not have.  No weight is clamped.
constexpr int kMaxFrac = 30, kMinFrac = 16;

__device__ __forceinline__ int fixed_frac_bits(int n, float m, bool signed_w) {
  if (signed_w) return -1;
  if (n == 0) return kMaxFrac;
  if (!(m < 1e30f)) return -1;  // inf or NaN
  for (int k = kMaxFrac; k >= kMinFrac; --k)
    if (static_cast<double>(n) * (static_cast<double>(m) * ldexp(1.0, k) +
                                  8.0) < 2147483648.0)
      return k;
  return -1;
}

// v at scale 2^k (a power of two, exact), rounded to the nearest integer,
// but a nonzero v to one unit of its sign at least
__device__ __forceinline__ int fixed_units(float v, float scale) {
  const int q = __float2int_rn(v * scale);
  return q != 0 || v == 0.f ? q : (v > 0.f ? 1 : -1);
}

// the clamp's mask on a raw word: fixed point at k fraction bits, or a
// float where k < 0
__device__ __forceinline__ bool fixed_passes(int word, int k) {
  return k >= 0 ? word >= 0 && word <= (1 << k)
                : clamp_passes(__int_as_float(word));
}

constexpr int kMaxDevices = 64;

// Raises fn's dynamic shared memory limit to what the card's opt-in limit
// leaves beside fn's static shared memory, on the current device, the
// first time a launch there needs more than the default:
// cudaFuncSetAttribute once a device (it costs microseconds of a wrapper's
// host time), not once a launch.  opted: fn's own record, one entry a
// device.
inline int opt_in_smem(const void* fn, std::atomic<int>* opted,
                       size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[dev].load() != 0) return cudaSuccess;
  int most = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)  // the opt-in limit less fn's static shared memory
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) opted[dev].store(1);
  return err;
}

}  // namespace
