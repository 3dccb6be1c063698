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
//   K6 backward: one launch, no scratch grid, no memset: a CTA a tile of a
//                cloud's z-planes (and, where a plane is too large for
//                shared memory, a band of its rows; the host-side plan,
//                ops/splat.py splat_backward_plan: 5 planes at the winners'
//                120 x 64^3, 1 at the 3D IoU's 24 x 32^3).  A tile owns the
//                points whose clamped lower corner (z, y) lies in it and
//                rebuilds the raw splat of its planes and rows and one
//                halo plane and row past them, so that each owned point
//                is gathered whole by one CTA: each output is written
//                once, with no atomics, and a point's 8-corner sum has a
//                fixed order.  One pass over the cloud's z coordinates and
//                weights lists the tile's points (scan_list); the listed
//                points of weight != 0 add their corners in the tile into
//                32-bit fixed point by native shared-memory atomics
//                (integer sums: bit-equal launches; the range in
//                splat_common.cuh); the owned points gather the cotangent
//                at their corners from device memory (32-byte sectors read
//                only there) times the clamp's mask from the tile.  Without
//                dc (the weights a constant, as every keep mask is),
//                zero-weight points are neither listed nor read: their
//                owner writes their zero gradient during the scan.  A tile
//                that owns no point leaves after its scan;
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
//   K7 backward: one launch, no scratch grid, no memset: the tiles and
//                first pass of K6 backward (the plan: one plane and its halo
//                a CTA at the meshing shapes, 4 planes at the sweep's 480 x
//                64^3, bands of 85 rows at 170^3), then per plane of the
//                tile the transpose of the Y blur, then of the X blur (the
//                reverse of the forward's X then Y): Y^T reads the plane of
//                the cotangent from device memory once, lanes along x
//                (coalesced), into a temporary of the tile's rows; X^T reads
//                it, lanes along y (odd stride), and writes dvox = the
//                result where the raw splat passes the clamp (0 <= raw <=
//                1) over the raw word it has just read.  Both from K7
//                forward's register windows (run_taps) with the taps
//                reversed, at the offset K - 1 - K / 2 (the forward's is
//                K / 2; they differ for even K).  Then the owned points
//                gather dvox from shared memory;
// The gather returns d c at each point's own corners for every point, a
// zero-weight one too (the JAX wrappers pin zero-weight points to voxel 0
// before the kernel, splat_pallas.py:487-488 and :538-539; the port does
// not).  The clamp is to [0, 1] and its mask 0 <= raw <= 1 for weights of
// either sign; the JAX Pallas kernels assume a splat >= 0 and clamp only
// the top (splat_pallas.py:230, :248).  The forwards' float atomics add
// in an order that varies between runs, so they agree with the plain
// versions to float rounding, not bit for bit; the backwards' integer sums
// do not depend on the order (bit-equal launches, in the fixed point's
// range), and agree with the plain versions but where a raw sum within its
// rounding of 0 or 1 flips the clamp's mask.
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

  // the splat, a chunk of points at a time: (1) scan_list reads z and the
  // weight of kScanUnroll points a thread at once and lists those with a
  // weight and a clamped z corner in the slab; (2) for_listed spreads the
  // listed points evenly over the threads, kListUnroll a thread at once,
  // and they add their corners in the slab.  So a point outside the slab
  // costs two coalesced loads, and no warp waits on a few lanes' dependent
  // loads and adds: a slab can hold far more points than the mean (a
  // chair's seat).
  const size_t off = static_cast<size_t>(b) * N;
  const int chunk = slab_tail(plane) / kScanStep * kScanStep;
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int c1 = min(N, c0 + chunk);
    if (threadIdx.x == 0) count = 0;
    __syncthreads();  // the last chunk's list consumed
    scan_list<kSlabThreads, kScanUnroll>(
        gz, gy, c, off, c0, c1, false, list, chunk, &count,
        [&](int i, float pz, float, float w) {
          const int iz = static_cast<int>(floorf(pz));
          const unsigned za = clamp_index(iz, S) - z0;
          const unsigned zb = clamp_index(iz + 1, S) - z0;
          // w == 0: a culled or dropped point
          return w != 0.f && (za < static_cast<unsigned>(np) ||
                              zb < static_cast<unsigned>(np))
                     ? i
                     : -1;
        });
    __syncthreads();
    for_listed<kSlabThreads, kListUnroll>(
        list, count, gz, gy, gx, c, off,
        [&](int, float pz, float py, float px, float w) {
          int z[2], y[2], x[2];
          float v[8];
          splat_axes(pz, py, px, w, S, z, y, x, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const unsigned zl = z[q >> 2] - z0;
            if (zl < static_cast<unsigned>(np) && v[q] != 0.f)
              atomicAdd(buf + zl * plane + y[(q >> 1) & 1] * stride + x[q & 1],
                        v[q]);
          }
        });
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

template <int KT>
int slab_launch(const float* gz, const float* gy, const float* gx,
                const float* c, const float* taps, int K, float* out, int B,
                int N, int S, int P, int slabs, int stride, size_t smem,
                cudaStream_t st) {
  static std::atomic<int> opted[kMaxDevices];
  const int err = opt_in_smem(
      reinterpret_cast<const void*>(&splat_blur_slab_kernel<KT>), opted,
      smem);
  if (err != cudaSuccess) return err;
  splat_blur_slab_kernel<KT><<<B * slabs, kSlabThreads, smem, st>>>(
      gz, gy, gx, c, taps, K, out, N, S, P, slabs, stride);
  return cudaGetLastError();
}

// A backward CTA's tile (ops/splat.py splat_backward_plan): cloud b, the
// owned planes [z0, z0 + nz) and rows [y0, y0 + ny), and the planes and
// rows held in shared memory with their halo, [z0, z0 + hz) and
// [y0, y0 + hy).  blockIdx.x = (b slabs + slab) bands + band.
struct BwdTile {
  int b, z0, nz, hz, y0, ny, hy;
  __device__ BwdTile(int S, int P, int R, int slabs, int bands) {
    const int t = static_cast<int>(blockIdx.x);
    const int band = t % bands, slab = t / bands % slabs;
    b = t / bands / slabs;
    z0 = slab * P;
    nz = min(P, S - z0);
    hz = min(P + 1, S - z0);
    y0 = band * R;
    ny = min(R, S - y0);
    hy = min(R + 1, S - y0);
  }
};

// the first pass's counts, reduced over the CTA, and the fixed point's
// fraction bits they give
struct BwdCounts {
  int count;      // the scan's hits (above kListMin: the list overflowed)
  int splats;     // points of weight != 0 the tile splats
  unsigned most;  // the largest |weight| among them, as float bits
  int owned;      // points the tile gathers
  int signed_w;   // one of them has a negative weight
  int frac;       // fixed_frac_bits of the above
};

// Words of a backward CTA's dynamic shared memory: its planes and rows
// with the halo, stride words a row; a temporary of those rows for K7
// (K >= 1); the point list.  ops/splat.py _backward_smem is its twin.
__host__ __device__ __forceinline__ long long bwd_words(int P, int R, int S,
                                                        int stride, int K) {
  const long long rows = static_cast<long long>(R + 1 < S ? R + 1 : S);
  const long long planes = P + 1 < S ? P + 1 : S;
  return planes * rows * stride + (K > 0 ? rows * stride : 0) + kListMin;
}

// The backward's first pass over the cloud's points, a block of kThreads.
// Lists the points the tile splats (weight != 0, a corner in its planes
// and rows with the halo) or gathers (its own: clamped lower z and y
// corner in its owned planes and rows; a zero-weight one only with dc),
// counts them, and writes the zero gradients of the zero-weight points it
// owns and does not gather.  rows: the plan has bands of rows (y read and
// tested).
template <int kThreads>
__device__ __forceinline__ void bwd_scan(
    const BwdTile& t, const float* __restrict__ gz,
    const float* __restrict__ gy, const float* __restrict__ c, size_t off,
    int N, int S, bool rows, bool dc, int* list, BwdCounts& sh,
    float* __restrict__ dgz, float* __restrict__ dgy,
    float* __restrict__ dgx) {
  int splats = 0, owned = 0, negative = 0;
  unsigned most = 0u;
  scan_list<kThreads, kScanUnroll>(
      gz, gy, c, off, 0, N, rows, list, kListMin, &sh.count,
      [&](int i, float pz, float py, float w) {
        const int iz = static_cast<int>(floorf(pz));
        const unsigned za = clamp_index(iz, S) - t.z0;
        const unsigned zb = clamp_index(iz + 1, S) - t.z0;
        bool own = za < static_cast<unsigned>(t.nz);
        bool in = za < static_cast<unsigned>(t.hz) ||
                  zb < static_cast<unsigned>(t.hz);
        if (rows) {
          const int iy = static_cast<int>(floorf(py));
          const unsigned ya = clamp_index(iy, S) - t.y0;
          const unsigned yb = clamp_index(iy + 1, S) - t.y0;
          own = own && ya < static_cast<unsigned>(t.ny);
          in = in && (ya < static_cast<unsigned>(t.hy) ||
                      yb < static_cast<unsigned>(t.hy));
        }
        const bool splat = w != 0.f && in;
        if (splat) {
          ++splats;
          most = max(most, __float_as_uint(fabsf(w)));
          negative |= w < 0.f;
        }
        if (own && (w != 0.f || dc)) {
          ++owned;
        } else if (own) {  // a culled or dropped point: no gradient
          dgz[off + i] = 0.f;
          dgy[off + i] = 0.f;
          dgx[off + i] = 0.f;
        }
        return splat || (own && dc) ? i : -1;
      });
  splats = __reduce_add_sync(0xffffffffu, splats);
  owned = __reduce_add_sync(0xffffffffu, owned);
  most = __reduce_max_sync(0xffffffffu, most);
  negative = __reduce_or_sync(0xffffffffu, negative);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sh.splats, splats);
    atomicAdd(&sh.owned, owned);
    atomicMax(&sh.most, most);
    if (negative) sh.signed_w = 1;
  }
}

// The raw splat of the tile's planes and rows with the halo into region
// (zeroed; plane words a plane, stride a row): fixed point at frac
// fraction bits, or floats where frac < 0 (fixed_frac_bits).  From the
// first pass's list (mark(z, y, w) sees each listed point), or where it
// overflowed (listed > kListMin) by chunks of kListMin points, each
// scanned and listed again (mark sees none).
template <int kThreads, typename Mark>
__device__ __forceinline__ void bwd_splat(
    const BwdTile& t, const float* __restrict__ gz,
    const float* __restrict__ gy, const float* __restrict__ gx,
    const float* __restrict__ c, size_t off, int N, int S, bool rows,
    int listed, int frac, int* region, int plane, int stride, int* list,
    int* count, Mark mark) {
  constexpr int kUnroll = kListMin / kThreads;  // a chunk a step
  const float scale = frac >= 0 ? ldexpf(1.f, frac) : 0.f;
  auto add = [&](int, float pz, float py, float px, float w) {
    mark(pz, py, w);
    if (w == 0.f) return;
    int z[2], y[2], x[2];
    float v[8];
    splat_axes(pz, py, px, w, S, z, y, x, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const unsigned zl = z[q >> 2] - t.z0;
      const unsigned yl = y[(q >> 1) & 1] - t.y0;
      if (zl < static_cast<unsigned>(t.hz) &&
          yl < static_cast<unsigned>(t.hy)) {
        int* at = region + zl * plane + yl * stride + x[q & 1];
        if (frac >= 0) {
          const int f = fixed_units(v[q], scale);
          if (f != 0) atomicAdd(at, f);
        } else if (v[q] != 0.f) {
          atomicAdd(reinterpret_cast<float*>(at), v[q]);
        }
      }
    }
  };
  if (listed <= kListMin) {
    for_listed<kThreads, kListUnroll>(list, listed, gz, gy, gx, c, off, add);
    return;
  }
  for (int c0 = 0; c0 < N; c0 += kListMin) {
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();  // the last chunk's list consumed
    scan_list<kThreads, kUnroll>(
        gz, gy, c, off, c0, min(N, c0 + kListMin), rows, list, kListMin,
        count, [&](int i, float pz, float py, float w) {
          const int iz = static_cast<int>(floorf(pz));
          const unsigned za = clamp_index(iz, S) - t.z0;
          const unsigned zb = clamp_index(iz + 1, S) - t.z0;
          bool in = za < static_cast<unsigned>(t.hz) ||
                    zb < static_cast<unsigned>(t.hz);
          if (rows) {
            const int iy = static_cast<int>(floorf(py));
            const unsigned ya = clamp_index(iy, S) - t.y0;
            const unsigned yb = clamp_index(iy + 1, S) - t.y0;
            in = in && (ya < static_cast<unsigned>(t.hy) ||
                        yb < static_cast<unsigned>(t.hy));
          }
          return w != 0.f && in ? i : -1;
        });
    __syncthreads();
    for_listed<kThreads, kListUnroll>(list, *count, gz, gy, gx, c, off, add);
    __syncthreads();  // the chunk's adds done, its list read
  }
}

// The splat's transpose as a gather of the tile's own points: for each,
// d(gz, gy, gx) = w * the sum over its 8 corners, in (dz, dy, dx) order,
// of dvox * the derivative of the trilinear weight (d tz / d gz = 1; the
// floor has no gradient, as in the plain chain) and, with dc, dc = the
// sum of dvox * the trilinear weight, a zero-weight point's too.  corner(
// zl, yl, z, y, x) gives dvox at the corner (zl, yl: within the tile).
// From the first pass's list, or by chunks where it overflowed.
template <int kThreads, typename Corner>
__device__ __forceinline__ void bwd_gather(
    const BwdTile& t, const float* __restrict__ gz,
    const float* __restrict__ gy, const float* __restrict__ gx,
    const float* __restrict__ c, size_t off, int N, int S, bool rows,
    int listed, int* list, int* count, float* __restrict__ dgz,
    float* __restrict__ dgy, float* __restrict__ dgx, float* __restrict__ dc,
    Corner corner) {
  constexpr int kUnroll = kListMin / kThreads;
  auto gather = [&](int i, float pz, float py, float px, float w) {
    const float fz = floorf(pz), fy = floorf(py), fx = floorf(px);
    const int iz = static_cast<int>(fz), iy = static_cast<int>(fy),
              ix = static_cast<int>(fx);
    const unsigned za = clamp_index(iz, S) - t.z0;
    const unsigned ya = clamp_index(iy, S) - t.y0;
    if (za >= static_cast<unsigned>(t.nz) ||
        ya >= static_cast<unsigned>(t.ny) || (w == 0.f && dc == nullptr))
      return;  // another tile's point, or one that needs no gathering
    const float tz = pz - fz, ty = py - fy, tx = px - fx;
    const float wz[2] = {1.f - tz, tz};
    const float wy[2] = {1.f - ty, ty};
    const float wx[2] = {1.f - tx, tx};
    const float dw[2] = {-1.f, 1.f};
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int z = clamp_index(iz + (q >> 2), S);
      const int y = clamp_index(iy + ((q >> 1) & 1), S);
      v[q] = corner(z - t.z0, y - t.y0, z, y, clamp_index(ix + (q & 1), S));
    }
    float sz = 0.f, sy = 0.f, sx = 0.f, sc = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int dz = q >> 2, dy = (q >> 1) & 1, dx = q & 1;
      sz += v[q] * dw[dz] * wy[dy] * wx[dx];
      sy += v[q] * wz[dz] * dw[dy] * wx[dx];
      sx += v[q] * wz[dz] * wy[dy] * dw[dx];
      sc += v[q] * wz[dz] * wy[dy] * wx[dx];
    }
    dgz[off + i] = w * sz;
    dgy[off + i] = w * sy;
    dgx[off + i] = w * sx;
    if (dc != nullptr) dc[off + i] = sc;
  };
  if (listed <= kListMin) {
    for_listed<kThreads, kListUnroll>(list, listed, gz, gy, gx, c, off,
                                      gather);
    return;
  }
  for (int c0 = 0; c0 < N; c0 += kListMin) {
    if (threadIdx.x == 0) *count = 0;
    __syncthreads();  // the last chunk's list consumed
    scan_list<kThreads, kUnroll>(
        gz, gy, c, off, c0, min(N, c0 + kListMin), rows, list, kListMin,
        count, [&](int i, float pz, float py, float w) {
          const unsigned za =
              clamp_index(static_cast<int>(floorf(pz)), S) - t.z0;
          const unsigned ya =
              clamp_index(static_cast<int>(floorf(py)), S) - t.y0;
          const bool own = za < static_cast<unsigned>(t.nz) &&
                           (!rows || ya < static_cast<unsigned>(t.ny));
          return own && (w != 0.f || dc != nullptr) ? i : -1;
        });
    __syncthreads();
    for_listed<kThreads, kListUnroll>(list, *count, gz, gy, gx, c, off,
                                      gather);
    __syncthreads();  // the chunk's gathers done, its list read
  }
}

// The start both backward kernels share: the first pass, then (the CTA
// leaving where it owns no point to gather) the zeroed tile and its raw
// splat.  Returns the fixed point's fraction bits (-1: floats), or
// kNoPoints for a CTA with nothing to gather; *listed: the first pass's
// list count.
constexpr int kNoPoints = -2;

template <int kThreads, typename Mark>
__device__ __forceinline__ int bwd_start(
    const BwdTile& t, const float* __restrict__ gz,
    const float* __restrict__ gy, const float* __restrict__ gx,
    const float* __restrict__ c, size_t off, int N, int S, bool rows,
    bool dc, int* region, long long region_words, int plane, int stride,
    int* list, BwdCounts& sh, float* __restrict__ dgz,
    float* __restrict__ dgy, float* __restrict__ dgx, int* listed,
    Mark mark) {
  if (threadIdx.x == 0) sh = BwdCounts{0, 0, 0u, 0, 0, 0};
  __syncthreads();
  bwd_scan<kThreads>(t, gz, gy, c, off, N, S, rows, dc, list, sh, dgz, dgy,
                     dgx);
  __syncthreads();  // the list and the counts complete
  *listed = sh.count;
  if (sh.owned == 0) return kNoPoints;  // reads no cotangent
  if (threadIdx.x == 0)
    sh.frac = fixed_frac_bits(sh.splats, __uint_as_float(sh.most),
                              sh.signed_w != 0);
  float4* r4 = reinterpret_cast<float4*>(region);
  for (long long i = threadIdx.x; i < region_words / 4; i += kThreads)
    r4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = region_words / 4 * 4 + threadIdx.x; i < region_words;
       i += kThreads)
    region[i] = 0;
  __syncthreads();  // the tile zeroed, frac set, the counts read
  const int frac = sh.frac;
  bwd_splat<kThreads>(t, gz, gy, gx, c, off, N, S, rows, *listed, frac,
                      region, plane, stride, list, &sh.count, mark);
  __syncthreads();  // the raw splat complete
  return frac;
}

// K6 backward: 1,024 threads a CTA (its CTAs are few and do no blur: the
// first pass, the splat and the gather spread over twice K7's threads).
constexpr int kK6Threads = 1024;

// grid: B slabs bands CTAs (BwdTile); dynamic shared memory:
// bwd_words(P, R, S, stride, 0) words.  dc null: zero-weight points are
// not gathered.
__global__ void __launch_bounds__(kK6Threads)
    splat_bwd_slab_kernel(const float* __restrict__ gz,
                          const float* __restrict__ gy,
                          const float* __restrict__ gx,
                          const float* __restrict__ c,
                          const float* __restrict__ g,
                          float* __restrict__ dgz, float* __restrict__ dgy,
                          float* __restrict__ dgx, float* __restrict__ dc,
                          int N, int S, int P, int R, int slabs, int bands,
                          int stride) {
  extern __shared__ float4 smem4[];
  __shared__ BwdCounts sh;
  const BwdTile t(S, P, R, slabs, bands);
  int* region = reinterpret_cast<int*>(smem4);
  const int plane = min(R + 1, S) * stride;
  const long long words = static_cast<long long>(min(P + 1, S)) * plane;
  int* list = region + words;
  const size_t off = static_cast<size_t>(t.b) * N;
  const bool rows = bands > 1;
  int listed = 0;
  const int frac = bwd_start<kK6Threads>(
      t, gz, gy, gx, c, off, N, S, rows, dc != nullptr, region, words, plane,
      stride, list, sh, dgz, dgy, dgx, &listed, [](float, float, float) {});
  if (frac == kNoPoints) return;
  // g read at the corners of the owned points only, the mask from the tile
  const float* gb = g + static_cast<size_t>(t.b) * S * S * S;
  bwd_gather<kK6Threads>(
      t, gz, gy, gx, c, off, N, S, rows, listed, list, &sh.count, dgz, dgy,
      dgx, dc, [&](int zl, int yl, int z, int y, int x) {
        const float v = __ldg(gb + (static_cast<size_t>(z) * S + y) * S + x);
        return fixed_passes(region[zl * plane + yl * stride + x], frac) ? v
                                                                      : 0.f;
      });
}

// K7 backward's row mask: up to kMaxSplatS + 1 rows of a tile
constexpr int kRowWords = (kMaxSplatS + 1 + 31) / 32;

// whether run r of kRun rows holds a needed row
__device__ __forceinline__ bool run_needed(const unsigned* need, int r) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int row = r * kRun + i;
    any |= (need[row >> 5] >> (row & 31)) & 1u;
  }
  return any;
}

// the k-th needed row of a tile (k below their count)
__device__ __forceinline__ int nth_row(const unsigned* need, int words,
                                       int k) {
  for (int i = 0; i < words; ++i) {
    unsigned m = need[i];
    const int n = __popc(m);
    if (k < n) {
      for (; k > 0; --k) m &= m - 1u;
      return i * 32 + __ffs(m) - 1;
    }
    k -= n;
  }
  return 0;
}

// the k-th run of kRun rows that holds a needed row (k below their count)
__device__ __forceinline__ int nth_run(const unsigned* need, int runs,
                                       int k) {
  for (int r = 0; r < runs; ++r)
    if (run_needed(need, r) && k-- == 0) return r;
  return 0;
}

// K7 backward.  grid: B slabs bands CTAs (BwdTile); dynamic shared
// memory: bwd_words(P, R, S, stride, K) words.  KT >= K taps, zero past K.
// Two CTAs a multiprocessor (64 registers a thread): the plan sizes the
// sweep's tiles for two, and one ran it 1.6x slower.
template <int KT>
__global__ void __launch_bounds__(kSlabThreads, 2)
    splat_blur_bwd_slab_kernel(const float* __restrict__ gz,
                               const float* __restrict__ gy,
                               const float* __restrict__ gx,
                               const float* __restrict__ c,
                               const float* __restrict__ taps, int K,
                               const float* __restrict__ g,
                               float* __restrict__ dgz,
                               float* __restrict__ dgy,
                               float* __restrict__ dgx,
                               float* __restrict__ dc, int N, int S, int P,
                               int R, int slabs, int bands, int stride) {
  extern __shared__ float4 smem4[];
  __shared__ BwdCounts sh;
  // the tile's rows that its own points' corners reach: the transposes
  // run over those rows alone
  __shared__ unsigned need[kRowWords];
  const BwdTile t(S, P, R, slabs, bands);
  int* region = reinterpret_cast<int*>(smem4);
  const int plane = min(R + 1, S) * stride;
  const long long words = static_cast<long long>(min(P + 1, S)) * plane;
  float* tmp = reinterpret_cast<float*>(region + words);
  int* list = region + words + plane;
  const size_t off = static_cast<size_t>(t.b) * N;
  const bool rows = bands > 1;
  const int row_words = (t.hy + 31) / 32;
  for (int i = threadIdx.x; i < kRowWords; i += kSlabThreads) need[i] = 0u;
  int listed = 0;
  const int frac = bwd_start<kSlabThreads>(
      t, gz, gy, gx, c, off, N, S, rows, dc != nullptr, region, words, plane,
      stride, list, sh, dgz, dgy, dgx, &listed,
      [&](float pz, float py, float w) {
        const unsigned za =
            clamp_index(static_cast<int>(floorf(pz)), S) - t.z0;
        const int iy = static_cast<int>(floorf(py));
        const unsigned ya = clamp_index(iy, S) - t.y0;
        if (za < static_cast<unsigned>(t.nz) &&
            ya < static_cast<unsigned>(t.ny) && (w != 0.f || dc != nullptr)) {
          const int yb = clamp_index(iy + 1, S) - t.y0;
          atomicOr(&need[ya >> 5], 1u << (ya & 31));
          atomicOr(&need[yb >> 5], 1u << (yb & 31));
        }
      });
  if (frac == kNoPoints) return;
  if (listed > kListMin) {  // the overflowed splat marked no rows: all
    for (int i = threadIdx.x; i < row_words; i += kSlabThreads)
      need[i] = i < t.hy / 32 ? ~0u : (1u << (t.hy % 32)) - 1u;
    __syncthreads();
  }
  // the needed rows and runs of kRun rows, counted; an item finds its own
  // by select (needed_row)
  int n_rows = 0, n_runs = 0;
  for (int i = 0; i < row_words; ++i) n_rows += __popc(need[i]);
  const int runs_all = (t.hy + kRun - 1) / kRun;
  for (int r = 0; r < runs_all; ++r) n_runs += run_needed(need, r);

  // the taps reversed: the transpose of the 'same' correlation is the
  // correlation with the reversed band at offset K - 1 - K / 2 (the
  // forward's is K / 2)
  float k[KT];
#pragma unroll
  for (int u = 0; u < KT; ++u) k[u] = u < K ? taps[K - 1 - u] : 0.f;
  const int shift = K - 1 - K / 2;
  float* dv = reinterpret_cast<float*>(region);
  for (int p = 0; p < t.hz; ++p) {
    // Y^T: lanes along x, each plane of g read once from device memory
    // (coalesced; the windows' overlap from L1) into the temporary, the
    // runs of rows that hold a needed row
    const float* gp = g + (static_cast<size_t>(t.b) * S + t.z0 + p) * S * S;
    for (int it = threadIdx.x; it < S * n_runs; it += kSlabThreads) {
      const int xx = it % S, r0 = nth_run(need, runs_all, it / S) * kRun;
      const int y0 = t.y0 + r0 - shift;
      float acc[kRun];
      run_taps<KT>(
          k,
          [&](int j) {
            const int yi = y0 + j;
            return yi >= 0 && yi < S ? __ldg(gp + yi * S + xx) : 0.f;
          },
          acc);
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        if (r0 + r < t.hy) tmp[(r0 + r) * stride + xx] = acc[r];
    }
    __syncthreads();
    // X^T: lanes along y (odd stride: no bank conflicts), times the
    // clamp's mask, written over the raw splat each thread has just read
    const int runs_x = (S + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < n_rows * runs_x; it += kSlabThreads) {
      const int rr = nth_row(need, row_words, it % n_rows),
                x0 = it / n_rows * kRun;
      const float* line = tmp + rr * stride;
      float acc[kRun];
      run_taps<KT>(
          k,
          [&](int j) {
            const int xi = x0 - shift + j;
            return xi >= 0 && xi < S ? line[xi] : 0.f;
          },
          acc);
      float* out = dv + p * plane + rr * stride + x0;
#pragma unroll
      for (int r = 0; r < kRun; ++r)
        if (x0 + r < S)
          out[r] = fixed_passes(__float_as_int(out[r]), frac) ? acc[r] : 0.f;
    }
    __syncthreads();  // the temporary is the next plane's
  }
  bwd_gather<kSlabThreads>(
      t, gz, gy, gx, c, off, N, S, rows, listed, list, &sh.count, dgz, dgy,
      dgx, dc, [&](int zl, int yl, int, int, int x) {
        return dv[zl * plane + yl * stride + x];
      });
}

// ctas CTAs of threads, after raising the kernel's dynamic shared memory
// limit once a device
template <typename Kernel, typename... Args>
int bwd_launch(Kernel* kernel, std::atomic<int>* opted, int ctas, int threads,
               size_t smem, cudaStream_t st, Args... args) {
  const int err = opt_in_smem(reinterpret_cast<const void*>(kernel), opted,
                              smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// A backward plan this file can run (ops/splat.py splat_backward_plan);
// its CTAs in *ctas.
bool bad_bwd_plan(int B, int N, int S, int K, int P, int R, int stride,
                  long long smem, int* ctas) {
  if (S < 1 || S > kMaxSplatS || K < 0 || K > kMaxTaps || B < 0 || N < 0 ||
      P < 1 || P > S || R < 1 || R > S || stride != (S | 1) ||
      smem != bwd_words(P, R, S, stride, K) * 4)
    return true;
  const long long n =
      static_cast<long long>(B) * ((S + P - 1) / P) * ((S + R - 1) / R);
  *ctas = static_cast<int>(n);
  return n > 0x7fffffffLL;
}

// K7 backward's launch for KT taps, inside this file's anonymous
// namespace as every launcher here: a function-local static of a template
// with external linkage can be one object across the libraries loaded in
// a process, and a second library holding this kernel then skipped raising
// its own kernel's limit (its launches failed)
template <int KT>
int blur_bwd_launch(const float* gz, const float* gy, const float* gx,
                    const float* c, const float* taps, int K, const float* g,
                    float* dgz, float* dgy, float* dgx, float* dc, int N,
                    int S, int P, int R, int stride, int ctas, size_t smem,
                    cudaStream_t st) {
  static std::atomic<int> opted[kMaxDevices];
  return bwd_launch(&splat_blur_bwd_slab_kernel<KT>, opted, ctas,
                    kSlabThreads, smem, st, gz, gy, gx, c, taps, K, g, dgz,
                    dgy, dgx, dc, N, S, P, R, (S + P - 1) / P,
                    (S + R - 1) / R, stride);
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
  static std::atomic<int> opted[kMaxDevices];
  cudaError_t err = static_cast<cudaError_t>(opt_in_smem(
      reinterpret_cast<const void*>(&splat_shared_kernel), opted,
      static_cast<size_t>(smem)));
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

// K6 backward at the (B, S, S, S) cotangent g: dgz, dgy, dgx (and dc,
// where not null) (B, N), written whole (no initial value).  planes, rows
// and stride are the plan's (splat_backward_plan, K = 0), smem =
// bwd_words(planes, rows, S, stride, 0) 4 bytes; a plan this file cannot
// run is refused.
extern "C" int im23d_splat_bwd(const void* gz, const void* gy,
                               const void* gx, const void* c, const void* g,
                               void* dgz, void* dgy, void* dgx, void* dc,
                               int B, int N, int S, int planes, int rows,
                               int stride, long long smem, void* stream) {
  int ctas = 0;
  if (bad_bwd_plan(B, N, S, 0, planes, rows, stride, smem, &ctas))
    return cudaErrorInvalidValue;
  if (ctas == 0 || N == 0) return cudaSuccess;
  static std::atomic<int> opted[kMaxDevices];
  return bwd_launch(
      &splat_bwd_slab_kernel, opted, ctas, kK6Threads,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(gz), static_cast<const float*>(gy),
      static_cast<const float*>(gx), static_cast<const float*>(c),
      static_cast<const float*>(g), static_cast<float*>(dgz),
      static_cast<float*>(dgy), static_cast<float*>(dgx),
      static_cast<float*>(dc), N, S, planes, rows, (S + planes - 1) / planes,
      (S + rows - 1) / rows, stride);
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

// K7 backward at the (B, S, S, S) cotangent g of the Y/X-blurred clamped
// splat: dgz, dgy, dgx (and dc, where not null) (B, N), written whole.
// planes, rows and stride are the plan's (splat_backward_plan, K taps),
// smem = bwd_words(planes, rows, S, stride, K) 4 bytes; a plan this file
// cannot run is refused.
extern "C" int im23d_splat_blur_bwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K, const void* g,
                                    void* dgz, void* dgy, void* dgx,
                                    void* dc, int B, int N, int S,
                                    int planes, int rows, int stride,
                                    long long smem, void* stream) {
  int ctas = 0;
  if (K < 1 ||
      bad_bwd_plan(B, N, S, K, planes, rows, stride, smem, &ctas))
    return cudaErrorInvalidValue;
  if (ctas == 0 || N == 0) return cudaSuccess;
  const auto* pz = static_cast<const float*>(gz);
  const auto* py = static_cast<const float*>(gy);
  const auto* px = static_cast<const float*>(gx);
  const auto* w = static_cast<const float*>(c);
  const auto* k = static_cast<const float*>(taps);
  const auto* cot = static_cast<const float*>(g);
  auto* oz = static_cast<float*>(dgz);
  auto* oy = static_cast<float*>(dgy);
  auto* ox = static_cast<float*>(dgx);
  auto* oc = static_cast<float*>(dc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
#define IM23D_BLUR_BWD(KT)                                                  \
  return blur_bwd_launch<KT>(pz, py, px, w, k, K, cot, oz, oy, ox, oc, N, \
                             S, planes, rows, stride, ctas, bytes, st)
  if (K == 21) IM23D_BLUR_BWD(21);
  if (K <= 8) IM23D_BLUR_BWD(8);
  if (K <= 16) IM23D_BLUR_BWD(16);
  if (K <= 24) IM23D_BLUR_BWD(24);
  if (K <= 32) IM23D_BLUR_BWD(32);
  IM23D_BLUR_BWD(64);
#undef IM23D_BLUR_BWD
}
