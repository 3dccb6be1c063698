// K1 and K2: the rendering-free projection forward and backward for Hopper
// (sm_90a), one thread-block cluster a cloud.
//
// K1 replaces the Pallas TPU kernel im23d_tpu/ops/splat_pallas.py
// _proj_sorted_fwd_kernel (and its dense twin _proj_fwd_kernel).  Per cloud:
//   splat (8 trilinear corners, weight c; corners clamped to the grid)
//   -> clamp <= 1 -> Y, X, Z blur by the K taps (zero-padded 'same',
//   half = K / 2, the band not assumed symmetric) -> x scale, clamp <= 1
//   -> clip [eps, 1 - eps] -> termination recurrence (leading plane
//   exp(eps + log o0)) -> depth sum, written flipped along Y.
// K2 replaces _proj_sorted_bwd_kernel (and its dense twin
// _proj_bwd_kernel): the VJP of K1 with respect to the grid coordinates
// (gz, gy, gx) and the scale, given the silhouette cotangent gsil; the
// splat weights c are constants.
//
// What bounds them on the H100: operations (a 21-tap blur along three axes
// is 126 FLOP a voxel, 0.25 ms of float32 FMA at the 480-cloud candidate
// sweep), provided the grid never reaches device memory.  The TPU kernel
// holds a cloud's 64^3 f32 grid (1 MiB) in VMEM; one H100 block has 227
// KB, but a cluster of 8 blocks has 8 x 128 KiB of distributed shared
// memory, which is that grid.  Design, one cluster launch per call:
//   - one cluster a cloud, C CTAs; the CTA of rank r owns the z-planes
//     [r P, r P + P) (P = 8 at S = 64: 8 x 64 x 65 floats, rows padded to
//     an odd stride so that a warp walking a row's neighbours in Y reads
//     32 banks) and takes the rays y in [r P, r P + P);
//   - splat: in 64-bit fixed point (2^-40: a corner weight above 2^-17 is
//     exact, a smaller one within 2^-41, finer than float32 near the
//     termination's eps; a weight above 2 counts as 2, which changes
//     nothing past the clamp and keeps a sum of under 2^20 points' corners
//     below 2^64).  An integer sum does not depend on the order of its
//     adds, so both kernels give the same bits on every launch.  Eight
//     bytes a voxel do not fit beside the float planes, so the splat runs
//     in passes of Q planes (Q = 4 at S = 64) through a 64-bit scratch
//     that lies over the float planes of later passes: in each pass every
//     CTA reads its 1/C of the cloud's points and adds the corners that
//     fall in that pass's planes into their owner's scratch through
//     distributed shared memory (remote atomics whose result is not read),
//     and each owner then turns its scratch into float planes, one plane
//     at a time, each written only over scratch already read;
//   - clamp, Y and X blur in place, plane-local, one line a thread held in
//     registers (the specialised instance unrolls every tap);
//   - rays: a thread per ray takes its z-column into registers, blurs it
//     along Z, scales, clamps and runs the termination as a running
//     product (sil += T o, T *= 1 - o; the leading plane o0 e^eps), and
//     stores its silhouette pixel.  A column is read by its own ray alone.
//     The column comes from the owner CTAs through distributed shared
//     memory; in the specialised instance each warp starts at another
//     owner, (rank + warp) mod C, so that the cluster's reads spread over
//     all its CTAs at once instead of queueing at one.
// K2 recomputes the same in its cluster, keeps the splat clamp's mask
// (raw <= 1) as one bit a voxel, runs the termination VJP per ray (tail
// summed back to front), writes scale x zblur^T(du) back into the ray's
// own column, then the X and Y blur transposes per plane with the mask, and
// the splat's transpose as a gather of each point's 8 corners through
// distributed shared memory.  dscale: a block reduction, then rank 0 sums
// the CTAs' partials in rank order: no atomics, bit-equal launches.
// Nothing but the points, the taps and scales in and the outputs out
// touches device memory: no scratch grid, no memset, no global atomics.
// Results agree with the plain chain to float rounding: the fixed-point
// splat's sum is exact but for corner weights below 2^-17, rounded once to
// float; the blurs sum their taps in another order than the plain band
// matmul.  The splat weights c are taken to be >= 0 (keep masks), as the
// plain chain's clamp to [0, 1] assumes.
//
// The instance for S = 64, K = 21 (the chairs sweep) has S, K and P
// compiled in; every other 1 <= S, K <= 64 runs the generic instance, whose
// per-thread lines live in local memory.  The host-side plan
// (ops/projection.py projection_plan) chooses C and P and the shared
// memory; the entry points refuse a plan they cannot run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxS = 64;
constexpr int kMaxK = 64;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kPlanes = 8;      // planes a CTA the plan aims for
// the specialised instance
constexpr int kExactS = 64, kExactK = 21;
constexpr int kFwdThreads = 512, kBwdThreads = 256, kGenericThreads = 256;
// scratch cells a thread turns into floats a plane
constexpr int kCells = kMaxS * kMaxS / kGenericThreads;
// shared memory beside the planes and the mask: the taps and the dscale
// reduction's partials, in floats
constexpr int kExtraFloats = kMaxK + 40;

struct ProjArgs {
  const float* gz;
  const float* gy;
  const float* gx;
  const float* c;
  const float* taps;
  const float* scale;
  const float* gsil;
  float* out;
  float* dscale;
  float* dgz;
  float* dgy;
  float* dgx;
  int S, K, N, P, C, Q;
  float eps;
};

// the splat's raw sums: unsigned 64-bit fixed point, 2^40 to 1; a corner
// weight counts at most kMaxWeight, so that the corners of fewer than
// kMaxPoints points never wrap a sum
constexpr float kFixedOne = 1099511627776.f;
constexpr float kMaxWeight = 2.f;
constexpr int kMaxPoints = 1 << 20;

// the row stride of a plane in shared memory: odd, so that 32 neighbouring
// rows start in 32 different banks
__host__ __device__ inline int row_stride(int S) { return S | 1; }

__host__ __device__ inline size_t planes_bytes(int S, int P) {
  const size_t b = static_cast<size_t>(P) * S * row_stride(S) * sizeof(float);
  return (b + 7) / 8 * 8;
}

// Where the splat's 64-bit scratch for Q planes starts: over the float
// planes of later passes, but past those of earlier ones, and far enough
// that float plane q0 + j, written once scratch plane j is read, ends
// before scratch plane j + 1 begins (q0 the last pass's first plane).
__host__ __device__ inline size_t scratch_offset(int S, int P, int Q) {
  const size_t fp = static_cast<size_t>(S) * row_stride(S) * sizeof(float);
  const size_t ip = static_cast<size_t>(S) * S * sizeof(unsigned long long);
  const size_t q0 = static_cast<size_t>((P - 1) / Q) * Q;
  size_t off = q0 * fp;
  if ((q0 + 1) * fp > ip + off) off = (q0 + 1) * fp - ip;
  return (off + 7) / 8 * 8;
}

// bytes of the planes and the scratch, which overlap
__host__ __device__ inline size_t arena_bytes(int S, int P, int Q) {
  const size_t scratch = scratch_offset(S, P, Q) +
                         static_cast<size_t>(Q) * S * S *
                             sizeof(unsigned long long);
  const size_t planes = planes_bytes(S, P);
  return planes > scratch ? planes : scratch;
}

// dynamic shared memory of a CTA: its planes and the splat's scratch, the
// backward's mask (one 64-bit word a (plane, x) column), the taps and the
// partials
__host__ __device__ inline size_t proj_smem(int S, int P, int Q, bool bwd) {
  return arena_bytes(S, P, Q) +
         (bwd ? static_cast<size_t>(P) * S * sizeof(uint64_t) : 0) +
         kExtraFloats * sizeof(float);
}

__device__ __forceinline__ int clamp_index(int i, int S) {
  return min(max(i, 0), S - 1);
}

// the two halves of cluster.sync(), so that a CTA can work between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// a point's splat weight and grid coordinates (w = 0 past the cloud's end)
struct Point {
  float w, z, y, x;
};

__device__ __forceinline__ Point load_point(const ProjArgs& a, size_t off,
                                            int i) {
  if (i >= a.N) return {0.f, 0.f, 0.f, 0.f};
  return {a.c[off + i], a.gz[off + i], a.gy[off + i], a.gx[off + i]};
}

// add v >= 0 to a fixed-point cell (local or another CTA's); integer adds
// commute, and the result is not read, so a remote add does not wait
__device__ __forceinline__ void splat_add(unsigned long long* cell, float v) {
  const unsigned long long q = __float2ull_rn(fminf(v, kMaxWeight) *
                                              kFixedOne);
  if (q != 0ull) atomicAdd(cell, q);
}

// sum_t k[t] v[i + t - h] (forward) or sum_t k[t] v[i - t + h] (its
// transpose), zero outside [0, S)
template <bool kT, int AS, int AK>
__device__ __forceinline__ float tap_sum(const float (&v)[AS],
                                         const float (&k)[AK], int i, int S,
                                         int K, int h) {
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int j = kT ? i - t + h : i + t - h;
    if (j >= 0 && j < S) acc = fmaf(k[t], v[j], acc);
  }
  return acc;
}

// Blur a line of shared memory in place: the S values at line[i * stride]
// are read into v first.  kLoadClamp takes min(., 1) of the splat's sums
// and returns the mask (sum <= 1) as bits; kMask zeroes the outputs whose
// bit is clear.
template <bool kT, bool kLoadClamp, bool kMask, int AS, int AK>
__device__ __forceinline__ uint64_t blur_line(float* line, int stride,
                                              const float (&k)[AK], int S,
                                              int K, int h, uint64_t bits) {
  float v[AS];
  uint64_t keep = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (kLoadClamp) {
      // splat sums are >= 0: only the top of the clamp binds
      const float r = line[i * stride];
      keep |= static_cast<uint64_t>(r <= 1.f) << i;
      v[i] = fminf(r, 1.f);
    } else {
      v[i] = line[i * stride];
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float acc = tap_sum<kT>(v, k, i, S, K, h);
    line[i * stride] = (!kMask || ((bits >> i) & 1u)) ? acc : 0.f;
  }
  return keep;
}

// The CTA's part of a cloud's forward up to the Y/X-blurred planes: taps
// into shared memory and registers, the fixed-point splat into its planes
// (passes of Q planes through the scratch acc, every CTA adding its share
// of the points into the owners' scratch), the clamp and the Y and X blurs
// in place.  With kMask the clamp's mask is kept, a word a (plane, x)
// column.
template <bool kMask, int kThreads, int AS, int AK>
__device__ __forceinline__ void splat_and_blur_yx(
    const ProjArgs& a, cg::cluster_group cluster, int b, int rank, float* pl,
    unsigned long long* acc, uint64_t* mask, float* ks, float (&k)[AK], int S,
    int K, int P, int C, int Q, int own) {
  const int SP = row_stride(S);
  const int SS = S * S;
  const int h = K / 2;
  const int tid = threadIdx.x;
  for (int t = tid; t < K; t += kThreads) ks[t] = a.taps[t];
  const size_t off = static_cast<size_t>(b) * a.N;
  for (int q0 = 0; q0 < P; q0 += Q) {  // the planes [q0, q0 + Q) of each CTA
    for (int i = tid; i < Q * SS; i += kThreads) acc[i] = 0ull;
    cluster_arrive();  // this CTA's scratch zeroed, its last planes written
    // the thread's points, the next always in flight; the first arrives
    // while the cluster's barrier settles
    const int stride = C * kThreads;
    int i = rank * kThreads + tid;
    Point pt = load_point(a, off, i);
    cluster_wait();  // every CTA's scratch zeroed
    for (; i < a.N; i += stride) {
      const Point next = load_point(a, off, i + stride);
      const float w = pt.w;
      const float fz = floorf(pt.z);
      const int iz = static_cast<int>(fz);
      const int z0 = clamp_index(iz, S), z1 = clamp_index(iz + 1, S);
      const int l0 = z0 % P - q0, l1 = z1 % P - q0;
      const bool in0 = l0 >= 0 && l0 < Q, in1 = l1 >= 0 && l1 < Q;
      // culled and dropped points have w = 0
      if (w != 0.f && (in0 || in1)) {
        const float fy = floorf(pt.y), fx = floorf(pt.x);
        const int iy = static_cast<int>(fy), ix = static_cast<int>(fx);
        const float tz = pt.z - fz, ty = pt.y - fy, tx = pt.x - fx;
        const float wz[2] = {1.f - tz, tz};
        const float wy[2] = {1.f - ty, ty};
        const float wx[2] = {1.f - tx, tx};
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          if (!(dz ? in1 : in0)) continue;
          unsigned long long* cells =
              cluster.map_shared_rank(acc, (dz ? z1 : z0) / P) +
              static_cast<size_t>(dz ? l1 : l0) * SS;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int y = clamp_index(iy + dy, S);
            const float wzy = w * wz[dz] * wy[dy];
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              splat_add(cells + y * S + clamp_index(ix + dx, S),
                        wzy * wx[dx]);
          }
        }
      }
      pt = next;
    }
    cluster.sync();  // every corner of this pass added
    // scratch plane j -> float plane q0 + j, which may lie over scratch
    // planes < j + 1 only: read the whole plane, then write it
    for (int j = 0; j < min(Q, own - q0); ++j) {
      float v[kCells];
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const int i = tid + u * kThreads;
        if (i < SS) v[u] = __ull2float_rn(acc[j * SS + i]) * (1.f / kFixedOne);
      }
      __syncthreads();
      float* plane = pl + static_cast<size_t>(q0 + j) * S * SP;
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const int i = tid + u * kThreads;
        if (i < SS) plane[i / S * SP + i % S] = v[u];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < K; ++t) k[t] = ks[t];
  // clamp and Y blur: a thread a (plane, x) column
  for (int task = tid; task < own * S; task += kThreads) {
    const int p = task / S, x = task - p * S;
    const uint64_t keep = blur_line<false, true, false, AS>(
        pl + static_cast<size_t>(p) * S * SP + x, SP, k, S, K, h, 0);
    if (kMask) mask[task] = keep;
  }
  __syncthreads();
  // X blur: a thread a (plane, y) row
  for (int task = tid; task < own * S; task += kThreads)
    blur_line<false, false, false, AS>(pl + static_cast<size_t>(task) * SP, 1,
                                       k, S, K, h, 0);
}

// K1 along one ray: the Z blur of its column w, the scale and clamps, the
// termination as a running product; returns its silhouette pixel
template <int AS, int AK>
__device__ __forceinline__ float ray_silhouette(const float (&w)[AS],
                                                const float (&k)[AK], int S,
                                                int K, float sc, float eps) {
  const int h = K / 2;
  const float e0 = expf(eps);  // the leading plane: exp(eps + log o0)
  float sil = 0.f, T = 1.f;
#pragma unroll
  for (int z = 0; z < S; ++z) {
    const float zb = tap_sum<false>(w, k, z, S, K, h);
    const float o = fminf(fmaxf(fminf(zb * sc, 1.f), eps), 1.f - eps);
    sil = fmaf(z == 0 ? e0 : T, o, sil);
    T *= 1.f - o;
  }
  return sil;
}

// K2 along one ray, given its column w and silhouette cotangent gs: the Z
// blur zb (unscaled), the termination front to back, its VJP back to front
// into du; w <- scale * zblur^T(du); returns dscale's term, sum du * zb
template <int AS, int AK>
__device__ __forceinline__ float ray_vjp(float (&w)[AS], const float (&k)[AK],
                                         int S, int K, float sc, float eps,
                                         float gs) {
  const int h = K / 2;
  const float e0 = expf(eps);
  float zb[AS], tr[AS], du[AS];
  // pass 1: tr[z] = p_z / o_z, the transmittance before plane z (e^eps at
  // the leading plane)
  float T = 1.f;
#pragma unroll
  for (int z = 0; z < S; ++z) {
    zb[z] = tap_sum<false>(w, k, z, S, K, h);
    const float o = fminf(fmaxf(fminf(zb[z] * sc, 1.f), eps), 1.f - eps);
    tr[z] = z == 0 ? e0 : T;
    T *= 1.f - o;
  }
  // pass 2, back to front: dsil/dlog o_z = p_z and dsil/dlog(1 - o_z) =
  // sum_{j > z} p_j, through the clips and the top clamp of u.  The tail
  // runs from the back, as the plain chain's cumsum backward does: a total
  // minus a prefix (the TPU kernel's form) cancels where the tail is small,
  // and 1 / (1 - o) magnifies that by up to 1 / eps.
  float tail = 0.f, ds = 0.f;
#pragma unroll
  for (int z = S - 1; z >= 0; --z) {
    const float u = zb[z] * sc;
    const float sv = fminf(u, 1.f);
    const float o = fminf(fmaxf(sv, eps), 1.f - eps);
    const bool pass = u <= 1.f && sv >= eps && sv <= 1.f - eps;
    const float d = pass ? gs * tr[z] - gs * tail / (1.f - o) : 0.f;
    tail = fmaf(tr[z], o, tail);
    ds = fmaf(d, zb[z], ds);
    du[z] = sc * d;
  }
#pragma unroll
  for (int z = 0; z < S; ++z) w[z] = tap_sum<true>(du, k, z, S, K, h);
  return ds;
}

// The ray (y, x)'s z-column of the blurred grid from the CTAs that own
// its planes (distributed shared memory), or, with kStore, back to them.
// The owners are visited from r0 on; with C and P compiled in (kC > 0),
// every r0 is an instance of its own, so that the column stays in
// registers.
template <bool kStore, int kR0, int kC, int kP, int AS>
__device__ __forceinline__ void column_io(cg::cluster_group cluster,
                                          float* pl, float (&w)[AS], int y,
                                          int x, int S, int P, int C) {
  const int SP = row_stride(S);
  constexpr int kMod = kC > 0 ? kC : 1;
  const int n = kC > 0 ? kC : C;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const int r = kC > 0 ? (i + kR0) % kMod : i;
    const int np = kC > 0 ? kP : P;
    float* col = cluster.map_shared_rank(pl, r) + y * SP + x;
#pragma unroll
    for (int zl = 0; zl < np; ++zl) {
      const int z = r * np + zl;
      if (z >= S) break;
      if (kStore)
        col[zl * S * SP] = w[z];
      else
        w[z] = col[zl * S * SP];
    }
  }
}

// column_io with the owners visited from r0 (8 CTAs compiled in) or in
// rank order (the generic instance)
template <bool kStore, int kC, int kP, int AS>
__device__ __forceinline__ void column_io_from(cg::cluster_group cluster,
                                               float* pl, float (&w)[AS],
                                               int y, int x, int S, int P,
                                               int C, int r0) {
  if constexpr (kC == 8) {
    switch (r0) {
      case 0: column_io<kStore, 0, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      case 1: column_io<kStore, 1, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      case 2: column_io<kStore, 2, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      case 3: column_io<kStore, 3, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      case 4: column_io<kStore, 4, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      case 5: column_io<kStore, 5, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      case 6: column_io<kStore, 6, 8, kP>(cluster, pl, w, y, x, S, P, C); break;
      default: column_io<kStore, 7, 8, kP>(cluster, pl, w, y, x, S, P, C);
    }
  } else {
    static_assert(kC == 0, "the owners' order is compiled for 8 CTAs");
    column_io<kStore, 0, 0, 0>(cluster, pl, w, y, x, S, P, C);
  }
}

// kS, kK, kP: S, K and P compiled in, or 0 for the generic instance
template <int kS, int kK, int kP, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    proj_fwd_kernel(const ProjArgs a) {
  constexpr bool kExact = kS > 0;
  constexpr int AS = kExact ? kS : kMaxS;
  constexpr int AK = kExact ? kK : kMaxK;
  const int S = kExact ? kS : a.S;
  const int K = kExact ? kK : a.K;
  const int P = kExact ? kP : a.P;
  constexpr int kC = kExact ? (kS + kP - 1) / (kP > 0 ? kP : 1) : 0;
  const int C = kExact ? kC : a.C;
  const int Q = a.Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pl = reinterpret_cast<float*>(smem_raw);
  auto* acc = reinterpret_cast<unsigned long long*>(smem_raw +
                                                    scratch_offset(S, P, Q));
  float* ks = reinterpret_cast<float*>(smem_raw + arena_bytes(S, P, Q));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int own = min(P, S - rank * P);  // planes and ray rows of this CTA
  float k[AK];
  splat_and_blur_yx<false, kThreads, AS>(a, cluster, b, rank, pl, acc,
                                         nullptr, ks, k, S, K, P, C, Q, own);
  cluster.sync();  // every plane of the cloud blurred along Y and X

  const float sc = a.scale[b];
  const int r0 = (rank + static_cast<int>(threadIdx.x) / 32) % C;
  for (int task = threadIdx.x; task < own * S; task += kThreads) {
    const int y = rank * P + task / S, x = task % S;
    float w[AS];
    column_io_from<false, kC, kP>(cluster, pl, w, y, x, S, P, C,
                                                r0);
    a.out[(static_cast<size_t>(b) * S + (S - 1 - y)) * S + x] =
        ray_silhouette(w, k, S, K, sc, a.eps);
  }
  cluster.sync();  // no CTA leaves while another reads its planes
}

template <int kS, int kK, int kP, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    proj_bwd_kernel(const ProjArgs a) {
  constexpr bool kExact = kS > 0;
  constexpr int AS = kExact ? kS : kMaxS;
  constexpr int AK = kExact ? kK : kMaxK;
  const int S = kExact ? kS : a.S;
  const int K = kExact ? kK : a.K;
  const int P = kExact ? kP : a.P;
  constexpr int kC = kExact ? (kS + kP - 1) / (kP > 0 ? kP : 1) : 0;
  const int C = kExact ? kC : a.C;
  const int Q = a.Q;
  const int SP = row_stride(S);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pl = reinterpret_cast<float*>(smem_raw);
  auto* acc = reinterpret_cast<unsigned long long*>(smem_raw +
                                                    scratch_offset(S, P, Q));
  uint64_t* mask = reinterpret_cast<uint64_t*>(smem_raw +
                                               arena_bytes(S, P, Q));
  float* ks = reinterpret_cast<float*>(mask + static_cast<size_t>(P) * S);
  float* red = ks + kMaxK;  // [32] warp partials, [32] the CTA's sum
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int own = min(P, S - rank * P);
  const int tid = threadIdx.x;
  float k[AK];
  // (a) the forward up to the Y/X-blurred planes, with the clamp's mask
  splat_and_blur_yx<true, kThreads, AS>(a, cluster, b, rank, pl, acc, mask,
                                        ks, k, S, K, P, C, Q, own);
  cluster.sync();

  // (b) per ray: the termination's VJP (ray_vjp), and the ray's own column
  // <- scale * zblur^T(du)
  const float sc = a.scale[b];
  float ds = 0.f;
  const int r0 = (rank + tid / 32) % C;
  for (int task = tid; task < own * S; task += kThreads) {
    const int y = rank * P + task / S, x = task % S;
    // the silhouette is written flipped along Y
    const float gs = a.gsil[(static_cast<size_t>(b) * S + (S - 1 - y)) * S +
                            x];
    float w[AS];
    column_io_from<false, kC, kP>(cluster, pl, w, y, x, S, P, C,
                                                r0);
    ds += ray_vjp(w, k, S, K, sc, a.eps, gs);
    column_io_from<true, kC, kP>(cluster, pl, w, y, x, S, P, C,
                                               r0);
  }
  // the CTA's sum of du * zb: warp shuffles, then the warps in order
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) ds += __shfl_xor_sync(0xffffffffu, ds, m);
  if ((tid & 31) == 0) red[tid >> 5] = ds;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
    red[32] = sum;
  }
  cluster.sync();  // every column's cotangent written, every partial too

  // (c) the X and Y blurs' transposes, then the clamp's mask
  const int h = K / 2;
  for (int task = tid; task < own * S; task += kThreads)
    blur_line<true, false, false, AS>(pl + static_cast<size_t>(task) * SP, 1,
                                      k, S, K, h, 0);
  __syncthreads();
  for (int task = tid; task < own * S; task += kThreads) {
    const int p = task / S, x = task - p * S;
    blur_line<true, false, true, AS>(pl + static_cast<size_t>(p) * S * SP + x,
                                     SP, k, S, K, h, mask[task]);
  }
  cluster.sync();  // the cloud's voxel cotangents complete
  if (rank == 0 && tid == 0) {
    float sum = 0.f;
    for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(red, r)[32];
    a.dscale[b] = sum;
  }

  // (d) the splat's transpose, gathered per point: d(gz, gy, gx) = c x the
  // sum over the 8 corners of dvox x the derivative of the trilinear weight
  // (d tz / d gz = 1; the floor has no gradient); the ranks split the points
  const size_t off = static_cast<size_t>(b) * a.N;
  const float dw[2] = {-1.f, 1.f};
  for (int i = rank * kThreads + tid; i < a.N; i += C * kThreads) {
    const float w = a.c[off + i];
    float sz = 0.f, sy = 0.f, sx = 0.f;
    if (w != 0.f) {
      const float pz = a.gz[off + i], py = a.gy[off + i], px = a.gx[off + i];
      const float fz = floorf(pz), fy = floorf(py), fx = floorf(px);
      const int iz = static_cast<int>(fz), iy = static_cast<int>(fy),
                ix = static_cast<int>(fx);
      const float tz = pz - fz, ty = py - fy, tx = px - fx;
      const float wz[2] = {1.f - tz, tz};
      const float wy[2] = {1.f - ty, ty};
      const float wx[2] = {1.f - tx, tx};
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int z = clamp_index(iz + dz, S);
        const float* plane = cluster.map_shared_rank(pl, z / P) +
                             static_cast<size_t>(z % P) * S * SP;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int y = clamp_index(iy + dy, S);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int x = clamp_index(ix + dx, S);
            const float v = plane[y * SP + x];
            sz += v * dw[dz] * wy[dy] * wx[dx];
            sy += v * wz[dz] * dw[dy] * wx[dx];
            sx += v * wz[dz] * wy[dy] * dw[dx];
          }
        }
      }
    }
    a.dgz[off + i] = w * sz;
    a.dgy[off + i] = w * sy;
    a.dgx[off + i] = w * sx;
  }
  cluster.sync();  // no CTA leaves while another reads its planes
}

using Kernel = void (*)(const ProjArgs);

// the kernel instance and block size for (S, K, P); false if the plan
// (cluster C, planes P, splat passes of Q planes) is not one the kernels
// take
bool pick(bool bwd, int S, int K, int C, int P, int Q, Kernel* fn,
          int* threads) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxK || P < 1 || P > S ||
      C != (S + P - 1) / P || C > kMaxCluster || Q < 1 || Q > P)
    return false;
  const bool exact = S == kExactS && K == kExactK && P == kPlanes;
  if (exact) {
    *fn = bwd ? proj_bwd_kernel<kExactS, kExactK, kPlanes, kBwdThreads>
              : proj_fwd_kernel<kExactS, kExactK, kPlanes, kFwdThreads>;
    *threads = bwd ? kBwdThreads : kFwdThreads;
  } else {
    *fn = bwd ? proj_bwd_kernel<0, 0, 0, kGenericThreads>
              : proj_fwd_kernel<0, 0, 0, kGenericThreads>;
    *threads = kGenericThreads;
  }
  return true;
}

cudaLaunchConfig_t launch_config(int grid, int threads, size_t smem,
                                 cudaStream_t st, cudaLaunchAttribute* attr,
                                 int C) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One cluster launch of B clouds, after checking the plan (cluster C,
// planes P, passes of Q planes, the shared memory the plan counted).
int launch(bool bwd, const ProjArgs& a, int B, size_t smem, void* stream) {
  Kernel fn;
  int threads;
  if (!pick(bwd, a.S, a.K, a.C, a.P, a.Q, &fn, &threads) ||
      smem != proj_smem(a.S, a.P, a.Q, bwd) || B < 0 || a.N < 0 ||
      a.N >= kMaxPoints ||
      static_cast<long long>(B) * a.C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      B * a.C, threads, smem, static_cast<cudaStream_t>(stream), attr, a.C);
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K1: out (B, S, S) = the silhouettes of the (B, N) grid-coordinate planes
// gz, gy, gx with splat weights c, taps (K,) and scale (B,), under the plan
// (cluster, planes, stage = the splat's planes a pass, smem).
extern "C" int im23d_projection_fwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K,
                                    const void* scale, void* out, int B,
                                    int N, int S, float eps, int cluster,
                                    int planes, int stage, long long smem,
                                    void* stream) {
  ProjArgs a = {};
  a.gz = static_cast<const float*>(gz);
  a.gy = static_cast<const float*>(gy);
  a.gx = static_cast<const float*>(gx);
  a.c = static_cast<const float*>(c);
  a.taps = static_cast<const float*>(taps);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.S = S;
  a.K = K;
  a.N = N;
  a.P = planes;
  a.C = cluster;
  a.Q = stage;
  a.eps = eps;
  return launch(false, a, B, static_cast<size_t>(smem), stream);
}

// K2: d(gz, gy, gx) (B, N) and dscale (B,) from the silhouette cotangent
// gsil (B, S, S); every output is written, none needs an initial value.
extern "C" int im23d_projection_bwd(const void* gz, const void* gy,
                                    const void* gx, const void* c,
                                    const void* taps, int K,
                                    const void* scale, const void* gsil,
                                    void* dscale, void* dgz, void* dgy,
                                    void* dgx, int B, int N, int S, float eps,
                                    int cluster, int planes, int stage,
                                    long long smem, void* stream) {
  ProjArgs a = {};
  a.gz = static_cast<const float*>(gz);
  a.gy = static_cast<const float*>(gy);
  a.gx = static_cast<const float*>(gx);
  a.c = static_cast<const float*>(c);
  a.taps = static_cast<const float*>(taps);
  a.scale = static_cast<const float*>(scale);
  a.gsil = static_cast<const float*>(gsil);
  a.dscale = static_cast<float*>(dscale);
  a.dgz = static_cast<float*>(dgz);
  a.dgy = static_cast<float*>(dgy);
  a.dgx = static_cast<float*>(dgx);
  a.S = S;
  a.K = K;
  a.N = N;
  a.P = planes;
  a.C = cluster;
  a.Q = stage;
  a.eps = eps;
  return launch(true, a, B, static_cast<size_t>(smem), stream);
}

// What projection_plan reads (ops/projection.py ProjectionLimits): the
// card's opt-in shared memory a block, then the kernels' constants.
extern "C" int im23d_projection_limits(int dev, int* out) {
  const cudaError_t err = cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int k[] = {kMaxCluster, kMaxS, kMaxK, kPlanes,
                   static_cast<int>(kExtraFloats * sizeof(float)),
                   kMaxPoints};
  for (int i = 0; i < static_cast<int>(sizeof k / sizeof k[0]); ++i)
    out[1 + i] = k[i];
  return err;
}

// The most clusters of a plan that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int im23d_projection_occupancy(int S, int K, int cluster,
                                          int planes, int stage, int bwd,
                                          long long smem, int* out) {
  Kernel fn;
  int threads;
  if (!pick(bwd != 0, S, K, cluster, planes, stage, &fn, &threads) ||
      static_cast<size_t>(smem) != proj_smem(S, planes, stage, bwd != 0))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, threads, static_cast<size_t>(smem), nullptr,
                    attr, cluster);
  return cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(fn),
                                        &cfg);
}
