// K5: bilinear texture lookup (align_corners=True, zero padding), sm_90a.
//
// Replaces the Pallas TPU kernel im23d_tpu/ops/sampling_pallas.py
// _fwd_kernel (the forward of grid_sample_bilinear_pallas).
// out[b, p, c] = sum over the four corners (yi, xi) of the sample point of
//   w(yi, xi) * img[b, yi, xi, c], a corner outside the image giving zero,
// with x = (g.x + 1) / 2 * (W - 1) and y = (g.y + 1) / 2 * (H - 1).
//
// What bounds it on the H100: the bytes of the grid read and the output
// write, and the latency of a data-dependent gather.  At the renderer's
// shape (50 textures of 128 x 130 x 3 sampled at 50 x 256 x 256) the
// textures are 10 MB and stay in L2; the grid read and the output write
// are 26 MB and 39 MB of streaming traffic.  Design: a thread takes four
// neighbouring samples, reads their grid as two 16-byte loads, finds each
// sample's four corners, their validity and weights once, reads each
// valid corner's C values together (one 16-byte load for C = 4), and
// writes the four samples' 4 x C outputs as C 16-byte stores, so that a
// warp's loads and stores are whole, neighbouring lines.  Other channel
// counts, misaligned operands and the last few samples take one sample a
// thread.  The TPU kernel's VMEM row windows, column tiers and hat matmuls
// served the MXU and have no counterpart: any texture size works.
//
// The arithmetic is the plain version's, operation by operation and with
// FMA contraction ruled out, so the two agree to the last bit.
//
// The backward (im23d_grid_sample_bwd) replaces sampling_pallas.py
// _bwd_kernel (the VJP of grid_sample_bilinear_pallas) and gives what
// autograd of the plain gather gives:
//   d img[b, corner, c] += d out[b, p, c] * w(corner), a corner outside the
//     image adding nothing; a zero product is not added, so a texel that no
//     sample weighs stays exactly 0 (pseudo-GT visibility tests d img > 0);
//   d grid from the four corners: d w(corner) = sum_c d out * img(corner),
//     d x = d wx1 - d wx0 (floor has no derivative), times (W - 1) / 2.
// What bounds it: the bytes of the upstream and grid read and d grid
// written, once the scatter into d img stops serialising.  The TPU kernel
// revisits one VMEM block of d img serially; here blocks run in parallel,
// and at the 1024^2 visibility render about 60 samples share each texel,
// so adds into one address collide (the atomic kernel of one thread a
// sample spent 3.1 of its 3.7 ms there: NVIDIA H100 80GB HBM3, 700 W,
// tools/time_split.py --only k5b).  Design, one launch (d img zeroed by
// the caller): a thread takes a run of neighbouring samples of one image
// (8 to 64, about as many as fall on one texel: the plan's), kRunSpt at a
// time: it reads their upstream as 16-byte loads and
// their grid only if one of them contributes (a sample whose upstream is 0
// on every channel adds nothing and gets d grid 0 without reading its
// corners), and keeps the sums of one corner cell's 4 x C texels in
// registers.  When the next sample's cell is one step away along x or y,
// the two texels the cells share stay in registers and only the other two
// are added to d img; any other move adds all four.  The adds are
// atomicAdds into device memory, which L2 carries out as native float
// adds.  A copy of d texture in each CTA's shared memory (a cluster of
// CTAs an image, the copies summed over distributed shared memory) was
// tried and read 1.0-1.2 ms at the visibility shape: Hopper has no
// shared-memory float add, and atomicAdd there is a compare-and-swap loop
// (ATOMS.CAST.SPIN) that costs several times L2's add.  d grid reads the
// corners from the L2-resident texture, as the forward does.  Textures of
// more than kRunMaxC channels take one thread a sample.
// The atomics add in an order that changes from run to run, so d img is
// not bit-equal between launches; d grid is (no atomics), and equal to the
// one-thread-a-sample kernel's bit for bit.  Both directions take the
// corners and weights from bilinear() below.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// a sample point's corners and weights, in the plain version's order of
// operations
struct Bilinear {
  float x0, y0, x1, y1, wx0, wx1, wy0, wy1;
};

__device__ __forceinline__ Bilinear bilinear(float gx, float gy, int H,
                                             int W) {
  Bilinear t;
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f),
                            static_cast<float>(W - 1));
  const float y = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f),
                            static_cast<float>(H - 1));
  t.x0 = floorf(x);
  t.y0 = floorf(y);
  t.x1 = __fadd_rn(t.x0, 1.f);
  t.y1 = __fadd_rn(t.y0, 1.f);
  t.wx1 = __fsub_rn(x, t.x0);
  t.wx0 = __fsub_rn(1.f, t.wx1);
  t.wy1 = __fsub_rn(y, t.y0);
  t.wy0 = __fsub_rn(1.f, t.wy1);
  return t;
}

// the plain version tests the float corner, then clamps and truncates
__device__ __forceinline__ bool inside(float yi, float xi, int H, int W) {
  return yi >= 0.f && yi < static_cast<float>(H) && xi >= 0.f &&
         xi < static_cast<float>(W);
}

__device__ __forceinline__ float corner(const float* __restrict__ img, float yi,
                                        float xi, int H, int W, int C, int c) {
  if (!inside(yi, xi, H, W)) return 0.f;
  const int y = static_cast<int>(yi), x = static_cast<int>(xi);
  return __ldg(img + (static_cast<size_t>(y) * W + x) * C + c);
}

// one sample's C outputs (C > 0 known at compile time): each valid
// corner's C values read together, each output summed over the corners in
// the plain version's order (00, 01, 10, 11)
template <int C>
__device__ __forceinline__ void sample(const float* __restrict__ imb,
                                       float gx, float gy, int H, int W,
                                       float* __restrict__ res) {
  const Bilinear t = bilinear(gx, gy, H, W);
  const float ys[4] = {t.y0, t.y0, t.y1, t.y1};
  const float xs[4] = {t.x0, t.x1, t.x0, t.x1};
  const float ws[4] = {__fmul_rn(t.wy0, t.wx0), __fmul_rn(t.wy0, t.wx1),
                       __fmul_rn(t.wy1, t.wx0), __fmul_rn(t.wy1, t.wx1)};
  float v[4][C];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool ok = inside(ys[q], xs[q], H, W);
    const float* src =
        imb + (ok ? (static_cast<size_t>(static_cast<int>(ys[q])) * W +
                     static_cast<int>(xs[q])) * C
                  : 0);
    if (C == 4) {
      const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(src))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[q][0] = f.x;
      v[q][1 % C] = f.y;
      v[q][2 % C] = f.z;
      v[q][3 % C] = f.w;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[q][c] = ok ? __ldg(src + c) : 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(v[0][c], ws[0]);
    acc = __fadd_rn(acc, __fmul_rn(v[1][c], ws[1]));
    acc = __fadd_rn(acc, __fmul_rn(v[2][c], ws[2]));
    acc = __fadd_rn(acc, __fmul_rn(v[3][c], ws[3]));
    res[c] = acc;
  }
}

constexpr int SPT = 4;  // samples a thread of the vectorised forward

// four neighbouring samples a thread: grid as two 16-byte loads, output as
// C 16-byte stores (grid and out 16-byte aligned, img too for C = 4); the
// last thread's partial group one sample at a time
template <int C>
__global__ void grid_sample_vec_kernel(const float* __restrict__ img,
                                       const float* __restrict__ grid,
                                       float* __restrict__ out, int H, int W,
                                       long long total, int P) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * SPT;
  if (i0 >= total) return;
  const size_t tex = static_cast<size_t>(H) * W * C;
  if (i0 + SPT <= total) {
    const float4 g01 = __ldg(reinterpret_cast<const float4*>(grid + 2 * i0));
    const float4 g23 =
        __ldg(reinterpret_cast<const float4*>(grid + 2 * i0 + 4));
    const float gx[SPT] = {g01.x, g01.z, g23.x, g23.z};
    const float gy[SPT] = {g01.y, g01.w, g23.y, g23.w};
    float res[SPT * C];
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      sample<C>(img + static_cast<size_t>((i0 + s) / P) * tex, gx[s], gy[s],
                H, W, res + s * C);
    float4* o = reinterpret_cast<float4*>(out + i0 * C);
#pragma unroll
    for (int q = 0; q < C; ++q)
      o[q] = make_float4(res[4 * q], res[4 * q + 1], res[4 * q + 2],
                         res[4 * q + 3]);
    return;
  }
  for (long long i = i0; i < total; ++i) {
    float res[C];
    sample<C>(img + static_cast<size_t>(i / P) * tex, grid[2 * i],
              grid[2 * i + 1], H, W, res);
#pragma unroll
    for (int c = 0; c < C; ++c) out[i * C + c] = res[c];
  }
}

// any C and alignment: a thread a sample, corners found once, C loads a
// corner
__global__ void grid_sample_kernel(const float* __restrict__ img,
                                   const float* __restrict__ grid,
                                   float* __restrict__ out, int H, int W,
                                   int C, long long total, int P) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const Bilinear t = bilinear(grid[2 * i], grid[2 * i + 1], H, W);
  const float ys[4] = {t.y0, t.y0, t.y1, t.y1};
  const float xs[4] = {t.x0, t.x1, t.x0, t.x1};
  const float ws[4] = {__fmul_rn(t.wy0, t.wx0), __fmul_rn(t.wy0, t.wx1),
                       __fmul_rn(t.wy1, t.wx0), __fmul_rn(t.wy1, t.wx1)};
  const float* imb = img + static_cast<size_t>(i / P) * H * W * C;
  const float* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    src[q] = inside(ys[q], xs[q], H, W)
                 ? imb + (static_cast<size_t>(static_cast<int>(ys[q])) * W +
                          static_cast<int>(xs[q])) * C
                 : nullptr;
  float* o = out + static_cast<size_t>(i) * C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float p = __fmul_rn(src[q] ? __ldg(src[q] + c) : 0.f, ws[q]);
      acc = q == 0 ? p : __fadd_rn(acc, p);
    }
    o[c] = acc;
  }
}

__device__ __forceinline__ void scatter(float* __restrict__ dimg, float yi,
                                        float xi, float w, int H, int W,
                                        int C, const float* __restrict__ g) {
  if (w == 0.f || !inside(yi, xi, H, W)) return;
  const int y = static_cast<int>(yi), x = static_cast<int>(xi);
  float* d = dimg + (static_cast<size_t>(y) * W + x) * C;
  for (int c = 0; c < C; ++c) {
    const float v = __fmul_rn(g[c], w);
    if (v != 0.f) atomicAdd(d + c, v);
  }
}

// dimg (zeroed by the caller) and dgrid may each be null: not wanted.
__global__ void grid_sample_bwd_kernel(const float* __restrict__ img,
                                       const float* __restrict__ grid,
                                       const float* __restrict__ dout,
                                       float* __restrict__ dimg,
                                       float* __restrict__ dgrid, int H,
                                       int W, int C, long long total, int P) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int b = static_cast<int>(i / P);
  const Bilinear t = bilinear(grid[2 * i], grid[2 * i + 1], H, W);
  const float x0 = t.x0, y0 = t.y0, x1 = t.x1, y1 = t.y1;
  const float wx0 = t.wx0, wx1 = t.wx1, wy0 = t.wy0, wy1 = t.wy1;
  const float* g = dout + static_cast<size_t>(i) * C;
  const size_t img_off = static_cast<size_t>(b) * H * W * C;
  if (dimg != nullptr) {
    float* d = dimg + img_off;
    scatter(d, y0, x0, __fmul_rn(wy0, wx0), H, W, C, g);
    scatter(d, y0, x1, __fmul_rn(wy0, wx1), H, W, C, g);
    scatter(d, y1, x0, __fmul_rn(wy1, wx0), H, W, C, g);
    scatter(d, y1, x1, __fmul_rn(wy1, wx1), H, W, C, g);
  }
  if (dgrid != nullptr) {
    const float* imb = img + img_off;
    float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
    for (int c = 0; c < C; ++c) {
      const float gc = g[c];
      d00 = __fadd_rn(d00, __fmul_rn(gc, corner(imb, y0, x0, H, W, C, c)));
      d01 = __fadd_rn(d01, __fmul_rn(gc, corner(imb, y0, x1, H, W, C, c)));
      d10 = __fadd_rn(d10, __fmul_rn(gc, corner(imb, y1, x0, H, W, C, c)));
      d11 = __fadd_rn(d11, __fmul_rn(gc, corner(imb, y1, x1, H, W, C, c)));
    }
    // w00 = wy0 wx0, w01 = wy0 wx1, w10 = wy1 wx0, w11 = wy1 wx1
    const float dwx1 = __fadd_rn(__fmul_rn(d01, wy0), __fmul_rn(d11, wy1));
    const float dwx0 = __fadd_rn(__fmul_rn(d00, wy0), __fmul_rn(d10, wy1));
    const float dwy1 = __fadd_rn(__fmul_rn(d10, wx0), __fmul_rn(d11, wx1));
    const float dwy0 = __fadd_rn(__fmul_rn(d00, wx0), __fmul_rn(d01, wx1));
    dgrid[2 * i] = __fmul_rn(__fmul_rn(__fsub_rn(dwx1, dwx0),
                                       static_cast<float>(W - 1)), 0.5f);
    dgrid[2 * i + 1] = __fmul_rn(__fmul_rn(__fsub_rn(dwy1, dwy0),
                                           static_cast<float>(H - 1)), 0.5f);
  }
}

// add corner q's sums (q = 2 dy + dx of the cell at (cy, cx)) into the
// image's d texture; a corner outside the image and a zero sum add nothing
template <int C>
__device__ __forceinline__ void flush_corner(float* acc, float cy, float cx,
                                             int q, const float (&a)[C],
                                             int H, int W) {
  const float y = (q & 2) ? __fadd_rn(cy, 1.f) : cy;
  const float x = (q & 1) ? __fadd_rn(cx, 1.f) : cx;
  if (!inside(y, x, H, W)) return;
  float* d = acc + (static_cast<int>(y) * W + static_cast<int>(x)) * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (a[c] != 0.f) atomicAdd(d + c, a[c]);
}

// move the register window from cell (cy, cx) to cell (ny, nx): a step of
// one cell along x or y keeps the two corners the cells share (their sums
// move to the new cell's corners) and adds only the other two to d
// texture; any other move adds all four.
template <int C>
__device__ __forceinline__ void step_cell(float* acc, float& cy, float& cx,
                                          float (&a)[4][C], float ny,
                                          float nx, int H, int W) {
  if (ny == cy && nx == cx) return;
  const bool right = ny == cy && nx == __fadd_rn(cx, 1.f);
  const bool left = ny == cy && nx == __fsub_rn(cx, 1.f);
  const bool down = nx == cx && ny == __fadd_rn(cy, 1.f);
  const bool up = nx == cx && ny == __fsub_rn(cy, 1.f);
  // corner q = 2 dy + dx; right keeps 1 and 3 (as 0 and 2), left 0 and 2
  // (as 1 and 3), down 2 and 3 (as 0 and 1), up 0 and 1 (as 2 and 3)
  if (!(left || up)) flush_corner<C>(acc, cy, cx, 0, a[0], H, W);
  if (!(right || up)) flush_corner<C>(acc, cy, cx, 1, a[1], H, W);
  if (!(left || down)) flush_corner<C>(acc, cy, cx, 2, a[2], H, W);
  if (!(right || down)) flush_corner<C>(acc, cy, cx, 3, a[3], H, W);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a0 = a[0][c], a1 = a[1][c], a2 = a[2][c], a3 = a[3][c];
    a[0][c] = right ? a1 : down ? a2 : 0.f;
    a[1][c] = left ? a0 : down ? a3 : 0.f;
    a[2][c] = right ? a3 : up ? a0 : 0.f;
    a[3][c] = left ? a2 : up ? a1 : 0.f;
  }
  cy = ny;
  cx = nx;
}

// one sample's d grid from its upstream g and the texture's corners, in the
// generic kernel's order of operations
template <int C>
__device__ __forceinline__ void sample_dgrid(const float* __restrict__ imb,
                                             const Bilinear& t,
                                             const float (&g)[C], int H,
                                             int W, float* dx, float* dy) {
  float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float gc = g[c];
    d00 = __fadd_rn(d00, __fmul_rn(gc, corner(imb, t.y0, t.x0, H, W, C, c)));
    d01 = __fadd_rn(d01, __fmul_rn(gc, corner(imb, t.y0, t.x1, H, W, C, c)));
    d10 = __fadd_rn(d10, __fmul_rn(gc, corner(imb, t.y1, t.x0, H, W, C, c)));
    d11 = __fadd_rn(d11, __fmul_rn(gc, corner(imb, t.y1, t.x1, H, W, C, c)));
  }
  const float dwx1 = __fadd_rn(__fmul_rn(d01, t.wy0), __fmul_rn(d11, t.wy1));
  const float dwx0 = __fadd_rn(__fmul_rn(d00, t.wy0), __fmul_rn(d10, t.wy1));
  const float dwy1 = __fadd_rn(__fmul_rn(d10, t.wx0), __fmul_rn(d11, t.wx1));
  const float dwy0 = __fadd_rn(__fmul_rn(d00, t.wx0), __fmul_rn(d01, t.wx1));
  *dx = __fmul_rn(__fmul_rn(__fsub_rn(dwx1, dwx0), static_cast<float>(W - 1)),
                  0.5f);
  *dy = __fmul_rn(__fmul_rn(__fsub_rn(dwy1, dwy0), static_cast<float>(H - 1)),
                  0.5f);
}

// -- the register-window backward -----------------------------------------

constexpr int kRunThreads = 256;  // threads of a block
constexpr int kRunSpt = 4;        // samples a thread reads at once
constexpr int kRunMaxC = 4;       // channels the kernel takes
constexpr int kRunMax = 1024;     // samples a run at most

// a thread a run of ``run`` (a multiple of kRunSpt) neighbouring samples of
// one image, one corner cell's sums in registers across the run
// (step_cell), flushed into d img (zeroed by the caller) by atomicAdd in
// device memory, which L2 carries out as a native float add.  vec: P % 4
// == 0 and grid, dout and dgrid 16-byte aligned.
template <int C, bool kGrid>
__global__ void __launch_bounds__(kRunThreads)
    grid_sample_bwd_run_kernel(const float* __restrict__ img,
                               const float* __restrict__ grid,
                               const float* __restrict__ dout,
                               float* __restrict__ dimg,
                               float* __restrict__ dgrid, int H, int W, int P,
                               int run, long long runs, int vec) {
  const long long t = static_cast<long long>(blockIdx.x) * kRunThreads +
                      threadIdx.x;
  const int per_image = (P + run - 1) / run;
  if (t >= runs) return;
  const int b = static_cast<int>(t / per_image);
  const int r = static_cast<int>(t % per_image);
  const int n = H * W * C;
  const size_t first = static_cast<size_t>(b) * P;
  const float* gr = grid + 2 * first;
  const float* up = dout + C * first;
  const float* imb = img + static_cast<size_t>(b) * n;
  float* to = dimg + static_cast<size_t>(b) * n;
  float* dg = kGrid ? dgrid + 2 * first : nullptr;
  float cy = __int_as_float(0x7fc00000), cx = cy;  // no cell yet (NaN)
  float a[4][C];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < C; ++c) a[p][c] = 0.f;
  const int end = min(P, r * run + run);
  for (int s0 = r * run; s0 < end; s0 += kRunSpt) {
    const int m = min(kRunSpt, P - s0);
    const bool full = vec && m == kRunSpt;
    float g[kRunSpt][C];
    if (full) {
      float u[kRunSpt * C];
      const float4* u4 = reinterpret_cast<const float4*>(up + C * s0);
#pragma unroll
      for (int j = 0; j < kRunSpt * C / 4; ++j) {
        const float4 f = __ldg(u4 + j);
        u[4 * j] = f.x;
        u[4 * j + 1] = f.y;
        u[4 * j + 2] = f.z;
        u[4 * j + 3] = f.w;
      }
#pragma unroll
      for (int s = 0; s < kRunSpt; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c) g[s][c] = u[s * C + c];
    } else {
#pragma unroll
      for (int s = 0; s < kRunSpt; ++s)
#pragma unroll
        for (int c = 0; c < C; ++c)
          g[s][c] = s < m ? up[C * (s0 + s) + c] : 0.f;
    }
    bool nz[kRunSpt];
    bool any = false;
#pragma unroll
    for (int s = 0; s < kRunSpt; ++s) {
      nz[s] = false;
#pragma unroll
      for (int c = 0; c < C; ++c) nz[s] = nz[s] || g[s][c] != 0.f;
      any = any || nz[s];
    }
    float dgx[kRunSpt], dgy[kRunSpt];
#pragma unroll
    for (int s = 0; s < kRunSpt; ++s) dgx[s] = dgy[s] = 0.f;
    if (any) {
      float gx[kRunSpt], gy[kRunSpt];
      if (full) {
        const float4* g4 = reinterpret_cast<const float4*>(gr + 2 * s0);
#pragma unroll
        for (int j = 0; j < kRunSpt / 2; ++j) {
          const float4 f = __ldg(g4 + j);
          gx[2 * j] = f.x;
          gy[2 * j] = f.y;
          gx[2 * j + 1] = f.z;
          gy[2 * j + 1] = f.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < kRunSpt; ++s) {
          gx[s] = s < m ? gr[2 * (s0 + s)] : 0.f;
          gy[s] = s < m ? gr[2 * (s0 + s) + 1] : 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < kRunSpt; ++s) {
        if (!nz[s]) continue;
        const Bilinear t = bilinear(gx[s], gy[s], H, W);
        step_cell<C>(to, cy, cx, a, t.y0, t.x0, H, W);
        const float ws[4] = {__fmul_rn(t.wy0, t.wx0), __fmul_rn(t.wy0, t.wx1),
                             __fmul_rn(t.wy1, t.wx0), __fmul_rn(t.wy1, t.wx1)};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int c = 0; c < C; ++c)
            a[p][c] = __fadd_rn(a[p][c], __fmul_rn(g[s][c], ws[p]));
        if (kGrid) sample_dgrid<C>(imb, t, g[s], H, W, &dgx[s], &dgy[s]);
      }
    }
    if (kGrid) {
      if (full) {
        float4* o = reinterpret_cast<float4*>(dg + 2 * s0);
#pragma unroll
        for (int j = 0; j < kRunSpt / 2; ++j)
          __stcs(o + j, make_float4(dgx[2 * j], dgy[2 * j], dgx[2 * j + 1],
                                    dgy[2 * j + 1]));
      } else {
        for (int s = 0; s < m; ++s) {
          dg[2 * (s0 + s)] = dgx[s];
          dg[2 * (s0 + s) + 1] = dgy[s];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) flush_corner<C>(to, cy, cx, q, a[q], H, W);
}

using RunKernel = void (*)(const float*, const float*, const float*, float*,
                           float*, int, int, int, int, long long, int);

template <int C>
RunKernel run_bwd(bool grad) {
  return grad ? grid_sample_bwd_run_kernel<C, true>
              : grid_sample_bwd_run_kernel<C, false>;
}

}  // namespace

// img (B, H, W, C), grid (B, P, 2) with P = Hg * Wg, out (B, P, C); float32.
extern "C" int im23d_grid_sample_fwd(const void* img, const void* grid,
                                     void* out, int B, int H, int W, int C,
                                     int P, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || P < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(B) * P;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const float*>(img);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<float*>(out);
  const bool aligned = reinterpret_cast<uintptr_t>(gr) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                       (C != 4 || reinterpret_cast<uintptr_t>(im) % 16 == 0);
  if (aligned && (C == 1 || C == 3 || C == 4)) {
    const long long threads = (total + SPT - 1) / SPT;
    const long long blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const unsigned nb = static_cast<unsigned>(blocks);
    if (C == 1)
      grid_sample_vec_kernel<1><<<nb, kThreads, 0, s>>>(im, gr, o, H, W,
                                                        total, P);
    else if (C == 3)
      grid_sample_vec_kernel<3><<<nb, kThreads, 0, s>>>(im, gr, o, H, W,
                                                        total, P);
    else
      grid_sample_vec_kernel<4><<<nb, kThreads, 0, s>>>(im, gr, o, H, W,
                                                        total, P);
    return cudaGetLastError();
  }
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      im, gr, o, H, W, C, total, P);
  return cudaGetLastError();
}

// img (B, H, W, C), grid (B, P, 2), dout (B, P, C); dimg (B, H, W, C),
// zeroed by the caller, and dgrid (B, P, 2), either null when not wanted;
// float32.  run > 0: the register-window kernel, runs of ``run`` samples
// (C <= kRunMaxC, dimg wanted), else a thread a sample; the plan
// (grid_sample_backward_plan) chooses, and a plan this file cannot run is
// refused.
extern "C" int im23d_grid_sample_bwd(const void* img, const void* grid,
                                     const void* dout, void* dimg,
                                     void* dgrid, int B, int H, int W, int C,
                                     int P, int run, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || P < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const float*>(img);
  const auto* gr = static_cast<const float*>(grid);
  const auto* up = static_cast<const float*>(dout);
  auto* di = static_cast<float*>(dimg);
  auto* dg = static_cast<float*>(dgrid);
  if (run != 0) {
    if (di == nullptr || C > kRunMaxC || run < 0 || run > kRunMax ||
        run % kRunSpt != 0)
      return cudaErrorInvalidValue;
    RunKernel fn;
    switch (C) {
      case 1: fn = run_bwd<1>(dg != nullptr); break;
      case 2: fn = run_bwd<2>(dg != nullptr); break;
      case 3: fn = run_bwd<3>(dg != nullptr); break;
      default: fn = run_bwd<4>(dg != nullptr);
    }
    const auto a16 = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const int vec =
        P % 4 == 0 && a16(gr) && a16(up) && (dg == nullptr || a16(dg));
    const long long n = static_cast<long long>(B) * ((P + run - 1) / run);
    const long long blocks = (n + kRunThreads - 1) / kRunThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    fn<<<static_cast<unsigned>(blocks), kRunThreads, 0, st>>>(
        im, gr, up, di, dg, H, W, P, run, n, vec);
    return cudaGetLastError();
  }
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(B) * P;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_sample_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      im, gr, up, di, dg, H, W, C, total, P);
  return cudaGetLastError();
}

// The register-window kernel's constants, for the host-side plan: the
// largest channel count, threads a block, samples a thread reads at once
// and samples a run at most.
extern "C" int im23d_k5b_limits(int* out) {
  out[0] = kRunMaxC;
  out[1] = kRunThreads;
  out[2] = kRunSpt;
  out[3] = kRunMax;
  return cudaSuccess;
}
