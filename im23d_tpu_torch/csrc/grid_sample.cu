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
// What bounds it: d img is a scatter.  The TPU kernel revisits one VMEM
// block of d img serially; here blocks run in parallel, so d img is
// accumulated with atomicAdd into L2-resident textures (10 MB at the train
// shape).  At the visibility render (50 x 1024^2 samples into 128 x 130
// texels per image) about 60 samples share a texel and the atomics
// collide: a simple kernel, timed in PERF.md; warp aggregation is left for
// later.  The order of the atomic sums changes from run to run.  Both
// directions take the corners and weights from bilinear() below.
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

// img (B, H, W, C), grid (B, P, 2), dout (B, P, C); dimg (B, H, W, C), zeroed
// by the caller, and dgrid (B, P, 2), either null when not wanted; float32.
extern "C" int im23d_grid_sample_bwd(const void* img, const void* grid,
                                     const void* dout, void* dimg,
                                     void* dgrid, int B, int H, int W, int C,
                                     int P, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || P < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(B) * P;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_sample_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(grid),
      static_cast<const float*>(dout), static_cast<float*>(dimg),
      static_cast<float*>(dgrid), H, W, C, total, P);
  return cudaGetLastError();
}
