// K5: bilinear texture lookup (align_corners=True, zero padding), sm_90a.
//
// Replaces the Pallas TPU kernel im23d_tpu/ops/sampling_pallas.py
// _fwd_kernel (the forward of grid_sample_bilinear_pallas).
// out[b, p, c] = sum over the four corners (yi, xi) of the sample point of
//   w(yi, xi) * img[b, yi, xi, c], a corner outside the image giving zero,
// with x = (g.x + 1) / 2 * (W - 1) and y = (g.y + 1) / 2 * (H - 1).
//
// What bounds it on the H100: memory latency of a data-dependent gather.
// At the renderer's shape (50 textures of 128 x 130 x 3 sampled at
// 50 x 256 x 256) the textures are 10 MB and stay in L2; the grid read and
// the output write are 26 MB and 39 MB of streaming traffic.  Design: one
// thread per output sample, neighbouring threads on neighbouring samples (so
// the grid read and the output write are coalesced), four corner reads of C
// floats each.  The TPU kernel's VMEM row windows, column tiers and hat
// matmuls served the MXU and have no counterpart: any texture size works.
//
// The arithmetic is the plain version's, operation by operation and with
// FMA contraction ruled out, so the two agree to the last bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float corner(const float* __restrict__ img, float yi,
                                        float xi, int H, int W, int C, int c) {
  // the plain version tests the float corner, then clamps and truncates
  if (!(yi >= 0.f && yi < static_cast<float>(H) && xi >= 0.f &&
        xi < static_cast<float>(W)))
    return 0.f;
  const int y = static_cast<int>(yi), x = static_cast<int>(xi);
  return __ldg(img + (static_cast<size_t>(y) * W + x) * C + c);
}

__global__ void grid_sample_kernel(const float* __restrict__ img,
                                   const float* __restrict__ grid,
                                   float* __restrict__ out, int H, int W,
                                   int C, long long total, int P) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  const int b = static_cast<int>(i / P);
  const float gx = grid[2 * i], gy = grid[2 * i + 1];
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f),
                            static_cast<float>(W - 1));
  const float y = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f),
                            static_cast<float>(H - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float wx1 = __fsub_rn(x, x0), wx0 = __fsub_rn(1.f, wx1);
  const float wy1 = __fsub_rn(y, y0), wy0 = __fsub_rn(1.f, wy1);
  const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
  const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
  const float* imb = img + static_cast<size_t>(b) * H * W * C;
  float* o = out + static_cast<size_t>(i) * C;
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(corner(imb, y0, x0, H, W, C, c), w00);
    acc = __fadd_rn(acc, __fmul_rn(corner(imb, y0, x1, H, W, C, c), w01));
    acc = __fadd_rn(acc, __fmul_rn(corner(imb, y1, x0, H, W, C, c), w10));
    acc = __fadd_rn(acc, __fmul_rn(corner(imb, y1, x1, H, W, C, c), w11));
    o[c] = acc;
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
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(grid),
      static_cast<float*>(out), H, W, C, total, P);
  return cudaGetLastError();
}
