// K4: DIB-R rasterizer forward (hard z-buffer attributes + soft coverage),
// sm_90a.
//
// Replaces the Pallas TPU kernel im23d_tpu/render/rasterizer_pallas.py
// _fwd_kernel (the forward of rasterize_tiled).  Semantics are those of the
// plain rasterizer (im23d_tpu_torch/render/rasterizer.py rasterize_torch):
//   * faces in chunks of 32 in face order; within a chunk the inside faces
//     whose z equals the chunk's largest z share the pixel, their
//     interpolated attributes averaged by count; a later chunk wins only
//     with a strictly larger z; feat is 0 where no face covers the pixel;
//   * soft = 1 - exp(sum over front faces of log1p(-min(cov, 1 - 1e-7))),
//     cov = exp(-d2 / sigma), d2 the squared distance to the face, 0 inside.
//
// What bounds it on the H100: CUDA-core arithmetic, about 100 instructions
// (three edge functions, three segment distances with a division, an exp
// and a log1p) per pixel and face near the pixel.  Design:
//   * one block per 32 x 8 pixel tile of one image, one thread per pixel,
//     a warp per tile row, so the output stores are coalesced;
//   * faces staged through shared memory 32 at a time, in face order, so
//     the chunk boundaries (and the tie rule they carry) are the plain
//     version's;
//   * warp 0 tests each staged face against the tile once: front-facing and
//     its bounding box, widened by `margin` = sqrt(104 sigma), reaching the
//     tile.  Beyond that margin exp(-d2/sigma) is 0 in float32 and no pixel
//     can be inside, so a face outside it changes no result; the ballot of
//     the test is a block-uniform mask, and a chunk whose mask is empty is
//     skipped whole.  (The TPU kernel's 4 sqrt(sigma) margin drops coverage
//     above 1e-7; it is not carried over, nor are its Morton sort, its 8x128
//     tile layout and its MXU winner contraction, which served the TPU.)
//   * the winner is kept per chunk in registers (running max, count and
//     attribute sums) and per image in registers across chunks.
// The edge functions, barycentrics, depth and segment distances use the
// plain version's grouping with FMA contraction ruled out, so the inside
// test, the depth ties and the winners agree with it bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32, kTileH = 8, kThreads = kTileW * kTileH;
constexpr int kChunk = 32;
constexpr int kMaxA = 8;  // rasterizer.py MAX_ATTRS
constexpr float kNegBig = -1e9f;
constexpr float kCovMax = 1.0f - 1e-7f;  // float32(1 - 1e-7)

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx,
                                         float by, float px, float py) {
  // (bx - ax)(py - ay) - (by - ay)(px - ax)
  return __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(py, ay)),
                   __fmul_rn(__fsub_rn(by, ay), __fsub_rn(px, ax)));
}

__device__ __forceinline__ float seg_dist2(float px, float py, float ax,
                                           float ay, float bx, float by) {
  const float abx = __fsub_rn(bx, ax), aby = __fsub_rn(by, ay);
  const float apx = __fsub_rn(px, ax), apy = __fsub_rn(py, ay);
  const float denom = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
  float t = __fdiv_rn(__fadd_rn(__fmul_rn(apx, abx), __fmul_rn(apy, aby)),
                      fmaxf(denom, 1e-12f));
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float dx = __fsub_rn(apx, __fmul_rn(t, abx));
  const float dy = __fsub_rn(apy, __fmul_rn(t, aby));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float pixel_x(int col, float sx) {
  return __fsub_rn(__fmul_rn(static_cast<float>(col) + 0.5f, sx), 1.f);
}

__device__ __forceinline__ float pixel_y(int row, float sy) {
  return __fsub_rn(1.f, __fmul_rn(static_cast<float>(row) + 0.5f, sy));
}

// fv (B, F, 3 corners, 3 xyz), attrs (B, F, 3 corners, A),
// feat (B, H, W, A), soft (B, H, W).
template <bool kCull>
__global__ void __launch_bounds__(kThreads)
    rasterize_fwd_kernel(const float* __restrict__ fv,
                         const float* __restrict__ attrs,
                         float* __restrict__ feat, float* __restrict__ soft,
                         int F, int A, int H, int W, float sx, float sy,
                         float sigma, float margin) {
  __shared__ float s_v[kChunk * 9];
  __shared__ float s_at[kChunk * 3 * kMaxA];
  __shared__ float s_inv_area[kChunk];
  __shared__ unsigned s_mask;

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileW, r0 = blockIdx.y * kTileH;
  const int col = c0 + tid % kTileW, row = r0 + tid / kTileW;
  const float px = pixel_x(col, sx), py = pixel_y(row, sy);
  // the tile's pixel centres span [tx0, tx1] x [ty0, ty1]
  const float tx0 = pixel_x(c0, sx), tx1 = pixel_x(c0 + kTileW - 1, sx);
  const float ty1 = pixel_y(r0, sy), ty0 = pixel_y(r0 + kTileH - 1, sy);

  const int A3 = 3 * A;
  const float* fvb = fv + static_cast<size_t>(b) * F * 9;
  const float* atb = attrs + static_cast<size_t>(b) * F * A3;

  float best_z = kNegBig;
  float best[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) best[a] = 0.f;
  float log_miss = 0.f;

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int n = min(kChunk, F - f0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < n * 9; i += kThreads)
      s_v[i] = fvb[static_cast<size_t>(f0) * 9 + i];
    for (int i = tid; i < n * A3; i += kThreads)
      s_at[(i / A3) * (3 * kMaxA) + i % A3] =
          atb[static_cast<size_t>(f0) * A3 + i];
    __syncthreads();
    if (tid < kChunk) {
      bool active = false;
      if (tid < n) {
        const float* v = s_v + tid * 9;
        const float x0 = v[0], y0 = v[1], x1 = v[3], y1 = v[4], x2 = v[6],
                    y2 = v[7];
        const float area = edge_fn(x0, y0, x1, y1, x2, y2);
        const bool nondegen = fabsf(area) > 1e-9f;
        const bool front = kCull ? area > 1e-9f : nondegen;
        s_inv_area[tid] = __fdiv_rn(1.f, nondegen ? area : 1.f);
        const float minx = fminf(fminf(x0, x1), x2) - margin;
        const float maxx = fmaxf(fmaxf(x0, x1), x2) + margin;
        const float miny = fminf(fminf(y0, y1), y2) - margin;
        const float maxy = fmaxf(fmaxf(y0, y1), y2) + margin;
        active = front && minx <= tx1 && maxx >= tx0 && miny <= ty1 &&
                 maxy >= ty0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, active);
      if (tid == 0) s_mask = mask;
    }
    __syncthreads();
    unsigned mask = s_mask;  // block-uniform
    if (mask == 0u) continue;

    float cz = kNegBig, cnt = 0.f;
    float acc[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) acc[a] = 0.f;
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1u;
      const float* v = s_v + j * 9;
      const float x0 = v[0], y0 = v[1], x1 = v[3], y1 = v[4], x2 = v[6],
                  y2 = v[7];
      const float e01 = edge_fn(x0, y0, x1, y1, px, py);
      const float e12 = edge_fn(x1, y1, x2, y2, px, py);
      const float e20 = edge_fn(x2, y2, x0, y0, px, py);
      bool inside = e01 >= 0.f && e12 >= 0.f && e20 >= 0.f;
      if (!kCull) inside = inside || (e01 <= 0.f && e12 <= 0.f && e20 <= 0.f);
      float d2 = 0.f;
      if (inside) {
        const float inv = s_inv_area[j];
        const float w0 = __fmul_rn(e12, inv), w1 = __fmul_rn(e20, inv),
                    w2 = __fmul_rn(e01, inv);
        const float z = __fadd_rn(
            __fadd_rn(__fmul_rn(w0, v[2]), __fmul_rn(w1, v[5])),
            __fmul_rn(w2, v[8]));
        if (z >= cz) {
          if (z > cz) {
            cz = z;
            cnt = 0.f;
#pragma unroll
            for (int a = 0; a < kMaxA; ++a) acc[a] = 0.f;
          }
          cnt += 1.f;
          const float* at = s_at + j * (3 * kMaxA);
#pragma unroll
          for (int a = 0; a < kMaxA; ++a) {
            if (a < A) {
              const float val = __fadd_rn(
                  __fadd_rn(__fmul_rn(w0, at[a]), __fmul_rn(w1, at[A + a])),
                  __fmul_rn(w2, at[2 * A + a]));
              acc[a] = __fadd_rn(acc[a], val);
            }
          }
        }
      } else {
        d2 = fminf(fminf(seg_dist2(px, py, x0, y0, x1, y1),
                         seg_dist2(px, py, x1, y1, x2, y2)),
                   seg_dist2(px, py, x2, y2, x0, y0));
      }
      const float cov = expf(__fdiv_rn(-d2, sigma));
      log_miss = __fadd_rn(log_miss, log1pf(-fminf(cov, kCovMax)));
    }
    if (cz > best_z) {  // strict: an earlier chunk keeps a tie
      best_z = cz;
      const float c = fmaxf(cnt, 1.f);
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) best[a] = __fdiv_rn(acc[a], c);
    }
  }

  if (row >= H || col >= W) return;
  const size_t pix = (static_cast<size_t>(b) * H + row) * W + col;
  const bool covered = best_z > 0.5f * kNegBig;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a)
    if (a < A) feat[pix * A + a] = covered ? best[a] : 0.f;
  soft[pix] = __fsub_rn(1.f, expf(log_miss));
}

}  // namespace

extern "C" int im23d_rasterize_fwd(const void* fv, const void* attrs,
                                   void* feat, void* soft, int B, int F,
                                   int A, int H, int W, float sx, float sy,
                                   float sigma, float margin, int cull,
                                   void* stream) {
  if (B < 1 || B > 65535 || F < 0 || A < 1 || A > kMaxA || H < 1 || W < 1 ||
      !(sigma > 0.f))
    return cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const float*>(fv);
  auto at = static_cast<const float*>(attrs);
  auto fe = static_cast<float*>(feat);
  auto so = static_cast<float*>(soft);
  if (cull)
    rasterize_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
        v, at, fe, so, F, A, H, W, sx, sy, sigma, margin);
  else
    rasterize_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
        v, at, fe, so, F, A, H, W, sx, sy, sigma, margin);
  return cudaGetLastError();
}
