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
//
// The backward (im23d_rasterize_bwd) replaces rasterizer_pallas.py
// _bwd_kernel.  It keeps the forward's tiling, chunks and cull, and reads
// the winner cache the forward wrote (the TPU kernel's bz/bc), so it walks
// the faces once.  What bounds it: the same per pixel and nearby face
// arithmetic as the forward, plus the per-face gradient sums.  The TPU
// kernel accumulates d planes in one VMEM block that its serial grid
// revisits; here blocks run in parallel, so each face's 6 + 3A sums are
// reduced inside the block (warp shuffles, then shared memory) and added
// to device memory with one atomicAdd per block, face and component.  The
// order of those sums changes from run to run.
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
// feat (B, H, W, A), soft (B, H, W); win and wz (B, H, W), or null: the
// winner cache of the backward, win = chunk << 6 | winner count of the
// winning chunk (-1 where no face covers the pixel), wz its z.
template <bool kCull>
__global__ void __launch_bounds__(kThreads)
    rasterize_fwd_kernel(const float* __restrict__ fv,
                         const float* __restrict__ attrs,
                         float* __restrict__ feat, float* __restrict__ soft,
                         int* __restrict__ win, float* __restrict__ wz,
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
  int best_word = -1;
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
      best_word = (f0 / kChunk) << 6 | static_cast<int>(cnt);
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
  if (win != nullptr) {
    win[pix] = covered ? best_word : -1;
    wz[pix] = best_z;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// d edge(a, b, p) into (a, b): e = (bx - ax)(py - ay) - (by - ay)(px - ax)
__device__ __forceinline__ void edge_grad(float de, float ax, float ay,
                                          float bx, float by, float px,
                                          float py, float* ga, float* gb) {
  ga[0] += de * (by - py);
  ga[1] += de * (px - bx);
  gb[0] += de * (py - ay);
  gb[1] += de * (ax - px);
}

// d d2 into segment a-b, d2 = |ap - t ab|^2: the t chain vanishes where t
// is unclamped (the residual is orthogonal to ab) and t is constant where
// clamped, so d a = -2 (1 - t) r, d b = -2 t r with r = ap - t ab (the TPU
// kernel's algebra, rasterizer_pallas.py _bwd_kernel).
__device__ __forceinline__ void seg_grad(float dd2, float px, float py,
                                         float ax, float ay, float bx,
                                         float by, float* ga, float* gb) {
  const float abx = __fsub_rn(bx, ax), aby = __fsub_rn(by, ay);
  const float apx = __fsub_rn(px, ax), apy = __fsub_rn(py, ay);
  const float denom = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
  float t = __fdiv_rn(__fadd_rn(__fmul_rn(apx, abx), __fmul_rn(apy, aby)),
                      fmaxf(denom, 1e-12f));
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float rx = __fsub_rn(apx, __fmul_rn(t, abx));
  const float ry = __fsub_rn(apy, __fmul_rn(t, aby));
  const float s = -2.f * dd2;
  ga[0] += s * (1.f - t) * rx;
  ga[1] += s * (1.f - t) * ry;
  gb[0] += s * t * rx;
  gb[1] += s * t * ry;
}

// per face: d (x, y) of its three corners, then d attrs (3 corners x A)
constexpr int kG = 6 + 3 * kMaxA;

// The VJP of rasterize_fwd_kernel as autograd of the plain rasterizer
// gives it: z only selects winners (d z = 0); d feat reaches the corners'
// x, y and the attributes through the barycentrics of the winning chunk's
// count-averaged winners; d soft reaches x, y through
// d log_miss = -d soft (1 - soft), d cov = -d log_miss / (1 - cov) where
// cov <= 1 - 1e-7, d d2 = -d cov cov / sigma outside the face, routed to
// the nearest edge (the first on a tie).  dfv and dattrs are zeroed by the
// caller; dfeat or dsoft may be null (no gradient).
template <bool kCull>
__global__ void __launch_bounds__(kThreads)
    rasterize_bwd_kernel(const float* __restrict__ fv,
                         const float* __restrict__ attrs,
                         const float* __restrict__ dfeat,
                         const float* __restrict__ dsoft,
                         const float* __restrict__ soft,
                         const int* __restrict__ win,
                         const float* __restrict__ wz,
                         float* __restrict__ dfv, float* __restrict__ dattrs,
                         int F, int A, int H, int W, float sx, float sy,
                         float sigma, float margin) {
  __shared__ float s_v[kChunk * 9];
  __shared__ float s_at[kChunk * 3 * kMaxA];
  __shared__ float s_inv_area[kChunk];
  __shared__ float s_g[kChunk * kG];
  __shared__ unsigned s_mask;

  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int c0 = blockIdx.x * kTileW, r0 = blockIdx.y * kTileH;
  const int col = c0 + tid % kTileW, row = r0 + tid / kTileW;
  const float px = pixel_x(col, sx), py = pixel_y(row, sy);
  const float tx0 = pixel_x(c0, sx), tx1 = pixel_x(c0 + kTileW - 1, sx);
  const float ty1 = pixel_y(r0, sy), ty0 = pixel_y(r0 + kTileH - 1, sy);

  const int A3 = 3 * A;
  const float* fvb = fv + static_cast<size_t>(b) * F * 9;
  const float* atb = attrs + static_cast<size_t>(b) * F * A3;

  // this pixel's upstream gradients (0 outside the image)
  float dlm = 0.f, my_z = 0.f;
  int my_chunk = -1;
  float g[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) g[a] = 0.f;
  if (row < H && col < W) {
    const size_t pix = (static_cast<size_t>(b) * H + row) * W + col;
    if (dsoft != nullptr)
      dlm = -dsoft[pix] * __fsub_rn(1.f, soft[pix]);
    const int word = win[pix];
    if (dfeat != nullptr && word >= 0) {
      my_chunk = word >> 6;
      my_z = wz[pix];
      const float cnt = static_cast<float>(word & 63);
#pragma unroll
      for (int a = 0; a < kMaxA; ++a)
        if (a < A) g[a] = __fdiv_rn(dfeat[pix * A + a], cnt);
    }
  }

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int n = min(kChunk, F - f0);
    __syncthreads();  // the previous chunk is flushed
    for (int i = tid; i < n * 9; i += kThreads)
      s_v[i] = fvb[static_cast<size_t>(f0) * 9 + i];
    for (int i = tid; i < n * A3; i += kThreads)
      s_at[(i / A3) * (3 * kMaxA) + i % A3] =
          atb[static_cast<size_t>(f0) * A3 + i];
    for (int i = tid; i < kChunk * kG; i += kThreads) s_g[i] = 0.f;
    __syncthreads();
    if (tid < kChunk) {  // the forward's cull, bit for bit
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
    const bool feat_chunk = my_chunk == f0 / kChunk;

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
      float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float ga[3 * kMaxA];  // [corner][a], a static stride: registers
#pragma unroll
      for (int k = 0; k < 3 * kMaxA; ++k) ga[k] = 0.f;
      bool any_xy = false, any_attr = false;
      if (inside) {
        if (feat_chunk) {
          const float inv = s_inv_area[j];
          const float w0 = __fmul_rn(e12, inv), w1 = __fmul_rn(e20, inv),
                      w2 = __fmul_rn(e01, inv);
          const float z = __fadd_rn(
              __fadd_rn(__fmul_rn(w0, v[2]), __fmul_rn(w1, v[5])),
              __fmul_rn(w2, v[8]));
          if (z >= my_z) {  // a winner of the winning chunk
            any_xy = any_attr = true;
            const float* at = s_at + j * (3 * kMaxA);
            float dw0 = 0.f, dw1 = 0.f, dw2 = 0.f;
#pragma unroll
            for (int a = 0; a < kMaxA; ++a) {
              if (a < A) {
                dw0 += g[a] * at[a];
                dw1 += g[a] * at[A + a];
                dw2 += g[a] * at[2 * A + a];
                ga[a] = w0 * g[a];
                ga[kMaxA + a] = w1 * g[a];
                ga[2 * kMaxA + a] = w2 * g[a];
              }
            }
            // w0 = e12 inv, w1 = e20 inv, w2 = e01 inv, inv = 1 / area
            const float dinv = dw0 * e12 + dw1 * e20 + dw2 * e01;
            const float darea = -dinv * inv * inv;
            edge_grad(dw2 * inv, x0, y0, x1, y1, px, py, gv, gv + 2);
            edge_grad(dw0 * inv, x1, y1, x2, y2, px, py, gv + 2, gv + 4);
            edge_grad(dw1 * inv, x2, y2, x0, y0, px, py, gv + 4, gv);
            gv[0] += darea * (y1 - y2);
            gv[1] += darea * (x2 - x1);
            gv[2] += darea * (y2 - y0);
            gv[3] += darea * (x0 - x2);
            gv[4] += darea * (y0 - y1);
            gv[5] += darea * (x1 - x0);
          }
        }
      } else if (dlm != 0.f) {
        const float d01 = seg_dist2(px, py, x0, y0, x1, y1);
        const float d12 = seg_dist2(px, py, x1, y1, x2, y2);
        const float d20 = seg_dist2(px, py, x2, y2, x0, y0);
        const float d2 = fminf(fminf(d01, d12), d20);
        const float cov = expf(__fdiv_rn(-d2, sigma));
        if (cov > 0.f && cov <= kCovMax) {
          any_xy = true;
          const float dcov = -dlm / (1.f - cov);
          const float dd2 = -(dcov * cov) / sigma;
          if (d01 == d2)
            seg_grad(dd2, px, py, x0, y0, x1, y1, gv, gv + 2);
          else if (d12 == d2)
            seg_grad(dd2, px, py, x1, y1, x2, y2, gv + 2, gv + 4);
          else
            seg_grad(dd2, px, py, x2, y2, x0, y0, gv + 4, gv);
        }
      }
      // per-face sums: warp shuffles, then shared memory
      float* sg = s_g + j * kG;
      if (__any_sync(0xffffffffu, any_xy)) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float t = warp_sum(gv[k]);
          if (lane == 0 && t != 0.f) atomicAdd(sg + k, t);
        }
      }
      if (__any_sync(0xffffffffu, any_attr)) {
#pragma unroll
        for (int k = 0; k < 3 * kMaxA; ++k) {
          const int corner = k / kMaxA, a = k % kMaxA;
          if (a < A) {
            const float t = warp_sum(ga[k]);
            if (lane == 0 && t != 0.f) atomicAdd(sg + 6 + corner * A + a, t);
          }
        }
      }
    }
    __syncthreads();
    // one global atomicAdd per block, face and component
    for (int i = tid; i < n * kG; i += kThreads) {
      const int j = i / kG, k = i % kG;
      const float t = s_g[i];
      if (t == 0.f) continue;
      const size_t face = static_cast<size_t>(b) * F + f0 + j;
      if (k < 6)
        atomicAdd(dfv + face * 9 + (k / 2) * 3 + k % 2, t);
      else if (k - 6 < A3)
        atomicAdd(dattrs + face * A3 + (k - 6), t);
    }
  }
}

}  // namespace

// win and wz may be null (no winner cache).
extern "C" int im23d_rasterize_fwd(const void* fv, const void* attrs,
                                   void* feat, void* soft, void* win,
                                   void* wz, int B, int F, int A, int H,
                                   int W, float sx, float sy, float sigma,
                                   float margin, int cull, void* stream) {
  if (B < 1 || B > 65535 || F < 0 || A < 1 || A > kMaxA || H < 1 || W < 1 ||
      !(sigma > 0.f))
    return cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const float*>(fv);
  auto at = static_cast<const float*>(attrs);
  auto fe = static_cast<float*>(feat);
  auto so = static_cast<float*>(soft);
  auto wi = static_cast<int*>(win);
  auto z = static_cast<float*>(wz);
  if ((wi == nullptr) != (z == nullptr)) return cudaErrorInvalidValue;
  if (cull)
    rasterize_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
        v, at, fe, so, wi, z, F, A, H, W, sx, sy, sigma, margin);
  else
    rasterize_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
        v, at, fe, so, wi, z, F, A, H, W, sx, sy, sigma, margin);
  return cudaGetLastError();
}

// fv, attrs as the forward's; dfeat (B, H, W, A) and dsoft (B, H, W), either
// null; soft, win, wz from the forward; dfv (B, F, 3, 3) and dattrs
// (B, F, 3, A) zeroed by the caller.
extern "C" int im23d_rasterize_bwd(const void* fv, const void* attrs,
                                   const void* dfeat, const void* dsoft,
                                   const void* soft, const void* win,
                                   const void* wz, void* dfv, void* dattrs,
                                   int B, int F, int A, int H, int W,
                                   float sx, float sy, float sigma,
                                   float margin, int cull, void* stream) {
  if (B < 1 || B > 65535 || F < 0 || A < 1 || A > kMaxA || H < 1 || W < 1 ||
      !(sigma > 0.f) || win == nullptr || wz == nullptr || soft == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const float*>(fv);
  auto at = static_cast<const float*>(attrs);
  auto df = static_cast<const float*>(dfeat);
  auto ds = static_cast<const float*>(dsoft);
  auto so = static_cast<const float*>(soft);
  auto wi = static_cast<const int*>(win);
  auto z = static_cast<const float*>(wz);
  auto dv = static_cast<float*>(dfv);
  auto da = static_cast<float*>(dattrs);
  if (cull)
    rasterize_bwd_kernel<true><<<grid, kThreads, 0, s>>>(
        v, at, df, ds, so, wi, z, dv, da, F, A, H, W, sx, sy, sigma, margin);
  else
    rasterize_bwd_kernel<false><<<grid, kThreads, 0, s>>>(
        v, at, df, ds, so, wi, z, dv, da, F, A, H, W, sx, sy, sigma, margin);
  return cudaGetLastError();
}
