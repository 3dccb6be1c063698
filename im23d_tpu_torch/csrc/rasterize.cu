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
// and a log1p) per pixel and face near the pixel; the bound counts the
// pixel-face pairs inside each front face's box widened by `margin` =
// sqrt(104 sigma).  Beyond that margin exp(-d2/sigma) is 0 in float32 and
// no pixel can be inside, so a pair outside it changes no output bit (its
// log1p term is -0).  (The TPU kernel's 4 sqrt(sigma) margin drops coverage
// above 1e-7; it is not carried over, nor are its Morton sort, its 8x128
// tile layout and its MXU winner contraction, which served the TPU.)
// Design, two launches:
//   * set-up (raster_setup_kernel): a block per (chunk of 32 faces, image).
//     Its first warp computes each face's record once: corners, depths,
//     edge vectors and reciprocal segment denominators, 1/area (the same
//     __fdiv_rn) and the widened box; then each thread takes a 16 x 16
//     pixel tile of
//     the image and writes the tile's bin word of the chunk: bit j set
//     where front face 32 chunk + j has its widened box reaching the
//     tile's pixel centres.  A word is exactly the per-chunk ballot of the
//     tiled kernel this replaced, written by one thread: no atomics, no
//     cleared buffer, the same bins on every launch.
//   * the rasterizer (raster_binned_kernel): a block per 16 x 16 tile, a
//     warp per 8 x 4 pixels (square-ish, so that a face's box test is
//     mostly uniform across the warp), a thread per pixel.  Each warp walks
//     the tile's bin words in chunk order and their set bits in face order,
//     so the chunk boundaries (and the tie rule they carry) are the plain
//     version's.  For a chunk word, lane j tests face 32 chunk + j's box
//     against the warp's pixels and copies the record of a face that
//     passes into the warp's part of shared memory: one round trip a
//     chunk, no block barrier.  The warp then walks those faces in order,
//     and a lane skips a face whose box misses its pixel.
//     The winner is kept per chunk in registers (running max, count and
//     attribute sums) and per pixel across chunks.
// The edge functions, barycentrics and depth use the plain version's
// grouping with FMA contraction ruled out (the records hold differences
// rounded as the per-pixel code rounded them), so the inside test, the
// depth ties, the winners and feat agree with it bit for bit.  The soft
// mask alone takes two products for divisions: the segment parameter by
// the edge's reciprocal denominator from the set-up pass, and d2 / sigma as
// d2 x (-1 / sigma).  Each moves a distance by an ulp and soft by ~1e-7;
// dividing cost a fifth of the kernel's time (0.368 -> 0.299 ms in a
// variant copy, NVIDIA H100 80GB HBM3, 700 W: tools/time_split.py --only
// k4f).  A skipped pair adds -0 to log_miss.
//
// The backward (im23d_rasterize_bwd) replaces rasterizer_pallas.py
// _bwd_kernel.  What bounds it: the same per pixel and nearby face
// arithmetic as the forward, plus each face's 6 + 3A gradient sums.  The
// TPU kernel accumulates d planes in one VMEM block that its serial grid
// revisits; here the sums are a gather, face-major: one warp per (image,
// face), the grid image-major so that one image's per-pixel inputs stay in
// L2 while its faces run.  A warp walks the pixel centres of its face's
// bounding box widened by `margin` (beyond it the face changes no value),
// 32 pixels at a time; each lane sums its pixels' gradients in registers,
// then one warp reduction (xor shuffles, the same on every lane) gives the
// face's sums, stored with plain stores.  The winner test needs no walk over
// the other faces: face f is a winner at a pixel whose cached winning chunk
// (the forward's cache, the TPU kernel's bz/bc) is f / 32 and where its z
// reaches the cached z.  No atomics: the result is the same on every
// launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;
// the forward's bins: 16 x 16 pixel tiles, a block each, a warp per 8 x 4
constexpr int kBinW = 16, kBinH = 16, kBinThreads = 256;
constexpr int kWarpW = 8, kWarpH = 4;
constexpr int kRec4 = 7;  // float4s of a face record
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

// (b - a) x (p - a) with b - a given: edge_fn with the difference rounded
// once beforehand, the same value
__device__ __forceinline__ float edge_v(float ax, float ay, float abx,
                                        float aby, float px, float py) {
  return __fsub_rn(__fmul_rn(abx, __fsub_rn(py, ay)),
                   __fmul_rn(aby, __fsub_rn(px, ax)));
}

// seg_dist2 with ab and 1 / max(|ab|^2, 1e-12) given: the segment parameter
// by a product with the edge's reciprocal, not a division (within an ulp;
// the distance feeds the soft mask only)
__device__ __forceinline__ float seg_dist2_v(float px, float py, float ax,
                                             float ay, float abx, float aby,
                                             float rden) {
  const float apx = __fsub_rn(px, ax), apy = __fsub_rn(py, ay);
  float t = __fmul_rn(__fadd_rn(__fmul_rn(apx, abx), __fmul_rn(apy, aby)),
                      rden);
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float dx = __fsub_rn(apx, __fmul_rn(t, abx));
  const float dy = __fsub_rn(apy, __fmul_rn(t, aby));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// 1 / max(|ab|^2, 1e-12)
__device__ __forceinline__ float seg_rden(float abx, float aby) {
  return __fdiv_rn(
      1.f,
      fmaxf(__fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby)), 1e-12f));
}

// A face's record, kRec4 float4s:
//   0: x0 y0 x1 y1    1: x2 y2 1/area -    2: minx maxx miny maxy (widened)
//   3: z0 z1 z2 -     4: x1-x0 y1-y0 x2-x1 y2-y1
//   5: x0-x2 y0-y2 1/den01 1/den12           6: 1/den20 - - -
// (den the segment's max(|ab|^2, 1e-12))
// fv (B, F, 3, 3) -> recs (B, F, kRec4); bins (B, tiles, nwords) of the
// chunk blockIdx.x of image blockIdx.y.
template <bool kCull>
__global__ void __launch_bounds__(kBinThreads)
    raster_setup_kernel(const float* __restrict__ fv,
                        float4* __restrict__ recs,
                        unsigned* __restrict__ bins, int F, int tiles_x,
                        int tiles, int nwords, float sx, float sy,
                        float margin) {
  __shared__ float4 s_box[kChunk];
  __shared__ unsigned s_front;
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  if (tid < kChunk) {
    const int f = chunk * kChunk + tid;
    bool front = false;
    float4 box = make_float4(1.f, -1.f, 1.f, -1.f);
    if (f < F) {
      const size_t face = static_cast<size_t>(b) * F + f;
      const float* v = fv + face * 9;
      const float x0 = v[0], y0 = v[1], z0 = v[2], x1 = v[3], y1 = v[4],
                  z1 = v[5], x2 = v[6], y2 = v[7], z2 = v[8];
      const float area = edge_fn(x0, y0, x1, y1, x2, y2);
      const bool nondegen = fabsf(area) > 1e-9f;
      front = kCull ? area > 1e-9f : nondegen;
      const float inv = __fdiv_rn(1.f, nondegen ? area : 1.f);
      box = make_float4(fminf(fminf(x0, x1), x2) - margin,
                        fmaxf(fmaxf(x0, x1), x2) + margin,
                        fminf(fminf(y0, y1), y2) - margin,
                        fmaxf(fmaxf(y0, y1), y2) + margin);
      const float e01x = __fsub_rn(x1, x0), e01y = __fsub_rn(y1, y0);
      const float e12x = __fsub_rn(x2, x1), e12y = __fsub_rn(y2, y1);
      const float e20x = __fsub_rn(x0, x2), e20y = __fsub_rn(y0, y2);
      float4* r = recs + face * kRec4;
      r[0] = make_float4(x0, y0, x1, y1);
      r[1] = make_float4(x2, y2, inv, 0.f);
      r[2] = box;
      r[3] = make_float4(z0, z1, z2, 0.f);
      r[4] = make_float4(e01x, e01y, e12x, e12y);
      r[5] = make_float4(e20x, e20y, seg_rden(e01x, e01y),
                         seg_rden(e12x, e12y));
      r[6] = make_float4(seg_rden(e20x, e20y), 0.f, 0.f, 0.f);
    }
    s_box[tid] = box;
    const unsigned m = __ballot_sync(0xffffffffu, front);
    if (tid == 0) s_front = m;
  }
  __syncthreads();
  const unsigned front = s_front;
  for (int t = tid; t < tiles; t += kBinThreads) {
    // the tile's pixel centres span [tx0, tx1] x [ty0, ty1]
    const int c0 = (t % tiles_x) * kBinW, r0 = (t / tiles_x) * kBinH;
    const float tx0 = pixel_x(c0, sx), tx1 = pixel_x(c0 + kBinW - 1, sx);
    const float ty1 = pixel_y(r0, sy), ty0 = pixel_y(r0 + kBinH - 1, sy);
    unsigned word = 0u, m = front;
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1u;
      const float4 bx = s_box[j];
      if (bx.x <= tx1 && bx.y >= tx0 && bx.z <= ty1 && bx.w >= ty0)
        word |= 1u << j;
    }
    bins[(static_cast<size_t>(b) * tiles + t) * nwords + chunk] = word;
  }
}

// attrs (B, F, 3 corners, A), feat (B, H, W, A), soft (B, H, W); win and wz
// (B, H, W), or null: the winner cache of the backward, win = chunk << 6 |
// winner count of the winning chunk (-1 where no face covers the pixel),
// wz its z.  kA: the attribute count compiled in (3, the renderer's u, v,
// mask), or kMaxA for any A <= kMaxA.
template <bool kCull, int kA>
__global__ void __launch_bounds__(kBinThreads)
    raster_binned_kernel(const float4* __restrict__ recs,
                         const unsigned* __restrict__ bins,
                         const float* __restrict__ attrs,
                         float* __restrict__ feat, float* __restrict__ soft,
                         int* __restrict__ win, float* __restrict__ wz, int F,
                         int A, int H, int W, int tiles_x, int tiles,
                         int nwords, float sx, float sy, float sigma) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (t % tiles_x) * kBinW + (warp % (kBinW / kWarpW)) * kWarpW;
  const int r0 = (t / tiles_x) * kBinH + (warp / (kBinW / kWarpW)) * kWarpH;
  const int col = c0 + lane % kWarpW, row = r0 + lane / kWarpW;
  const float px = pixel_x(col, sx), py = pixel_y(row, sy);
  // the warp's pixel centres span [wx0, wx1] x [wy0, wy1]
  const float wx0 = pixel_x(c0, sx), wx1 = pixel_x(c0 + kWarpW - 1, sx);
  const float wy1 = pixel_y(r0, sy), wy0 = pixel_y(r0 + kWarpH - 1, sy);
  const bool valid = row < H && col < W;
  const int An = kA == kMaxA ? A : kA;
  const float nis = __fdiv_rn(-1.f, sigma);  // cov = exp(d2 * (-1 / sigma))
  const unsigned* bin = bins + (static_cast<size_t>(b) * tiles + t) * nwords;
  const float4* rb = recs + static_cast<size_t>(b) * F * kRec4;
  const float* atb = attrs + static_cast<size_t>(b) * F * 3 * An;
  // the warp's copy of the records of a chunk's faces near its pixels
  __shared__ float4 s_rec[kBinThreads / 32][kChunk][kRec4];
  float4(*wrec)[kRec4] = s_rec[warp];

  float best_z = kNegBig;
  int best_word = -1;
  float best[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) best[a] = 0.f;
  float log_miss = 0.f;

  for (int w0 = 0; w0 < nwords; w0 += 32) {
    const unsigned mine = w0 + lane < nwords ? __ldg(bin + w0 + lane) : 0u;
    unsigned words = __ballot_sync(0xffffffffu, mine != 0u);
    while (words) {  // the chunks with faces near the tile, in order
      const int wl = __ffs(words) - 1;
      words &= words - 1u;
      const unsigned bits = __shfl_sync(0xffffffffu, mine, wl);
      const int chunk = w0 + wl;
      // lane j takes face 32 chunk + j of the bin: the faces whose box
      // reaches the warp's pixels, and their records into shared memory,
      // all in one round trip
      const bool in_bin = (bits >> lane) & 1u;
      const float4* rl = rb + static_cast<size_t>(chunk * kChunk + lane) *
                                  kRec4;
      float4 lb = make_float4(1.f, -1.f, 1.f, -1.f);
      if (in_bin) lb = __ldg(rl + 2);
      const bool near = in_bin && lb.x <= wx1 && lb.y >= wx0 &&
                        lb.z <= wy1 && lb.w >= wy0;
      unsigned faces = __ballot_sync(0xffffffffu, near);
      if (faces == 0u) continue;
      __syncwarp();  // the previous chunk's records are read
      if (near) {
#pragma unroll
        for (int k = 0; k < kRec4; ++k)
          wrec[lane][k] = k == 2 ? lb : __ldg(rl + k);
      }
      __syncwarp();
      float cz = kNegBig, cnt = 0.f;
      float acc[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) acc[a] = 0.f;
      while (faces) {  // the chunk's faces near the warp, in order
        const int j = __ffs(faces) - 1;
        faces &= faces - 1u;
        const int f = chunk * kChunk + j;
        const float4* r = wrec[j];
        const float4 bx = r[2];
        if (!(valid && bx.x <= px && px <= bx.y && bx.z <= py && py <= bx.w))
          continue;  // the box misses this pixel: no inside, cov 0
        const float4 v01 = r[0], v2 = r[1], ev = r[4], ev2 = r[5];
        const float x0 = v01.x, y0 = v01.y, x1 = v01.z, y1 = v01.w,
                    x2 = v2.x, y2 = v2.y;
        const float e01 = edge_v(x0, y0, ev.x, ev.y, px, py);
        const float e12 = edge_v(x1, y1, ev.z, ev.w, px, py);
        const float e20 = edge_v(x2, y2, ev2.x, ev2.y, px, py);
        bool inside = e01 >= 0.f && e12 >= 0.f && e20 >= 0.f;
        if (!kCull) inside = inside || (e01 <= 0.f && e12 <= 0.f && e20 <= 0.f);
        float d2 = 0.f;
        if (inside) {
          const float inv = v2.z;
          const float4 z = r[3];
          const float w0 = __fmul_rn(e12, inv), w1 = __fmul_rn(e20, inv),
                      w2 = __fmul_rn(e01, inv);
          const float zz = __fadd_rn(
              __fadd_rn(__fmul_rn(w0, z.x), __fmul_rn(w1, z.y)),
              __fmul_rn(w2, z.z));
          if (zz >= cz) {
            if (zz > cz) {
              cz = zz;
              cnt = 0.f;
#pragma unroll
              for (int a = 0; a < kA; ++a) acc[a] = 0.f;
            }
            cnt += 1.f;
            const float* at = atb + static_cast<size_t>(f) * 3 * An;
#pragma unroll
            for (int a = 0; a < kA; ++a) {
              if (a < An) {
                const float val = __fadd_rn(
                    __fadd_rn(__fmul_rn(w0, __ldg(at + a)),
                              __fmul_rn(w1, __ldg(at + An + a))),
                    __fmul_rn(w2, __ldg(at + 2 * An + a)));
                acc[a] = __fadd_rn(acc[a], val);
              }
            }
          }
        } else {
          const float rden20 = r[6].x;
          d2 = fminf(fminf(seg_dist2_v(px, py, x0, y0, ev.x, ev.y, ev2.z),
                           seg_dist2_v(px, py, x1, y1, ev.z, ev.w, ev2.w)),
                     seg_dist2_v(px, py, x2, y2, ev2.x, ev2.y, rden20));
        }
        const float cov = expf(__fmul_rn(d2, nis));
        log_miss = __fadd_rn(log_miss, log1pf(-fminf(cov, kCovMax)));
      }
      if (cz > best_z) {  // strict: an earlier chunk keeps a tie
        best_z = cz;
        best_word = chunk << 6 | static_cast<int>(cnt);
        const float c = fmaxf(cnt, 1.f);
#pragma unroll
        for (int a = 0; a < kA; ++a) best[a] = __fdiv_rn(acc[a], c);
      }
    }
  }

  if (!valid) return;
  const size_t pix = (static_cast<size_t>(b) * H + row) * W + col;
  const bool covered = best_z > 0.5f * kNegBig;
#pragma unroll
  for (int a = 0; a < kA; ++a)
    if (a < An) feat[pix * An + a] = covered ? best[a] : 0.f;
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

// The VJP of rasterize_fwd_kernel as autograd of the plain rasterizer
// gives it: z only selects winners (d z = 0); d feat reaches the corners'
// x, y and the attributes through the barycentrics of the winning chunk's
// count-averaged winners; d soft reaches x, y through
// d log_miss = -d soft (1 - soft), d cov = -d log_miss / (1 - cov) where
// cov <= 1 - 1e-7, d d2 = -d cov cov / sigma outside the face, routed to
// the nearest edge (the first on a tie).  Every face's dfv and dattrs are
// written (zero for a face that is not drawn); dfeat or dsoft may be null
// (no gradient).
constexpr int kBwdWarps = 4;  // faces a block

// kA: the attribute count compiled in (3, the renderer's u, v, mask), or
// kMaxA for any A <= kMaxA; the register budget keeps 8 blocks an SM
template <bool kCull, int kA>
__global__ void __launch_bounds__(kBwdWarps * 32, 8)
    rasterize_bwd_kernel(const float* __restrict__ fv,
                         const float* __restrict__ attrs,
                         const float* __restrict__ dfeat,
                         const float* __restrict__ dsoft,
                         const float* __restrict__ soft,
                         const int* __restrict__ win,
                         const float* __restrict__ wz,
                         float* __restrict__ dfv, float* __restrict__ dattrs,
                         int B, int F, int A, int H, int W, float sx,
                         float sy, float sigma, float margin) {
  const int lane = threadIdx.x & 31;
  const long long wid =
      static_cast<long long>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5);
  if (wid >= static_cast<long long>(B) * F) return;
  const int b = static_cast<int>(wid / F), f = static_cast<int>(wid % F);
  const size_t face = static_cast<size_t>(b) * F + f;
  const int An = kA == kMaxA ? A : kA;  // a compile-time 3 where it can
  const int A3 = 3 * An;
  const float* v = fv + face * 9;
  const float x0 = v[0], y0 = v[1], x1 = v[3], y1 = v[4], x2 = v[6],
              y2 = v[7];
  const float area = edge_fn(x0, y0, x1, y1, x2, y2);
  const bool front = kCull ? area > 1e-9f : fabsf(area) > 1e-9f;

  float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ga[3 * kA];  // [corner][a], a static stride: registers
#pragma unroll
  for (int k = 0; k < 3 * kA; ++k) ga[k] = 0.f;
  if (front) {
    const float inv = __fdiv_rn(1.f, area);
    const float* at = attrs + face * A3;
    // the pixel centres in the widened box, one pixel more on each side
    // (a pixel outside the box changes no sum: its coverage is 0 in
    // float32 and it is not inside)
    const float minx = fminf(fminf(x0, x1), x2) - margin;
    const float maxx = fmaxf(fmaxf(x0, x1), x2) + margin;
    const float miny = fminf(fminf(y0, y1), y2) - margin;
    const float maxy = fmaxf(fmaxf(y0, y1), y2) + margin;
    auto clampf = [](float t, int n) {
      return static_cast<int>(fminf(fmaxf(t, -1.f), static_cast<float>(n)));
    };
    const int c_lo = max(clampf(floorf((minx + 1.f) / sx - 0.5f), W) - 1, 0);
    const int c_hi = min(clampf(ceilf((maxx + 1.f) / sx - 0.5f), W) + 1,
                         W - 1);
    const int r_lo = max(clampf(floorf((1.f - maxy) / sy - 0.5f), H) - 1, 0);
    const int r_hi = min(clampf(ceilf((1.f - miny) / sy - 0.5f), H) + 1,
                         H - 1);
    const int bw = c_hi - c_lo + 1;
    const int npx = c_hi < c_lo || r_hi < r_lo ? 0 : bw * (r_hi - r_lo + 1);
    const int chunk = f / kChunk;
    for (int k = lane; k < npx; k += 32) {
      const int r = r_lo + k / bw, col = c_lo + k % bw;
      const float px = pixel_x(col, sx), py = pixel_y(r, sy);
      const float e01 = edge_fn(x0, y0, x1, y1, px, py);
      const float e12 = edge_fn(x1, y1, x2, y2, px, py);
      const float e20 = edge_fn(x2, y2, x0, y0, px, py);
      bool inside = e01 >= 0.f && e12 >= 0.f && e20 >= 0.f;
      if (!kCull) inside = inside || (e01 <= 0.f && e12 <= 0.f && e20 <= 0.f);
      const size_t pix = (static_cast<size_t>(b) * H + r) * W + col;
      if (inside) {
        if (dfeat == nullptr) continue;
        const int word = win[pix];
        if (word < 0 || (word >> 6) != chunk) continue;
        const float w0 = __fmul_rn(e12, inv), w1 = __fmul_rn(e20, inv),
                    w2 = __fmul_rn(e01, inv);
        const float z = __fadd_rn(
            __fadd_rn(__fmul_rn(w0, v[2]), __fmul_rn(w1, v[5])),
            __fmul_rn(w2, v[8]));
        if (!(z >= wz[pix])) continue;  // a winner of the winning chunk
        const float cnt = static_cast<float>(word & 63);
        float dw0 = 0.f, dw1 = 0.f, dw2 = 0.f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          if (a < An) {
            const float d = dfeat[pix * An + a];
            const float g = cnt == 1.f ? d : __fdiv_rn(d, cnt);
            dw0 += g * at[a];
            dw1 += g * at[An + a];
            dw2 += g * at[2 * An + a];
            ga[a] += w0 * g;
            ga[kA + a] += w1 * g;
            ga[2 * kA + a] += w2 * g;
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
      } else if (dsoft != nullptr) {
        const float dlm = -dsoft[pix] * __fsub_rn(1.f, soft[pix]);
        if (dlm == 0.f) continue;
        const float d01 = seg_dist2(px, py, x0, y0, x1, y1);
        const float d12 = seg_dist2(px, py, x1, y1, x2, y2);
        const float d20 = seg_dist2(px, py, x2, y2, x0, y0);
        const float d2 = fminf(fminf(d01, d12), d20);
        const float cov = expf(__fdiv_rn(-d2, sigma));
        if (!(cov > 0.f && cov <= kCovMax)) continue;
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
  }
  // the face's sums: every lane ends with the same totals; lane k stores
  // component k (dfv: x, y of each corner, d z = 0; then dattrs)
  float out_v = 0.f, out_a = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float t = warp_sum(gv[k]);
    if (lane == (k / 2) * 3 + k % 2) out_v = t;
  }
#pragma unroll
  for (int k = 0; k < 3 * kA; ++k) {
    const int corner = k / kA, a = k % kA;
    if (a < An) {
      const float t = warp_sum(ga[k]);
      if (lane == corner * An + a) out_a = t;
    }
  }
  if (lane < 9) dfv[face * 9 + lane] = out_v;
  if (lane < A3) dattrs[face * A3 + lane] = out_a;
}

}  // namespace

// win and wz may be null (no winner cache).  recs (B, F, kRec4 float4s)
// and bins (B, tiles, ceil(F / 32) words, tiles = ceil(H / tile_h) x
// ceil(W / tile_w)) are scratch the set-up pass writes whole; tile_w and
// tile_h must be the kernel's (16 x 16).
extern "C" int im23d_rasterize_fwd(const void* fv, const void* attrs,
                                   void* feat, void* soft, void* win,
                                   void* wz, void* recs, void* bins, int B,
                                   int F, int A, int H, int W, int tile_w,
                                   int tile_h, float sx, float sy,
                                   float sigma, float margin, int cull,
                                   void* stream) {
  if (B < 1 || B > 65535 || F < 0 || A < 1 || A > kMaxA || H < 1 || W < 1 ||
      !(sigma > 0.f) || tile_w != kBinW || tile_h != kBinH)
    return cudaErrorInvalidValue;
  if ((win == nullptr) != (wz == nullptr)) return cudaErrorInvalidValue;
  const int tiles_x = (W + kBinW - 1) / kBinW;
  const long long tiles_ll =
      static_cast<long long>(tiles_x) * ((H + kBinH - 1) / kBinH);
  if (tiles_ll > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int tiles = static_cast<int>(tiles_ll);
  const int nwords = (F + kChunk - 1) / kChunk;
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const float*>(fv);
  auto rc = static_cast<float4*>(recs);
  auto bn = static_cast<unsigned*>(bins);
  if (nwords > 0) {
    const dim3 grid(nwords, B);
    if (cull)
      raster_setup_kernel<true><<<grid, kBinThreads, 0, s>>>(
          v, rc, bn, F, tiles_x, tiles, nwords, sx, sy, margin);
    else
      raster_setup_kernel<false><<<grid, kBinThreads, 0, s>>>(
          v, rc, bn, F, tiles_x, tiles, nwords, sx, sy, margin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto at = static_cast<const float*>(attrs);
  auto fe = static_cast<float*>(feat);
  auto so = static_cast<float*>(soft);
  auto wi = static_cast<int*>(win);
  auto z = static_cast<float*>(wz);
  auto kernel = cull ? (A == 3 ? raster_binned_kernel<true, 3>
                               : raster_binned_kernel<true, kMaxA>)
                    : (A == 3 ? raster_binned_kernel<false, 3>
                              : raster_binned_kernel<false, kMaxA>);
  kernel<<<dim3(tiles, B), kBinThreads, 0, s>>>(rc, bn, at, fe, so, wi, z, F,
                                                A, H, W, tiles_x, tiles,
                                                nwords, sx, sy, sigma);
  return cudaGetLastError();
}

// fv, attrs as the forward's; dfeat (B, H, W, A) and dsoft (B, H, W), either
// null; soft, win, wz from the forward; dfv (B, F, 3, 3) and dattrs
// (B, F, 3, A) written whole.
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
  const long long faces = static_cast<long long>(B) * F;
  if (faces == 0) return cudaSuccess;
  const long long blocks = (faces + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
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
  auto kernel = cull ? (A == 3 ? rasterize_bwd_kernel<true, 3>
                               : rasterize_bwd_kernel<true, kMaxA>)
                    : (A == 3 ? rasterize_bwd_kernel<false, 3>
                              : rasterize_bwd_kernel<false, kMaxA>);
  kernel<<<grid, kBwdWarps * 32, 0, s>>>(v, at, df, ds, so, wi, z, dv, da, B,
                                          F, A, H, W, sx, sy, sigma, margin);
  return cudaGetLastError();
}
