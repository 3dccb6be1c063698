// K8: the GAN generator's texture-head conv, sm_90a.
//
// Forward replaces the Pallas TPU kernel im23d_tpu/ops/conv_pallas.py
// _fwd_kernel (the forward of head_conv_tanh):
//   y[b, o, h, w] = tanh(bias[o] + sum over c, i, j of
//                        w[o, c, i, j] * xp[b, c, h + i, w + j]),
// a 5 x 5 conv from C input channels to 3 outputs, where xp is x padded by 2
// on each side: zero rows in H, replicate or circular columns in W.  x and y
// are NCHW in bfloat16 (im23d_head_conv_fwd_bf16, the main path) or float32
// (im23d_head_conv_fwd); w (3, C, 5, 5) and bias are float32 as the model
// holds them, w rounded to x's type before use; the sums are float32.
//
// What bounds the bfloat16 forward on the H100: bytes.  At the main path's
// shape (32 x 64 x 512 x 256 -> 3) it reads 537 MB of x (0.16 ms at
// 3.35 TB/s) for 40 GFLOP.  A GEMM with the pixels as M, K = 25 taps x C and
// N = the 3 outputs padded to 8 would load every 16 x 16 A fragment from
// shared memory for one mma: 13 GB of ldmatrix traffic, about 0.45 ms of
// the SMs' shared-memory bandwidth.  So the kernel folds the tap column j
// into N, as the TPU kernel folds output columns into MXU lanes:
//   z[b, h, u, (j, o)] = sum over i, c of w[o, c, i, j] * xp[b, c, h + i, u]
//   y[b, o, h, w]      = tanh(bias[o] + sum over j of z[b, h, w + j, (j, o)])
// M = padded columns u, K = 5 tap rows x C, N = 16 (15 live): one fragment
// of x feeds 2 mma.sync.m16n8k16 (bf16, float32 sums), and a warp that owns
// two neighbouring output rows feeds each fragment to both (4 tap rows in
// common), so x is read from shared memory 3 times per element, not 25.
//   - A persistent block (256 threads, one an SM) rounds the weights to
//     bf16 once into shared memory, in ldmatrix order (a 16-channel k-step
//     of one tap row: 16 rows n of 16 channels), then walks tiles of
//     16 rows x 64 columns of one image.
//   - x arrives 16 channels (one k-step) a stage as a TMA box of the NCHW
//     tensor, 21 rows x 88 columns from (h0 - 2, w0 - 8) (the box's first
//     column must be 16-byte aligned), rows and channels outside x
//     zero-filled; a ring of three boxes is in flight while the block
//     reads the oldest.  A channel's box is 21 x 11 16-byte units, an odd
//     number, so the eight channels one ldmatrix reads fall in eight bank
//     groups.  ldmatrix.trans reads A straight from the box: 8 columns of
//     8 channels transposed are the m16n8k16 A fragment's pixel rows.  The
//     W pad needs no copy under replicate padding: a column of z depends
//     on that column of x alone, so the epilogue reads a pad column's z at
//     its source column.  Under circular padding the tiles at the image's
//     edges write the pad's columns into the box (read from x).
//     A width that is not a multiple of 8, or an x that is not 16-byte
//     aligned, loads the same box with plain loads instead.
//   - Epilogue: z through shared memory (the box just read), a row at a
//     time; each lane sums the 5 columns of 2 neighbouring outputs of 3
//     channels in order j = 0 .. 4, adds the bias, takes tanh in float32
//     and stores 4 bytes a channel (a warp a 128-byte row segment).
// C up to 128 (8 stages; channels past C read as zero).
//
// The float32 forward stays on the FMA units: a block owns a 32 x 32
// output tile (a thread: 4 rows of one column, 12 float32 sums); input
// channels are staged 8 at a time as a 36 x 36 float32 patch with the
// padding applied by index arithmetic, with the chunk's 600 weights.
//
// The dW kernel (im23d_head_conv_dw) replaces conv_pallas.py _dw_kernel:
//   dw[o, c, i, j] = sum over b, h, w of xp[b, c, h + i, w + j] * g[b, o, h, w]
// with g = dy * (1 - y^2) formed in float32 by the caller and rounded to
// x's type here, as the JAX VJP rounds the upstream (conv_pallas.py:322):
// bf16 products, float32 sums.  Both instances reduce in two deterministic
// passes: each block sums a fixed set of tiles into its own rows of a
// partial buffer, then one thread per weight adds the rows in row order.
// No float atomicAdd, so the result is the same on every launch.
//
// bfloat16 x, C <= 64 (the head: the main path), on the tensor cores.
// What bounds it: bytes.  At 32 x 64 x 512 x 256 it reads 537 MB of x
// (0.16 ms at 3.35 TB/s) for 40 GFLOP, about 0.05-0.1 ms of mma.sync.  So
// x is read once, a row at a time, and every element of a row feeds all
// 15 (tap column, output) pairs and 5 tap rows from shared memory.  With
// u = w + j, the tap column folded into M (the forward's trick transposed):
//   dw[o, c, i, j] = sum over b, h, u of g[b, o, h, u - j] xp[b, c, h + i, u]
// M = (j, o), 15 of 16 rows live; N = (c, i); K = the pixels of a row.
// With a block barrier a row it read 0.39 ms, not the bound: the barrier
// serialised each row's loads, fragment loads and mma.sync products
// (variant copies, tools/time_split.py --only k8dw; NVIDIA H100 80GB
// HBM3, 700 W); hence the producer warp below.
//   - A persistent block (256 threads, one an SM) takes a contiguous range
//     of (image, 128-column tile, output row) tasks, rows fastest, so it
//     streams each tile's rows down the image and reads each x row once
//     (plus 4 rows of halo where its range starts a tile).
//   - x arrives a row at a time: a TMA box of 64 channels x 136 columns
//     from column c0 - 8 (17 16-byte units a channel, an odd number, so
//     the 8 channels one ldmatrix reads fall in 8 bank groups), rows and
//     columns outside x zero-filled, into a ring of 12 boxes, 7 rows ahead
//     of the rows in use.  An output row h reads the 5 boxes of x rows
//     h - 2 .. h + 2 (tap row i = x row - h + 2).
//   - A: g's row h for the tile's columns, 3 channels in float32, zero
//     outside [0, W), turned into bf16 pairs twice over (from an even and
//     from an odd column) by the fixer warp, so that the pair at any shift
//     u - j of the row is one aligned word.
//     One A fragment (16 columns) feeds 5 tap rows x 2 n-tiles.
//   - B: ldmatrix (non-transposed) straight from the box: channel rows
//     with columns contiguous are the k x n fragment.
//   - Warps: a copier warp starts each x row's TMA box and each task's g
//     row (a TMA box of float32, a ring of 8), a fixer warp writes each
//     row's pad columns once it has arrived and turns each g row into
//     bf16 pairs; 8 consumer warps, 4 groups
//     of 16 channels x 2 parts of the tile's 16-column chunks (the pad
//     chunk below split 3 + 2 by tap rows), wait on mbarriers for a row's
//     bytes and pads, and release rows and g rows by mbarriers: no block
//     barrier a row.  The next
//     chunk's fragments load while the current one's products run; each
//     consumer keeps its 5 x 16 x 16 sums in registers over all its
//     block's rows; at the end the two parts' sums are added in a fixed
//     order into the block's partial row.
//   - The W padding: the columns u that lie in the tile hold x itself.
//     The 4 pad columns of xp (-2, -1 and W, W + 1), whose products the
//     tile at that edge owns, go into box columns 6, 7 (left) and 0, 1
//     (right; unused columns of x there) as each row arrives, under both
//     padding modes, and one more step of K = 8 (mma m16n8k8, box columns
//     0 .. 7) multiplies them, A zero but at those 4 columns.  A column of
//     x at or past W reads zero from the box, so a partial last tile needs
//     no mask.
//     A width that is not a multiple of 8, an x or a g that is not 16-byte
//     aligned, loads the same boxes, pads included, with plain loads.
// Any other x (float32, or bfloat16 with 64 < C <= 128) runs on the FMA
// units: a thread owns one (channel, tap row) pair and its 15 (output, tap
// column) sums; a block stages an 8 x 36 patch of every channel and the
// 4 x 32 tile of g, and walks its tiles with a 5-value sliding window.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstring>

#include "conv_common.cuh"

namespace {

constexpr int KS = 5;   // kernel size
constexpr int PAD = 2;  // (KS - 1) / 2
constexpr int CO = 3;   // output channels

// float32 forward tile: 32 columns x (8 threads x 4 rows)
constexpr int FT_W = 32, FT_TY = 8, FT_ROWS = 4, FT_H = FT_TY * FT_ROWS;
constexpr int F_PH = FT_H + KS - 1, F_PW = FT_W + KS - 1;
constexpr int F_CK = 8;  // input channels staged at a time

// bfloat16 forward: tiles of TC_TH rows x TC_TW columns, 8 warps of two
// output rows; a stage's box holds TC_CK channels x TC_BH rows x TC_BW
// columns from (h0 - 2, w0 - 8): the tensor memory accelerator takes a
// box whose first column is 16-byte aligned, so column k of the box is
// w0 - 8 + k and the 68 columns the tile reads are k = 6 .. 73
constexpr int TC_TH = 16, TC_TW = 64, TC_THREADS = 256;
constexpr int TC_CK = 16;              // channels a stage: one k-step
constexpr int TC_OFF = 8;              // box column of x column w0
constexpr int TC_BW = TC_TW + 24;      // 74 columns needed, 11 16-byte units
constexpr int TC_BH = TC_TH + KS;      // 20 rows needed, one more: odd
constexpr int TC_BOX = TC_CK * TC_BH * TC_BW * 2;  // bytes, a multiple of 128
constexpr int TC_NBUF = 3;             // boxes in flight
constexpr int TC_MT = 5;               // m16 tiles over box columns 0 .. 79
constexpr int TC_N = 16;               // (j, o) = 3 j + o, 15 live
constexpr int TC_WKS = TC_N * 16 * 2;  // bytes of one 16-channel k-step
constexpr int TC_ZS = 68;              // z floats a (row, n): box columns
                                       // 6 .. 73; 2 ZS = 8 mod 32 banks
constexpr int TC_MAX_C = 128;
static_assert(TC_BOX % 128 == 0, "boxes stay 128-byte aligned");
static_assert(CO * KS * TC_ZS * 4 * (TC_THREADS / 32) <= TC_BOX,
              "a row of z a warp fits the box it replaces");

// dW tile: 4 rows x 32 columns of one image
constexpr int DT_H = 4, DT_W = 32;
constexpr int D_PH = DT_H + KS - 1, D_PW = DT_W + KS - 1;
constexpr int D_CS = D_PH * D_PW + 1;  // odd channel stride: no bank conflicts

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the upstream rounded to x's type T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(static_cast<T>(v));
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(FT_W* FT_TY)
    head_conv_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ y, int C, int H, int W,
                         int circular) {
  __shared__ float xs[F_CK][F_PH][F_PW];
  __shared__ float ws[F_CK][CO][KS][KS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * FT_W + tx;
  const int w0 = blockIdx.x * FT_W, h0 = blockIdx.y * FT_H, b = blockIdx.z;
  const float* xb = x + static_cast<size_t>(b) * C * H * W;

  float acc[FT_ROWS][CO];
#pragma unroll
  for (int r = 0; r < FT_ROWS; ++r)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[r][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += F_CK) {
    for (int idx = tid; idx < F_CK * F_PH * F_PW; idx += FT_W * FT_TY) {
      const int cc = idx / (F_PH * F_PW);
      const int rem = idx - cc * (F_PH * F_PW);
      const int r = rem / F_PW, col = rem - r * F_PW;
      const int c = c0 + cc, row = h0 + r - PAD;
      float v = 0.f;
      if (c < C && row >= 0 && row < H)
        v = xb[(static_cast<size_t>(c) * H + row) * W +
               src_col(w0 + col - PAD, W, circular)];
      xs[cc][r][col] = v;
    }
    for (int idx = tid; idx < F_CK * CO * KS * KS; idx += FT_W * FT_TY) {
      const int cc = idx / (CO * KS * KS);
      const int rem = idx - cc * (CO * KS * KS);
      const int o = rem / (KS * KS), k = rem - o * (KS * KS);
      const int c = c0 + cc;
      ws[cc][o][k / KS][k % KS] =
          c < C ? w[(static_cast<size_t>(o) * C + c) * KS * KS + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < F_CK; ++cc) {
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        float xv[FT_ROWS + KS - 1];
#pragma unroll
        for (int t = 0; t < FT_ROWS + KS - 1; ++t)
          xv[t] = xs[cc][ty * FT_ROWS + t][tx + j];
#pragma unroll
        for (int i = 0; i < KS; ++i)
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const float wv = ws[cc][o][i][j];
#pragma unroll
            for (int r = 0; r < FT_ROWS; ++r)
              acc[r][o] = fmaf(xv[r + i], wv, acc[r][o]);
          }
      }
    }
    __syncthreads();
  }

  const int wo = w0 + tx;
  if (wo >= W) return;
#pragma unroll
  for (int r = 0; r < FT_ROWS; ++r) {
    const int h = h0 + ty * FT_ROWS + r;
    if (h >= H) break;
#pragma unroll
    for (int o = 0; o < CO; ++o)
      y[((static_cast<size_t>(b) * CO + o) * H + h) * W + wo] =
          tanhf(acc[r][o] + bias[o]);
  }
}

// ---- the bfloat16 forward on the tensor cores -----------------------------

struct TcGeo {
  int B, C, H, W, circular;
  int tiles_w, tiles_h, tiles, nstage;
};

struct TcOrigin {
  int b, h0, w0, c0;
};

// the block's stage s: its tile (blockIdx.x + s / nstage grid strides) and
// channel chunk s % nstage
__device__ __forceinline__ TcOrigin tc_origin(const TcGeo& g, int s) {
  const int t = blockIdx.x + (s / g.nstage) * gridDim.x;
  TcOrigin o;
  o.c0 = (s % g.nstage) * TC_CK;
  o.w0 = (t % g.tiles_w) * TC_TW;
  const int r = t / g.tiles_w;
  o.h0 = (r % g.tiles_h) * TC_TH;
  o.b = r / g.tiles_h;
  return o;
}

__device__ __forceinline__ unsigned char* box_at(unsigned char* box, int c,
                                                 int r, int k) {
  return box + ((c * TC_BH + r) * TC_BW + k) * 2;
}

// the box's W-pad columns of an edge tile under circular padding, once its
// data is in: a column whose source lies in the box is copied there, else
// read from x
__device__ __forceinline__ void tc_fix_pads(unsigned char* box,
                                            const __nv_bfloat16* __restrict__ x,
                                            const TcGeo& g, const TcOrigin& o) {
  const bool left = o.w0 == 0, right = o.w0 + TC_TW >= g.W;
  if (!left && !right) return;
  for (int idx = threadIdx.x; idx < TC_CK * TC_BH * 4; idx += TC_THREADS) {
    const int side = idx & 3, rest = idx >> 2;
    const int r = rest % TC_BH, c = rest / TC_BH;
    if (side < 2 ? !left : !right) continue;
    const int u = side < 2 ? side - PAD : g.W + side - 2;  // -2, -1, W, W + 1
    const int k = u - (o.w0 - TC_OFF);
    if (k < 0 || k >= TC_BW) continue;
    const int su = src_col(u, g.W, g.circular), sk = su - (o.w0 - TC_OFF);
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (sk >= 0 && sk < TC_BW) {
      v = *reinterpret_cast<const __nv_bfloat16*>(box_at(box, c, r, sk));
    } else {
      const int row = o.h0 - PAD + r, ch = o.c0 + c;
      if (row >= 0 && row < g.H && ch < g.C)
        v = x[((static_cast<size_t>(o.b) * g.C + ch) * g.H + row) * g.W + su];
    }
    *reinterpret_cast<__nv_bfloat16*>(box_at(box, c, r, k)) = v;
  }
}

// the box loaded with plain loads, padding included (shapes the tensor
// memory accelerator cannot take)
__device__ __forceinline__ void tc_load_plain(unsigned char* box,
                                              const __nv_bfloat16* __restrict__ x,
                                              const TcGeo& g,
                                              const TcOrigin& o) {
  for (int idx = threadIdx.x; idx < TC_CK * TC_BH * TC_BW;
       idx += TC_THREADS) {
    const int k = idx % TC_BW, rest = idx / TC_BW;
    const int r = rest % TC_BH, c = rest / TC_BH;
    const int u = o.w0 - TC_OFF + k, row = o.h0 - PAD + r, ch = o.c0 + c;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (u >= -PAD && u < g.W + PAD && row >= 0 && row < g.H && ch < g.C)
      v = x[((static_cast<size_t>(o.b) * g.C + ch) * g.H + row) * g.W +
            src_col(u, g.W, g.circular)];
    *reinterpret_cast<__nv_bfloat16*>(box_at(box, c, r, k)) = v;
  }
}

// one stage's products into the warp's two output rows: box rows
// 2 warp + r, r = 0 .. 5, each A fragment (16 columns x the stage's 16
// channels, by ldmatrix.trans from the box) feeding tap row r of the first
// output row and r - 1 of the second; the B fragments of the stage's 5 tap
// rows held in registers
__device__ __forceinline__ void tc_stage(float (&acc)[2][TC_MT][2][4],
                                         const unsigned char* box,
                                         const unsigned char* ws, int chunk,
                                         int nk, int warp, int lane) {
  uint32_t bf[KS][4];
  {
    const int m = lane >> 3;
    const int n = ((m >> 1) << 3) + (lane & 7), khalf = m & 1;
#pragma unroll
    for (int i = 0; i < KS; ++i)
      ldmatrix_x4(bf[i], ws + ((i * nk + chunk) * 2 + khalf) * TC_WKS / 2 +
                             n * 16);
  }
  // lane l: row l % 8 of matrix l / 8 = (column half, channel half)
  const int m = lane >> 3;
  const unsigned char* a_base =
      box_at(const_cast<unsigned char*>(box), 8 * (m >> 1) + (lane & 7),
             2 * warp, 8 * (m & 1));
#pragma unroll
  for (int r = 0; r < KS + 1; ++r)
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, a_base + (r * TC_BW + 16 * mt) * 2);
      if (r < KS) {
        mma_bf16(acc[0][mt][0], a, bf[r][0], bf[r][1]);
        mma_bf16(acc[0][mt][1], a, bf[r][2], bf[r][3]);
      }
      if (r >= 1) {
        mma_bf16(acc[1][mt][0], a, bf[r - 1][0], bf[r - 1][1]);
        mma_bf16(acc[1][mt][1], a, bf[r - 1][2], bf[r - 1][3]);
      }
    }
}

// y of the warp's two rows, one row at a time: the lanes write the row's
// z (the box columns 6 .. 73 that outputs read, n < 15) into the warp's part
// of zbuf, then each lane sums y for 2 neighbouring columns of the row and
// 3 channels and stores them
__device__ __forceinline__ void tc_epilogue(float (&acc)[2][TC_MT][2][4],
                                            float* zbuf,
                                            const float (&bias)[CO],
                                            __nv_bfloat16* __restrict__ y,
                                            const TcGeo& g, const TcOrigin& o,
                                            int warp, int lane) {
  float* z = zbuf + warp * CO * KS * TC_ZS;
  const int gq = lane >> 2, tg = lane & 3;
  const int q0 = 2 * lane, wc = o.w0 + q0;
  // replicate padding: a pad column's z is its source column's (a column
  // of z depends on that column of x alone), so the sums read z at the
  // column clamped to the image; circular pads are in the box already
  const int lo = !g.circular && o.w0 == 0 ? PAD : 0;
  const int hi = g.circular ? TC_ZS - 1 : min(TC_ZS - 1, g.W - o.w0 + 1);
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const bool pair = g.W % 2 == 0 && wc + 1 < g.W;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (rr) __syncwarp();  // the first row's reads are done
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * mt + gq + 8 * (e >> 1) - (TC_OFF - PAD);
          const int n = 8 * nt + 2 * tg + (e & 1);
          if (p >= 0 && p < TC_ZS && n < CO * KS)
            z[n * TC_ZS + p] = acc[rr][mt][nt][e];
          acc[rr][mt][nt][e] = 0.f;
        }
    __syncwarp();
    const int h = o.h0 + 2 * warp + rr;
    if (h >= g.H || wc >= g.W) continue;
    __nv_bfloat16* yp = y + static_cast<size_t>(o.b) * CO * plane +
                        static_cast<size_t>(h) * g.W + wc;
#pragma unroll
    for (int oc = 0; oc < CO; ++oc) {
      float v[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j)
          s += z[(CO * j + oc) * TC_ZS + min(max(q0 + cc + j, lo), hi)];
        v[cc] = tanhf(s + bias[oc]);
      }
      if (pair) {
        *reinterpret_cast<uint32_t*>(yp + oc * plane) = pack_bf16(v[0], v[1]);
      } else {
        yp[oc * plane] = __float2bfloat16_rn(v[0]);
        if (wc + 1 < g.W) yp[oc * plane + 1] = __float2bfloat16_rn(v[1]);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(TC_THREADS, 1)
    head_conv_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, TcGeo g,
                        const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* boxes = tc_smem;                // the stage boxes' ring
  unsigned char* ws = tc_smem + TC_NBUF * TC_BOX;  // the bf16 weights
  const int nk = g.nstage;                       // k-steps a tap row
  auto* bars = reinterpret_cast<uint64_t*>(ws + KS * nk * TC_WKS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the weights, rounded to bf16, as ldmatrix rows: k-step ks = i nk + c / 16
  // holds n = 3 j + o (16 rows) x channels c of that step (two 16-byte
  // halves); n = 15 and channels past C are zero
  for (int idx = tid; idx < KS * nk * 16 * TC_N; idx += TC_THREADS) {
    const int n = idx % TC_N, rest = idx / TC_N;
    const int cl = rest % 16, ks = rest / 16;
    const int i = ks / nk, c = (ks % nk) * 16 + cl;
    const int j = n / CO, oc = n % CO;
    const float v = n < KS * CO && c < g.C
                        ? __ldg(w + ((static_cast<size_t>(oc) * g.C + c) *
                                         KS + i) * KS + j)
                        : 0.f;
    reinterpret_cast<__nv_bfloat16*>(
        ws + ((ks * 2 + (cl >> 3)) * TC_N + n) * 16)[cl & 7] =
        __float2bfloat16_rn(v);
  }
  float bv[CO];
#pragma unroll
  for (int oc = 0; oc < CO; ++oc) bv[oc] = __ldg(bias + oc);

  const int mine = blockIdx.x < g.tiles
                       ? (g.tiles - 1 - blockIdx.x) / gridDim.x + 1
                       : 0;
  const int stages = mine * g.nstage;
  if (kVec && tid == 0) {
    for (int i = 0; i < TC_NBUF; ++i) mbar_init(&bars[i], 1);
    for (int s = 0; s < TC_NBUF && s < stages; ++s) {
      const TcOrigin o = tc_origin(g, s);
      mbar_expect_tx(&bars[s], TC_BOX);
      tma_load(boxes + s * TC_BOX, &xmap, &bars[s], o.w0 - TC_OFF,
               o.h0 - PAD, o.c0, o.b);
    }
  }
  __syncthreads();  // weights written, barriers initialised

  float acc[2][TC_MT][2][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][mt][nt][e] = 0.f;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % TC_NBUF;
    unsigned char* box = boxes + slot * TC_BOX;
    const TcOrigin o = tc_origin(g, s);
    bool wrote = false;  // generic writes into the box in this stage
    if (kVec) {
      mbar_wait(&bars[slot], (s / TC_NBUF) & 1);
      if (g.circular && (o.w0 == 0 || o.w0 + TC_TW >= g.W)) {
        tc_fix_pads(box, x, g, o);
        __syncthreads();
        wrote = true;
      }
    } else {
      tc_load_plain(box, x, g, o);
      __syncthreads();
    }
    const int chunk = o.c0 / TC_CK;
    tc_stage(acc, box, ws, chunk, nk, warp, lane);
    if (chunk == g.nstage - 1) {
      __syncthreads();  // every warp is done with the box: z goes there
      tc_epilogue(acc, reinterpret_cast<float*>(box), bv, y, g, o, warp,
                  lane);
      wrote = true;
    }
    // this thread's writes into the box come before the next box's copy
    // into it (another proxy); then every thread's
    if (kVec && wrote)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kVec && tid == 0 && s + TC_NBUF < stages) {
      const TcOrigin no = tc_origin(g, s + TC_NBUF);
      mbar_expect_tx(&bars[slot], TC_BOX);
      tma_load(box, &xmap, &bars[slot], no.w0 - TC_OFF, no.h0 - PAD, no.c0,
               no.b);
    }
  }
}

// ---- dW of bfloat16 x on the tensor cores ---------------------------------

constexpr int DW_TW = 128;                  // columns of x a tile owns
constexpr int DW_OFF = 8;                   // box column of x column c0
constexpr int DW_BW = DW_TW + DW_OFF;       // 136: 17 16-byte units
constexpr int DW_CS = 64;                   // channels a box (all of C)
constexpr int DW_ROWB = DW_CS * DW_BW * 2;  // bytes of one row's box
constexpr int DW_NS = 12;                   // row boxes in the ring
constexpr int DW_PARTS = 2;                 // consumer warps a 16-channel group
constexpr int DW_CWARPS = 4 * DW_PARTS;     // consumer warps: 64 channels
constexpr int DW_THREADS = (DW_CWARPS + 2) * 32;  // and two producer warps
constexpr int DW_GOFF = 12;                 // staged g entry of column c0
constexpr int DW_GE = DW_TW + 20;           // g entries a row: c0 - 12 + e
constexpr int DW_GRB = CO * DW_GE * 4;      // bytes of a staged g row
constexpr int DW_GRS = (DW_GRB + 127) / 128 * 128;  // and their stride
constexpr int DW_GS = 8;                    // g rows in their ring
constexpr int DW_GW = DW_GE / 2 - 2;        // bf16 pairs of a copy: 72
static_assert(2 * CO * DW_GW * 4 <= DW_GRB, "the pairs fit their g row");
constexpr int DW_SMEM = DW_NS * DW_ROWB + DW_GS * DW_GRS +
                        (3 * DW_NS + 3 * DW_GS) * 8;
static_assert(DW_ROWB % 128 == 0 && DW_GE % 4 == 0, "aligned copies");
// the copying warp starts row n once the consumers have released row
// n - DW_NS, which needs rows up to n - DW_NS + 4 copied (and fixed by the
// other producer warp, which waits on nothing but the copies): DW_NS >= 5;
// likewise g row k (started with task k's first x row) waits on task
// k - DW_GS, whose window ends at most k - DW_GS + 4 rows past that row
static_assert(DW_NS >= 5 && DW_GS >= 5,
              "the rings hold a window of 5 rows and one more");

struct DwGeo {
  int B, C, H, W, circular, tiles_w;
  long long tasks;  // B x tiles_w x H output rows
};

// task t -> image, tile and output row (rows fastest)
__device__ __forceinline__ void dw_task(const DwGeo& g, long long t, int& b,
                                        int& tile, int& h) {
  h = static_cast<int>(t % g.H);
  const long long r = t / g.H;
  tile = static_cast<int>(r % g.tiles_w);
  b = static_cast<int>(r / g.tiles_w);
}

// the task after (b, tile, h)
__device__ __forceinline__ void dw_step(const DwGeo& g, int& b, int& tile,
                                        int& h) {
  if (++h == g.H) {
    h = 0;
    if (++tile == g.tiles_w) {
      tile = 0;
      ++b;
    }
  }
}

// a cursor over a block's loads: its tasks [t0, t1) split into runs where
// the (image, tile) changes, a run of output rows h_a .. h_a + len - 1
// loading x rows h_a - 2 .. h_a + len + 1 in order
struct DwCursor {
  long long next;  // the first task of the next run
  int b, tile, ha, len;  // the run
  int r, left;     // the load's x row; loads left in the run (0: no more)
};

__device__ __forceinline__ void dw_run(const DwGeo& g, long long t,
                                       long long t1, DwCursor& c) {
  dw_task(g, t, c.b, c.tile, c.ha);
  c.len = static_cast<int>(min(t1 - t, static_cast<long long>(g.H - c.ha)));
  c.next = t + c.len;
  c.r = c.ha - 2;
  c.left = c.len + 4;
}

__device__ __forceinline__ void dw_advance(const DwGeo& g, long long t1,
                                           DwCursor& c) {
  if (--c.left > 0)
    ++c.r;
  else if (c.next < t1)
    dw_run(g, c.next, t1, c);
}

// waits for the phase of parity p of an mbarrier; a wait of more than
// 2^32 clocks (seconds: a fault) traps instead of hanging the card
__device__ __forceinline__ void dw_wait(uint64_t* bar, int p) {
  unsigned done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred q;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
        "selp.u32 %0, 1, 0, q;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(static_cast<unsigned>(p & 1))
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void dw_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(smem_u32(bar))
               : "memory");
}

// a producer lane's share of the row box of x row r for a tile with plain
// loads, the pad columns included (box column k holds x column c0 - 8 + k;
// columns 6, 7 of the first tile xp's -2, -1, columns 0, 1 of the last
// tile W, W + 1)
__device__ void dw_load_plain(unsigned char* box,
                              const __nv_bfloat16* __restrict__ x,
                              const DwGeo& g, int b, int tile, int r,
                              int lane) {
  const int c0 = tile * DW_TW;
  const bool first = tile == 0, last = c0 + DW_TW >= g.W;
  auto* dst = reinterpret_cast<__nv_bfloat16*>(box);
  for (int idx = lane; idx < DW_CS * DW_BW; idx += 32) {
    const int k = idx % DW_BW, c = idx / DW_BW;
    const bool lpad = first && k >= DW_OFF - PAD && k < DW_OFF;
    const bool rpad = last && k < PAD;
    const int q = lpad ? k - DW_OFF : rpad ? g.W + k : c0 - DW_OFF + k;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (r >= 0 && r < g.H && c < g.C &&
        (lpad || rpad || (q >= 0 && q < g.W)))
      v = x[((static_cast<size_t>(b) * g.C + c) * g.H + r) * g.W +
            src_col(q, g.W, g.circular)];
    dst[idx] = v;
  }
}

// a producer lane's share of the pad columns of a TMA-loaded row box, once
// it has arrived: from the box where the source column is in it, else
// from x; fenced against the box's next copy
__device__ void dw_fix_pads(unsigned char* box,
                            const __nv_bfloat16* __restrict__ x,
                            const DwGeo& g, int b, int tile, int r,
                            int lane) {
  const int c0 = tile * DW_TW;
  const bool first = tile == 0, last = c0 + DW_TW >= g.W;
  const int npc = (first ? PAD : 0) + (last ? PAD : 0);
  for (int idx = lane; idx < npc * DW_CS; idx += 32) {
    int pc = idx / DW_CS;
    const int c = idx % DW_CS;
    int k, q;
    if (first && pc < PAD) {
      k = DW_OFF - PAD + pc;  // 6, 7: xp columns -2, -1
      q = pc - PAD;
    } else {
      pc -= first ? PAD : 0;
      k = pc;  // 0, 1: xp columns W, W + 1
      q = g.W + pc;
    }
    auto* row = reinterpret_cast<__nv_bfloat16*>(box) + c * DW_BW;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (r >= 0 && r < g.H && c < g.C) {
      const int sq = src_col(q, g.W, g.circular), sk = sq - c0 + DW_OFF;
      v = sk >= DW_OFF && sk < DW_BW
              ? row[sk]
              : x[((static_cast<size_t>(b) * g.C + c) * g.H + r) * g.W + sq];
    }
    row[k] = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a producer lane's share of g row h of a tile, plain loads: 3 channels x
// DW_GE entries from column c0 - 12, zero outside [0, W)
__device__ void dw_stage_g_plain(float* stage, const float* __restrict__ gup,
                                 const DwGeo& g, int b, int tile, int h,
                                 int lane) {
  const int w0 = tile * DW_TW - DW_GOFF;
  for (int idx = lane; idx < CO * DW_GE; idx += 32) {
    const int o = idx / DW_GE, w = w0 + idx % DW_GE;
    stage[idx] =
        w >= 0 && w < g.W
            ? gup[((static_cast<size_t>(b) * CO + o) * g.H + h) * g.W + w]
            : 0.f;
  }
}

// a g row's 3 x DW_GE float32 entries, in place, as bf16 pairs twice: the
// first copy's word p of channel o holds entries 2p, 2p + 1, the second's
// 2p + 1, 2p + 2, so that a pair at any entry is one aligned word; by a
// warp, the floats read before any word is written, fenced against the
// slot's next copy
__device__ __forceinline__ void dw_pairs(unsigned char* row, int lane) {
  const float* f = reinterpret_cast<const float*>(row);
  constexpr int kN = (CO * DW_GW + 31) / 32;
  float v[kN][3];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = lane + 32 * i;
    if (idx < CO * DW_GW) {
      const float* e = f + (idx / DW_GW) * DW_GE + 2 * (idx % DW_GW);
      v[i][0] = e[0];
      v[i][1] = e[1];
      v[i][2] = e[2];
    }
  }
  __syncwarp();
  auto* w = reinterpret_cast<uint32_t*>(row);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = lane + 32 * i;
    if (idx < CO * DW_GW) {
      w[idx] = pack_bf16(v[i][0], v[i][1]);
      w[CO * DW_GW + idx] = pack_bf16(v[i][1], v[i][2]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __threadfence_block();
}

// the bf16 pair (entries e, e + 1) of channel o's row of pairs
__device__ __forceinline__ uint32_t dw_gpair(const uint32_t* w, int o,
                                             int e) {
  return e & 1 ? w[CO * DW_GW + o * DW_GW + ((e - 1) >> 1)]
               : w[o * DW_GW + (e >> 1)];
}

template <bool kVec>
__global__ void __launch_bounds__(DW_THREADS, 1)
    head_conv_dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ gup,
                           float* __restrict__ partial, DwGeo g,
                           const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap gmap) {
  extern __shared__ __align__(128) unsigned char dw_smem[];
  unsigned char* ring = dw_smem;
  unsigned char* gring = dw_smem + DW_NS * DW_ROWB;
  auto* bars = reinterpret_cast<uint64_t*>(gring + DW_GS * DW_GRS);
  uint64_t* full = bars;            // a row's box has arrived (TMA bytes)
  uint64_t* fixed = bars + DW_NS;   // and its pad columns are written
  uint64_t* empty = bars + 2 * DW_NS;  // the consumers are done with it
  uint64_t* gfull = bars + 3 * DW_NS;  // a g row has arrived
  uint64_t* gready = gfull + DW_GS;    // and is bf16 pairs
  uint64_t* gempty = gready + DW_GS;   // and is done with
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = blockIdx.x * g.tasks / gridDim.x;
  const long long t1 = (blockIdx.x + 1) * g.tasks / gridDim.x;

  if (tid == 0) {
    for (int i = 0; i < DW_NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&fixed[i], 1);
      mbar_init(&empty[i], DW_CWARPS);
    }
    for (int i = 0; i < DW_GS; ++i) {
      mbar_init(&gfull[i], 1);
      mbar_init(&gready[i], 1);
      mbar_init(&gempty[i], DW_CWARPS);
    }
  }
  __syncthreads();

  if (warp == DW_CWARPS + 1) {
    // the fixer: each row's pad columns once its box has arrived, and each
    // task's g row turned into bf16 pairs in place with its first x row
    DwCursor fc;
    fc.left = 0;
    if (t0 < t1) dw_run(g, t0, t1, fc);
    int k = 0;
    for (int n = 0; fc.left > 0; ++n, dw_advance(g, t1, fc)) {
      if (fc.len + 4 - fc.left < fc.len) {  // task k's first x row
        const int gs = k % DW_GS;
        dw_wait(&gfull[gs], k / DW_GS);
        dw_pairs(gring + gs * DW_GRS, lane);
        __syncwarp();
        if (lane == 0) dw_arrive(&gready[gs]);
        ++k;
      }
      const int s = n % DW_NS;
      if (kVec) {
        dw_wait(&full[s], n / DW_NS);
        if (fc.tile == 0 || fc.tile * DW_TW + DW_TW >= g.W)
          dw_fix_pads(ring + s * DW_ROWB, x, g, fc.b, fc.tile, fc.r, lane);
      } else {  // the plain loads wrote the pads
        dw_wait(&full[s], n / DW_NS);
      }
      __threadfence_block();  // the lanes' writes before lane 0's arrival
      __syncwarp();
      if (lane == 0) dw_arrive(&fixed[s]);
    }
    return;
  }
  if (warp == DW_CWARPS) {
    // the copier: x rows into the ring, each task's g row into its ring
    DwCursor ic;
    ic.left = 0;
    if (t0 < t1) dw_run(g, t0, t1, ic);
    int k = 0;
    for (int n = 0; ic.left > 0; ++n, dw_advance(g, t1, ic)) {
      const int s = n % DW_NS;
      if (n >= DW_NS) dw_wait(&empty[s], n / DW_NS - 1);
      unsigned char* box = ring + s * DW_ROWB;
      if (kVec) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], DW_ROWB);
          tma_load(box, &xmap, &full[s], ic.tile * DW_TW - DW_OFF, ic.r, 0,
                   ic.b);
        }
      } else {
        dw_load_plain(box, x, g, ic.b, ic.tile, ic.r, lane);
        __threadfence_block();
        __syncwarp();
        if (lane == 0) dw_arrive(&full[s]);
      }
      // the g row of the task whose first x row this is
      const int m = ic.len + 4 - ic.left;  // the load's place in its run
      if (m < ic.len) {
        const int gs = k % DW_GS, h = ic.ha + m;
        if (k >= DW_GS) dw_wait(&gempty[gs], k / DW_GS - 1);
        float* st = reinterpret_cast<float*>(gring + gs * DW_GRS);
        if (kVec) {
          if (lane == 0) {
            mbar_expect_tx(&gfull[gs], DW_GRB);
            tma_load(st, &gmap, &gfull[gs], ic.tile * DW_TW - DW_GOFF, h, 0,
                     ic.b);
          }
        } else {
          dw_stage_g_plain(st, gup, g, ic.b, ic.tile, h, lane);
          __threadfence_block();
          __syncwarp();
          if (lane == 0) dw_arrive(&gfull[gs]);
        }
        ++k;
      }
    }
    return;
  }

  // the consumers: 4 groups of 16 channels x 2 parts of the chunks
  const int cg = warp & 3, part = warp >> 2;
  const int gq = lane >> 2, t4 = lane & 3;
  // this lane's A rows: m = gq and gq + 8 of (j, o) = 3 j + o, 15 live
  const int j0 = gq / CO, o0 = gq % CO;
  const int m1 = gq + 8, j1 = m1 / CO, o1 = m1 % CO;
  const bool live1 = m1 < CO * KS;
  // A[(j, o), k] = g[o, h, w] at w = c0 - 6 + k - j: staged entry
  // k + 6 - j, an even entry (first copy) for even j, odd (second) for
  // odd j; the lane's first column is k = 2 t4
  const int a0_off = (j0 & 1 ? CO * DW_GW : 0) + o0 * DW_GW + t4 +
                     ((6 - j0 - (j0 & 1)) >> 1);
  const int a1_off = (j1 & 1 ? CO * DW_GW : 0) + o1 * DW_GW + t4 +
                     ((6 - j1 - (j1 & 1)) >> 1);
  // ldmatrix rows: matrix l / 8 = (channel half, column half); for the
  // pad chunk's 8 columns, matrix l / 8 = channel half
  const int lm = lane >> 3;
  const int b_off =
      ((cg * 16 + (lm >> 1) * 8 + (lane & 7)) * DW_BW + (lm & 1) * 8) * 2;
  const int b_off8 = (cg * 16 + (lane & 15)) * DW_BW * 2;

  float acc[KS][2][4];
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  // a row's box is ready: its bytes and its pad columns
  auto ready = [&](int n) {
    dw_wait(&full[n % DW_NS], n / DW_NS);
    dw_wait(&fixed[n % DW_NS], n / DW_NS);
  };
  int b = 0, tile = 0, h = 0;
  if (t0 < t1) dw_task(g, t0, b, tile, h);
  int waited = 0;  // rows waited for
  for (long long t = t0; t < t1; ++t) {
    if (t == t0 || h == 0)  // a new run: x rows h - 2 .. h + 1
      for (int i = 0; i < 4; ++i) ready(waited++);
    ready(waited++);  // x row h + 2
    const int L = waited - KS;  // the load of x row h - 2
    const int kt = static_cast<int>(t - t0);
    dw_wait(&gready[kt % DW_GS], kt / DW_GS);
    const uint32_t* gs = reinterpret_cast<const uint32_t*>(
        gring + (kt % DW_GS) * DW_GRS);

    const int c0 = tile * DW_TW;
    const bool first = tile == 0, last = c0 + DW_TW >= g.W;
    // chunks: the 16-column chunks from box column 8 that start inside
    // the image, alternating between the two parts, then at an edge the
    // pad chunk (box columns 0 .. 15), its 5 tap rows split 3 + 2
    const int nint = min(DW_TW / 16, (g.W - c0 + 15) / 16);
    const unsigned char* rows[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i)
      rows[i] = ring + ((L + i) % DW_NS) * DW_ROWB + b_off;
    // chunk q's A fragment and the B fragments of its 5 x rows
    auto frag = [&](int q, uint32_t(&a)[4], uint32_t(&bf)[KS][4]) {
      const int k0 = DW_OFF + 16 * q;
      a[0] = gs[a0_off + k0 / 2];
      a[2] = gs[a0_off + k0 / 2 + 4];
      a[1] = live1 ? gs[a1_off + k0 / 2] : 0u;
      a[3] = live1 ? gs[a1_off + k0 / 2 + 4] : 0u;
#pragma unroll
      for (int i = 0; i < KS; ++i) ldmatrix_x4(bf[i], rows[i] + k0 * 2);
    };
    auto mmas = [&](const uint32_t(&a)[4], const uint32_t(&bf)[KS][4]) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        mma_bf16(acc[i][0], a, bf[i][0], bf[i][1]);
        mma_bf16(acc[i][1], a, bf[i][2], bf[i][3]);
      }
    };
    // the part's chunks part, part + 2, ...: the next chunk's fragments
    // load while the current chunk's products run
    uint32_t fa0[4], fb0[KS][4], fa1[4], fb1[KS][4];
    int q = part;
    if (q < nint) frag(q, fa0, fb0);
    while (q < nint) {
      if (q + 2 < nint) frag(q + 2, fa1, fb1);
      mmas(fa0, fb0);
      q += 2;
      if (q >= nint) break;
      if (q + 2 < nint) frag(q + 2, fa0, fb0);
      mmas(fa1, fb1);
      q += 2;
    }
    if (first || last) {
      // K = 8 (mma m16n8k8), box columns 0 .. 7: A zero but at columns 6,
      // 7 (xp columns -2, -1: w = -j, 1 - j) and 0, 1 (xp columns W,
      // W + 1: w = W + 2 - j, W + 3 - j)
      uint32_t a[2] = {0u, 0u};
      if (first && t4 == 3) {
        a[0] = dw_gpair(gs, o0, DW_GOFF - j0);
        a[1] = live1 ? dw_gpair(gs, o1, DW_GOFF - j1) : 0u;
      }
      if (last && t4 == 0) {
        const int e = g.W - c0 + DW_GOFF + 2;
        a[0] = dw_gpair(gs, o0, e - j0);
        a[1] = live1 ? dw_gpair(gs, o1, e - j1) : 0u;
      }
      const int i_lo = part ? 0 : 3, i_hi = part ? 3 : KS;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        if (i < i_lo || i >= i_hi) continue;
        uint32_t bf[2];
        ldmatrix_x2(bf, ring + ((L + i) % DW_NS) * DW_ROWB + b_off8);
        mma_bf16_k8(acc[i][0], a, bf[0]);
        mma_bf16_k8(acc[i][1], a, bf[1]);
      }
    }
    // release the g row and the x rows the next task does not read
    dw_step(g, b, tile, h);
    const int next_l = t + 1 < t1 ? (h == 0 ? L + KS : L + 1) : waited;
    __syncwarp();
    if (lane == 0) {
      dw_arrive(&gempty[kt % DW_GS]);
      for (int n = L; n < next_l; ++n) dw_arrive(&empty[n % DW_NS]);
    }
  }

  // the two parts' sums added in a fixed order (part 1's through shared
  // memory: the ring, which no copy writes any more), then the block's
  // row of partial; the consumer warps alone synchronise
  asm volatile("bar.sync 1, %0;\n" ::"n"(DW_CWARPS * 32) : "memory");
  float* other = reinterpret_cast<float*>(ring) + (cg * 32 + lane) * KS * 8;
  if (part == 1) {
#pragma unroll
    for (int i = 0; i < KS; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) other[i * 8 + e] = acc[i][e >> 2][e & 3];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(DW_CWARPS * 32) : "memory");
  if (part == 1) return;
  float* prow = partial + static_cast<size_t>(blockIdx.x) * CO * g.C * KS * KS;
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = gq + 8 * (e >> 1);
        const int c = cg * 16 + nt * 8 + 2 * t4 + (e & 1);
        if (m < CO * KS && c < g.C) {
          const int j = m / CO, o = m % CO;
          prow[((o * g.C + c) * KS + i) * KS + j] =
              acc[i][nt][e] + other[i * 8 + nt * 4 + e];
        }
      }
}

// one row of partial sums per block: thread (i, c) -> dw[o, c, i, j]
template <typename T>
__global__ void head_conv_dw_partial_kernel(const T* __restrict__ x,
                                            const float* __restrict__ g,
                                            float* __restrict__ partial,
                                            int B, int C, int H, int W,
                                            int circular) {
  extern __shared__ float smem[];
  float* xs = smem;               // C channels x D_CS
  float* gs = smem + C * D_CS;    // CO x DT_H x DT_W
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const bool active = tid < KS * C;
  const int i = tid / C, c = tid - (tid / C) * C;
  const int tiles_w = (W + DT_W - 1) / DT_W, tiles_h = (H + DT_H - 1) / DT_H;
  const long long tiles = static_cast<long long>(B) * tiles_h * tiles_w;

  float acc[CO][KS];
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int j = 0; j < KS; ++j) acc[o][j] = 0.f;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tw = static_cast<int>(t % tiles_w);
    const long long rest = t / tiles_w;
    const int th = static_cast<int>(rest % tiles_h);
    const int b = static_cast<int>(rest / tiles_h);
    const int w0 = tw * DT_W, h0 = th * DT_H;
    const T* xb = x + static_cast<size_t>(b) * C * H * W;
    __syncthreads();  // the previous tile's reads are done
    for (int idx = tid; idx < C * D_PH * D_PW; idx += nthreads) {
      const int cc = idx / (D_PH * D_PW);
      const int rem = idx - cc * (D_PH * D_PW);
      const int r = rem / D_PW, col = rem - r * D_PW;
      const int row = h0 + r - PAD;
      float v = 0.f;
      if (row >= 0 && row < H)
        v = to_f(xb[(static_cast<size_t>(cc) * H + row) * W +
                    src_col(w0 + col - PAD, W, circular)]);
      xs[cc * D_CS + r * D_PW + col] = v;
    }
    for (int idx = tid; idx < CO * DT_H * DT_W; idx += nthreads) {
      const int o = idx / (DT_H * DT_W);
      const int rem = idx - o * (DT_H * DT_W);
      const int r = rem / DT_W, col = rem - r * DT_W;
      const int h = h0 + r, wc = w0 + col;
      gs[idx] = (h < H && wc < W)
                    ? round_to<T>(g[((static_cast<size_t>(b) * CO + o) * H +
                                     h) * W + wc])
                    : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int r = 0; r < DT_H; ++r) {
      const float* xr = xs + c * D_CS + (r + i) * D_PW;
      const float* g0 = gs + r * DT_W;
      const float* g1 = gs + (DT_H + r) * DT_W;
      const float* g2 = gs + (2 * DT_H + r) * DT_W;
      float win[KS];
#pragma unroll
      for (int j = 0; j < KS - 1; ++j) win[j] = xr[j];
#pragma unroll
      for (int col = 0; col < DT_W; ++col) {
        win[KS - 1] = xr[col + KS - 1];
        const float a0 = g0[col], a1 = g1[col], a2 = g2[col];
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          acc[0][j] = fmaf(win[j], a0, acc[0][j]);
          acc[1][j] = fmaf(win[j], a1, acc[1][j]);
          acc[2][j] = fmaf(win[j], a2, acc[2][j]);
        }
#pragma unroll
        for (int j = 0; j < KS - 1; ++j) win[j] = win[j + 1];
      }
    }
  }
  if (!active) return;
  float* row = partial + static_cast<size_t>(blockIdx.x) * CO * C * KS * KS;
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int j = 0; j < KS; ++j)
      row[((o * C + c) * KS + i) * KS + j] = acc[o][j];
}

// dw[k] = sum of partial[p, k] over p = 0 .. nrows - 1, in that order
__global__ void head_conv_dw_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dw, int n,
                                           int nrows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float s = 0.f;
  for (int p = 0; p < nrows; ++p) s += partial[static_cast<size_t>(p) * n + k];
  dw[k] = s;
}

template <typename T>
int launch_dw(const void* x, const void* g, void* partial, void* dw, int B,
              int C, int H, int W, int circular, int nrows,
              cudaStream_t stream) {
  const int threads = (KS * C + 31) / 32 * 32;
  const size_t smem = (static_cast<size_t>(C) * D_CS + CO * DT_H * DT_W) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      head_conv_dw_partial_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  head_conv_dw_partial_kernel<T><<<nrows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<float*>(partial), B, C, H, W, circular);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = CO * C * KS * KS;
  head_conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, nrows);
  return cudaGetLastError();
}

bool bad_shape(int B, int C, int H, int W) {
  return B < 1 || B > 65535 || C < 1 || C > TC_MAX_C || H < 1 || W < 1;
}

}  // namespace

// float32 x (the FMA kernel)
extern "C" int im23d_head_conv_fwd(const void* x, const void* w,
                                   const void* bias, void* y, int B, int C,
                                   int H, int W, int circular, void* stream) {
  if (bad_shape(B, C, H, W)) return cudaErrorInvalidValue;
  const dim3 grid((W + FT_W - 1) / FT_W, (H + FT_H - 1) / FT_H, B);
  head_conv_fwd_kernel<<<grid, dim3(FT_W, FT_TY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), C, H, W,
      circular);
  return cudaGetLastError();
}

// bfloat16 x (the tensor-core kernel): persistent blocks, one an SM; TMA
// boxes where W is a multiple of 8 and x is 16-byte aligned
extern "C" int im23d_head_conv_fwd_bf16(const void* x, const void* w,
                                        const void* bias, void* y, int B,
                                        int C, int H, int W, int circular,
                                        void* stream) {
  if (bad_shape(B, C, H, W)) return cudaErrorInvalidValue;
  TcGeo g;
  g.B = B;
  g.C = C;
  g.H = H;
  g.W = W;
  g.circular = circular;
  g.tiles_w = (W + TC_TW - 1) / TC_TW;
  g.tiles_h = (H + TC_TH - 1) / TC_TH;
  g.nstage = (C + TC_CK - 1) / TC_CK;
  const long long tiles = static_cast<long long>(B) * g.tiles_h * g.tiles_w;
  if (tiles * g.nstage > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 8 == 0;
  const int smem = TC_NBUF * TC_BOX + KS * g.nstage * TC_WKS + 8 * TC_NBUF;
  const void* kernel = vec
                           ? reinterpret_cast<const void*>(
                                 head_conv_tc_kernel<true>)
                           : reinterpret_cast<const void*>(
                                 head_conv_tc_kernel<false>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        TC_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(occ) * sms ? tiles
                                                : static_cast<long long>(occ) * sms);
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof xmap);
  if (vec && !encode_nchw_bf16(&xmap, x, B, C, H, W, TC_BW, TC_BH, TC_CK))
    return cudaErrorNotSupported;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (vec)
    head_conv_tc_kernel<true><<<grid, TC_THREADS, smem, s>>>(xp, wp, bp, yp,
                                                             g, xmap);
  else
    head_conv_tc_kernel<false><<<grid, TC_THREADS, smem, s>>>(xp, wp, bp, yp,
                                                              g, xmap);
  return cudaGetLastError();
}

// the tensor-core dW: a persistent block an SM (at most nrows), a partial
// row each, then the ordered sum of the rows
static int launch_dw_tc(const void* x, const void* gup, void* partial,
                        void* dw, int B, int C, int H, int W, int circular,
                        int nrows, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = min(nrows, sms);
  DwGeo g;
  g.B = B;
  g.C = C;
  g.H = H;
  g.W = W;
  g.circular = circular;
  g.tiles_w = (W + DW_TW - 1) / DW_TW;
  g.tasks = static_cast<long long>(B) * g.tiles_w * H;
  // TMA boxes of x and of g
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && W % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(gup) % 16 == 0;
  const void* kernel =
      vec ? reinterpret_cast<const void*>(head_conv_dw_tc_kernel<true>)
          : reinterpret_cast<const void*>(head_conv_dw_tc_kernel<false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DW_SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, gmap;
  memset(&xmap, 0, sizeof xmap);
  memset(&gmap, 0, sizeof gmap);
  if (vec && !(encode_nchw_bf16(&xmap, x, B, C, H, W, DW_BW, 1, DW_CS) &&
               encode_nchw(&gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, gup, B,
                           CO, H, W, DW_GE, 1, CO)))
    return cudaErrorNotSupported;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* gp = static_cast<const float*>(gup);
  auto* pp = static_cast<float*>(partial);
  if (vec)
    head_conv_dw_tc_kernel<true>
        <<<grid, DW_THREADS, DW_SMEM, stream>>>(xp, gp, pp, g, xmap, gmap);
  else
    head_conv_dw_tc_kernel<false>
        <<<grid, DW_THREADS, DW_SMEM, stream>>>(xp, gp, pp, g, xmap, gmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = CO * C * KS * KS;
  head_conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      pp, static_cast<float*>(dw), n, grid);
  return cudaGetLastError();
}

// partial holds nrows rows of 3 x C x 25 floats: bfloat16 x with C <= 64
// runs on the tensor cores (a persistent block an SM, at most nrows), any
// other x on the FMA kernel (nrows blocks)
extern "C" int im23d_head_conv_dw(const void* x, const void* g, void* partial,
                                  void* dw, int B, int C, int H, int W,
                                  int circular, int bf16, int nrows,
                                  void* stream) {
  if (bad_shape(B, C, H, W) || nrows < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && C <= DW_CS)
    return launch_dw_tc(x, g, partial, dw, B, C, H, W, circular, nrows, s);
  return bf16 ? launch_dw<__nv_bfloat16>(x, g, partial, dw, B, C, H, W,
                                         circular, nrows, s)
              : launch_dw<float>(x, g, partial, dw, B, C, H, W, circular,
                                 nrows, s);
}
