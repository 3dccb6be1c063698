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
// with g = dy * (1 - y^2) in float32, reduced in two deterministic passes:
// each block sums a fixed set of tiles into its own row of a partial buffer,
// then one thread per weight adds the rows in block order.  No float
// atomicAdd, so the result is the same on every launch.  A thread owns one
// (channel, tap row) pair and its 15 (output, tap column) sums on the
// float32 FMA units; a block stages an 8 x 36 patch of every channel and
// the 4 x 32 tile of g, and walks its tiles with a 5-value sliding window.
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
                    ? g[((static_cast<size_t>(b) * CO + o) * H + h) * W + wc]
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

extern "C" int im23d_head_conv_dw(const void* x, const void* g, void* partial,
                                  void* dw, int B, int C, int H, int W,
                                  int circular, int bf16, int nrows,
                                  void* stream) {
  if (bad_shape(B, C, H, W) || nrows < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dw<__nv_bfloat16>(x, g, partial, dw, B, C, H, W,
                                         circular, nrows, s)
              : launch_dw<float>(x, g, partial, dw, B, C, H, W, circular,
                                 nrows, s);
}
