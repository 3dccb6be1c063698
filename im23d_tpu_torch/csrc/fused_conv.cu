// K9: the GAN generator's folded affine + leaky ReLU + 3 x 3 conv, sm_90a.
//
// im23d_fused_conv_fwd replaces the Pallas TPU kernel
// im23d_tpu/ops/conv_pallas.py _fused_fwd_kernel (the forward of
// fused_affine_conv3x3):
//   act[b, c, h, w] = leaky_relu(x[b, c, h, w] * a[b, c] + bb[b, c], 0.2)
//                     (pre >= 0 keeps pre), rounded to x's type once;
//   y[b, o, h, w]   = sum over c, i, j of w[o, c, i, j] * actp[b, c, h + i, w + j]
// where actp is act padded by one on each side: zero rows in H (zero after
// the affine: lrelu(bb) would be wrong there), replicate or circular
// columns in W.  Without the affine (affine = 0) act is x itself.  x and y
// are NCHW in bfloat16 or float32, a and bb (B, C) float32, w the float32
// (Cout, Cin, 3, 3) weight as the model holds it: the kernel rounds it to
// x's type itself.
//
// What bounds it on the H100: at the generator's 512 x 256 stages both
// bytes and operations.  blk6's conv2 (32 x 64 x 512 x 256 -> 64, bf16)
// moves 1.07 GB (0.32 ms at 3.35 TB/s) and does 0.31 TFLOP (0.31 ms at the
// bf16 tensor-core peak); with 128 input channels the operations bound.
// The TPU kernel folds W columns into MXU lanes and DMAs padded row
// windows; here it is an implicit GEMM, M = output pixels, N = Cout,
// K = 9 * Cin, in a persistent bf16 kernel (one block an SM, 8 warps):
//   - the weights: every block first rounds its share of w to bf16 into a
//     (3, 3, Cout, Cin) scratch, then the grid synchronises (a cooperative
//     launch), so no copy of the weight is made outside the kernel; a
//     block owns 64 output channels for its whole life and keeps all
//     their 9 x Cin weights in shared memory where they fit (73.7 KB at
//     64 -> 64), loaded once; otherwise (128 and more input channels) a
//     two-slot ring holds one 32-channel stage, the next stage's weights
//     arriving by cp.async during this stage's products;
//   - a block walks many tiles of up to 512 output pixels, 16 rows x 32
//     columns where W allows (a padded patch of 18 x 34: 1.20x the pixels,
//     against 1.55x for the first version's 4 x 64 tiles); small layers
//     take shorter tiles or whole images side by side, so that every
//     multiprocessor gets about one (the plan: ops/conv.py
//     fused_conv_plan);
//   - activations are staged 32 input channels at a time.  One thread
//     asks the tensor memory accelerator for the next stage's box of x
//     (32 channels x the patch rows x tw + 16 columns, out-of-image rows
//     and channels zero-filled) at the start of a stage; it lands, with
//     an mbarrier, while the 8 warps run this stage's products.  The warps
//     then transform it into the next patch buffer, channel-last with
//     16-byte chunks XOR-swizzled so that ldmatrix reads no bank twice:
//     ldmatrix.trans turns 8 columns x 8 channels of the box into the
//     4-byte channel pairs of the patch, and each element gets the affine,
//     the leaky ReLU (float32, no FMA contraction, so the result is the
//     plain version's) and one bf16 rounding once; H-pad rows are written
//     as zero and the W-pad columns copied from their source columns by
//     index, the right one just past the tile's last column of x (in the
//     last tile of a width that the tile width does not divide, over a
//     column of the box's zero fill).  Shapes the box cannot take (W not
//     a multiple of 8) load the next stage after the products instead, a
//     thread per padded pixel;
//   - each warp owns 64 pixels x 64 channels (acc: 128 floats a thread)
//     and runs the nine taps as shifted windows of the patch: ldmatrix.x4
//     fragments, loaded one k-step ahead of the mma.sync.m16n8k16 bf16
//     products that use them; the tap loop stays rolled, so that the code
//     fits the instruction caches (unrolled, it cost the transform and the
//     epilogue misses);
//   - y is written from the accumulators: two rounds of shuffles give a
//     lane 4 neighbouring pixels of one channel, one 8-byte store.
// The order of the K sums: for each 32-channel stage in order, the taps
// (row-major), within a tap the channels in k-steps of 16 (each mma sums
// its 16 products in the tensor core's own order), all into one float32
// accumulator; a 16-channel last stage runs with its other 16 channels
// zero.  wgmma is left out: its operands must sit in shared memory in
// 8-row core matrices, and a tap's window starts at any pixel.
// float32 operands take a separate kernel on the float32 FMA units (no
// TF32): 128 pixels a block, 256 threads, each 8 pixels x 4 channels, 8
// channels a stage, the weight read from its (Cout, Cin, 3, 3) layout.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr float SLOPE = 0.2f;
constexpr int BM = 512;       // output pixels a bf16 tile
constexpr int FBM = 128;      // output pixels a float32 block
constexpr int BN = 64;        // output channels a block
constexpr int MAX_TW = 32;    // widest bf16 pixel tile
constexpr int MAX_PATCH = 640;  // padded pixels of a bf16 tile, at most
constexpr int CK = 32;        // bf16 input channels a stage: a staged pixel
                              // or weight row is 64 bytes, 4 chunks of 16
constexpr int BT = 256;       // threads of the bf16 kernel: 8 warps of 64
                              // pixels x 64 channels
constexpr int WSTAGE = 9 * BN * 64;  // bytes of one stage's weights
constexpr int TABLES = BT / 32 * 2 * CK * 4;  // the warps' affine tables
constexpr int FT = 256;       // threads of the float32 kernel
constexpr int FCK = 8;        // float32 input channels a stage
constexpr int F_MAX_TW = 64;  // widest float32 pixel tile

__device__ __forceinline__ int src_col(int col, int W, int circular) {
  if (circular) {
    col %= W;
    return col < 0 ? col + W : col;
  }
  return min(max(col, 0), W - 1);
}

// lrelu(v * a + b) with JAX's tie rule; the product and the sum rounded
// separately, as the plain version computes them
__device__ __forceinline__ float affine_lrelu(float v, float a, float b) {
  const float pre = __fadd_rn(__fmul_rn(v, a), b);
  return pre >= 0.f ? pre : SLOPE * pre;
}

// byte offset of 16-byte chunk c of row r: the chunk index is XORed with
// bits 1-2 of the row, so 8 consecutive rows' chunks fill all 32 banks
// (ldmatrix reads 8 rows at a time, the loaders write 8 at a time)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared without registers; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// how the bf16 kernel cuts the output: tiles of ti images x th rows x tw
// columns (ti > 1 only when th and tw cover the image), 64 output
// channels a slice
struct Plan {
  int ti, th, tw;
  int tiles_w, tiles_h, tiles_b, nslices;
  int vec;       // x staged by TMA boxes
  int resident;  // all of a slice's weights in shared memory
  int patch;     // padded pixels of a tile: ti (th + 2) (tw + 2)
  int bw, bh;    // the TMA box's columns and rows (vec plans)
};

// bytes of a stage's TMA box in shared memory (vec plans: CK channels x
// bh rows x bw columns of bf16), rounded to 128; the mbarrier follows it
__host__ __device__ __forceinline__ int raw_bytes(const Plan& p) {
  return p.vec ? (CK * p.bh * p.bw * 2 + 127) / 128 * 128 : 0;
}

// a tile's origin: first image, row and column, first output channel
struct Origin {
  int b0, h0, w0, n0;
};

// work item -> origin; items run slice-fastest, so neighbouring blocks
// share a tile's activations in L2
__device__ __forceinline__ Origin origin_of(const Plan& p, int item) {
  Origin o;
  o.n0 = (item % p.nslices) * BN;
  int t = item / p.nslices;
  o.w0 = (t % p.tiles_w) * p.tw;
  t /= p.tiles_w;
  o.h0 = (t % p.tiles_h) * p.th;
  o.b0 = (t / p.tiles_h) * p.ti;
  return o;
}

struct Geo {
  int B, Cin, Cout, H, W, circular;
};

// The tile geometry, known at compile time for the main path's tilings
// (TW x TH = 32 x 8 and 16 x 16, one image a tile), else read from the
// plan (TW = TH = 0): the divisions that map a thread's work to pixels
// then become shifts and multiplies.
template <int TW, int TH>
struct Tile {
  const Plan& p;
  __device__ __forceinline__ int tw() const { return TW ? TW : p.tw; }
  __device__ __forceinline__ int th() const { return TH ? TH : p.th; }
  __device__ __forceinline__ int ti() const { return TW ? 1 : p.ti; }
};

// ---- TMA: a stage's raw x, one box a stage, into shared memory ----------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces the bytes the next copy brings
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// box (columns, rows, channels, 1 image) at (w, h, c, b) of x viewed as
// (W, H, C, B); coordinates outside x are filled with zero
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int w, int h, int c,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :
      : "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(w),
        "r"(h), "r"(c), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// A stage's raw box holds, for each of CK channels and bh >= th + 2 patch
// rows, bw >= tw + 16 columns from w0 - 8 (the interior starts 16 bytes
// in).  Chosen by the plan so that a channel's bh x bw block is an odd
// number of 16-byte units where shared memory allows: the eight channel
// rows that one ldmatrix.trans reads then fall in eight different bank
// groups.  A transform unit is one 16-byte column group (8 pixels) of one
// patch row across all CK channels: one ldmatrix.x4.trans hands lane
// (g, tg) channels 8 q + 2 tg, 8 q + 2 tg + 1 of pixel g for q = 0..3,
// which is one 4-byte word of the channel-last patch each; the lane
// applies the affine, the leaky ReLU and the rounding and writes the four
// words.  Interior units cover the tile's tw columns; a halo unit reads
// the group that holds a W-pad column's source column and only its lanes
// g = source % 8 write.  Units go to warps round-robin.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the stage's affine rows for the warp's own shared-memory table (CK a
// values, then CK b values): lane c fetches channel c (zero where there is
// no affine or no channel) ...
__device__ __forceinline__ float2 fetch_affine(const float* a,
                                               const float* bb, const Geo& g,
                                               const Origin& o, int c0,
                                               int kc, int lane) {
  const bool ok = a != nullptr && lane < kc;
  return make_float2(ok ? __ldg(a + o.b0 * g.Cin + c0 + lane) : 0.f,
                     ok ? __ldg(bb + o.b0 * g.Cin + c0 + lane) : 0.f);
}

// ... and writes it once the warp's last reads of the table are done
__device__ __forceinline__ void publish_affine(float* tab, float2 ab,
                                               int lane) {
  __syncwarp();
  tab[lane] = ab.x;
  tab[CK + lane] = ab.y;
  __syncwarp();
}

// the stage's transform, a patch row at a time (rows warp, warp + 8, ...):
// each row's column groups read by ldmatrix.trans before any is written
template <int TW, int TH>
__device__ __forceinline__ void transform(
    unsigned char* As, const unsigned char* raw, const Plan& p, const Geo& g,
    const __nv_bfloat16* __restrict__ x, const float* tab, bool affine,
    const Origin& o, int c0, int kc, int lane, int warp) {
  constexpr int NW = BT / 32, MAX_G8 = MAX_TW / 8;
  const Tile<TW, TH> t{p};
  const int tw = t.tw(), rows = t.th() + 2, pw = tw + 2, g8 = tw / 8;
  const int qn = kc / 8, gg = lane >> 2, tg = lane & 3;
  float av[4][2], bv[4][2];  // the affine rows of channels 8 q + 2 tg + h
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 fa = *reinterpret_cast<const float2*>(tab + q * 8 + 2 * tg);
    const float2 fb =
        *reinterpret_cast<const float2*>(tab + CK + q * 8 + 2 * tg);
    av[q][0] = fa.x;
    av[q][1] = fa.y;
    bv[q][0] = fb.x;
    bv[q][1] = fb.y;
  }
  // the tile's columns of x: tw, fewer in the last tile of a width that
  // tw does not divide (its columns past W come from the box's zero fill
  // and feed only outputs that are not stored)
  const int wl = min(tw, g.W - o.w0);
  // the two W-pad columns' sources, the same for every row: their place
  // in the box, or (circular pads of wide images) x itself; the right one
  // is written after column wl
  int hcol[2], hrc[2];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    hcol[side] = src_col(side ? o.w0 + wl : o.w0 - 1, g.W, g.circular);
    hrc[side] = hcol[side] - (o.w0 - 8);
  }
  // lane's ldmatrix row: channel `lane` of the box
  const unsigned char* lane_row =
      raw + static_cast<size_t>(lane) * p.bh * p.bw * 2;
  auto put = [&](uint32_t v, int px, int q, bool in) {
    if (affine) {
      const float pl = __fadd_rn(
          __fmul_rn(__uint_as_float(v << 16), av[q][0]), bv[q][0]);
      const float ph = __fadd_rn(
          __fmul_rn(__uint_as_float(v & 0xffff0000u), av[q][1]), bv[q][1]);
      v = pack_bf16(fmaxf(pl, SLOPE * pl), fmaxf(ph, SLOPE * ph));
    }
    *reinterpret_cast<uint32_t*>(As + swz(px, q) + 4 * tg) =
        in && q < qn ? v : 0u;
  };
#pragma unroll 1
  for (int r = warp; r < rows; r += NW) {
    const int row = o.h0 + r - 1;
    const bool in = row >= 0 && row < g.H;
    const unsigned char* src = lane_row + r * p.bw * 2;
    uint32_t d[MAX_G8 + 2][4];
#pragma unroll
    for (int gq = 0; gq < MAX_G8; ++gq)
      if (gq < g8) ldmatrix_x4_trans(d[gq], src + (1 + gq) * 16);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const bool inbox = hrc[side] >= 0 && hrc[side] < p.bw;
      ldmatrix_x4_trans(d[MAX_G8 + side],
                        src + (inbox ? hrc[side] >> 3 : 0) * 16);
      if (!inbox) {  // lanes g = 0 read their channels from x itself
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t w2 = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = q * 8 + 2 * tg + h;
            if (gg == 0 && in && c < kc)
              w2 |= static_cast<uint32_t>(__ldg(
                        reinterpret_cast<const unsigned short*>(x) +
                        ((static_cast<size_t>(o.b0) * g.Cin + c0 + c) * g.H +
                         row) * static_cast<size_t>(g.W) + hcol[side]))
                    << (16 * h);
          }
          d[MAX_G8 + side][q] = w2;
        }
      }
    }
#pragma unroll
    for (int gq = 0; gq < MAX_G8; ++gq)
      if (gq < g8)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          put(d[gq][q], r * pw + 1 + 8 * gq + gg, q, in);
    // in a partial tile the right pad's place holds a zero-filled column
    // that another lane wrote above
    __syncwarp();
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const bool inbox = hrc[side] >= 0 && hrc[side] < p.bw;
      if (gg == (inbox ? hrc[side] & 7 : 0))
#pragma unroll
        for (int q = 0; q < 4; ++q)
          put(d[MAX_G8 + side][q], r * pw + (side ? wl + 1 : 0), q, in);
    }
  }
}

// the stage loaded and written in one go, a thread per padded pixel with
// 16 channels' loads in flight (shapes without aligned 16-byte rows)
__device__ __forceinline__ void load_direct(
    unsigned char* As, const Plan& p, const Geo& g,
    const __nv_bfloat16* __restrict__ x, const float* a, const float* bb,
    const Origin& o, int c0, int kc) {
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const int pw = p.tw + 2, per_img = (p.th + 2) * pw;
  for (int q = threadIdx.x; q < p.patch; q += BT) {
    const int i = q / per_img, rq = q - i * per_img;
    const int r = rq / pw, col = rq - r * pw;
    const int img = o.b0 + i, row = o.h0 + r - 1;
    const bool in = img < g.B && row >= 0 && row < g.H;
    const __nv_bfloat16* src =
        in ? x + (static_cast<size_t>(img) * g.Cin + c0) * plane +
                 static_cast<size_t>(row) * g.W +
                 src_col(o.w0 + col - 1, g.W, g.circular)
           : x;
#pragma unroll 1
    for (int k0 = 0; k0 < kc; k0 += 16) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = in ? __bfloat162float(src[(k0 + j) * plane]) : 0.f;
      if (a != nullptr && in) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int idx = img * g.Cin + c0 + k0 + j;
          v[j] = affine_lrelu(v[j], __ldg(a + idx), __ldg(bb + idx));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(As + swz(q, k0 / 8 + h)) = make_uint4(
            pack_bf16(v[8 * h], v[8 * h + 1]),
            pack_bf16(v[8 * h + 2], v[8 * h + 3]),
            pack_bf16(v[8 * h + 4], v[8 * h + 5]),
            pack_bf16(v[8 * h + 6], v[8 * h + 7]));
    }
    if (kc < CK)  // a 16-channel stage: its other 16 channels are zero
      *reinterpret_cast<uint4*>(As + swz(q, 2)) =
          *reinterpret_cast<uint4*>(As + swz(q, 3)) = make_uint4(0, 0, 0, 0);
  }
}

// cp.async of one stage's weights, rows (tap, n) of CK channels, from the
// (3, 3, Cout, Cin) bf16 scratch; rows past Cout and channels past kc are
// zero-filled
__device__ __forceinline__ void load_weights(
    unsigned char* Bs, const __nv_bfloat16* __restrict__ w9, const Geo& g,
    int n0, int c0, int kc) {
  for (int idx = threadIdx.x; idx < 9 * BN * 4; idx += BT) {
    const int v = idx & 3, rn = idx >> 2;
    const int n = rn % BN, tap = rn / BN;
    const bool ok = n0 + n < g.Cout && v * 8 < kc;
    cp_async16(Bs + swz(rn, v),
               ok ? w9 + (static_cast<size_t>(tap) * g.Cout + n0 + n) *
                                g.Cin + c0 + v * 8
                  : w9,
               ok);
  }
}

struct Frags {
  uint32_t a[4][4];
  uint32_t b[8][2];
};

__device__ __forceinline__ void load_frags(Frags& f, const unsigned char* As,
                                           const unsigned char* Bs,
                                           const int (&qa)[4], int pw,
                                           int a_k, int b_row, int b_k,
                                           int tap, int ks) {
  const int dq = (tap / 3) * pw + tap % 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    ldmatrix_x4(f.a[mi], As + swz(qa[mi] + dq, 2 * ks + a_k));
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t r[4];
    ldmatrix_x4(r, Bs + swz(tap * BN + np * 16 + b_row, 2 * ks + b_k));
    f.b[2 * np][0] = r[0];
    f.b[2 * np][1] = r[1];
    f.b[2 * np + 1][0] = r[2];
    f.b[2 * np + 1][1] = r[3];
  }
}

// one stage's products: 9 taps x 2 k-steps of 16 channels, each k-step's
// fragments loaded while the previous k-step's products run.  The tap loop
// stays rolled, so that the kernel's code fits the instruction caches.
__device__ __forceinline__ void mma_stage(float (&acc)[4][8][4],
                                          const unsigned char* As,
                                          const unsigned char* Bs,
                                          const int (&qa)[4], int pw, int a_k,
                                          int b_row, int b_k) {
  Frags fr[2];
  load_frags(fr[0], As, Bs, qa, pw, a_k, b_row, b_k, 0, 0);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks == 0)
        load_frags(fr[1], As, Bs, qa, pw, a_k, b_row, b_k, tap, 1);
      else if (tap < 8)
        load_frags(fr[0], As, Bs, qa, pw, a_k, b_row, b_k, tap + 1, 0);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
          mma_bf16(acc[mi][nj], fr[ks].a[mi], fr[ks].b[nj][0],
                   fr[ks].b[nj][1]);
    }
  }
}

// the accumulators of tile o, rounded to bf16 once, into y.  A lane holds
// pixels g and g + 8 of each 16-pixel fragment for channels 2 tg and
// 2 tg + 1.  Where tw and W are multiples of 4, two rounds of shuffles
// (lanes g ^ 1, then g ^ 2) give every lane 4 neighbouring pixels of one
// channel, stored as 8 bytes: lanes with g & 2 clear store pixels
// (g & 4) ... + 3 of the fragment's first 8, the others the same of its
// last 8; channel 2 tg + (g & 1).  Other shapes store one value at a time.
template <int TW, int TH>
__device__ __forceinline__ void store_tile(float (&acc)[4][8][4],
                                           __nv_bfloat16* __restrict__ y,
                                           const Plan& p, const Geo& gm,
                                           const Origin& o, int wm, int lane) {
  const Tile<TW, TH> t{p};
  const int g = lane >> 2, tg = lane & 3;
  const int per_img = t.th() * t.tw(), used = t.ti() * per_img;
  const size_t plane = static_cast<size_t>(gm.H) * gm.W;
  if (t.tw() % 4 == 0 && gm.W % 4 == 0) {
    const bool odd = g & 1, hi = g & 2;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = wm * 64 + mi * 16 + (g & 4) + (hi ? 8 : 0);
      const int i = m / per_img, rem = m - i * per_img;
      const int img = o.b0 + i, h = o.h0 + rem / t.tw(),
                wc = o.w0 + rem % t.tw();
      const bool ok = m < used && img < gm.B && h < gm.H && wc < gm.W;
      __nv_bfloat16* yp = y + static_cast<size_t>(img) * gm.Cout * plane +
                          static_cast<size_t>(h) * gm.W + wc;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int n = o.n0 + nj * 8 + tg * 2 + (odd ? 1 : 0);
        uint32_t pr[2];  // this lane's pixel pair of each half
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v0 = acc[mi][nj][2 * half],
                      v1 = acc[mi][nj][2 * half + 1];
          const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
          pr[half] = odd ? pack_bf16(got, v1) : pack_bf16(v0, got);
        }
        const uint32_t other =
            __shfl_xor_sync(0xffffffffu, hi ? pr[0] : pr[1], 8);
        if (ok && n < gm.Cout)
          *reinterpret_cast<uint2*>(yp + n * plane) =
              hi ? make_uint2(other, pr[1]) : make_uint2(pr[0], other);
      }
    }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm * 64 + mi * 16 + g + 8 * half;
      const int i = m / per_img, rem = m - i * per_img;
      const int img = o.b0 + i, h = o.h0 + rem / t.tw(),
                wc = o.w0 + rem % t.tw();
      if (m >= used || img >= gm.B || h >= gm.H || wc >= gm.W) continue;
      __nv_bfloat16* yp = y + static_cast<size_t>(img) * gm.Cout * plane +
                          static_cast<size_t>(h) * gm.W + wc;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int n = o.n0 + nj * 8 + tg * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < gm.Cout)
            yp[(n + e) * plane] =
                __float2bfloat16_rn(acc[mi][nj][2 * half + e]);
      }
    }
}

template <int TW, int TH>
__global__ void __launch_bounds__(BT, 1)
    fused_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ a,
                           const float* __restrict__ bb,
                           const float* __restrict__ w,
                           __nv_bfloat16* __restrict__ w9,
                           __nv_bfloat16* __restrict__ y, Geo gm, Plan p,
                           const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nks = (gm.Cin + CK - 1) / CK;
  unsigned char* Bs = smem;  // nks (resident) or 2 stages of weights
  unsigned char* As = Bs + (p.resident ? nks : 2) * WSTAGE;  // 2 patches
  const int abytes = p.patch * 64;
  unsigned char* raw = As + 2 * abytes;  // the TMA box of the next stage
  auto* bar = reinterpret_cast<uint64_t*>(raw + raw_bytes(p));
  // each warp's affine table for the stage it transforms (vec plans)
  float* tab = reinterpret_cast<float*>(raw + raw_bytes(p) + 128) +
               (threadIdx.x >> 5) * 2 * CK;
  const unsigned box_bytes = CK * p.bh * p.bw * 2;

  // the weights, rounded to bf16 once, into the (3, 3, Cout, Cin) scratch:
  // two channels a thread step, read from w's (Cout, Cin, 3, 3) layout
  {
    const int pairs = 9 * gm.Cout * gm.Cin / 2;
    for (int e = blockIdx.x * BT + threadIdx.x; e < pairs;
         e += gridDim.x * BT) {
      const int c2 = (e * 2) % gm.Cin, rn = (e * 2) / gm.Cin;
      const int n = rn % gm.Cout, tap = rn / gm.Cout;
      const float* src = w + (static_cast<size_t>(n) * gm.Cin + c2) * 9 + tap;
      *reinterpret_cast<__nv_bfloat162*>(w9 + 2 * static_cast<size_t>(e)) =
          __floats2bfloat162_rn(__ldg(src), __ldg(src + 9));
    }
    __threadfence();
    cg::this_grid().sync();
  }

  const Tile<TW, TH> t{p};
  const int total = p.tiles_b * p.tiles_h * p.tiles_w * p.nslices;
  int item = blockIdx.x;
  if (item >= total) return;

  const int tid = threadIdx.x, lane = tid & 31, wm = tid >> 5;
  const int pw = t.tw() + 2, per_img = t.th() * t.tw();
  const int used = t.ti() * per_img;
  const bool active = wm * 64 < used;  // a warp row with pixels to compute

  // this lane's ldmatrix row in each of its four 16-pixel fragments: the
  // patch pixel at tap (0, 0); unused pixels read pixel 0
  int qa[4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m = wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int i = m / per_img, rem = m - i * per_img;
    qa[mi] = m < used
                 ? (i * (t.th() + 2) + rem / t.tw()) * pw + rem % t.tw()
                 : 0;
  }
  const int a_k = lane >> 4;  // 16-byte chunk within a k-step of 16
  const int b_row = (lane & 7) + (lane >> 4) * 8;  // + 16 per ldmatrix
  const int b_k = (lane >> 3) & 1;

  Origin o = origin_of(p, item);
  const int kc0 = min(CK, gm.Cin);
  if (p.resident)
    for (int k = 0; k < nks; ++k)
      load_weights(Bs + k * WSTAGE, w9, gm, o.n0, k * CK,
                   min(CK, gm.Cin - k * CK));
  else
    load_weights(Bs, w9, gm, o.n0, 0, kc0);
  unsigned phase = 0;  // parity of the TMA box the block waits for next
  if (p.vec) {
    if (tid == 0) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, box_bytes);
      tma_load(raw, &xmap, bar, o.w0 - 8, o.h0 - 1, 0, o.b0);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    mbar_wait(bar, phase);
    phase ^= 1;
    publish_affine(tab, fetch_affine(a, bb, gm, o, 0, kc0, lane), lane);
    transform<TW, TH>(As, raw, p, gm, x, tab, a != nullptr, o, 0, kc0, lane,
                      wm);
  } else {
    load_direct(As, p, gm, x, a, bb, o, 0, kc0);
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  int k = 0, slot = 0;
  for (;;) {
    // the next stage: this tile's next channel chunk, or the next tile's
    // first
    int nitem = item, nk = k + 1;
    if (nk == nks) {
      nk = 0;
      nitem += gridDim.x;
    }
    const bool more = nitem < total;
    const Origin no = more ? origin_of(p, nitem) : o;
    const int nc0 = nk * CK, nkc = min(CK, gm.Cin - nc0);
    unsigned char* An = As + (slot ^ 1) * abytes;
    const unsigned char* Ac = As + slot * abytes;
    const unsigned char* Bc = Bs + (p.resident ? k : slot) * WSTAGE;
    if (more && !p.resident)
      load_weights(Bs + (slot ^ 1) * WSTAGE, w9, gm, no.n0, nc0, nkc);
    const bool tma = more && p.vec;
    if (tma && tid == 0) {  // the raw box was consumed before the barrier
      mbar_expect_tx(bar, box_bytes);
      tma_load(raw, &xmap, bar, no.w0 - 8, no.h0 - 1, nc0, no.b0);
    }
    if (active) mma_stage(acc, Ac, Bc, qa, pw, a_k, b_row, b_k);
    if (tma) {
      // the next stage's transform, once its box (in flight during the
      // products) has arrived
      publish_affine(tab, fetch_affine(a, bb, gm, no, nc0, nkc, lane), lane);
      mbar_wait(bar, phase);
      transform<TW, TH>(An, raw, p, gm, x, tab, a != nullptr, no, nc0, nkc,
                        lane, wm);
    }
    if (tma) phase ^= 1;
    if (more && !p.vec) load_direct(An, p, gm, x, a, bb, no, nc0, nkc);
    if (k == nks - 1) {
      store_tile<TW, TH>(acc, y, p, gm, o, wm, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (!more) break;
    item = nitem;
    o = no;
    k = nk;
    slot ^= 1;
  }
}

struct Tiling {
  int tw, th, tiles_w, tiles_h;
};

// block -> (image, first output row, first output column)
__device__ __forceinline__ void tile_origin(const Tiling& t, int& b, int& h0,
                                            int& w0) {
  int blk = blockIdx.x;
  w0 = (blk % t.tiles_w) * t.tw;
  blk /= t.tiles_w;
  h0 = (blk % t.tiles_h) * t.th;
  b = blk / t.tiles_h;
}

__global__ void __launch_bounds__(FT)
    fused_conv_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ a,
                          const float* __restrict__ bb,
                          const float* __restrict__ w, float* __restrict__ y,
                          int Cin, int Cout, int H, int W, Tiling t,
                          int circular) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pw = t.tw + 2, patch = (t.th + 2) * pw;
  auto* Xs = reinterpret_cast<float*>(smem);  // FCK x patch
  float* Ws = Xs + FCK * patch;               // FCK x 9 x BN

  const int tid = threadIdx.x, tn = tid & 15, tm = tid >> 4;
  int b, h0, w0;
  tile_origin(t, b, h0, w0);
  const int n0 = blockIdx.y * BN;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + static_cast<size_t>(b) * Cin * plane;
  const float* ab = a ? a + static_cast<size_t>(b) * Cin : nullptr;
  const float* bbb = a ? bb + static_cast<size_t>(b) * Cin : nullptr;
  const int used = t.th * t.tw;

  int q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = tm * 8 + i;
    q[i] = p < used ? (p / t.tw) * pw + p % t.tw : 0;
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += FCK) {
    __syncthreads();
    for (int idx = tid; idx < FCK * patch; idx += FT) {
      const int cc = idx / patch, qq = idx - (idx / patch) * patch;
      const int r = qq / pw, col = qq - (qq / pw) * pw;
      const int row = h0 + r - 1, c = c0 + cc;
      float v = 0.f;  // H-pad rows stay zero
      if (row >= 0 && row < H) {
        v = xb[c * plane + static_cast<size_t>(row) * W +
               src_col(w0 + col - 1, W, circular)];
        if (ab) v = affine_lrelu(v, ab[c], bbb[c]);
      }
      Xs[idx] = v;
    }
    for (int idx = tid; idx < FCK * 9 * BN; idx += FT) {
      const int n = idx % BN, rest = idx / BN;
      const int tap = rest % 9, cc = rest / 9;
      Ws[idx] = n0 + n < Cout
                    ? w[(static_cast<size_t>(n0 + n) * Cin + c0 + cc) * 9 +
                        tap]
                    : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int cc = 0; cc < FCK; ++cc) {
      const float* xs = Xs + cc * patch;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dq = (tap / 3) * pw + tap % 3;
        const float4 wv =
            *reinterpret_cast<const float4*>(Ws + (cc * 9 + tap) * BN + tn * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xv = xs[q[i] + dq];
          acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = tm * 8 + i;
    if (p >= used) continue;
    const int h = h0 + p / t.tw, wc = w0 + p % t.tw;
    if (h >= H || wc >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < Cout)
        y[(static_cast<size_t>(b) * Cout + n) * plane +
          static_cast<size_t>(h) * W + wc] = acc[i][j];
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, found once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

}  // namespace

// What ops/conv.py fused_conv_plan reads to plan for device `dev`, into
// out[0..8]: its multiprocessors and opt-in shared memory a block (bytes),
// then the bf16 kernel's BM, BN, CK, MAX_TW, MAX_PATCH, WSTAGE and TABLES,
// so that the plan and the checks below use the same numbers.
extern "C" int im23d_fused_conv_limits(int dev, int* out) {
  cudaError_t err =
      cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int k[] = {BM, BN, CK, MAX_TW, MAX_PATCH, WSTAGE, TABLES};
  memcpy(out + 2, k, sizeof k);
  return err;
}

// x, a, bb, w, y as the note at the top says; w9 a (3, 3, Cout, Cin) bf16
// scratch for bf16 x.  ti, th, tw, vec, resident, bw and bh are the bf16
// kernel's plan (ops/conv.py fused_conv_plan): tiles of ti images x th
// rows x tw columns, x staged by TMA boxes of bw columns x bh rows, all
// weights of a slice kept in shared memory; a plan the kernel cannot run
// is refused.
extern "C" int im23d_fused_conv_fwd(const void* x, const void* a,
                                    const void* bb, const void* w, void* w9,
                                    void* y, int B, int Cin, int Cout, int H,
                                    int W, int circular, int affine, int bf16,
                                    int ti, int th, int tw, int vec,
                                    int resident, int bw, int bh,
                                    void* stream) {
  if (B < 1 || Cin < 16 || Cin % 16 || Cout < 16 || Cout % 16 || H < 1 ||
      W < 1 || (affine && (a == nullptr || bb == nullptr)) ||
      (bf16 && w9 == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* af = affine ? static_cast<const float*>(a) : nullptr;
  const float* bf = affine ? static_cast<const float*>(bb) : nullptr;
  if (!bf16) {
    Tiling t;
    t.tw = W < F_MAX_TW ? W : F_MAX_TW;
    t.th = FBM / t.tw;
    t.tiles_w = (W + t.tw - 1) / t.tw;
    t.tiles_h = (H + t.th - 1) / t.th;
    const long long blocks =
        static_cast<long long>(B) * t.tiles_w * t.tiles_h;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(blocks), (Cout + BN - 1) / BN);
    const size_t patch = static_cast<size_t>(t.th + 2) * (t.tw + 2);
    const size_t smem = (FCK * patch + FCK * 9 * BN) * sizeof(float);
    fused_conv_f32_kernel<<<grid, FT, smem, s>>>(
        static_cast<const float*>(x), af, bf, static_cast<const float*>(w),
        static_cast<float*>(y), Cin, Cout, H, W, t, circular);
    return cudaGetLastError();
  }
  Plan p;
  p.ti = ti;
  p.th = th;
  p.tw = tw;
  p.vec = vec;
  p.resident = resident;
  p.bw = bw;
  p.bh = bh;
  if (ti < 1 || th < 1 || tw < 1 || ti > B || th > H || tw > W ||
      tw > MAX_TW || ti * th * tw > BM || (ti > 1 && (th != H || tw != W)))
    return cudaErrorInvalidValue;
  p.patch = ti * (th + 2) * (tw + 2);
  if (p.patch > MAX_PATCH) return cudaErrorInvalidValue;
  // TMA boxes: 16-byte aligned rows of x, whole 16-byte box rows
  if (vec && (reinterpret_cast<uintptr_t>(x) % 16 || W % 8 || tw % 8 ||
              ti != 1 || bw < tw + 16 || bw % 8 || bw > 256 ||
              bh < th + 2 || bh > 256))
    return cudaErrorInvalidValue;
  p.nslices = (Cout + BN - 1) / BN;
  p.tiles_w = (W + tw - 1) / tw;
  p.tiles_h = (H + th - 1) / th;
  p.tiles_b = (B + ti - 1) / ti;
  const int nks = (Cin + CK - 1) / CK;
  const long long smem_ll =
      static_cast<long long>(resident ? nks : 2) * WSTAGE +
      2LL * p.patch * 64 + raw_bytes(p) + 128 +
      (vec ? TABLES : 0);  // patches, box, mbarrier, tables
  if (smem_ll > INT_MAX) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_ll);
  // the main path's tilings take kernels with their geometry compiled in
  const void* kernel =
      reinterpret_cast<const void*>(fused_conv_bf16_kernel<0, 0>);
  if (vec && ti == 1 && tw == 32 && th == 16)
    kernel = reinterpret_cast<const void*>(fused_conv_bf16_kernel<32, 16>);
  else if (vec && ti == 1 && tw == 16 && th == 32)
    kernel = reinterpret_cast<const void*>(fused_conv_bf16_kernel<16, 32>);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, BT, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  // persistent blocks, all resident (the cooperative launch's condition);
  // a multiple of the slice count, so each block keeps one slice; at
  // least one an SM, so that every SM rounds its share of the weights
  const long long total = static_cast<long long>(p.tiles_b) * p.tiles_h *
                          p.tiles_w * p.nslices;
  if (total > INT_MAX || 9LL * Cout * Cin > INT_MAX)
    return cudaErrorInvalidValue;
  const long long cap = static_cast<long long>(occ) * sms;
  long long grid = std::min(cap, std::max<long long>(total, sms));
  grid = std::max<long long>(p.nslices, grid / p.nslices * p.nslices);
  if (grid > cap) return cudaErrorCooperativeLaunchTooLarge;
  Geo gm;
  gm.B = B;
  gm.Cin = Cin;
  gm.Cout = Cout;
  gm.H = H;
  gm.W = W;
  gm.circular = circular;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const float*>(w);
  auto* w9p = static_cast<__nv_bfloat16*>(w9);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  // x viewed as (W, H, Cin, B) for the TMA boxes of vec plans
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof xmap);
  if (vec) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {2ull * W, 2ull * H * W, 2ull * Cin * H * W};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw),
                               static_cast<cuuint32_t>(bh), CK, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  void* args[] = {&xp, &af, &bf, &wp, &w9p, &yp, &gm, &p, &xmap};
  err = cudaLaunchCooperativeKernel(
      kernel,
      dim3(static_cast<unsigned>(grid)), dim3(BT), args,
      static_cast<size_t>(smem), s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
