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
// columns in W.  Without the affine (affine = 0) act is x itself.  x, w and
// y are NCHW in bfloat16 or float32, a and bb (B, C) float32; the caller
// passes w as (3, 3, Cout, Cin) in x's type.
//
// What bounds it on the H100: at the generator's 512 x 256 stages both
// bytes and operations.  blk6's conv2 (32 x 64 x 512 x 256 -> 64, bf16)
// moves 1.07 GB (0.32 ms at 3.35 TB/s) and does 0.31 TFLOP (0.31 ms at the
// bf16 tensor-core peak); with 128 input channels the operations bound.
// The TPU kernel folds W columns into MXU lanes and DMAs padded row
// windows; here it is an implicit GEMM, M = output pixels, N = Cout,
// K = 9 * Cin:
//   - a block owns 256 output pixels (TH rows x TW columns of one image,
//     TW = min(W, 64)) and 64 output channels;
//   - input channels are staged 32 at a time as the (TH + 2) x (TW + 2)
//     padded patch, channel-last in shared memory (64-byte rows, their
//     16-byte chunks XOR-swizzled so ldmatrix reads no bank twice): a
//     thread per padded pixel starts its 16 channels' loads together,
//     applies a * x + bb and the leaky ReLU in float32 (no FMA
//     contraction, so the result is the plain version's), writes zero on
//     the H-pad rows, finds the W-pad column by index arithmetic and rounds
//     to bf16 once; the chunk's 9 x 64 x 32 weights arrive by cp.async
//     meanwhile;
//   - eight warps (4 x 2, each 64 pixels x 32 channels) run the nine taps
//     as shifted windows of the patch: ldmatrix.x4 fragments and
//     mma.sync.m16n8k16 bf16 products with float32 accumulators;
//   - the sums, rounded to bf16 once, go through shared memory so y is
//     written along W, two pixels a store.
// float32 operands take a separate kernel on the float32 FMA units (no
// TF32): 128 pixels a block, 256 threads, each 8 pixels x 4 channels, 8
// channels a stage.  A pipelined patch ring (the next stage's loads in
// flight during this stage's products), wgmma and TMA are left to a later
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr float SLOPE = 0.2f;
constexpr int BM = 256;       // output pixels a bf16 block
constexpr int FBM = 128;      // output pixels a float32 block
constexpr int BN = 64;        // output channels a block
constexpr int MAX_TW = 64;    // widest pixel tile
constexpr int CK = 32;        // bf16 input channels a stage: a staged pixel
                              // or weight row is 64 bytes, 4 chunks of 16
constexpr int BT = 256;       // threads of the bf16 kernel: 8 warps, 4 x 2
constexpr int CS = BM + 8;    // bf16 stride of the epilogue's [n][m] tile
constexpr int FT = 256;       // threads of the float32 kernel
constexpr int FCK = 8;        // float32 input channels a stage

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

__global__ void __launch_bounds__(BT, 2)
    fused_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ a,
                           const float* __restrict__ bb,
                           const __nv_bfloat16* __restrict__ w9,
                           __nv_bfloat16* __restrict__ y, int Cin, int Cout,
                           int H, int W, Tiling t, int circular) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pw = t.tw + 2, patch = (t.th + 2) * pw;
  unsigned char* As = smem;                    // patch rows of CK bf16
  unsigned char* Bs = As + patch * 64;         // 9 x BN rows of CK bf16
  auto* ABs = reinterpret_cast<float*>(Bs + 9 * BN * 64);  // a, b: 2 Cin
  auto* Cs = reinterpret_cast<__nv_bfloat16*>(smem);  // BN x CS, after

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  int b, h0, w0;
  tile_origin(t, b, h0, w0);
  const int n0 = blockIdx.y * BN;
  const size_t plane = static_cast<size_t>(H) * W;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * Cin * plane;
  const bool affine = a != nullptr;
  if (affine)
    for (int i = tid; i < Cin; i += BT) {
      ABs[i] = a[static_cast<size_t>(b) * Cin + i];
      ABs[Cin + i] = bb[static_cast<size_t>(b) * Cin + i];
    }
  const int used = t.th * t.tw;  // pixels of the tile (<= BM)

  // this lane's ldmatrix row in each of its four 16-pixel fragments: the
  // patch index of the pixel at tap (0, 0); unused pixels read pixel 0
  int qa[4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int p = wm * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    qa[mi] = p < used ? (p / t.tw) * pw + p % t.tw : 0;
  }
  const int a_k = lane >> 4;  // 16-byte chunk within a k-step of 16
  int b_row[2];
#pragma unroll
  for (int np = 0; np < 2; ++np)
    b_row[np] = wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8;
  const int b_k = (lane >> 3) & 1;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    const int kc = min(CK, Cin - c0);  // 32, or 16 for the last stage
    __syncthreads();                   // the previous stage's reads are done
    // weights: rows (tap, n) of kc input channels, 16 bytes at a time, in
    // flight while the activations are staged
    const int kv = kc / 8;
    for (int idx = tid; idx < 9 * BN * kv; idx += BT) {
      const int v = idx % kv, rn = idx / kv;
      const int n = rn % BN, tap = rn / BN;
      const bool ok = n0 + n < Cout;
      cp_async16(Bs + swz(rn, v),
                 ok ? w9 + (static_cast<size_t>(tap) * Cout + n0 + n) * Cin +
                          c0 + v * 8
                    : w9,
                 ok);
    }
    // activations: a thread per padded pixel, 16 channels' loads in flight
    for (int q = tid; q < patch; q += BT) {
      const int r = q / pw, col = q - (q / pw) * pw;
      const int row = h0 + r - 1;
      const bool in = row >= 0 && row < H;  // H-pad rows stay zero
      const __nv_bfloat16* src =
          xb + static_cast<size_t>(c0) * plane +
          (in ? static_cast<size_t>(row) * W + src_col(w0 + col - 1, W,
                                                          circular)
              : 0);
#pragma unroll 1
      for (int k0 = 0; k0 < kc; k0 += 16) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          v[j] = in ? __bfloat162float(src[(k0 + j) * plane]) : 0.f;
        if (affine && in) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = c0 + k0 + j;
            v[j] = affine_lrelu(v[j], ABs[c], ABs[Cin + c]);
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
    }
    cp_async_wait_all();
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dq = (tap / 3) * pw + tap % 3;
#pragma unroll 1
      for (int ks = 0; ks < kc / 8; ks += 2) {  // 16-byte chunks
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], As + swz(qa[mi] + dq, ks + a_k));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, Bs + swz(tap * BN + b_row[np], ks + b_k));
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            mma_bf16(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
      }
    }
  }

  // accumulators, rounded to bf16 once -> shared [n][m] -> y along W
  __syncthreads();
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int m = wm * 64 + mi * 16 + g, n = wn * 32 + nj * 8 + tg * 2;
      Cs[n * CS + m] = __float2bfloat16_rn(acc[mi][nj][0]);
      Cs[(n + 1) * CS + m] = __float2bfloat16_rn(acc[mi][nj][1]);
      Cs[n * CS + m + 8] = __float2bfloat16_rn(acc[mi][nj][2]);
      Cs[(n + 1) * CS + m + 8] = __float2bfloat16_rn(acc[mi][nj][3]);
    }
  __syncthreads();
  // two pixels a thread: a pair shares its row when TW is even
  for (int idx = tid; idx < BN * BM / 2; idx += BT) {
    const int n = idx / (BM / 2), m = 2 * (idx - n * (BM / 2));
    if (m >= used || n0 + n >= Cout) continue;
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(Cs + n * CS + m);
    __nv_bfloat16* yn = y + (static_cast<size_t>(b) * Cout + n0 + n) * plane;
    const int h = h0 + m / t.tw, wc = w0 + m % t.tw;
    if (t.tw % 2 == 0 && W % 2 == 0) {  // (h, wc), (h, wc + 1): 4 bytes
      if (h < H && wc < W)
        *reinterpret_cast<__nv_bfloat162*>(yn + static_cast<size_t>(h) * W +
                                           wc) = v;
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int me = m + e;
      const int he = h0 + me / t.tw, we = w0 + me % t.tw;
      if (me < used && he < H && we < W)
        yn[static_cast<size_t>(he) * W + we] = e ? v.y : v.x;
    }
  }
}

__global__ void __launch_bounds__(FT)
    fused_conv_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ a,
                          const float* __restrict__ bb,
                          const float* __restrict__ w9, float* __restrict__ y,
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
                    ? w9[(static_cast<size_t>(tap) * Cout + n0 + n) * Cin +
                         c0 + cc]
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

// the pixel tiles of a (B, H, W) output for blocks of `bm` pixels
Tiling make_tiling(int H, int W, int bm) {
  Tiling t;
  t.tw = W < MAX_TW ? W : MAX_TW;
  t.th = bm / t.tw;
  t.tiles_w = (W + t.tw - 1) / t.tw;
  t.tiles_h = (H + t.th - 1) / t.th;
  return t;
}

}  // namespace

extern "C" int im23d_fused_conv_fwd(const void* x, const void* a,
                                    const void* bb, const void* w9, void* y,
                                    int B, int Cin, int Cout, int H, int W,
                                    int circular, int affine, int bf16,
                                    void* stream) {
  if (B < 1 || Cin < 16 || Cin % 16 || Cout < 16 || Cout % 16 || H < 1 ||
      W < 1 || (affine && (a == nullptr || bb == nullptr)))
    return cudaErrorInvalidValue;
  const Tiling t = make_tiling(H, W, bf16 ? BM : FBM);
  const long long blocks =
      static_cast<long long>(B) * t.tiles_w * t.tiles_h;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), (Cout + BN - 1) / BN);
  const size_t patch = static_cast<size_t>(t.th + 2) * (t.tw + 2);
  auto s = static_cast<cudaStream_t>(stream);
  const float* af = affine ? static_cast<const float*>(a) : nullptr;
  const float* bf = affine ? static_cast<const float*>(bb) : nullptr;
  if (bf16) {
    size_t smem = (patch + 9 * BN) * CK * sizeof(__nv_bfloat16) +
                  (affine ? 2 * Cin * sizeof(float) : 0);
    const size_t epi = static_cast<size_t>(BN) * CS * sizeof(__nv_bfloat16);
    if (smem < epi) smem = epi;
    cudaError_t err = cudaFuncSetAttribute(
        fused_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fused_conv_bf16_kernel<<<grid, BT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), af, bf,
        static_cast<const __nv_bfloat16*>(w9), static_cast<__nv_bfloat16*>(y),
        Cin, Cout, H, W, t, circular);
  } else {
    const size_t smem = (FCK * patch + FCK * 9 * BN) * sizeof(float);
    fused_conv_f32_kernel<<<grid, FT, smem, s>>>(
        static_cast<const float*>(x), af, bf, static_cast<const float*>(w9),
        static_cast<float*>(y), Cin, Cout, H, W, t, circular);
  }
  return cudaGetLastError();
}
