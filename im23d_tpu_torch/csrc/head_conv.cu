// K8: the GAN generator's texture-head conv, sm_90a.
//
// Forward (im23d_head_conv_fwd) replaces the Pallas TPU kernel
// im23d_tpu/ops/conv_pallas.py _fwd_kernel (the forward of head_conv_tanh):
//   y[b, o, h, w] = tanh(bias[o] + sum over c, i, j of
//                        w[o, c, i, j] * xp[b, c, h + i, w + j]),
// a 5 x 5 conv from C input channels to 3 outputs, where xp is x padded by 2
// on each side: zero rows in H, replicate or circular columns in W.  x and y
// are NCHW in float32 or bfloat16; w and bias are float32 (the caller rounds
// w to x's type first); the sums are float32.
//
// The dW kernel (im23d_head_conv_dw) replaces conv_pallas.py _dw_kernel:
//   dw[o, c, i, j] = sum over b, h, w of xp[b, c, h + i, w + j] * g[b, o, h, w]
// with g = dy * (1 - y^2) in float32, reduced in two deterministic passes:
// each block sums a fixed set of tiles into its own row of a partial buffer,
// then one thread per weight adds the rows in block order.  No float
// atomicAdd, so the result is the same on every launch.
//
// What bounds it on the H100: operations.  At the main path's shape
// (32 x 64 x 512 x 256 -> 3) both directions do 2 * 25 * 64 * 3 FLOP per
// output pixel, 40.3 GFLOP, against 0.56 GB of traffic in bfloat16.  The TPU
// kernel folds output columns into 128 MXU lanes because 3 output channels
// would fill 3 of them; on this card that folding would multiply by zeros,
// so these kernels run the plain sum on the float32 FMA units:
//   forward, a block owns a 32 x 32 output tile (a thread: 4 rows of one
//   column, 12 float32 sums); input channels are staged 8 at a time as a
//   36 x 36 float32 patch with the padding applied by index arithmetic (no
//   padded copy in device memory), with the chunk's 600 weights; each staged
//   value feeds 12 FMAs of the thread's sliding window.
//   dW, a thread owns one (channel, tap row) pair and its 15 (output, tap
//   column) sums; a block stages an 8 x 36 patch of every channel and the
//   4 x 32 tile of g, and walks its tiles with a 5-value sliding window (one
//   shared-memory read and three broadcast reads of g per 15 FMAs).
// Tensor cores and TMA are left to a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KS = 5;   // kernel size
constexpr int PAD = 2;  // (KS - 1) / 2
constexpr int CO = 3;   // output channels

// forward tile: 32 columns x (8 threads x 4 rows)
constexpr int FT_W = 32, FT_TY = 8, FT_ROWS = 4, FT_H = FT_TY * FT_ROWS;
constexpr int F_PH = FT_H + KS - 1, F_PW = FT_W + KS - 1;
constexpr int F_CK = 8;  // input channels staged at a time

// dW tile: 4 rows x 32 columns of one image
constexpr int DT_H = 4, DT_W = 32;
constexpr int D_PH = DT_H + KS - 1, D_PW = DT_W + KS - 1;
constexpr int D_CS = D_PH * D_PW + 1;  // odd channel stride: no bank conflicts

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// source column of padded column `col` (in unpadded coordinates, so -2..-1
// and W..W+1 are the pad): replicate clamps, circular wraps
__device__ __forceinline__ int src_col(int col, int W, int circular) {
  if (circular) {
    col %= W;
    return col < 0 ? col + W : col;
  }
  return min(max(col, 0), W - 1);
}

template <typename T>
__global__ void __launch_bounds__(FT_W* FT_TY)
    head_conv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ y,
                         int C, int H, int W, int circular) {
  __shared__ float xs[F_CK][F_PH][F_PW];
  __shared__ float ws[F_CK][CO][KS][KS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * FT_W + tx;
  const int w0 = blockIdx.x * FT_W, h0 = blockIdx.y * FT_H, b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * C * H * W;

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
        v = to_f(xb[(static_cast<size_t>(c) * H + row) * W +
                    src_col(w0 + col - PAD, W, circular)]);
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
          from_f<T>(tanhf(acc[r][o] + bias[o]));
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
int launch_fwd(const void* x, const void* w, const void* bias, void* y, int B,
               int C, int H, int W, int circular, cudaStream_t stream) {
  const dim3 grid((W + FT_W - 1) / FT_W, (H + FT_H - 1) / FT_H, B);
  head_conv_fwd_kernel<T><<<grid, dim3(FT_W, FT_TY), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), C, H, W, circular);
  return cudaGetLastError();
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
  return B < 1 || B > 65535 || C < 1 || C > 128 || H < 1 || W < 1;
}

}  // namespace

extern "C" int im23d_head_conv_fwd(const void* x, const void* w,
                                   const void* bias, void* y, int B, int C,
                                   int H, int W, int circular, int bf16,
                                   void* stream) {
  if (bad_shape(B, C, H, W)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, bias, y, B, C, H, W, circular,
                                          s)
              : launch_fwd<float>(x, w, bias, y, B, C, H, W, circular, s);
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
