// Device code shared by the GAN generator's two conv kernels, K8
// (head_conv.cu) and K9 (fused_conv.cu), sm_90a: the W padding's source
// column, bf16 tensor-core products (mma.sync m16n8k16) and their
// ldmatrix operand loads, and TMA boxes of an NCHW bf16 tensor landing on
// an mbarrier.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// source column of padded column `col` (in unpadded coordinates: negative
// and >= W are the pad): replicate clamps, circular wraps
__device__ __forceinline__ int src_col(int col, int W, int circular) {
  if (circular) {
    col %= W;
    return col < 0 ? col + W : col;
  }
  return min(max(col, 0), W - 1);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: lane (g, tg) gets elements 2 tg and
// 2 tg + 1 of column g of the rows in shared memory
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row-major fragments) * b (16 x 8, column-major), bf16
// products summed in float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with K = 8: a 16 x 8 A (two registers) and an 8 x 8 B (one)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4],
                                            const uint32_t (&a)[2],
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// two 8 x 8 b16 matrices; lanes 0 .. 15 give the addresses of their rows
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// ---- TMA boxes and the mbarriers they complete on -------------------------

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

// cuTensorMapEncodeTiled of libcuda, found once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// the tensor map of a contiguous NCHW tensor x (bf16 or float32) viewed as
// (W, H, C, B), boxes of bw columns x bh rows x bc channels of one image,
// zero fill; false where cuTensorMapEncodeTiled refuses it (a row of x
// must be a multiple of 16 bytes and x 16-byte aligned)
inline bool encode_nchw(CUtensorMap* map, CUtensorMapDataType type,
                        int elem, const void* x, int B, int C, int H, int W,
                        int bw, int bh, int bc) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t e = static_cast<cuuint64_t>(elem);
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {e * W, e * H * W, e * C * H * W};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bc), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same for bf16 x (W a multiple of 8)
inline bool encode_nchw_bf16(CUtensorMap* map, const void* x, int B, int C,
                             int H, int W, int bw, int bh, int bc) {
  return encode_nchw(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, C, H, W,
                     bw, bh, bc);
}

}  // namespace
