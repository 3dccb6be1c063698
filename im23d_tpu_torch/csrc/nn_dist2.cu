// K3: nearest-neighbour squared distance for the Chamfer metric, sm_90a.
//
// Replaces the Pallas TPU kernel im23d_tpu/metrics/chamfer.py _nn_kernel.
// out[b, n] = min_m (dz^2 + dy^2 + dx^2) with d = y[b, m] - x[b, n].
//
// What bounds it on the H100: N*M*8 FLOPs on CUDA cores (no tensor-core form
// of the direct difference); at the eval shapes (24 x 8000 x 2048) the inputs
// are under 3 MB, so the kernel is compute and launch bound.  Design: one
// thread per x point keeps a running min in a register; the block streams y
// through shared memory in tiles of kTile points, each tile read once per
// block.  The ragged last tile is cut by its count: no padding values.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 256;

__global__ void nn_dist2_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ out, int N, int M) {
  __shared__ float sz[kTile], sy[kTile], sx[kTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * N * 3;
  const float* yb = y + static_cast<size_t>(b) * M * 3;
  float xz = 0.f, xy = 0.f, xx = 0.f;
  if (n < N) {
    xz = xb[3 * n];
    xy = xb[3 * n + 1];
    xx = xb[3 * n + 2];
  }
  float best = INFINITY;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int cnt = min(kTile, M - m0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const float* p = yb + 3 * static_cast<size_t>(m0 + i);
      sz[i] = p[0];
      sy[i] = p[1];
      sx[i] = p[2];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dz = sz[j] - xz, dy = sy[j] - xy, dx = sx[j] - xx;
      best = fminf(best, dz * dz + dy * dy + dx * dx);
    }
  }
  if (n < N) out[static_cast<size_t>(b) * N + n] = best;
}

}  // namespace

extern "C" int im23d_nn_dist2(const void* x, const void* y, void* out, int B,
                              int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1) return cudaErrorInvalidValue;
  nn_dist2_kernel<<<dim3((N + kTile - 1) / kTile, B), kTile, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), N, M);
  return cudaGetLastError();
}
