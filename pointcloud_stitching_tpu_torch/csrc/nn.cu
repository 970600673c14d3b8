// K3: exact batched 1-nearest-neighbour by direct squared differences.
//
// Replaces: pointcloud_stitching_tpu/kernels/nn_pallas.py
//   nn_batched_prepared (_nn_kernel_dma), prepared by prepare_ref_batched.
//
// Contract (the same as the TPU kernel's): for each batch row b and query
// q, the index and squared distance of the nearest reference point, with
// d2 = ((dx*dx) + dy*dy) + dz*dz in float32. Masked references carry the
// 1e12 sentinel (applied by the wrapper's prepare step), so they never win
// against a real point. On a tie the lowest reference index wins: the
// kernel walks the references in ascending order and replaces the best
// only on a strict `<`. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn), so nvcc cannot contract them into FMAs and the
// distances match the plain PyTorch version bit for bit.
//
// What bounds it on Hopper: issue rate of the FP32 pipes. Each pair costs
// 3 subtractions, 3 multiplies, 2 adds and a compare; the flagship ring ICP
// call (8 pairs x 2048 queries x 2048 refs) is 33.5M pairs, about 0.3
// GFLOP, and reads only 8 x 2 x 24 KB. One thread per query keeps its
// running (best_d2, best_idx) in registers; the references are staged
// through shared memory in tiles and read as broadcasts. At flagship shapes
// the grid is (2048 / 256) x 8 = 64 blocks, fewer than the card's 132 SMs,
// so about half the SMs idle: splitting the reference range across blocks
// (with an ordered combine) is the fix, left for a later change.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // queries per block
constexpr int RTILE = 1024;   // references staged per shared-memory tile

__global__ void nn_batched(const float* __restrict__ query,  // [B, N, 3]
                           const float* __restrict__ refT,   // [B, 3, M]
                           int n, int m, int* __restrict__ idx_out,
                           float* __restrict__ d2_out) {
  __shared__ float sx[RTILE], sy[RTILE], sz[RTILE];
  const int b = blockIdx.y;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool live = q < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* p = query + ((long long)b * n + q) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
  }
  const float* rx = refT + (long long)b * 3 * m;
  const float* ry = rx + m;
  const float* rz = ry + m;
  float best = INFINITY;
  int best_idx = 0;
  for (int base = 0; base < m; base += RTILE) {
    const int cnt = min(RTILE, m - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += THREADS) {
      sx[k] = rx[base + k];
      sy[k] = ry[base + k];
      sz[k] = rz[base + k];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < cnt; ++k) {
        const float dx = __fsub_rn(qx, sx[k]);
        const float dy = __fsub_rn(qy, sy[k]);
        const float dz = __fsub_rn(qz, sz[k]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 < best) {
          best = d2;
          best_idx = base + k;
        }
      }
    }
  }
  if (live) {
    idx_out[(long long)b * n + q] = best_idx;
    d2_out[(long long)b * n + q] = best;
  }
}

}  // namespace

extern "C" int pcs_nn_batched(const float* query, const float* refT, int b,
                              int n, int m, int* idx, float* d2,
                              void* stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + THREADS - 1) / THREADS, b);
  nn_batched<<<grid, THREADS, 0, (cudaStream_t)stream>>>(query, refT, n, m,
                                                          idx, d2);
  return (int)cudaGetLastError();
}
