// K3: exact batched 1-nearest-neighbour by direct squared differences.
// K4, its range-pruned variant, follows it below.
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

// K4: K3's search restricted to reference-block ranges.
//
// Replaces: pointcloud_stitching_tpu/kernels/nn_pallas.py
//   nn_batched_prepared_ranged (_nn_kernel_dma_ranged), reached through
//   nearest_neighbors_pruned.
//
// Contract: query q of batch row b lies in query tile t = q / query_tile
// and sweeps only the references [jlo[b,t] * ref_block,
// min((jhi[b,t] + 1) * ref_block, M)), in ascending order with a strict
// `<`, so the result is the first index of the minimum over that range,
// with K3's arithmetic (bitwise equal d2). The reference is unpadded, so
// the last block is ragged and the sweep end is clamped to M; an empty
// range (jlo > jhi) leaves (d2, idx) = (+inf, 0).
//
// What bounds it on Hopper: the same FP32 issue rate as K3, times the
// share of reference blocks that the ranges keep. Ranges belong to query
// tiles, not CUDA blocks: each block stages the union of its threads'
// ranges through shared memory and each thread compares only the
// references of its own tile's range. With query_tile a multiple of 256
// every thread of a block shares one range and nothing staged is skipped.
// Ranges of very different lengths leave some SMs with far more work than
// others; that imbalance is not addressed here.
__global__ void nn_batched_ranged(const float* __restrict__ query,  // [B,N,3]
                                  const float* __restrict__ refT,   // [B,3,M]
                                  const int* __restrict__ jlo,      // [B,nq]
                                  const int* __restrict__ jhi,      // [B,nq]
                                  int n, int m, int nq, int query_tile,
                                  int ref_block, int* __restrict__ idx_out,
                                  float* __restrict__ d2_out) {
  __shared__ float sx[RTILE], sy[RTILE], sz[RTILE];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * THREADS;
  const int q = q0 + threadIdx.x;
  const bool live = q < n;
  const int* lo_b = jlo + (long long)b * nq;
  const int* hi_b = jhi + (long long)b * nq;
  // reference range [lo, hi) of a query tile, clamped to [0, m]
  auto range_lo = [&](int t) {
    return (int)min(max((long long)lo_b[t] * ref_block, 0LL), (long long)m);
  };
  auto range_hi = [&](int t) {
    return (int)min(max(((long long)hi_b[t] + 1) * ref_block, 0LL),
                    (long long)m);
  };
  // the union over the tiles this block's queries fall in
  const int t_first = q0 / query_tile;
  const int t_last = min((min(q0 + THREADS, n) - 1) / query_tile, nq - 1);
  int ulo = m, uhi = 0;
  for (int t = t_first; t <= t_last; ++t) {
    ulo = min(ulo, range_lo(t));
    uhi = max(uhi, range_hi(t));
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  int mylo = 0, myhi = 0;
  if (live) {
    const float* p = query + ((long long)b * n + q) * 3;
    qx = p[0];
    qy = p[1];
    qz = p[2];
    const int t = min(q / query_tile, nq - 1);
    mylo = range_lo(t);
    myhi = range_hi(t);
  }
  const float* rx = refT + (long long)b * 3 * m;
  const float* ry = rx + m;
  const float* rz = ry + m;
  float best = INFINITY;
  int best_idx = 0;
  for (int base = ulo; base < uhi; base += RTILE) {
    const int cnt = min(RTILE, uhi - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += THREADS) {
      sx[k] = rx[base + k];
      sy[k] = ry[base + k];
      sz[k] = rz[base + k];
    }
    __syncthreads();
    const int kb = max(mylo - base, 0);
    const int ke = min(myhi - base, cnt);
    for (int k = kb; k < ke; ++k) {
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

extern "C" int pcs_nn_batched_ranged(const float* query, const float* refT,
                                     const int* jlo, const int* jhi, int b,
                                     int n, int m, int query_tile,
                                     int ref_block, int* idx, float* d2,
                                     void* stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || query_tile < 1 ||
      ref_block < 1)
    return (int)cudaErrorInvalidValue;
  const int nq = (n + query_tile - 1) / query_tile;
  const dim3 grid((n + THREADS - 1) / THREADS, b);
  nn_batched_ranged<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      query, refT, jlo, jhi, n, m, nq, query_tile, ref_block, idx, d2);
  return (int)cudaGetLastError();
}
