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
// against a real point. On a tie the lowest reference index wins. Every
// product and sum is rounded on its own (__fsub_rn / __fmul_rn /
// __fadd_rn), so nvcc cannot contract them into FMAs and the distances
// match the plain PyTorch version bit for bit.
//
// What bounds it on Hopper: the issue rate of the FP32 pipes. Each pair
// costs 9 instructions (3 subtractions, 3 multiplies, 2 adds, a compare),
// none of which may fuse; the ring ICP call (8 pairs x 2048 queries x 2048
// refs) is 33.5M pairs, 3.0e8 instructions, about 9 us at 132 SMs x 128
// lanes x 1.98 GHz, and reads only 8 x 2 x 24 KB.
//
// Design. A block takes NN_QTILE queries (NN_QPT per thread, so that each
// shared-memory broadcast of a reference feeds NN_QPT independent chains)
// and one of S contiguous, ascending slices of the references. The host
// picks S (kernels/nn_pallas.py's nn_splits, at most 7: clusters of 8 land
// unevenly on the SMs) so that the grid covers the card's SMs about twice
// where the query tiles alone do not (the ring shape: 8 x 4 tiles would
// fill 32 of 132 SMs; S = 7 gives 224 blocks), and S = 1 where they do
// (the registration shapes). Each
// block stages its slice in tiles of NN_RTILE references with cp.async,
// double-buffered (the analogue of the TPU kernel's double-buffered DMA),
// and sweeps it in ascending order with a strict `<`. The S blocks of one
// query tile form a thread-block cluster: each leaves its per-query (best,
// idx) in shared memory, and after cluster.sync() rank 0 reads ranks
// 1..S-1 through distributed shared memory in rank order, replacing only on
// a strict `<`. The slices ascend with the rank, so the first index still
// wins; there are no atomics, no scratch and no second launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NN_THREADS = 128;
constexpr int NN_QPT = 4;                          // queries per thread
constexpr int NN_QTILE = NN_THREADS * NN_QPT;      // queries per block
constexpr int NN_RTILE = 1024;                     // references per stage
constexpr int NN_MAX_SPLITS = 8;                   // portable cluster size

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage references [base, base + cnt) of one batch row into sx/sy/sz and
// pad to a multiple of 4 with +inf (which never wins: inf < best is false).
__device__ __forceinline__ void stage_refs(float* sx, float* sy, float* sz,
                                           const float* rx, const float* ry,
                                           const float* rz, int base,
                                           int cnt) {
  for (int k = threadIdx.x; k < cnt; k += NN_THREADS) {
    cp_async4(sx + k, rx + base + k);
    cp_async4(sy + k, ry + base + k);
    cp_async4(sz + k, rz + base + k);
  }
  const int pad = (cnt + 3) & ~3;
  for (int k = cnt + threadIdx.x; k < pad; k += NN_THREADS)
    sx[k] = sy[k] = sz[k] = INFINITY;
}

__device__ __forceinline__ void nn_step(float qx, float qy, float qz,
                                        float rx, float ry, float rz, int r,
                                        float& best, int& best_idx) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  if (d2 < best) {
    best = d2;
    best_idx = r;
  }
}

// grid (S, ceil(n / NN_QTILE), b); clusters of (S, 1, 1) when S > 1.
__global__ void __launch_bounds__(NN_THREADS)
nn_batched_split(const float* __restrict__ query,  // [B, N, 3]
                 const float* __restrict__ refT,   // [B, 3, M]
                 int n, int m, int splits, int* __restrict__ idx_out,
                 float* __restrict__ d2_out) {
  __shared__ __align__(16) float sx[2][NN_RTILE];
  __shared__ __align__(16) float sy[2][NN_RTILE];
  __shared__ __align__(16) float sz[2][NN_RTILE];
  __shared__ float s_best[NN_QTILE];
  __shared__ int s_idx[NN_QTILE];
  const int rank = blockIdx.x;  // == the block's rank in its cluster
  const int b = blockIdx.z;
  const int q0 = blockIdx.y * NN_QTILE;
  float qx[NN_QPT], qy[NN_QPT], qz[NN_QPT], best[NN_QPT];
  int best_idx[NN_QPT];
#pragma unroll
  for (int u = 0; u < NN_QPT; ++u) {
    const int q = q0 + threadIdx.x + u * NN_THREADS;
    qx[u] = qy[u] = qz[u] = 0.f;
    if (q < n) {
      const float* p = query + ((long long)b * n + q) * 3;
      qx[u] = p[0];
      qy[u] = p[1];
      qz[u] = p[2];
    }
    best[u] = INFINITY;
    best_idx[u] = 0;
  }
  // this block's slice [lo, hi) of the references: non-empty for S <= M
  const int lo = (int)((long long)m * rank / splits);
  const int hi = (int)((long long)m * (rank + 1) / splits);
  const float* rx = refT + (long long)b * 3 * m;
  const float* ry = rx + m;
  const float* rz = ry + m;
  const int stages = (hi - lo + NN_RTILE - 1) / NN_RTILE;
  stage_refs(sx[0], sy[0], sz[0], rx, ry, rz, lo, min(NN_RTILE, hi - lo));
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    const int base = lo + st * NN_RTILE;
    const int cnt = min(NN_RTILE, hi - base);
    if (st + 1 < stages) {
      const int nb = base + NN_RTILE;
      stage_refs(sx[(st + 1) & 1], sy[(st + 1) & 1], sz[(st + 1) & 1], rx,
                 ry, rz, nb, min(NN_RTILE, hi - nb));
    }
    cp_async_commit();
    cp_async_wait_one();  // this stage's copies have landed
    __syncthreads();
    const float* cx = sx[st & 1];
    const float* cy = sy[st & 1];
    const float* cz = sz[st & 1];
    for (int k = 0; k < cnt; k += 4) {
      const float4 X = *reinterpret_cast<const float4*>(cx + k);
      const float4 Y = *reinterpret_cast<const float4*>(cy + k);
      const float4 Z = *reinterpret_cast<const float4*>(cz + k);
#pragma unroll
      for (int u = 0; u < NN_QPT; ++u) {
        nn_step(qx[u], qy[u], qz[u], X.x, Y.x, Z.x, base + k, best[u],
                best_idx[u]);
        nn_step(qx[u], qy[u], qz[u], X.y, Y.y, Z.y, base + k + 1, best[u],
                best_idx[u]);
        nn_step(qx[u], qy[u], qz[u], X.z, Y.z, Z.z, base + k + 2, best[u],
                best_idx[u]);
        nn_step(qx[u], qy[u], qz[u], X.w, Y.w, Z.w, base + k + 3, best[u],
                best_idx[u]);
      }
    }
    __syncthreads();  // the buffer is refilled two stages on
  }

  if (splits > 1) {
    // ordered combine across the cluster through distributed shared memory
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      s_best[threadIdx.x + u * NN_THREADS] = best[u];
      s_idx[threadIdx.x + u * NN_THREADS] = best_idx[u];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < splits; ++r) {
        const float* rb = cluster.map_shared_rank(s_best, r);
        const int* ri = cluster.map_shared_rank(s_idx, r);
#pragma unroll
        for (int u = 0; u < NN_QPT; ++u) {
          const int j = threadIdx.x + u * NN_THREADS;
          const float d = rb[j];
          if (d < best[u]) {
            best[u] = d;
            best_idx[u] = ri[j];
          }
        }
      }
    }
    cluster.sync();  // ranks 1.. keep their shared memory until rank 0 read
  }
  if (rank == 0) {
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const int q = q0 + threadIdx.x + u * NN_THREADS;
      if (q < n) {
        idx_out[(long long)b * n + q] = best_idx[u];
        d2_out[(long long)b * n + q] = best[u];
      }
    }
  }
}

// K4's launch shape (unchanged from its first version)
constexpr int THREADS = 256;  // queries per block
constexpr int RTILE = 1024;   // references staged per shared-memory tile

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

// K3. query [b, n, 3], refT [b, 3, m] f32; idx [b, n] i32, d2 [b, n] f32;
// splits S in 1..min(8, m) (see kernels/nn_pallas.py's nn_splits).
extern "C" int pcs_nn_batched(const float* query, const float* refT, int b,
                              int n, int m, int splits, int* idx, float* d2,
                              void* stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || splits < 1 ||
      splits > NN_MAX_SPLITS || splits > m)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + (long long)NN_QTILE - 1) / NN_QTILE;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (unsigned)tiles, b);
  cfg.blockDim = dim3(NN_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, nn_batched_split, query,
                                           refT, n, m, splits, idx, d2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int pcs_nn_query_tile() { return NN_QTILE; }

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
