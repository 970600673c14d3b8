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

// K4: K3's search restricted to reference-block ranges.
//
// Replaces: pointcloud_stitching_tpu/kernels/nn_pallas.py
//   nn_batched_prepared_ranged (_nn_kernel_dma_ranged), reached through
//   nearest_neighbors_pruned.
//
// Contract: query q of batch row b lies in query tile t = q / query_tile
// and sweeps only the references [jlo[b,t] * ref_block,
// min((jhi[b,t] + 1) * ref_block, M)), so the result is the first index of
// the minimum over that range, with K3's arithmetic (bitwise equal d2). The
// reference is unpadded, so the last block is ragged and the sweep end is
// clamped to M; an empty range (jlo > jhi) leaves (d2, idx) = (+inf, 0).
//
// What bounds it on Hopper: the same FP32 issue rate as K3, times the
// share of reference blocks that the ranges keep. The ranges differ in
// length by an order of magnitude, so a grid with one block per query tile
// ends when its longest range does, with most SMs idle. Instead:
//   * the work is cut into items of one query sub-tile (NN_QTILE queries,
//     NN_QPT per thread, K3's shape) x one chunk of `chunk` references of
//     that sub-tile's range, so every item is about the same size;
//   * the items are found on the device, never on the host (the caller
//     must not wait for the ranges): a set-up kernel scans the chunk counts
//     of the B x ceil(N / NN_QTILE) sub-tiles into `off`, and a persistent
//     grid sized from the SM count takes item numbers from a counter; a
//     block finds its sub-tile by a binary search in `off`. No block waits
//     for another, so the grid need not be resident at once;
//   * inside an item, K3's loop: cp.async double buffering, float4 shared
//     reads feeding NN_QPT independent queries, ascending with a strict `<`;
//   * the chunks of one query meet in a 64-bit key (bits(d2) << 32) | idx
//     under atomicMin. d2 is +0 or above, or +inf, so its bits order as an
//     unsigned integer: the least key is the least d2 and, among equal
//     distances, the least index, whatever order the blocks arrive in. The
//     result does not depend on the schedule and equals the plain
//     version's. The set-up kernel writes the keys' start value and
//     (+inf, 0) to the outputs; the block that finishes a sub-tile's last
//     chunk (a counter per sub-tile) unpacks that sub-tile's keys. The
//     scratch is written afresh by every call, so calls share nothing.
// A sub-tile that spans query tiles with different ranges (query_tile below
// NN_QTILE, or not a multiple of it) stages the union of their ranges, and
// a thread whose queries do not all cover a staged tile sweeps its own
// part of it one query at a time.
constexpr unsigned long long RG_KEY_START = 0x7f80000000000000ull;  // +inf, 0
constexpr int RG_SETUP_THREADS = 256;

// reference range [lo, hi) of query tile t of one batch row, within [0, m]
__device__ __forceinline__ int range_lo(const int* lo_b, int t, int ref_block,
                                        int m) {
  return (int)min(max((long long)lo_b[t] * ref_block, 0LL), (long long)m);
}
__device__ __forceinline__ int range_hi(const int* hi_b, int t, int ref_block,
                                        int m) {
  return (int)min(max(((long long)hi_b[t] + 1) * ref_block, 0LL),
                  (long long)m);
}

// The union [ulo, uhi) of the non-empty ranges of the query tiles that
// sub-tile s (queries [s * NN_QTILE, ..)) of one batch row falls in;
// ulo == uhi when there is none.
__device__ __forceinline__ void subtile_union(const int* lo_b, const int* hi_b,
                                              int s, int n, int m, int nq,
                                              int query_tile, int ref_block,
                                              int& ulo, int& uhi) {
  const int q0 = s * NN_QTILE;
  const int t_first = q0 / query_tile;
  const int t_last = min((min(q0 + NN_QTILE, n) - 1) / query_tile, nq - 1);
  ulo = m;
  uhi = 0;
  for (int t = t_first; t <= t_last; ++t) {
    const int lo = range_lo(lo_b, t, ref_block, m);
    const int hi = range_hi(hi_b, t, ref_block, m);
    if (lo < hi) {
      ulo = min(ulo, lo);
      uhi = max(uhi, hi);
    }
  }
  if (uhi < ulo) uhi = ulo;
}

// Set-up: every block writes the start values of its share of the queries
// and zeroes its share of the sub-tiles' done counters; block 0 also scans
// the sub-tiles' chunk counts into off[0 .. ns] and zeroes the item counter.
__global__ void __launch_bounds__(RG_SETUP_THREADS)
nn_ranged_setup(const int* __restrict__ jlo, const int* __restrict__ jhi,
                int b, int n, int m, int nq, int nsub, int query_tile,
                int ref_block, int chunk, int* __restrict__ off,
                int* __restrict__ item_ctr, int* __restrict__ done,
                unsigned long long* __restrict__ keys,
                int* __restrict__ idx_out, float* __restrict__ d2_out) {
  const long long total = (long long)b * n;
  const int ns = b * nsub;
  const long long step = (long long)gridDim.x * RG_SETUP_THREADS;
  const long long first = (long long)blockIdx.x * RG_SETUP_THREADS +
                          threadIdx.x;
  for (long long i = first; i < total; i += step) {
    keys[i] = RG_KEY_START;
    idx_out[i] = 0;
    d2_out[i] = INFINITY;
  }
  for (long long i = first; i < ns; i += step) done[i] = 0;
  if (blockIdx.x != 0) return;

  __shared__ int warp_incl[RG_SETUP_THREADS / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    carry = 0;
    off[0] = 0;
    *item_ctr = 0;
  }
  __syncthreads();
  for (int base = 0; base < ns; base += RG_SETUP_THREADS) {
    const int i = base + threadIdx.x;
    int v = 0;
    if (i < ns) {
      const int bi = i / nsub;
      int ulo, uhi;
      subtile_union(jlo + (long long)bi * nq, jhi + (long long)bi * nq,
                    i - bi * nsub, n, m, nq, query_tile, ref_block, ulo, uhi);
      v = (uhi - ulo + chunk - 1) / chunk;
    }
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int y = lane < RG_SETUP_THREADS / 32 ? warp_incl[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) y += z;
      }
      if (lane < RG_SETUP_THREADS / 32) warp_incl[lane] = y;
    }
    __syncthreads();
    const int incl = carry + x + (warp > 0 ? warp_incl[warp - 1] : 0);
    if (i < ns) off[i + 1] = incl;
    __syncthreads();
    if (threadIdx.x == RG_SETUP_THREADS - 1) carry = incl;
    __syncthreads();
  }
}

// A persistent grid: each block takes items in order from the counter until
// none is left. off/item_ctr/done/keys as the set-up kernel left them.
__global__ void __launch_bounds__(NN_THREADS)
nn_ranged_items(const float* __restrict__ query,  // [B, N, 3]
                const float* __restrict__ refT,   // [B, 3, M]
                const int* __restrict__ jlo,      // [B, nq]
                const int* __restrict__ jhi,      // [B, nq]
                int n, int m, int nq, int nsub, int ns, int query_tile,
                int ref_block, int chunk, const int* __restrict__ off,
                int* __restrict__ item_ctr, int* __restrict__ done,
                unsigned long long* __restrict__ keys,
                int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ __align__(16) float sx[2][NN_RTILE];
  __shared__ __align__(16) float sy[2][NN_RTILE];
  __shared__ __align__(16) float sz[2][NN_RTILE];
  __shared__ int s_item, s_last;
  const int items = off[ns];
  for (;;) {
    __syncthreads();  // the last item's shared memory is no longer read
    if (threadIdx.x == 0) s_item = atomicAdd(item_ctr, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) break;
    // the sub-tile st with off[st] <= item < off[st + 1]
    int st = 0;
    for (int hi = ns; hi - st > 1;) {
      const int mid = (st + hi) >> 1;
      if (off[mid] <= item) st = mid; else hi = mid;
    }
    const int c = item - off[st];
    const int nchunks = off[st + 1] - off[st];
    const int b = st / nsub;
    const int q0 = (st - b * nsub) * NN_QTILE;
    const int* lo_b = jlo + (long long)b * nq;
    const int* hi_b = jhi + (long long)b * nq;
    int ulo, uhi;
    subtile_union(lo_b, hi_b, st - b * nsub, n, m, nq, query_tile, ref_block,
                  ulo, uhi);
    const int lo = ulo + c * chunk;  // this item's references [lo, hi)
    const int hi = min(lo + chunk, uhi);

    float qx[NN_QPT], qy[NN_QPT], qz[NN_QPT], best[NN_QPT];
    int best_idx[NN_QPT], mylo[NN_QPT], myhi[NN_QPT];
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const int q = q0 + threadIdx.x + u * NN_THREADS;
      qx[u] = qy[u] = qz[u] = 0.f;
      mylo[u] = 0;  // a query past the end sweeps what is staged; its
      myhi[u] = m;  // result is not kept
      if (q < n) {
        const float* p = query + ((long long)b * n + q) * 3;
        qx[u] = p[0];
        qy[u] = p[1];
        qz[u] = p[2];
        const int t = min(q / query_tile, nq - 1);
        mylo[u] = range_lo(lo_b, t, ref_block, m);
        myhi[u] = range_hi(hi_b, t, ref_block, m);
      }
      best[u] = INFINITY;
      best_idx[u] = 0;
    }
    const float* rx = refT + (long long)b * 3 * m;
    const float* ry = rx + m;
    const float* rz = ry + m;
    const int stages = (hi - lo + NN_RTILE - 1) / NN_RTILE;
    stage_refs(sx[0], sy[0], sz[0], rx, ry, rz, lo, min(NN_RTILE, hi - lo));
    cp_async_commit();
    for (int sg = 0; sg < stages; ++sg) {
      const int base = lo + sg * NN_RTILE;
      const int cnt = min(NN_RTILE, hi - base);
      if (sg + 1 < stages) {
        const int nb = base + NN_RTILE;
        stage_refs(sx[(sg + 1) & 1], sy[(sg + 1) & 1], sz[(sg + 1) & 1], rx,
                   ry, rz, nb, min(NN_RTILE, hi - nb));
      }
      cp_async_commit();
      cp_async_wait_one();  // this stage's copies have landed
      __syncthreads();
      const float* cx = sx[sg & 1];
      const float* cy = sy[sg & 1];
      const float* cz = sz[sg & 1];
      bool covers = true;  // every query of this thread sweeps the stage
#pragma unroll
      for (int u = 0; u < NN_QPT; ++u)
        covers = covers && mylo[u] <= base && myhi[u] >= base + cnt;
      if (covers) {
        for (int k = 0; k < cnt; k += 4) {
          const float4 X = *reinterpret_cast<const float4*>(cx + k);
          const float4 Y = *reinterpret_cast<const float4*>(cy + k);
          const float4 Z = *reinterpret_cast<const float4*>(cz + k);
#pragma unroll
          for (int u = 0; u < NN_QPT; ++u) {
            nn_step(qx[u], qy[u], qz[u], X.x, Y.x, Z.x, base + k, best[u],
                    best_idx[u]);
            nn_step(qx[u], qy[u], qz[u], X.y, Y.y, Z.y, base + k + 1,
                    best[u], best_idx[u]);
            nn_step(qx[u], qy[u], qz[u], X.z, Y.z, Z.z, base + k + 2,
                    best[u], best_idx[u]);
            nn_step(qx[u], qy[u], qz[u], X.w, Y.w, Z.w, base + k + 3,
                    best[u], best_idx[u]);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < NN_QPT; ++u) {
          const int ke = min(myhi[u] - base, cnt);
          for (int k = max(mylo[u] - base, 0); k < ke; ++k)
            nn_step(qx[u], qy[u], qz[u], cx[k], cy[k], cz[k], base + k,
                    best[u], best_idx[u]);
        }
      }
      __syncthreads();  // the buffer is refilled two stages on
    }

    // fold this chunk into the queries' keys; the block that finishes the
    // sub-tile's last chunk unpacks them (fence, count, fence: every other
    // chunk's keys are then visible)
#pragma unroll
    for (int u = 0; u < NN_QPT; ++u) {
      const int q = q0 + threadIdx.x + u * NN_THREADS;
      if (q < n && best[u] < INFINITY)
        atomicMin(keys + (long long)b * n + q,
                  ((unsigned long long)__float_as_uint(best[u]) << 32) |
                      (unsigned)best_idx[u]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(done + st, 1) == nchunks - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
#pragma unroll
      for (int u = 0; u < NN_QPT; ++u) {
        const int q = q0 + threadIdx.x + u * NN_THREADS;
        if (q < n) {
          const unsigned long long key = __ldcg(keys + (long long)b * n + q);
          idx_out[(long long)b * n + q] = (int)(unsigned)key;
          d2_out[(long long)b * n + q] =
              __uint_as_float((unsigned)(key >> 32));
        }
      }
    }
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

// K4's persistent grid: the device's SMs x the blocks of nn_ranged_items
// that fit on one (at most 8, or blocks_per_sm where that is positive and
// smaller). Below 1 on an error.
extern "C" int pcs_nn_ranged_grid(int blocks_per_sm) {
  int dev = 0, sms = 0, fit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, nn_ranged_items, NN_THREADS, 0) != cudaSuccess)
    return 0;
  fit = min(fit, 8);
  if (blocks_per_sm > 0) fit = min(fit, blocks_per_sm);
  return sms * fit;
}

// K4. As K3, with jlo/jhi [b, ceil(n / query_tile)] i32. chunk: references
// per item (>= 1); blocks_per_sm: blocks of the persistent grid per SM (0:
// as many as fit, at most 8). Scratch, written afresh by the call: keys
// [b * n] u64, meta [2 * ns + 2] i32 with ns = b * ceil(n / 512) sub-tiles
// (off[0 .. ns], the item counter, done[0 .. ns - 1]); ns * (ceil(m /
// chunk) + 1) must stay below 2^31. Two kernel launches.
extern "C" int pcs_nn_batched_ranged(const float* query, const float* refT,
                                     const int* jlo, const int* jhi, int b,
                                     int n, int m, int query_tile,
                                     int ref_block, int chunk,
                                     int blocks_per_sm, int* idx, float* d2,
                                     unsigned long long* keys, int* meta,
                                     void* stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || query_tile < 1 ||
      ref_block < 1 || chunk < 1 || blocks_per_sm < 0)
    return (int)cudaErrorInvalidValue;
  const int nq = (n + query_tile - 1) / query_tile;
  const int nsub = (n + NN_QTILE - 1) / NN_QTILE;
  const long long ns = (long long)b * nsub;
  if (ns * ((m + (long long)chunk - 1) / chunk + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int grid = pcs_nn_ranged_grid(blocks_per_sm);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  int* off = meta;
  int* item_ctr = meta + ns + 1;
  int* done = meta + ns + 2;
  const long long setup_blocks =
      ((long long)b * n + RG_SETUP_THREADS - 1) / RG_SETUP_THREADS;
  nn_ranged_setup<<<(unsigned)min(setup_blocks, 1024LL), RG_SETUP_THREADS, 0,
                    (cudaStream_t)stream>>>(
      jlo, jhi, b, n, m, nq, nsub, query_tile, ref_block, chunk, off,
      item_ctr, done, keys, idx, d2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nn_ranged_items<<<grid, NN_THREADS, 0, (cudaStream_t)stream>>>(
      query, refT, jlo, jhi, n, m, nq, nsub, (int)ns, query_tile, ref_block,
      chunk, off, item_ctr, done, keys, idx, d2);
  return (int)cudaGetLastError();
}
