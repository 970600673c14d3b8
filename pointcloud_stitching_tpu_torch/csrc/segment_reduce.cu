// Segment sums over sorted segments: K1 (ids from boundary flags) and K2
// (precomputed sorted ids), for the voxel passes of the stitch step.
//
// Replaces: pointcloud_stitching_tpu/kernels/segment_reduce.py
//   K1  segment_sum_from_flags  (_segsum_flags_kernel)
//   K2  segment_sum_sorted      (_segsum_kernel)
//
// What bounds them on Hopper: memory. Each row is read once (ch floats plus
// a flag byte or a 4-byte id) and each segment's sum written once; the
// float64 adds (one per value) are far below the card's FP64 rate. The
// flagship output pass (K1) reads 3,256,320 rows x 7 floats (91 MB), about
// 27 us at the H100's 3.35 TB/s; the ring-ICP voxel pass (K2) moves only
// 3.4 MB, so K2 is bound there by launch latency and by its critical path.
//
// K1. The TPU kernel walks the sorted stream in order on one core and
// carries the running segment id and partial sums from grid step to grid
// step. CUDA blocks run in no order, so nothing carries between them:
//   * the rows are cut into tiles of TILE rows, one block per tile;
//   * a first kernel counts the flags of every tile, a second scans those
//     counts in one block (the carry the TPU kept in SMEM becomes a tile
//     offset), then each block scans its own flags (ballot + popc per
//     warp, then across warps) to give every row its segment id;
//   * inside a tile, the thread at the head of each run of equal ids sums
//     that run's rows from shared memory: no atomics;
//   * a run at the start of a tile that continues a segment from an earlier
//     tile stores its partial in `part` (head slot), and so does a segment
//     that starts in a tile and reaches its end (tail slot); a fix-up pass
//     then lets the tile that holds the segment's first row add the head
//     partials of the following tiles in tile order.
//
// K2. One launch, no memset, and no serial run sums. In the ring-ICP pass
// most rows lie in a few long runs (every voxel past a camera's 2048th goes
// to its discard id), so a thread that sums a run row by row is a chain of
// thousands of dependent adds. Instead:
//   * one block per tile of K2_TILE rows, K2_RPT consecutive rows per
//     thread, staged through shared memory by cp.async, all in flight;
//   * each thread folds its rows into one segmented-scan element (the sum
//     of its last run, and whether a run starts among its rows); a block
//     segmented scan (warp shuffles in float64 with head flags, then the
//     warps' totals in shared memory) gives each thread the carry from the
//     rows before it, in O(log tile) steps whatever the run lengths; the
//     row that ends a run then writes that run's sum. The head flags'
//     part of the scan is worked out once; the channels then loop, K2_CG
//     at a time so that their scans share each shuffle's and barrier's
//     latency, which keeps the kernel's code small (a version with all 16
//     channels unrolled was slower per block, held up fetching its
//     instructions);
//   * the block zeroes the slots between consecutive ids (a row reads its
//     predecessor's id, the tile's first row seg[r0 - 1]) and, after the
//     last row, those up to capacity: every gap float is one step of a
//     block-strided loop, found by a binary search over the rows' scanned
//     gap offsets;
//   * runs that cross tiles: a decoupled look-back. Blocks take tiles in
//     start order from a counter. A tile in which a run starts publishes
//     X_t, the sum of its last run so far (status PREFIX); a tile that one
//     run passes through publishes its sum (status AGG). A tile whose first
//     run began earlier reads the statuses of the 32 tiles before it at
//     once (a warp), adds the AGG sums up to the nearest PREFIX, and so has
//     X_{t-1}: it writes the run's sum if the run ends in it, or publishes
//     its own PREFIX if the run passes through. The last block to finish
//     zeroes the statuses and counters, so the next launch needs no
//     memset. No atomics touch the sums.
// Ids may jump (the flat multi-camera layout); ids outside [0, capacity)
// drop; slots that no segment reaches are zero. The ids must not decrease:
// a block that sees an id below its predecessor's raises a flag, and the
// last block then writes NaN into every slot, so such input cannot pass
// for sums.
//
// Both add in float64 and round to float32 once. A float64 sum of float32
// values is exact while the run's largest partial sum over its smallest
// value's unit in the last place stays below 2^53, i.e. while the values'
// magnitudes span less than about 2^29 / (rows in the run). Then the sum
// does not depend on the order of the adds: the same bits on every run,
// the same bits as the plain version (which adds in float64 with atomics
// on the card), and integer-valued channels (the packed voxel branch)
// exact. Values spanning more (a coordinate of 1e-9 m beside one of 4 m in
// a long run) could round differently in the last float64 bit, which
// changes the float32 result only when it lies on a rounding boundary.
// Bitwise agreement is what keeps the ICP pass, and hence the refined
// extrinsics, identical between the kernels and the plain path.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 512;            // rows per tile == threads per block
constexpr int WARPS = TILE / 32;
constexpr int MAX_CH = 16;           // dynamic smem: MAX_CH * TILE * 4 = 32 KB
constexpr int SCAN_THREADS = 1024;
constexpr int FIXUP_THREADS = 256;

// tile_info layout, 3 ints per tile
constexpr int TI_HAS_CONT = 0;   // first run continues an earlier segment
constexpr int TI_HAS_START = 1;  // tile holds at least one segment start
constexpr int TI_LAST_ID = 2;    // id of the tile's last row

// Inclusive block-wide count of `f` over threads 0..threadIdx.x.
__device__ int block_scan_flag(int f, int* warp_incl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, f);
  const int incl = __popc(ballot & (0xffffffffu >> (31 - lane)));
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < WARPS ? warp_incl[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane < WARPS) warp_incl[lane] = v;
  }
  __syncthreads();
  return incl + (warp > 0 ? warp_incl[warp - 1] : 0);
}

// K1 pass 1: number of flagged rows in each tile.
__global__ void tile_flag_count(const uint8_t* __restrict__ flags, int n,
                                int* __restrict__ tile_counts) {
  __shared__ int warp_count[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int f = (i < n && flags[i] != 0) ? 1 : 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, f);
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_count[w];
    tile_counts[blockIdx.x] = s;
  }
}

// K1 pass 2: exclusive scan of the tile counts, in one block.
__global__ void tile_offsets_scan(const int* __restrict__ counts, int ntiles,
                                  int* __restrict__ offsets) {
  __shared__ int warp_incl[SCAN_THREADS / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? counts[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += t;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int y = warp_incl[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) y += t;
      }
      warp_incl[lane] = y;
    }
    __syncthreads();
    const int incl = x + (warp > 0 ? warp_incl[warp - 1] : 0);
    const int c = carry;
    if (i < ntiles) offsets[i] = c + incl - v;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = c + incl;
    __syncthreads();
  }
}

// K1 per-tile run sums: ids from flags + tile offsets.
__global__ void tile_segsum(const float* __restrict__ vals, int n, int ch,
                            const uint8_t* __restrict__ flags,
                            const int* __restrict__ tile_offsets,
                            int capacity, float* __restrict__ out,
                            double* __restrict__ part,
                            int* __restrict__ tile_info) {
  extern __shared__ float sval[];          // [ch][TILE]
  __shared__ int sid[TILE];
  __shared__ int warp_incl[WARPS];
  const int t = blockIdx.x, tid = threadIdx.x;
  const long long r0 = (long long)t * TILE;
  const int rows = (int)min((long long)TILE, (long long)n - r0);
  const long long i = r0 + tid;
  const bool live = tid < rows;

  const int f = (live && flags[i] != 0) ? 1 : 0;
  const int id = tile_offsets[t] + block_scan_flag(f, warp_incl) - 1;
  const bool start = f != 0;
  if (live) sid[tid] = id;
  // coalesced copy of the tile's rows, transposed to [ch][TILE]
  const float* src = vals + r0 * ch;
  for (int k = tid; k < rows * ch; k += TILE) {
    const int r = k / ch, c = k - r * ch;
    sval[c * TILE + r] = src[k];
  }
  const int any_start = __syncthreads_or(start ? 1 : 0);

  if (live && (start || tid == 0)) {
    const bool keep = id >= 0 && id < capacity;
    if (keep) {
      int end = tid + 1;
      while (end < rows && sid[end] == id) ++end;
      double* head = part + (2LL * t) * ch;     // continuation of a segment
      double* tail = part + (2LL * t + 1) * ch; // start that reaches the end
      for (int c = 0; c < ch; ++c) {
        const float* col = sval + c * TILE;
        double acc = 0.0;
        for (int r = tid; r < end; ++r) acc += (double)col[r];
        if (!start) {
          head[c] = acc;
        } else {
          out[(long long)id * ch + c] = (float)acc;
          if (end == rows) tail[c] = acc;
        }
      }
    }
    if (tid == 0) tile_info[3 * t + TI_HAS_CONT] = (!start && keep) ? 1 : 0;
  }
  if (tid == 0) {
    tile_info[3 * t + TI_HAS_START] = any_start;
    tile_info[3 * t + TI_LAST_ID] = sid[rows - 1];
  }
}

// A segment that starts in tile t and runs past its end: add the head
// partials of the following tiles to tile t's tail partial, in tile order,
// and round once.
__global__ void tile_fixup(int ntiles, int ch, int capacity,
                           const double* __restrict__ part,
                           const int* __restrict__ tile_info,
                           float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles || !tile_info[3 * t + TI_HAS_START]) return;
  const int s = tile_info[3 * t + TI_LAST_ID];
  if (s < 0 || s >= capacity) return;
  if (t + 1 >= ntiles || !tile_info[3 * (t + 1) + TI_HAS_CONT]) return;
  for (int c = 0; c < ch; ++c) {
    double acc = part[(2LL * t + 1) * ch + c];
    for (int k = t + 1; k < ntiles && tile_info[3 * k + TI_HAS_CONT]; ++k) {
      acc += part[(2LL * k) * ch + c];
      if (tile_info[3 * k + TI_HAS_START]) break;  // segment ends in tile k
    }
    out[(long long)s * ch + c] = (float)acc;
  }
}

int ntiles_of(int n) { return (n + TILE - 1) / TILE; }

// ---------------------------------------------------------------------------
// K2: one launch, a segmented reduction inside each tile, and a decoupled
// look-back across tiles.

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the look-back's status words: a release store after the tile's values,
// an acquire load before reading another tile's
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

constexpr int K2_THREADS = 256;
constexpr int K2_RPT = 4;                         // rows per thread
constexpr int K2_TILE = K2_THREADS * K2_RPT;      // rows per block
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int K2_CG = 4;                          // channels scanned at once
constexpr unsigned FULL = 0xffffffffu;

// per-tile flags
constexpr int TF_HEAD_CONT = 1;  // the tile's first row continues a run
constexpr int TF_TAIL_CONT = 2;  // the tile's last row's run continues
constexpr int TF_PASS = 4;       // no run starts in the tile (and HEAD_CONT)
// look-back status of a tile (0: not yet published)
constexpr int ST_AGG = 1;        // abuf holds the tile's sum (a PASS tile)
constexpr int ST_PREFIX = 2;     // xbuf holds X_t, its last run's sum so far

// Segmented scan with head flags: combining an earlier (a, fa) with a
// later (b, fb) gives (fb ? b : a + b, fa | fb). The flags do not depend on
// the channel, so a warp works out once which of its 5 shuffle steps add
// (the returned mask) and turns `f` into its inclusive flag; each channel's
// scan is then 5 shuffles and adds.
__device__ __forceinline__ unsigned seg_mask(bool& f) {
  const int lane = threadIdx.x & 31;
  unsigned mask = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int o = 1 << s;
    const bool uf = __shfl_up_sync(FULL, (int)f, o) != 0;
    if (lane >= o) {
      if (!f) mask |= 1u << s;
      f = f || uf;
    }
  }
  return mask;
}

__device__ __forceinline__ double seg_scan(double v, unsigned mask) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const double u = __shfl_up_sync(FULL, v, 1 << s);
    if (mask & (1u << s)) v = u + v;
  }
  return v;
}

// Exclusive block scan of one int per thread; returns the block total too.
__device__ __forceinline__ int block_scan_int_excl(int x, int* s_w,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_w[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int y = lane < K2_WARPS ? s_w[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += u;
    }
    if (lane < K2_WARPS) s_w[lane] = y;
  }
  __syncthreads();
  const int excl = v - x + (warp > 0 ? s_w[warp - 1] : 0);
  *total = s_w[K2_WARPS - 1];
  __syncthreads();
  return excl;
}

// One block per tile of K2_TILE rows, tiles taken in start order from a
// counter (so every earlier tile is running or done, and the look-back
// waits on nothing that cannot run). Thread i holds rows i*K2_RPT.. of the
// tile. state: [0] tile counter, [1] done counter, [2] decreasing-id flag,
// [3..] per-tile status; all zero on entry and left zero by the last block
// to finish. xbuf/abuf: [ntiles][MAX_CH] f64, any contents.
__global__ void __launch_bounds__(K2_THREADS)
segsum_sorted_kernel(const float* __restrict__ vals,
                     const int* __restrict__ seg, int n, int ch,
                     int capacity, float* __restrict__ out,
                     int* __restrict__ state, double* __restrict__ xbuf,
                     double* __restrict__ abuf) {
  extern __shared__ float sval[];  // K2_THREADS x (K2_RPT * ch + 1)
  __shared__ double s_wv[MAX_CH + K2_CG][K2_WARPS];
  __shared__ double s_head[MAX_CH], s_tail[MAX_CH], s_x[MAX_CH];
  __shared__ int s_w[K2_WARPS];
  __shared__ int s_goff[K2_TILE + 2];  // gap offsets in floats, per row
  __shared__ int s_glo[K2_TILE + 1];   // first zeroed slot, per row
  __shared__ int s_tile, s_flags, s_last, s_bad;
  int* tile_ctr = state;
  int* done_ctr = state + 1;
  int* bad_flag = state + 2;
  int* status = state + 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_ctr, 1);
  __syncthreads();
  const int t = s_tile;
  const long long r0 = (long long)t * K2_TILE;
  const int rows = (int)max(0LL, min((long long)K2_TILE, (long long)n - r0));
  const int stride = K2_RPT * ch + 1;  // odd: no bank conflicts below

  // the tile's rows into shared memory, K2_RPT rows per thread-slot plus
  // one pad float: coalesced asynchronous copies, all in flight at once
  const float* src = vals + r0 * ch;
  for (int k = tid; k < rows * ch; k += K2_THREADS)
    cp_async4(sval + k + k / (stride - 1), src + k);
  cp_async_commit();

  const int j0 = tid * K2_RPT;
  const int nj = max(0, min(K2_RPT, rows - j0));
  const long long i0 = r0 + j0;
  int id[K2_RPT];
  unsigned head = 0, run_end = 0;  // bit j: row j starts / ends a run
  // INT_MIN: the array's first row has no predecessor
  int prev = (nj > 0 && i0 > 0) ? seg[i0 - 1] : INT_MIN;
  bool decreases = false;
  // gaps: the slots between a row's predecessor's id and its own read 0,
  // and so do those after the last row's id; entry `rows` is the latter
  int gap = 0;
#pragma unroll
  for (int j = 0; j < K2_RPT; ++j) {
    id[j] = 0;
    if (j < nj) {
      id[j] = seg[i0 + j];
      decreases |= id[j] < prev;
      if (i0 + j == 0 || prev != id[j]) head |= 1u << j;
      const long long lo = max((long long)prev + 1, 0LL);
      const long long hi = min((long long)id[j], (long long)capacity);
      const int len = hi > lo ? (int)(hi - lo) : 0;
      s_glo[j0 + j] = (int)lo;
      s_goff[j0 + j] = len * ch;  // a length for now
      gap += len * ch;
      prev = id[j];
    }
  }
#pragma unroll
  for (int j = 0; j < K2_RPT; ++j) {
    if (j < nj) {
      const long long i = i0 + j;
      const int next = j + 1 < nj ? id[min(j + 1, K2_RPT - 1)]
                                  : (i + 1 < n ? seg[i + 1] : 0);
      if (i + 1 == n || next != id[j]) run_end |= 1u << j;
    }
  }
  const bool holds_end = (rows == 0) ? tid == 0 : (j0 <= rows - 1 &&
                                                   rows - 1 < j0 + K2_RPT);
  if (holds_end) {
    // the tile's last row; after the array's last row, the tail gap
    const bool array_end = r0 + rows == n;
    const long long lo = array_end ? max((long long)prev + 1, 0LL) : 0;
    const int len = array_end && capacity > lo ? (int)(capacity - lo) : 0;
    s_glo[rows] = (int)lo;
    s_goff[rows] = len * ch;
    gap += len * ch;
  }
  if (decreases) atomicOr(bad_flag, 1);
  int gap_total;
  int goff = block_scan_int_excl(gap, s_w, &gap_total);
  for (int j = 0; j < nj; ++j) {
    const int len = s_goff[j0 + j];
    s_goff[j0 + j] = goff;
    goff += len;
  }
  if (holds_end) {
    s_goff[rows] = goff;
    s_goff[rows + 1] = gap_total;
  }

  // the head flags' scan, shared by every channel
  bool fw = head != 0;
  const unsigned mask = seg_mask(fw);  // fw: inclusive over the warp
  const int fw_prev = __shfl_up_sync(FULL, (int)fw, 1);
  const bool ef = lane > 0 && fw_prev != 0;  // a head earlier in the warp
  if (lane == 31) s_w[warp] = fw;
  cp_async_wait_all();
  __syncthreads();  // sval, s_goff, s_glo and s_w complete
  bool wf = lane < K2_WARPS ? s_w[lane] != 0 : false;
  const unsigned wmask = seg_mask(wf);  // warp 0 uses it: warp totals
  __syncthreads();
  if (warp == 0 && lane < K2_WARPS) s_w[lane] = wf;  // inclusive flags
  __syncthreads();
  // a run starts in the tile before this thread's rows
  const bool head_before = ef || (warp > 0 && s_w[warp - 1] != 0);

  // zero the gaps, the whole block on each float; the entry of float k is
  // the largest e with s_goff[e] <= k (still the last one, mostly)
  for (int k = tid, e = 0; k < gap_total; k += K2_THREADS) {
    if (s_goff[e + 1] <= k) {
      int lo = e + 1, hi = rows + 1;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_goff[mid] <= k) lo = mid; else hi = mid;
      }
      e = lo;
    }
    out[(long long)s_glo[e] * ch + (k - s_goff[e])] = 0.0f;
  }

  // K2_CG channels at a time (their scans share each shuffle's and
  // barrier's latency): the thread's element (the sum of its last run),
  // the block's exclusive segmented scan, then the row that ends a run
  // writes that run's sum
  const float* my = sval + tid * stride;
  for (int c0 = 0; c0 < ch; c0 += K2_CG) {
    const int ng = min(K2_CG, ch - c0);
    double v[K2_CG], e[K2_CG];
#pragma unroll
    for (int u = 0; u < K2_CG; ++u) v[u] = 0.0;
#pragma unroll
    for (int j = 0; j < K2_RPT; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) {
        if (head & (1u << j)) v[u] = 0.0;
        if (u < ng) v[u] += (double)my[j * ch + c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < K2_CG; ++u) {
      v[u] = seg_scan(v[u], mask);
      e[u] = __shfl_up_sync(FULL, v[u], 1);
      if (lane == 0) e[u] = 0.0;
      if (lane == 31) s_wv[c0 + u][warp] = v[u];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) {
        double y = lane < K2_WARPS ? s_wv[c0 + u][lane] : 0.0;
        y = seg_scan(y, wmask);
        if (lane < K2_WARPS) s_wv[c0 + u][lane] = y;
      }
    }
    __syncthreads();
    if (warp > 0 && !ef) {
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) e[u] = s_wv[c0 + u][warp - 1] + e[u];
    }
    bool has_head = head_before;  // the current run starts in this tile
#pragma unroll
    for (int j = 0; j < K2_RPT; ++j) {
      if (j >= nj) break;
      if (head & (1u << j)) has_head = true;
      const bool end = run_end & (1u << j);
      const bool tile_end = j0 + j == rows - 1;
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) {
        if (head & (1u << j)) e[u] = 0.0;
        if (u < ng) e[u] += (double)my[j * ch + c0 + u];
      }
      if (end && has_head) {
        if (id[j] >= 0 && id[j] < capacity) {
#pragma unroll
          for (int u = 0; u < K2_CG; ++u)
            if (u < ng) out[(long long)id[j] * ch + c0 + u] = (float)e[u];
        }
      } else if ((end || tile_end) && !has_head) {
#pragma unroll
        for (int u = 0; u < K2_CG; ++u)  // the first run, begun before
          if (u < ng) s_head[c0 + u] = e[u];
      }
      if (tile_end) {
#pragma unroll
        for (int u = 0; u < K2_CG; ++u)
          if (u < ng) s_tail[c0 + u] = e[u];
      }
    }
  }
  if (holds_end && rows > 0) {
    const bool head_cont = r0 > 0 && seg[r0 - 1] == seg[r0];
    const bool tail_cont = !(run_end & (1u << (rows - 1 - j0)));
    const bool any_head = head_before || head != 0;
    s_flags = (head_cont ? TF_HEAD_CONT : 0) | (tail_cont ? TF_TAIL_CONT : 0) |
              (any_head ? 0 : TF_PASS);
  } else if (rows == 0 && tid == 0) {
    s_flags = 0;
    for (int c = 0; c < ch; ++c) s_tail[c] = 0.0;
  }
  __syncthreads();

  // publish, and look back for the run that continues into this tile:
  // X_t = PASS_t ? X_{t-1} + tail_t : tail_t; a run that continues into
  // tile t and ends there sums to X_{t-1} + head_t
  if (warp == 0) {
    const int fl = s_flags;
    const bool pass = fl & TF_PASS;
    if (lane == 0) {
      double* dst = (pass ? abuf : xbuf) + (long long)t * MAX_CH;
      for (int c = 0; c < ch; ++c) dst[c] = s_tail[c];
      st_release(status + t, pass ? ST_AGG : ST_PREFIX);
    }
    if (fl & TF_HEAD_CONT) {
      for (int c = lane; c < ch; c += 32) s_x[c] = 0.0;
      __syncwarp();
      for (int k0 = t - 1;; k0 -= 32) {
        const int k = k0 - lane;  // lane 0 looks at the nearest tile
        int st = ST_PREFIX;
        if (k >= 0) {
          do { st = ld_acquire(status + k); } while (st == 0);
        }
        const unsigned pm = __ballot_sync(FULL, st == ST_PREFIX);
        const int p = pm ? __ffs(pm) - 1 : 32;  // the nearest prefix
        // every channel's value in one round trip, then one sum each
        const double* src_k = (lane < p ? abuf : xbuf) + (long long)k * MAX_CH;
        double v[MAX_CH];
#pragma unroll
        for (int c = 0; c < MAX_CH; ++c)
          v[c] = (c < ch && lane <= p) ? __ldcg(src_k + c) : 0.0;
#pragma unroll
        for (int c = 0; c < MAX_CH; ++c) {
          if (c < ch) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              v[c] += __shfl_down_sync(FULL, v[c], o);
            if (lane == 0) s_x[c] += v[c];
          }
        }
        __syncwarp();
        if (p < 32) break;
      }
      if (!(pass && (fl & TF_TAIL_CONT))) {  // the run ends in this tile
        const int s = seg[r0];
        if (s >= 0 && s < capacity)
          for (int c = lane; c < ch; c += 32)
            out[(long long)s * ch + c] = (float)(s_x[c] + s_head[c]);
      }
      if (pass && lane == 0) {
        double* dst = xbuf + (long long)t * MAX_CH;
        for (int c = 0; c < ch; ++c) dst[c] = s_x[c] + s_tail[c];
        st_release(status + t, ST_PREFIX);
      }
    }
  }

  // the last block to finish leaves the state zero for the next launch,
  // and fills the output with NaN if any block saw a decreasing id (every
  // other block's writes are done: fence, count, fence, as in a grid sync)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(done_ctr, 1) == (int)gridDim.x - 1;
    if (s_last) __threadfence();
    s_bad = s_last && atomicExch(bad_flag, 0) != 0;
  }
  __syncthreads();
  if (s_last) {
    for (int k = tid; k < (int)gridDim.x; k += K2_THREADS) status[k] = 0;
    if (tid == 0) {
      *tile_ctr = 0;
      *done_ctr = 0;
    }
    if (s_bad)
      for (long long k = tid; k < (long long)capacity * ch; k += K2_THREADS)
        out[k] = __int_as_float(0x7fc00000);
  }
}

size_t k2_smem_bytes(int ch) {
  return sizeof(float) * (size_t)K2_THREADS * (K2_RPT * ch + 1);
}

}  // namespace

extern "C" {

int pcs_segsum_tile_rows() { return TILE; }

const char* pcs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1. vals [n, ch] f32, flags [n] u8; scratch: tile_counts/tile_offsets
// [ntiles] i32, tile_info [3 * ntiles] i32, part [2 * ntiles, ch] f64.
int pcs_segsum_flags(const float* vals, const uint8_t* flags, int n, int ch,
                     int capacity, float* out, int* tile_counts,
                     int* tile_offsets, int* tile_info, double* part,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ch < 1 || ch > MAX_CH) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)capacity * ch, s);
  const int ntiles = ntiles_of(n);
  if (ntiles > 0) {
    tile_flag_count<<<ntiles, TILE, 0, s>>>(flags, n, tile_counts);
    tile_offsets_scan<<<1, SCAN_THREADS, 0, s>>>(tile_counts, ntiles,
                                                 tile_offsets);
    tile_segsum<<<ntiles, TILE, sizeof(float) * ch * TILE, s>>>(
        vals, n, ch, flags, tile_offsets, capacity, out, part, tile_info);
    tile_fixup<<<(ntiles + FIXUP_THREADS - 1) / FIXUP_THREADS, FIXUP_THREADS,
                 0, s>>>(ntiles, ch, capacity, part, tile_info, out);
  }
  return (int)cudaGetLastError();
}

// K2. vals [n, ch] f32, seg [n] i32 nondecreasing; out [capacity, ch]
// (capacity * ch < 2^31). Scratch: state [3 + ntiles] i32 all zero on
// entry (and left zero), xbuf/abuf [ntiles * 16] f64 (any contents), with
// ntiles = max(1, ceil(n / pcs_segsum_sorted_tile_rows())). One kernel
// launch; calls that share the scratch must run in stream order.
int pcs_segsum_sorted(const float* vals, const int* seg, int n, int ch,
                      int capacity, float* out, int* state, double* xbuf,
                      double* abuf, void* stream) {
  if (ch < 1 || ch > MAX_CH || n < 0 || capacity < 1 ||
      (long long)capacity * ch >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k2_smem_bytes(ch);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segsum_sorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntiles = max(1, (n + K2_TILE - 1) / K2_TILE);
  segsum_sorted_kernel<<<ntiles, K2_THREADS, smem, (cudaStream_t)stream>>>(
      vals, seg, n, ch, capacity, out, state, xbuf, abuf);
  return (int)cudaGetLastError();
}

int pcs_segsum_sorted_tile_rows() { return K2_TILE; }
int pcs_segsum_sorted_threads() { return K2_THREADS; }
int pcs_segsum_sorted_smem(int ch) { return (int)k2_smem_bytes(ch); }

}  // extern "C"
