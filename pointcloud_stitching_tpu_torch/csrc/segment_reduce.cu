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
// step. CUDA blocks run in no order, so the carry becomes two decoupled
// look-backs inside one launch (no memset, no second pass over the flags):
//   * one block per tile of 1024 rows, 4 or 8 rows per thread by the
//     channel count. Tile t is block t: blocks start in index order, so the
//     tiles a look-back waits for are running or done. (A persistent grid
//     that took tiles from a counter was measured slower.)
//   * the ids: a block counts its flags, publishes the count in one 64-bit
//     word (tag | state | count), and a warp reads the words of the 32
//     tiles before it at once, adding counts back to the nearest tile whose
//     inclusive prefix is known; it then publishes its own prefix. State
//     and value travel in one word, so this chain needs no fences, and it
//     runs ahead of the values: it reads flags only;
//   * a tile whose ids are all past capacity (the saturated grid of the
//     flagship scene: 92% of the tiles) stops once it knows and never reads
//     its rows; it leaves a word behind, and the tiles that start after
//     that stop at once. A tile that starts within the first `capacity`
//     rows cannot be such a tile and starts its copy (cp.async, as K2)
//     before the look-back; the others start it once they know;
//   * the sums: K2's segmented scan inside the warp (float64, head flags
//     from the row flags), the warps' totals folded in order by every
//     thread that needs them (one barrier per 4 channels), and K2's
//     look-back over the float64 partials for the run that enters the
//     tile. Only a tile whose first row carries no flag looks back, and
//     only if that run's id is kept;
//   * the slots that no run reaches: ids are dense (every id below the
//     number of flags has a run), so only [flags in all, capacity) reads 0.
//     After tile t at most U_t = (flags up to t's end) + (rows after t) ids
//     can exist; U_t falls from N to the number of flags by one for every
//     row without a flag. Tile t zeroes the slots [U_t, U_{t-1}) below
//     capacity, at most one per row it holds, and extra blocks past the
//     last tile zero [N, capacity) where capacity > N. Every slot is
//     written exactly once, by a sum or by a zero;
//   * no counters and no reset: every word a launch publishes carries the
//     launch's epoch, and a word with another epoch reads as not yet
//     published. The wrapper counts the epochs per scratch.
// What bounds it: the bytes it has to read (every flag, and the rows whose
// ids are kept) and a tile's latency chain (flags, count, look-back, copy,
// scans, writes), which is hidden only by the blocks resident on an SM.
//
// K1 on packed rows (segment_sum_packed). The global voxel pass's packed
// branch needs no [n, 7|10] buffer of rows and no flag bytes: the row
// source is a template parameter of K1. PackedRows reads the sorted int32
// voxel key, the sort's permutation and, through it, the words of the pack
// kernel below (30-bit quantised offset, 24-bit colour). A row's flag is
// `key != previous key` on a valid row, in registers; its channels
// [ix·f, iy·f, iz·f, q0, q1, q2, 1] (+ [r, g, b]) are built into the
// thread's own slot of the staging buffer, with (ix, iy, iz) decoded from
// the key (division by nz and ny) on flagged rows only. Invalid points
// carry the largest key, so they are a sorted suffix (about 80% of the
// global pass's rows, after the crop): a tile that starts with one returns
// at once, and no tile looks back into it. In the tile that holds the last
// valid row that row ends its run, and the tile publishes F, the number of
// runs, in one more count word (cstat[ntiles]); the zero-only blocks,
// which cover every slot, wait for it and zero [F, capacity) (a tile zeroes
// nothing). The sums (float64 over integers) are exact, so the result is
// bit for bit that of FlagRows over the rows PyTorch composes.
//
// The pack kernel (voxel_pack_kernel; it replaces no TPU kernel: XLA fuses
// the same elementwise work into the sort's operands). One thread a point
// reads its xyz, mask and rgb once and writes the key and the offset (and
// colour) word: 16 to 20 bytes read, 8 to 12 written, memory-bound. Its
// float32 arithmetic is PyTorch's, step by step: p = xyz * inv, floor,
// frac = p - floor(p), (frac * 1024) truncated; the products and the
// difference are written with __fmul_rn / __fsub_rn, so the compiler cannot
// contract them into a fused multiply-add, which would change the bits.
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

#include <type_traits>

namespace {

constexpr int MAX_CH = 16;
constexpr int PACK_SENTINEL = INT_MAX;  // the key of an invalid point

// ---------------------------------------------------------------------------
// Shared by K1 and K2: one launch, a segmented reduction inside each tile,
// and a decoupled look-back across tiles.

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

// Warp 0 of tile t, whose first run began in an earlier tile: s_x[c] = the
// sum of that run's rows before the tile. The warp reads the statuses of the
// 32 tiles before it at once (lane 0 the nearest), waits until each has
// published, and adds the AGG sums back to the nearest PREFIX; if there is
// none among the 32 it goes on with the 32 before those. A status counts
// as published when its bits above the lowest two equal `tag` (K2: 0, its
// last block zeroes the statuses; K1: the launch's epoch).
__device__ __forceinline__ void lookback_run_sum(
    const int* status, int tag, const double* __restrict__ xbuf,
    const double* __restrict__ abuf, int t, int ch, double* s_x) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < ch; c += 32) s_x[c] = 0.0;
  __syncwarp();
  for (int k0 = t - 1;; k0 -= 32) {
    const int k = k0 - lane;
    int st = ST_PREFIX;  // before the array: a prefix of nothing
    if (k >= 0) {
      do {
        st = ld_acquire(status + k);
      } while (st == 0 || (st & ~3) != tag);
    }
    const unsigned pm = __ballot_sync(FULL, (st & 3) == ST_PREFIX);
    const int p = pm ? __ffs(pm) - 1 : 32;  // the nearest prefix
    // every channel's value in one round trip, then one sum each
    const double* src_k = (lane < p ? abuf : xbuf) + (long long)k * MAX_CH;
    double v[MAX_CH];
#pragma unroll
    for (int c = 0; c < MAX_CH; ++c)
      v[c] = (c < ch && lane <= p && k >= 0) ? __ldcg(src_k + c) : 0.0;
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
      lookback_run_sum(status, 0, xbuf, abuf, t, ch, s_x);
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

// ---------------------------------------------------------------------------
// K1: ids from boundary flags, in one launch (see the note at the top).

// K1's launch shape: tiles of K1_TILE rows, RPT rows to a thread, so that a
// thread holds about 32 floats whatever the channel count (measured at 4
// and 7 channels: fewer, longer threads win where rows are narrow, more,
// shorter ones where they are wide), and 1024 threads to an SM (64
// registers a thread): a tile's latency is hidden by the other tiles
// resident with it.
constexpr int K1_TILE = 1024;
constexpr int K1_NARROW_CH = 4;   // up to here 8 rows to a thread, else 4
constexpr int K1_SM_THREADS = 1024;
constexpr int K1_ZERO_FLOATS = 16384;  // floats zeroed by a zero-only block
// count look-back word: low half a flag count; high half the launch's tag
// (epoch << 2) plus a state
constexpr unsigned CS_AGG = 1;     // the tile's own count
constexpr unsigned CS_PREFIX = 2;  // the count up to the tile's end
constexpr unsigned CS_TOTAL = 3;   // PackedRows: the count of every run

__device__ __forceinline__ void st_relaxed64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The rows [r0, r0 + rows) into shared memory, one pad float after each
// thread's RPT rows: coalesced asynchronous copies, all in flight at
// once. Element k goes to k + k / per; the quotient is stepped, not divided.
template <int THREADS>
__device__ __forceinline__ void stage_rows(float* sval, const float* src,
                                           int count, int per) {
  int slot = threadIdx.x / per, rem = threadIdx.x - slot * per;
  const int dq = THREADS / per, dr = THREADS - dq * per;
  for (int k = threadIdx.x; k < count; k += THREADS) {
    cp_async4(sval + k + slot, src + k);
    slot += dq;
    rem += dr;
    if (rem >= per) {
      rem -= per;
      ++slot;
    }
  }
  cp_async_commit();
}

// K1's row sources (see the note at the top). FlagRows: rows [n, ch] and
// flags [n] (nonzero: a run starts at the row) in memory.
struct FlagRows {
  const float* vals;
  const uint8_t* flags;
};
// PackedRows: skey [n] the sorted keys (PACK_SENTINEL for an invalid point,
// so those rows are a suffix), perm [n] the sort's permutation, off / col
// [n] the pack kernel's words in the points' own order (col null: 7
// channels, else 10), dims the grid's (nx, ny, nz), each at least 1.
struct PackedRows {
  const int* skey;
  const long long* perm;
  const int* off;
  const int* col;
  const int* dims;
};

// Block t < ntiles is tile t of K1_TILE rows (thread i holds rows i * RPT..
// of the tile, RPT = K1_TILE / THREADS); the blocks after them zero a share
// of the slots [n, capacity). A tile waits only for tiles before it, and
// blocks start in index order, so what it waits for is running or done.
// status / cstat: per-tile words of the sums' and the counts' look-backs,
// and hint, one word for the launch; a word counts as published when it
// carries this launch's tag (epoch << 2, epoch >= 1), so nothing resets
// them between launches. xbuf/abuf: [ntiles][MAX_CH] f64.
template <int THREADS, class Rows>
__global__ void __launch_bounds__(THREADS, K1_SM_THREADS / THREADS)
segsum_flags_kernel(Rows src, int n, int ch, int capacity, int ntiles,
                    float* __restrict__ out, int tag,
                    unsigned long long* __restrict__ hint,
                    int* __restrict__ status,
                    unsigned long long* __restrict__ cstat,
                    double* __restrict__ xbuf, double* __restrict__ abuf) {
  constexpr bool PACKED = std::is_same<Rows, PackedRows>::value;
  constexpr int RPT = K1_TILE / THREADS;  // rows per thread
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float sval[];  // THREADS x (RPT * ch + 1)
  __shared__ double s_wv[MAX_CH + K2_CG][WARPS];
  __shared__ double s_head[MAX_CH], s_tail[MAX_CH], s_x[MAX_CH];
  __shared__ int s_cnt[WARPS], s_fw[WARPS];
  __shared__ int s_excl, s_tail_cont;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;

  const unsigned long long hi_tag = (unsigned long long)(unsigned)tag << 32;
  if (t >= ntiles) {
    if constexpr (PACKED) {
      // a zero-only block: its share of the slots [F, capacity), F the
      // number of runs, which the tile that holds the last valid row
      // publishes in cstat[ntiles] (no valid row: 0)
      __shared__ int s_runs;
      if (tid == 0) {
        unsigned long long w = hi_tag | ((unsigned long long)CS_TOTAL << 32);
        if (ntiles > 0 && __ldg(src.skey) != PACK_SENTINEL) {
          do {
            w = ld_relaxed64(cstat + ntiles);
          } while ((unsigned)(w >> 32) != ((unsigned)tag | CS_TOTAL));
        }
        s_runs = (int)min((unsigned)w, (unsigned)capacity);
      }
      __syncthreads();
      const long long lo = (long long)(t - ntiles) * K1_ZERO_FLOATS;
      const long long hi = min(lo + K1_ZERO_FLOATS, (long long)capacity * ch);
      for (long long k = max(lo, (long long)s_runs * ch) + tid; k < hi;
           k += THREADS)
        out[k] = 0.0f;
    } else {
      // a zero-only block: its share of the slots past the last row's
      const long long lo = (long long)min(n, capacity) * ch +
                           (long long)(t - ntiles) * K1_ZERO_FLOATS;
      const long long hi = min(lo + K1_ZERO_FLOATS, (long long)capacity * ch);
      for (long long k = lo + tid; k < hi; k += THREADS) out[k] = 0.0f;
    }
    return;
  }
  const long long r0 = (long long)t * K1_TILE;
  // PackedRows: the valid rows are a prefix of the array, so a tile whose
  // first row is invalid holds no valid row: nothing to count, sum or zero,
  // and no tile looks back into it (every later tile is one too)
  if constexpr (PACKED) {
    if (__ldg(src.skey + r0) == PACK_SENTINEL) return;
  }
  const int rows = (int)min((long long)K1_TILE, (long long)n - r0);
  const int per = RPT * ch;  // floats of one thread's rows
  const int stride = per + 1;   // odd: no bank conflicts below
  // At most r0 runs start before the tile, so with r0 <= capacity its ids
  // cannot all lie past capacity and the copy starts now, under the
  // look-back. A later tile first learns whether any of its ids is below
  // capacity.
  const bool early = r0 <= capacity;
  if constexpr (!PACKED) {
    if (early) stage_rows<THREADS>(sval, src.vals + r0 * ch, rows * ch, per);
  }
  // Has a tile before this one found its ids past capacity already? (The
  // answer arrives under the flags' loads.)
  const unsigned long long past = hi_tag |
                                  ((unsigned long long)CS_PREFIX << 32) |
                                  (unsigned)(capacity + 1);
  unsigned long long seen = 0;
  if (!early && tid == 0) seen = ld_relaxed64(hint);

  // the flags of this thread's rows: bit j of head, row j starts a run;
  // bit j of run_end, the row after it does (or there is none). PackedRows
  // also: nv, the thread's rows that hold data (a prefix of its nj); last,
  // which of them is the tile's last such row, or -1; boundary, whether the
  // tile holds the array's last valid row.
  const int j0 = tid * RPT;
  const int nj = max(0, min(RPT, rows - j0));
  const long long i0 = r0 + j0;
  unsigned head = 0, run_end = 0;
  int nv = nj, last = -1;
  bool boundary = false;
  int key[RPT];  // PackedRows: the rows' sorted keys
  if constexpr (PACKED) {
    boundary = r0 + rows == n ||
               __ldg(src.skey + r0 + rows) == PACK_SENTINEL;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      key[j] = j < nj ? __ldg(src.skey + i0 + j) : PACK_SENTINEL;
    nv = 0;
    if (nj > 0) {
      const int next = i0 + nj < n ? __ldg(src.skey + i0 + nj)
                                   : PACK_SENTINEL;
      int prev = i0 > 0 ? __ldg(src.skey + i0 - 1) : -1;  // keys are >= 0
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int nk = j + 1 < nj ? key[min(j + 1, RPT - 1)] : next;
        if (key[j] != PACK_SENTINEL) {
          nv = j + 1;
          if (key[j] != prev) head |= 1u << j;
          if (nk != key[j]) run_end |= 1u << j;
        }
        prev = key[j];
      }
      if (nv > 0 && (nv < nj || next == PACK_SENTINEL || j0 + nj == rows))
        last = nv - 1;
      if (j0 + nj == rows)
        s_tail_cont = nv == nj && !((run_end >> (nj - 1)) & 1u);
    }
  } else {
    for (int j = 0; j < nj; ++j)
      if (__ldg(src.flags + i0 + j) != 0) head |= 1u << j;
    if (nj > 0) {
      const bool next = i0 + nj >= n || __ldg(src.flags + i0 + nj) != 0;
      run_end = ((head >> 1) | (next ? 1u << (nj - 1) : 0u)) &
                ((1u << nj) - 1u);
      if (j0 + nj == rows) s_tail_cont = !next;
    }
  }
  // A tile whose ids are all past capacity leaves `hint` = (tag, its
  // number). Blocks start in index order, so a tile that reads it is a later
  // one and its ids are past capacity too: it has nothing to sum and no slot
  // to zero. It leaves a count of capacity + 1 for any tile that started
  // with it and still looks back (the true count is no less), and is done.
  if (!early &&
      __syncthreads_or((unsigned)(seen >> 32) == (unsigned)tag &&
                       t >= (int)(unsigned)seen)) {
    if (tid == 0) {
      st_relaxed64(cstat + t, past);
      // the runs in all number more than capacity: nothing to zero
      if (boundary)
        st_relaxed64(cstat + ntiles,
                     hi_tag | ((unsigned long long)CS_TOTAL << 32) |
                         (unsigned)(capacity + 1));
    }
    return;
  }
  // flags before this thread in its warp, and the head flags' scan that
  // every channel shares (as in K2)
  const int cnt = __popc(head);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  bool fw = head != 0;
  const unsigned mask = seg_mask(fw);  // fw: inclusive over the warp
  const int fw_prev = __shfl_up_sync(FULL, (int)fw, 1);
  const bool ef = lane > 0 && fw_prev != 0;  // a head earlier in the warp
  if (lane == 31) {
    s_cnt[warp] = incl;
    s_fw[warp] = fw;
  }
  __syncthreads();
  int excl = incl - cnt, total = 0;  // flags before the thread / in the tile
  bool head_before = ef;             // a run starts in the tile before it
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_cnt[w];
    total += c;
    if (w < warp) {
      excl += c;
      head_before = head_before || s_fw[w] != 0;
    }
  }

  // the counts' look-back: publish the tile's count, add the counts of the
  // tiles before it back to the nearest known prefix, publish the tile's
  // own prefix
  if (warp == 0) {
    int before = 0;
    if (t > 0) {
      if (lane == 0)
        st_relaxed64(cstat + t, hi_tag | ((unsigned long long)CS_AGG << 32) |
                                    (unsigned)total);
      for (int k0 = t - 1;; k0 -= 32) {
        const int k = k0 - lane;  // lane 0 looks at the nearest tile
        unsigned hi = CS_PREFIX, lo = 0;  // before the array: 0 flags
        if (k >= 0) {
          unsigned long long w;
          do {
            w = ld_relaxed64(cstat + k);
            hi = (unsigned)(w >> 32);
          } while ((hi & ~3u) != (unsigned)tag);
          lo = (unsigned)w;
        }
        const unsigned pm = __ballot_sync(FULL, (hi & 3u) == CS_PREFIX);
        const int p = pm ? __ffs(pm) - 1 : 32;  // the nearest prefix
        int v = lane <= p ? (int)lo : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
        before += __shfl_sync(FULL, v, 0);
        if (p < 32) break;
      }
    }
    if (lane == 0) {
      st_relaxed64(cstat + t, hi_tag | ((unsigned long long)CS_PREFIX << 32) |
                                  (unsigned)(before + total));
      if (boundary)  // the zero-only blocks' F
        st_relaxed64(cstat + ntiles,
                     hi_tag | ((unsigned long long)CS_TOTAL << 32) |
                         (unsigned)(before + total));
      s_excl = before;
    }
  }
  __syncthreads();
  const int before = s_excl;  // flags in the tiles before this one

  // the slots no run can reach any more (see the note at the top; with
  // PackedRows the zero-only blocks zero [F, capacity))
  if (!PACKED) {
    const long long u_hi = (long long)before + ((long long)n - r0);
    const long long u_lo = u_hi - (rows - total);
    const long long a = min(u_lo, (long long)capacity) * ch;
    const long long b = min(u_hi, (long long)capacity) * ch;
    for (long long k = a + tid; k < b; k += THREADS) out[k] = 0.0f;
  }
  // Every id of the tile, the entering run's before - 1 included, is at or
  // past capacity: nothing to sum, and no later tile reads this one's sums
  // (its ids are no smaller). The rows are never read, and the tiles that
  // start from now on learn it from `hint`.
  if (before > capacity) {
    if (tid == 0) st_relaxed64(hint, hi_tag | (unsigned)t);
    return;
  }
  if constexpr (PACKED) {
    // the thread's valid rows into its own slot of sval: the gathers first,
    // all in flight, then the channels
    long long p[RPT];
    int o[RPT], c[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (j < nv) p[j] = __ldg(src.perm + i0 + j);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (j < nv) {
        o[j] = __ldg(src.off + p[j]);
        c[j] = src.col != nullptr ? __ldg(src.col + p[j]) : 0;
      }
    }
    const int ny = __ldg(src.dims + 1), nz = __ldg(src.dims + 2);
    float* w = sval + tid * stride;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (j < nv) {
        float* r = w + j * ch;
        int ix = 0, iy = 0, iz = 0;
        if (head & (1u << j)) {  // the voxel's indices, on its first row
          const int q = key[j] / nz;
          iz = key[j] - q * nz;
          ix = q / ny;
          iy = q - ix * ny;
        }
        r[0] = (float)ix;
        r[1] = (float)iy;
        r[2] = (float)iz;
        r[3] = (float)((o[j] >> 20) & 1023);
        r[4] = (float)((o[j] >> 10) & 1023);
        r[5] = (float)(o[j] & 1023);
        r[6] = 1.0f;
        if (ch > 7) {
          r[7] = (float)((c[j] >> 16) & 255);
          r[8] = (float)((c[j] >> 8) & 255);
          r[9] = (float)(c[j] & 255);
        }
      }
    }
  } else {
    if (!early)
      stage_rows<THREADS>(sval, src.vals + r0 * ch, rows * ch, per);
  }
  cp_async_wait_all();
  __syncthreads();  // sval complete

  // K2_CG channels at a time: the thread's element (the sum of its last
  // run), the warp's segmented scan, the warps' totals folded in order,
  // then the row that ends a run writes that run's sum
  const int id0 = before + excl - 1;  // the run that enters these rows
  const float* my = sval + tid * stride;
  for (int c0 = 0; c0 < ch; c0 += K2_CG) {
    const int ng = min(K2_CG, ch - c0);
    double v[K2_CG], e[K2_CG];
#pragma unroll
    for (int u = 0; u < K2_CG; ++u) v[u] = 0.0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (j >= (PACKED ? nv : nj)) break;
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
    if (warp > 0 && !ef) {
      // the sum that the warps before this one carry into it
      double carry[K2_CG];
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) carry[u] = 0.0;
      for (int w = 0; w < warp; ++w) {
        const bool reset = s_fw[w] != 0;
#pragma unroll
        for (int u = 0; u < K2_CG; ++u)
          carry[u] = (reset ? 0.0 : carry[u]) + s_wv[c0 + u][w];
      }
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) e[u] = carry[u] + e[u];
    }
    bool has_head = head_before;  // the current run starts in this tile
    int id = id0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (j >= (PACKED ? nv : nj)) break;
      if (head & (1u << j)) {
        has_head = true;
        ++id;
      }
      const bool end = run_end & (1u << j);
      const bool tile_end = PACKED ? j == last : j0 + j == rows - 1;
#pragma unroll
      for (int u = 0; u < K2_CG; ++u) {
        if (head & (1u << j)) e[u] = 0.0;
        if (u < ng) e[u] += (double)my[j * ch + c0 + u];
      }
      if (end && has_head) {
        if (id < capacity) {  // a run that starts here has id >= 0
#pragma unroll
          for (int u = 0; u < K2_CG; ++u)
            if (u < ng) out[(long long)id * ch + c0 + u] = (float)e[u];
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
  __syncthreads();

  // publish, and look back for the run that enters this tile (K2's
  // scheme): X_t = (no flag in t) ? X_{t-1} + tail_t : tail_t. A tile whose
  // last run ends with it publishes a status only: nothing reads its sum.
  // The run that enters has id before - 1; where that is not kept (rows
  // before the first flag), nothing looks back for it, here or in any
  // later tile it reaches.
  if (warp == 0) {
    const bool pass = total == 0;
    const bool tail_cont = s_tail_cont != 0;
    const int hid = before - 1;
    if (lane == 0) {
      if (tail_cont) {
        double* dst = (pass ? abuf : xbuf) + (long long)t * MAX_CH;
        for (int c = 0; c < ch; ++c) dst[c] = s_tail[c];
      }
      st_release(status + t, tag | (pass ? ST_AGG : ST_PREFIX));
    }
    // thread 0 holds the tile's first row: no flag there, a run enters
    const bool head_cont = !(__shfl_sync(FULL, head, 0) & 1u);
    if (head_cont && hid >= 0) {  // hid < capacity: before <= capacity
      lookback_run_sum(status, tag, xbuf, abuf, t, ch, s_x);
      if (!(pass && tail_cont)) {  // the run ends in this tile
        for (int c = lane; c < ch; c += 32)
          out[(long long)hid * ch + c] = (float)(s_x[c] + s_head[c]);
      } else if (lane == 0) {
        double* dst = xbuf + (long long)t * MAX_CH;
        for (int c = 0; c < ch; ++c) dst[c] = s_x[c] + s_tail[c];
        st_release(status + t, tag | ST_PREFIX);
      }
    }
  }
}

// The pack kernel (see the note at the top): point i's key, PACK_SENTINEL
// where mask[i] is 0, its offset word and, with rgb, its colour word.
// inv: 1 / leaf; min_ijk: the valid points' least (floor(p)) per axis;
// dims: (nx, ny, nz). The offset and colour words are made for every
// point, as PyTorch makes them.
constexpr int PACK_THREADS = 256;

__global__ void __launch_bounds__(PACK_THREADS)
voxel_pack_kernel(const float* __restrict__ xyz,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ rgb,
                  const float* __restrict__ inv_p,
                  const int* __restrict__ min_ijk,
                  const int* __restrict__ dims, int n, int* __restrict__ key,
                  int* __restrict__ off, int* __restrict__ col) {
  const long long i = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (i >= n) return;
  const float inv = __ldg(inv_p);
  int f[3], q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = __fmul_rn(__ldg(xyz + 3 * i + a), inv);
    const float fl = floorf(p);
    f[a] = (int)fl;
    const int qa = (int)__fmul_rn(__fsub_rn(p, fl), 1024.0f);
    q[a] = min(max(qa, 0), 1023);
  }
  int k = PACK_SENTINEL;
  if (__ldg(mask + i) != 0) {
    const int ny = __ldg(dims + 1), nz = __ldg(dims + 2);
    k = ((f[0] - __ldg(min_ijk)) * ny + (f[1] - __ldg(min_ijk + 1))) * nz +
        (f[2] - __ldg(min_ijk + 2));
  }
  key[i] = k;
  off[i] = (q[0] << 20) | (q[1] << 10) | q[2];
  if (rgb != nullptr) {
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      c[a] = min(max((int)__ldg(rgb + 3 * i + a), 0), 255);
    col[i] = (c[0] << 16) | (c[1] << 8) | c[2];
  }
}

// K1's grid: the tiles, then the blocks that zero the slots [n, capacity)
int k1_tiles(int n) { return (n + K1_TILE - 1) / K1_TILE; }
int k1_zero_blocks(int n, int ch, int capacity) {
  const long long z = (long long)(capacity - min(n, capacity)) * ch;
  return (int)((z + K1_ZERO_FLOATS - 1) / K1_ZERO_FLOATS);
}

int k1_threads(int ch) { return ch <= K1_NARROW_CH ? 128 : 256; }
size_t k1_smem_bytes(int ch) {
  const int threads = k1_threads(ch);
  return sizeof(float) * (size_t)threads * (K1_TILE / threads * ch + 1);
}

size_t k2_smem_bytes(int ch) {
  return sizeof(float) * (size_t)K2_THREADS * (K2_RPT * ch + 1);
}

// Raise the kernel's dynamic shared memory limit where a tile needs more
// than the 48 KB a launch gets by default.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* pcs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1. vals [n, ch] f32, flags [n] u8 (nonzero: a run starts at the row);
// out [capacity, ch] (capacity * ch < 2^31). Scratch, with ntiles =
// ceil(n / pcs_segsum_flags_tile_rows()): hint [1] u64, status [ntiles] i32
// and cstat [ntiles] u64, zero before the first call and then left as the
// calls leave them; xbuf/abuf [ntiles * 16] f64 (any contents). epoch: 1 ..
// 2^29 - 1, different from that of every earlier call on this scratch since
// it was last zeroed. One kernel launch of pcs_segsum_flags_grid blocks;
// calls that share the scratch must run in stream order.
int pcs_segsum_flags(const float* vals, const uint8_t* flags, int n, int ch,
                     int capacity, float* out, int epoch,
                     unsigned long long* hint, int* status,
                     unsigned long long* cstat, double* xbuf, double* abuf,
                     void* stream) {
  if (ch < 1 || ch > MAX_CH || n < 0 || capacity < 1 || epoch < 1 ||
      epoch >= (1 << 29) || (long long)capacity * ch >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k1_smem_bytes(ch);
  const int ntiles = k1_tiles(n);
  const int grid = ntiles + k1_zero_blocks(n, ch, capacity);
  const FlagRows src{vals, flags};
  auto launch = [&](auto kernel, int threads) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        src, n, ch, capacity, ntiles, out, epoch << 2, hint, status, cstat,
        xbuf, abuf);
    return (int)cudaGetLastError();
  };
  return k1_threads(ch) == 128
             ? launch(segsum_flags_kernel<128, FlagRows>, 128)
             : launch(segsum_flags_kernel<256, FlagRows>, 256);
}

// K1 on packed rows: skey [n] i32 sorted (PACK_SENTINEL last), perm [n]
// i64, off [n] and col [n] i32 (col null: 7 channels, else 10), dims [3]
// i32 (nx, ny, nz, each >= 1); out [capacity, 7 or 10]. Scratch and epoch
// as pcs_segsum_flags's, which it may share in stream order, but cstat
// [ntiles + 1]. One launch: the tiles, then the blocks that zero
// [runs, capacity), each K1_ZERO_FLOATS floats of [0, capacity).
int pcs_segsum_packed(const int* skey, const long long* perm, const int* off,
                      const int* col, const int* dims, int n, int capacity,
                      float* out, int epoch, unsigned long long* hint,
                      int* status, unsigned long long* cstat, double* xbuf,
                      double* abuf, void* stream) {
  const int ch = col != nullptr ? 10 : 7;
  if (n < 0 || capacity < 1 || epoch < 1 || epoch >= (1 << 29) ||
      (long long)capacity * ch >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  constexpr int threads = 256;  // k1_threads(ch) for 7 and 10 channels
  const size_t smem = k1_smem_bytes(ch);
  const cudaError_t e =
      allow_smem(segsum_flags_kernel<threads, PackedRows>, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = k1_tiles(n);
  const int grid = ntiles + k1_zero_blocks(0, ch, capacity);
  const PackedRows src{skey, perm, off, col, dims};
  segsum_flags_kernel<threads, PackedRows>
      <<<grid, threads, smem, (cudaStream_t)stream>>>(
          src, n, ch, capacity, ntiles, out, epoch << 2, hint, status, cstat,
          xbuf, abuf);
  return (int)cudaGetLastError();
}

// The pack kernel: xyz [n, 3] f32, mask [n] u8, rgb [n, 3] f32 or null;
// inv [1] f32, min_ijk [3] and dims [3] i32 on the device; key and off [n]
// i32, col [n] i32 (written where rgb is given). One launch (none for n 0).
int pcs_voxel_pack(const float* xyz, const uint8_t* mask, const float* rgb,
                   const float* inv, const int* min_ijk, const int* dims,
                   int n, int* key, int* off, int* col, void* stream) {
  if (n < 0 || (rgb != nullptr && col == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  voxel_pack_kernel<<<(n + PACK_THREADS - 1) / PACK_THREADS, PACK_THREADS, 0,
                      (cudaStream_t)stream>>>(xyz, mask, rgb, inv, min_ijk,
                                              dims, n, key, off, col);
  return (int)cudaGetLastError();
}

int pcs_segsum_flags_grid(int n, int ch, int capacity) {
  return k1_tiles(n) + k1_zero_blocks(n, ch, capacity);
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
  const cudaError_t e = allow_smem(segsum_sorted_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = max(1, (n + K2_TILE - 1) / K2_TILE);
  segsum_sorted_kernel<<<ntiles, K2_THREADS, smem, (cudaStream_t)stream>>>(
      vals, seg, n, ch, capacity, out, state, xbuf, abuf);
  return (int)cudaGetLastError();
}

int pcs_segsum_sorted_tile_rows() { return K2_TILE; }
int pcs_segsum_sorted_threads() { return K2_THREADS; }
int pcs_segsum_sorted_smem(int ch) { return (int)k2_smem_bytes(ch); }
int pcs_segsum_flags_tile_rows() { return K1_TILE; }
int pcs_segsum_flags_threads(int ch) { return k1_threads(ch); }
int pcs_segsum_flags_smem(int ch) { return (int)k1_smem_bytes(ch); }

}  // extern "C"
