// Segment sums over sorted segments: K1 (ids from boundary flags) and K2
// (precomputed sorted ids), for the voxel passes of the stitch step.
//
// Replaces: pointcloud_stitching_tpu/kernels/segment_reduce.py
//   K1  segment_sum_from_flags  (_segsum_flags_kernel)
//   K2  segment_sum_sorted      (_segsum_kernel)
//
// What bounds it on Hopper: memory. Each row is read once (ch floats plus a
// flag byte or a 4-byte id) and each segment's sum written once; the
// float64 adds (one per value) are far below the card's FP64 rate. The
// flagship output pass reads 3,256,320 rows x 7 floats (91 MB), about 27 us
// at the H100's 3.35 TB/s.
//
// Design. The TPU kernels walk the sorted stream in order on one core and
// carry the running segment id (K1) and partial sums from grid step to
// grid step. CUDA blocks run in no order, so nothing carries between them:
//   * the rows are cut into tiles of TILE rows, one block per tile;
//   * K1 first counts the flags of every tile and scans those counts in
//     one block (the carry the TPU kept in SMEM becomes a tile offset), then
//     each block scans its own flags (ballot + popc per warp, then across
//     warps) to give every row its segment id = offset + prefix - 1;
//   * inside a tile, the thread at the head of each run of equal ids sums
//     that run's rows from shared memory: no atomics;
//   * a run at the start of a tile that continues a segment from an earlier
//     tile stores its partial in `part` (head slot), and so does a segment
//     that starts in a tile and reaches its end (tail slot); a fix-up pass
//     then lets the tile that holds the segment's first row add the head
//     partials of the following tiles in tile order.
// Sums accumulate in float64 and round to float32 once. A float64 sum of
// float32 values is exact unless the segment's values span more than about
// 2^(53-24) in magnitude, so the result is the correctly rounded sum,
// whatever the order: the same bits on every run, the same bits as the
// plain version (which also adds in float64), and integer-valued channels
// (the packed voxel branch) exact. Bitwise agreement is what keeps the
// ICP pass, and hence the refined extrinsics, identical between the kernel
// and the plain path. Ids outside [0, capacity) drop; slots that no
// segment reaches are zero.
#include <cuda_runtime.h>
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

// Per-tile run sums. FROM_FLAGS: ids from flags + tile offsets (K1);
// otherwise ids read from `seg` (K2).
template <bool FROM_FLAGS>
__global__ void tile_segsum(const float* __restrict__ vals, int n, int ch,
                            const uint8_t* __restrict__ flags,
                            const int* __restrict__ tile_offsets,
                            const int* __restrict__ seg, int capacity,
                            float* __restrict__ out, double* __restrict__ part,
                            int* __restrict__ tile_info) {
  extern __shared__ float sval[];          // [ch][TILE]
  __shared__ int sid[TILE];
  __shared__ int warp_incl[WARPS];
  const int t = blockIdx.x, tid = threadIdx.x;
  const long long r0 = (long long)t * TILE;
  const int rows = (int)min((long long)TILE, (long long)n - r0);
  const long long i = r0 + tid;
  const bool live = tid < rows;

  int id;
  bool start;
  if (FROM_FLAGS) {
    const int f = (live && flags[i] != 0) ? 1 : 0;
    id = tile_offsets[t] + block_scan_flag(f, warp_incl) - 1;
    start = f != 0;
  } else {
    id = live ? seg[i] : 0;
    start = live && (i == 0 || seg[i - 1] != id);
  }
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
    tile_segsum<true><<<ntiles, TILE, sizeof(float) * ch * TILE, s>>>(
        vals, n, ch, flags, tile_offsets, nullptr, capacity, out, part,
        tile_info);
    tile_fixup<<<(ntiles + FIXUP_THREADS - 1) / FIXUP_THREADS, FIXUP_THREADS,
                 0, s>>>(ntiles, ch, capacity, part, tile_info, out);
  }
  return (int)cudaGetLastError();
}

// K2. vals [n, ch] f32, seg [n] i32 sorted; scratch: tile_info
// [3 * ntiles] i32, part [2 * ntiles, ch] f64.
int pcs_segsum_sorted(const float* vals, const int* seg, int n, int ch,
                      int capacity, float* out, int* tile_info, double* part,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ch < 1 || ch > MAX_CH) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(out, 0, sizeof(float) * (size_t)capacity * ch, s);
  const int ntiles = ntiles_of(n);
  if (ntiles > 0) {
    tile_segsum<false><<<ntiles, TILE, sizeof(float) * ch * TILE, s>>>(
        vals, n, ch, nullptr, nullptr, seg, capacity, out, part, tile_info);
    tile_fixup<<<(ntiles + FIXUP_THREADS - 1) / FIXUP_THREADS, FIXUP_THREADS,
                 0, s>>>(ntiles, ch, capacity, part, tile_info, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
