// The port's random draws: JAX's threefry2x32 counter stream and the
// float32 prefix sum that XLA's CPU backend computes for jnp.cumsum.
//
// Replaces no Pallas kernel. The JAX package draws its random numbers with
// jax.random (ops/sac.py segment_plane: random.choice with p; models/
// registration.py register_global: split, normal, categorical, randint),
// which XLA lowers to threefry2x32 and, for choice, to a cumulative sum.
// These two kernels give the port the same numbers from the same key.
//
// threefry2x32_kernel: one thread per counter i of a draw. The counter is
// JAX's partitionable one (jax_threefry_partitionable, the default since
// JAX 0.5): the 64-bit flat index split into (hi, lo) = (i >> 32, i & M).
// 20 rounds with rotations {13,15,26,6} and {17,29,16,24} in turns of 4;
// after group g the key word ks[(g+1)%3] goes into x0 and ks[(g+2)%3]+g+1
// into x1, with ks[2] = k0 ^ k1 ^ 0x1BD11BDA. It writes the pair (x0, x1)
// (jax.random.split) or x0 ^ x1 (jax.random.bits at 32 bits), each word
// as an int64 below 2^32, the port's key and bits type (PyTorch's uint32
// has no shifts on CUDA). The key is read from device memory, so a draw
// never waits for the host. What bounds it: the 8 or 16 bytes a counter
// writes; 20 rounds of add/rotate/xor are ~100 integer operations a
// counter, far below the card's integer rate.
//
// scan16: the inclusive prefix sum of float32 values in XLA's CPU order,
// a recursive blocked scan of base 16: each block of 16 is summed in
// sequence (its inner scan), the block totals are scanned the same way,
// and each element of block b >= 1 becomes prefix[b-1] + inner. That
// order is what makes jax.random.choice's searchsorted land on JAX's
// index; a parallel scan (torch.cumsum on CUDA) or a double accumulator
// (torch.cumsum on the CPU) rounds elsewhere. scan16_kernel runs one
// thread per block of 16 at one level and writes the level's totals;
// addback_kernel adds the scanned totals back, one thread per element.
// The host function walks the ceil(log16 n) levels down and up, so a scan
// of n values is 2 * levels - 1 launches (9 at 262,144). Every add is
// __fadd_rn, so no contraction or reassociation can move a rounding.
// What bounds it: bytes (each level reads and writes its values once).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BASE = 16;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int r0,
                                        int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
}

__global__ void threefry2x32_kernel(const long long* __restrict__ key,
                                    long long n, int pairs,
                                    long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32) + k0;
  uint32_t x1 = (uint32_t)i + k1;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  if (pairs) {
    out[2 * i] = (long long)x0;
    out[2 * i + 1] = (long long)x1;
  } else {
    out[i] = (long long)(x0 ^ x1);
  }
}

// One level: block b of 16 values of src (zeros past n, as XLA pads)
// scanned in sequence into dst; its total into totals[b] (when given).
// src and dst may be the same array: each thread owns its 16 values.
__global__ void scan16_kernel(const float* src, long long n, float* dst,
                              float* __restrict__ totals) {
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long base = b * BASE;
  if (base >= n) return;
  float s = src[base];
  dst[base] = s;
#pragma unroll
  for (int j = 1; j < BASE; ++j) {
    const long long k = base + j;
    s = __fadd_rn(s, k < n ? src[k] : 0.0f);
    if (k < n) dst[k] = s;
  }
  if (totals != nullptr) totals[b] = s;
}

// dst[i] = scanned[i / 16 - 1] + dst[i] for every i past the first block.
__global__ void addback_kernel(float* __restrict__ dst, long long n,
                               const float* __restrict__ scanned) {
  const long long i = BASE + (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  dst[i] = __fadd_rn(scanned[i / BASE - 1], dst[i]);
}

unsigned blocks_for(long long work) {
  return (unsigned)((work + THREADS - 1) / THREADS);
}

}  // namespace

// key [2] i64 (words below 2^32); out [n] i64 (x0 ^ x1) or, with pairs,
// [n, 2] i64 (x0, x1) for the counters 0 .. n-1.
extern "C" int pcs_threefry2x32(const long long* key, long long n, int pairs,
                                long long* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  threefry2x32_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      key, n, pairs, out);
  return (int)cudaGetLastError();
}

// The f32 floats of scratch that a scan of n values needs for its levels'
// totals: ceil(n / 16) + ceil(n / 256) + ... down to the level of <= 16.
extern "C" long long pcs_scan16_scratch(long long n) {
  long long total = 0;
  while (n > BASE) {
    n = (n + BASE - 1) / BASE;
    total += n;
  }
  return total;
}

// x [n] f32 -> out [n] f32, inclusive, in XLA's CPU order; scratch holds
// pcs_scan16_scratch(n) floats. Launches 2 * levels - 1 kernels.
extern "C" int pcs_scan16(const float* x, long long n, float* out,
                          float* scratch, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  // level l: values lvl[l] of count cnt[l]; lvl[0] is out, the rest
  // follow each other in scratch (a level's totals are the next level)
  float* lvl[16];
  long long cnt[16];
  int levels = 0;
  lvl[0] = out;
  cnt[0] = n;
  float* next = scratch;
  while (cnt[levels] > BASE) {
    const long long m = (cnt[levels] + BASE - 1) / BASE;
    lvl[levels + 1] = next;
    cnt[levels + 1] = m;
    next += m;
    ++levels;
  }
  // down: scan every level in blocks of 16, its totals into the next
  for (int l = 0; l <= levels; ++l) {
    const long long nb = (cnt[l] + BASE - 1) / BASE;
    scan16_kernel<<<blocks_for(nb), THREADS, 0, s>>>(
        l == 0 ? x : lvl[l], cnt[l], lvl[l],
        l < levels ? lvl[l + 1] : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // up: each level's scanned totals added into the level below
  for (int l = levels - 1; l >= 0; --l) {
    addback_kernel<<<blocks_for(cnt[l] - BASE), THREADS, 0, s>>>(
        lvl[l], cnt[l], lvl[l + 1]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
