// K5: brick-local image gather for the TSDF integrator.
//
// Replaces: pointcloud_stitching_tpu/kernels/patch_gather.py
//   patch_gather (_kernel), reached from models/tsdf.py _onehot_gather for
//   every image plane (depth, packed colour) that integrate gathers.
//
// Contract (the TPU kernel's, bit for bit): for brick b and voxel k,
//   hp  = max(512, ceil(H / 8) * 8),  wp = max(1024, ceil(W / 128) * 128)
//   v0a = clamp(v0 - floormod(v0, 8), 0, hp - 128)
//   u0a = clamp(u0 - floormod(u0, 128), 0, wp - 256)
//   ivl = iv + (v0 - v0a),  iul = iu + (u0 - u0a)
//   out = img[v0a + ivl, u0a + iul]  if 0 <= ivl < 128, 0 <= iul < 256 and
//         the pixel lies inside [0, H) x [0, W);  0.0 otherwise.
// floormod is the floor modulo (numpy's %, torch.remainder), not C's %,
// which truncates toward zero: a negative start needs the window below it.
// The TPU pads the image with zeros to hp x wp so that its DMA windows stay
// in bounds; here nothing is padded, and a pixel in the pad reads 0.0 by
// the bounds test instead. The output is a copy of one float32 value, so
// it equals the plain PyTorch version bit for bit.
//
// What bounds it on Hopper: memory traffic. Each output element reads two
// int32 local indices and writes one float (12 B); the two window starts
// are shared by the brick's 512 threads, and the image (848 x 480 f32 is
// 1.6 MB) stays resident in the 50 MB L2, so its reads are L2 hits. The
// TPU kernel's one-hot MXU products and bf16 limb splits exist only because
// Mosaic has no vector gather; a GPU thread reads its pixel directly
// through the read-only cache.
#include <cuda_runtime.h>

namespace {

constexpr int BVOX = 512;     // voxels per 8^3 brick
constexpr int WV = 128;       // window rows (start aligned down to 8)
constexpr int WU = 256;       // window cols (start aligned down to 128)
constexpr int THREADS = 256;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void patch_gather_kernel(const float* __restrict__ img, int h,
                                    int w, int hp, int wp,
                                    const int* __restrict__ v0,
                                    const int* __restrict__ u0,
                                    const int* __restrict__ iv,
                                    const int* __restrict__ iu,
                                    long long total,
                                    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long b = i / BVOX;
  const int vs = __ldg(v0 + b);
  const int us = __ldg(u0 + b);
  const int v0a = min(max(vs - floor_mod(vs, 8), 0), hp - WV);
  const int u0a = min(max(us - floor_mod(us, 128), 0), wp - WU);
  const int ivl = __ldg(iv + i) + (vs - v0a);
  const int iul = __ldg(iu + i) + (us - u0a);
  const int r = v0a + ivl;
  const int c = u0a + iul;
  float val = 0.0f;
  if (ivl >= 0 && ivl < WV && iul >= 0 && iul < WU && r < h && c < w)
    val = __ldg(img + (long long)r * w + c);
  out[i] = val;
}

}  // namespace

// img [h, w] f32; v0, u0 [nb] i32; iv, iu [nb, 512] i32; out [nb, 512] f32.
extern "C" int pcs_patch_gather(const float* img, int h, int w, const int* v0,
                                const int* u0, const int* iv, const int* iu,
                                int nb, float* out, void* stream) {
  if (h < 1 || w < 1 || nb < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const int h8 = (h + 7) / 8 * 8, w128 = (w + 127) / 128 * 128;
  const int hp = h8 > 512 ? h8 : 512;
  const int wp = w128 > 1024 ? w128 : 1024;
  const long long total = (long long)nb * BVOX;
  const long long blocks = (total + THREADS - 1) / THREADS;
  patch_gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      img, h, w, hp, wp, v0, u0, iv, iu, total, out);
  return (int)cudaGetLastError();
}
