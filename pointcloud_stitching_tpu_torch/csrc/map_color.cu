// Texture-mapped colour (librealsense's rs2::pointcloud::map_to) for every
// camera of a frame set in one launch.
//
// Replaces no TPU kernel: the JAX package's ops/deproject.py map_color is
// plain jnp. On the card the plain PyTorch composition (ops/deproject.py
// map_color with a CPU tensor or impl='torch') is a chain of library
// operations that also writes a float32 copy of every colour frame each
// frame (8 x 1280 x 720 x 3 x 4 B = 88 MB) before it gathers from it. Here
// one thread maps one point and gathers its three bytes straight from the
// uint8 frame.
//
// Contract, per camera c and point i (the composition's, step by step):
//   if !mask[c, i]: rgb = 0
//   p  = R_c xyz[c, i] + t_c          (depth -> colour extrinsic, fp32)
//   if !(p.z > 1e-9): rgb = 0         (project's in_front)
//   x = p.x / p.z, y = p.y / p.z, then camera c's model (model_ids[c], or
//   model for every camera where model_ids is null; utils/types.py's
//   DistortionModel): BROWN_CONRADY applies the forward
//   polynomial in closed form, INVERSE_BROWN_CONRADY inverts the stored
//   inverse map by 10 fixed-point steps (ops/deproject.py's
//   _distort_inverse_brown_conrady and _undistort_brown_conrady_iterative,
//   operation by operation: every multiply, add and division rounded on
//   its own, as separate torch operations round them, so none of them is
//   contracted here), NONE leaves x, y as they are
//   u  = rint(fma(x, fx_c, ppx_c)),  v likewise with fy_c, ppy_c
//        (one fused multiply-add, as torch.addcmul; rint rounds half to
//        even, as torch.round)
//   if 0 <= u < wc and 0 <= v < hc: rgb = color[c, v, u, :] as float
//   else rgb = 0
// The composition's transform is a cuBLAS matmul whose summation order is
// not this kernel's, so the last bit of p may differ and move a rounding
// that sits on a half pixel; nowhere else can the two differ.
//
// What bounds it on Hopper: memory traffic. A point reads its mask (1 B),
// its xyz (12 B, only when valid) and writes 12 B of rgb; the camera's
// colour frame (2.76 MB at 1280 x 720) is read at the pixels the points
// land on, and the eight frames (22 MB) stay in the 50 MB L2. Neighbouring
// threads take neighbouring pixels of the depth grid, so a warp's loads
// and stores of xyz and rgb are contiguous runs of 384 B, and its colour
// reads fall on neighbouring colour pixels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// utils/types.py's DistortionModel
constexpr int BROWN_CONRADY = 1, INVERSE_BROWN_CONRADY = 2;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// ops/deproject.py _distort_inverse_brown_conrady; k = k1, k2, p1, p2, k3
__device__ __forceinline__ void distort(float& x, float& y, const float* k) {
  const float k1 = __ldg(k), k2 = __ldg(k + 1), p1 = __ldg(k + 2),
              p2 = __ldg(k + 3), k3 = __ldg(k + 4);
  const float r2 = add(mul(x, x), mul(y, y));
  const float f = add(add(add(1.0f, mul(k1, r2)), mul(mul(k2, r2), r2)),
                      mul(mul(mul(k3, r2), r2), r2));
  const float ux = add(add(mul(x, f), mul(mul(mul(2.0f, p1), x), y)),
                       mul(p2, add(r2, mul(mul(2.0f, x), x))));
  const float uy = add(add(mul(y, f), mul(mul(mul(2.0f, p2), x), y)),
                       mul(p1, add(r2, mul(mul(2.0f, y), y))));
  x = ux;
  y = uy;
}

// ops/deproject.py _undistort_brown_conrady_iterative (10 steps)
__device__ __forceinline__ void undistort(float& x, float& y,
                                          const float* k) {
  const float k1 = __ldg(k), k2 = __ldg(k + 1), p1 = __ldg(k + 2),
              p2 = __ldg(k + 3), k3 = __ldg(k + 4);
  const float xo = x, yo = y;
  for (int it = 0; it < 10; ++it) {
    const float r2 = add(mul(x, x), mul(y, y));
    const float icdist = __frcp_rn(
        add(1.0f, mul(add(mul(add(mul(k3, r2), k2), r2), k1), r2)));
    const float dx = add(mul(mul(mul(2.0f, p1), x), y),
                         mul(p2, add(r2, mul(mul(2.0f, x), x))));
    const float dy = add(mul(mul(mul(2.0f, p2), x), y),
                         mul(p1, add(r2, mul(mul(2.0f, y), y))));
    x = mul(__fsub_rn(xo, dx), icdist);
    y = mul(__fsub_rn(yo, dy), icdist);
  }
}

__global__ void map_color_kernel(const float* __restrict__ xyz,
                                 const uint8_t* __restrict__ mask,
                                 const uint8_t* __restrict__ color,
                                 const float* __restrict__ ext,
                                 const float* __restrict__ fx,
                                 const float* __restrict__ fy,
                                 const float* __restrict__ ppx,
                                 const float* __restrict__ ppy,
                                 const float* __restrict__ coeffs,
                                 const int* __restrict__ model_ids,
                                 int model,
                                 long long n, long long total, int hc,
                                 int wc, float* __restrict__ rgb) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (__ldg(mask + i)) {
    const int c = (int)(i / n);
    const float* T = ext + 16 * c;
    const float x = __ldg(xyz + 3 * i), y = __ldg(xyz + 3 * i + 1),
                z = __ldg(xyz + 3 * i + 2);
    // row k of [R | t]: R_k0 x + R_k1 y + R_k2 z, then + t_k
    const float pz = fmaf(__ldg(T + 10), z,
                          fmaf(__ldg(T + 9), y, __ldg(T + 8) * x)) +
                     __ldg(T + 11);
    if (pz > 1e-9f) {
      const float px = fmaf(__ldg(T + 2), z,
                            fmaf(__ldg(T + 1), y, __ldg(T + 0) * x)) +
                       __ldg(T + 3);
      const float py = fmaf(__ldg(T + 6), z,
                            fmaf(__ldg(T + 5), y, __ldg(T + 4) * x)) +
                       __ldg(T + 7);
      float xn = __fdiv_rn(px, pz), yn = __fdiv_rn(py, pz);
      // one model per camera, so a warp (inside one camera unless it
      // straddles two) takes one branch
      const int m = model_ids ? __ldg(model_ids + c) : model;
      if (m == BROWN_CONRADY) distort(xn, yn, coeffs + 5 * c);
      else if (m == INVERSE_BROWN_CONRADY) undistort(xn, yn, coeffs + 5 * c);
      const float u = rintf(fmaf(xn, __ldg(fx + c), __ldg(ppx + c)));
      const float v = rintf(fmaf(yn, __ldg(fy + c), __ldg(ppy + c)));
      // compared as floats: an int conversion of an out-of-range u is
      // undefined in C, and the float test says the same for every u
      if (u >= 0.0f && u < (float)wc && v >= 0.0f && v < (float)hc) {
        const uint8_t* px8 = color + ((long long)c * hc + (int)v) * wc * 3 +
                             (long long)(int)u * 3;
        r = (float)__ldg(px8);
        g = (float)__ldg(px8 + 1);
        b = (float)__ldg(px8 + 2);
      }
    }
  }
  rgb[3 * i] = r;
  rgb[3 * i + 1] = g;
  rgb[3 * i + 2] = b;
}

}  // namespace

// xyz [ncam, n, 3] f32; mask [ncam, n] u8; color [ncam, hc, wc, 3] u8;
// ext [ncam, 4, 4] f32 (row major, depth -> colour); fx, fy, ppx, ppy
// [ncam] f32; coeffs [ncam, 5] f32 (k1, k2, p1, p2, k3); model_ids
// [ncam] i32 or null, then model for every camera (0 none, 1 Brown-Conrady,
// 2 inverse Brown-Conrady); rgb [ncam, n, 3] f32 (every element written).
extern "C" int pcs_map_color(const float* xyz, const uint8_t* mask,
                             const uint8_t* color, const float* ext,
                             const float* fx, const float* fy,
                             const float* ppx, const float* ppy,
                             const float* coeffs, const int* model_ids,
                             int model, int ncam,
                             long long n, int hc, int wc, float* rgb,
                             void* stream) {
  if (ncam < 0 || n < 0 || hc < 1 || wc < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)ncam * n;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + THREADS - 1) / THREADS;
  map_color_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      xyz, mask, color, ext, fx, fy, ppx, ppy, coeffs, model_ids, model, n,
      total, hc, wc, rgb);
  return (int)cudaGetLastError();
}
