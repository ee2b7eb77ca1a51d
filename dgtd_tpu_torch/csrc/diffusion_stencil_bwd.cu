// Backward of one depth-diffusion stencil step for Hopper (sm_90a), plane
// layout.
//
// Replaces dgtd_tpu/ops/diffusion_pallas.py::diffusion_step_bwd_pallas, whose
// two Pallas kernels are fused here into one launch per step:
//   _stencil_bwd_x_kernel (transpose stencil)
//     dx[p, q] = sum_t g[p, q - o_t] * w[p, t, q - o_t]
//   _stencil_bwd_w_kernel (per-tap product)
//     dw[p, t, q] = g[p, q] * x[p, q + o_t]
// with o_t = (t/k - r, t%k - r), r = k/2, and every tap that falls outside
// the plane skipped (the forward's halo is zero). x is the step's input
// (P, H, W), g the gradient of its output (P, H, W), w the normalized weights
// (P, k*k, H, W); all contiguous, fp32 or bf16, fp32 accumulation.
//
// The caller chains the steps in reverse. dw is summed over the steps in fp32:
// a step adds dw_in (fp32, may be null for the first step of the chain) to its
// own product and writes dw_out, in fp32 for every step but the last and in
// the weights' dtype for the last, so bf16 weights round once. In fp32 dw_in
// and dw_out may be the same buffer: each thread reads its element before it
// writes it.
//
// What bounds it on this card: bytes. Each step reads w and writes dw once
// (2 k*k values per pixel) and reads and writes an fp32 dw sum in between
// steps; it does about 4 flops per tap, far below the fp32 ridge. At the
// train shape (P = 10*24 planes of 12x12, k = 7) one step moves a few MB that
// the 50 MB L2 holds, so launches set the time.
//
// The design is the simple one: one thread per (plane, pixel), which gathers
// dx (no atomics) and writes its k*k dw taps. Consecutive threads take
// consecutive x of one row, so the reads of g, w[p, t, ...] and the writes of
// dw[p, t, ...] are coalesced; the neighbourhood reads hit L1. Ragged and
// rectangular H x W need no padding: out-of-plane taps are bounds-checked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename TO>
__global__ void stencil_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                   const T* __restrict__ w, T* __restrict__ dx,
                                   const float* dw_in, TO* dw_out, int64_t planes, int h,
                                   int wd, int k) {
  const int64_t hw = (int64_t)h * wd;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= planes * hw) return;
  const int64_t p = idx / hw;
  const int64_t pix = idx - p * hw;
  const int y = (int)(pix / wd);
  const int xx = (int)(pix - (int64_t)y * wd);
  const int r = k / 2;
  const int64_t kk = (int64_t)k * k;
  const T* gp = g + p * hw;
  const T* xp = x + p * hw;
  const T* wp = w + p * kk * hw;
  const float gq = load_f(gp + pix);
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int oy = dy - r;
    const int sy = y - oy;  // transpose tap (dx)
    const int fy = y + oy;  // forward tap (dw)
    for (int ddx = 0; ddx < k; ++ddx) {
      const int ox = ddx - r;
      const int t = dy * k + ddx;
      const int sx = xx - ox;
      if (sy >= 0 && sy < h && sx >= 0 && sx < wd) {
        const int64_t s = (int64_t)sy * wd + sx;
        acc = fmaf(load_f(gp + s), load_f(wp + (int64_t)t * hw + s), acc);
      }
      const int fx = xx + ox;
      float v = 0.f;
      if (fy >= 0 && fy < h && fx >= 0 && fx < wd) v = gq * load_f(xp + (int64_t)fy * wd + fx);
      const int64_t o = (p * kk + t) * hw + pix;
      if (dw_in != nullptr) v += dw_in[o];
      store_f(dw_out + o, v);
    }
  }
  store_f(dx + idx, acc);
}

template <typename T, typename TO>
cudaError_t launch(const void* g, const void* x, const void* w, void* dx, const float* dw_in,
                   void* dw_out, int64_t planes, int h, int wd, int k, cudaStream_t s) {
  const int threads = 256;
  const int64_t blocks = (planes * h * wd + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stencil_bwd_kernel<T, TO><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(dx), dw_in, static_cast<TO*>(dw_out), planes, h, wd, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x, w, dx); dw_dtype: 0 = float32,
// 1 = bfloat16 (dw_out; bf16 only with bf16 inputs). dw_in is fp32 or null.
// device: the CUDA ordinal of the tensors and of the stream. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dgtd_diffusion_step_bwd(const void* g, const void* x, const void* w, void* dx,
                                       const float* dw_in, void* dw_out, long long planes,
                                       int h, int wd, int k, int dtype, int dw_dtype,
                                       int device, void* stream) {
  // this library carries its own CUDA runtime: make the tensors' device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)planes * h * wd <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dw_dtype == 0) {
    err = launch<float, float>(g, x, w, dx, dw_in, dw_out, planes, h, wd, k, s);
  } else if (dtype == 1 && dw_dtype == 0) {
    err = launch<__nv_bfloat16, float>(g, x, w, dx, dw_in, dw_out, planes, h, wd, k, s);
  } else if (dtype == 1 && dw_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, x, w, dx, dw_in, dw_out, planes, h, wd, k, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
