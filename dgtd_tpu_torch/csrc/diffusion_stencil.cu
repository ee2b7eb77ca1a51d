// Depth-diffusion stencil step for Hopper (sm_90a), plane layout.
//
// Replaces dgtd_tpu/ops/diffusion_pallas.py::diffusion_step_pallas_v2
// (the Pallas kernel _stencil_kernel_v2). One step computes
//
//   out[p, y, x] = sum_{t < k*k} x[p, y + t/k - r, x + t%k - r] * w[p, t, y, x]
//
// with a zero halo (r = k/2), fp32 accumulation, and the result stored in
// x's dtype (fp32 or bf16). x is (P, H, W); w is (P, k*k, H, W), contiguous.
//
// What bounds it on this card: bytes and launches. Each step reads the k*k
// weight planes once (k*k*P*H*W values) and does 2 flops per weight value,
// far below the ~20 flop/byte ridge of the fp32 CUDA cores. At the served
// shape (P = 8*24 planes of 12x12, k = 7) a step moves ~2.7 MB in bf16,
// under a microsecond of DRAM time that the 50 MB L2 mostly absorbs, so the
// launch itself sets the time.
//
// The design is the simple one: one thread per output pixel, one launch per
// step (the caller ping-pongs two buffers). Consecutive threads take
// consecutive x of one row, so the reads of w[p, t, y, :] and of x are
// coalesced; taps that fall outside the plane are skipped (the halo is
// zero), which also masks ragged and rectangular H x W. No shared memory:
// the k*k neighbourhood reads of x hit L1.

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

template <typename T>
__global__ void stencil_step_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                    T* __restrict__ out, int64_t planes, int h, int wd,
                                    int k) {
  const int64_t hw = (int64_t)h * wd;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= planes * hw) return;
  const int64_t p = idx / hw;
  const int64_t pix = idx - p * hw;
  const int y = (int)(pix / wd);
  const int xx = (int)(pix - (int64_t)y * wd);
  const int r = k / 2;
  const T* xp = x + p * hw;
  const T* wp = w + p * (int64_t)k * k * hw + pix;
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - r;
    if (sy < 0 || sy >= h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int sx = xx + dx - r;
      if (sx < 0 || sx >= wd) continue;
      const int t = dy * k + dx;
      acc = fmaf(load_f(xp + (int64_t)sy * wd + sx), load_f(wp + (int64_t)t * hw), acc);
    }
  }
  store_f(out + idx, acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the tensors
// and of the stream. Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int dgtd_diffusion_step(const void* x, const void* w, void* out, long long planes,
                                   int h, int wd, int k, int dtype, int device, void* stream) {
  // this library carries its own CUDA runtime: make the tensors' device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)planes * h * wd;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    stencil_step_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
        planes, h, wd, k);
  } else if (dtype == 1) {
    stencil_step_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), planes, h, wd, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
