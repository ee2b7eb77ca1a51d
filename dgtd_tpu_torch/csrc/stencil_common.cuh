// Shared by diffusion_stencil.cu and diffusion_stencil_bwd.cu: element loads
// and stores in fp32 or bf16, and the limit of the fused (all steps in one
// launch) kernels, which ops/diffusion.py::fused_path mirrors.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
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
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
// v rounded to T and back: the value a step stores in its tensors' dtype
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The fused kernels run one block per plane and one thread per pixel, with k
// a template argument (1, 3, 5 or 7) so that a pixel's k*k weights or dw
// sums are registers. 512 threads leave each thread 128 registers, room for
// the backward's 49 dw sums without spilling.
constexpr int FUSED_MAX_PIXELS = 512;
// a block's dynamic shared memory on Hopper (227 KB), above 48 KB only after
// cudaFuncSetAttribute
constexpr size_t FUSED_SMEM_LIMIT = 232448;
constexpr size_t STATIC_SMEM_LIMIT = 49152;

// Shared memory of the fused backward, the larger of the two fused kernels:
// three padded fp32 planes (the gradient's ping-pong pair and the step
// input) and the k*k weight planes in their own dtype. Within the pixel
// limit it is at most 144 KB (a 1 x 512 plane at k = 7 in fp32), so the
// thread count binds first.
inline size_t fused_bwd_smem(int h, int wd, int k, int elem_bytes) {
  const int r = k / 2;
  return 3 * sizeof(float) * (size_t)(h + 2 * r) * (size_t)(wd + 2 * r) +
         (size_t)k * k * (size_t)h * wd * elem_bytes;
}

inline bool fused_fits(int h, int wd, int k, int elem_bytes) {
  return (k == 1 || k == 3 || k == 5 || k == 7) && h > 0 && wd > 0 &&
         (int64_t)h * wd <= FUSED_MAX_PIXELS && fused_bwd_smem(h, wd, k, elem_bytes) <= FUSED_SMEM_LIMIT;
}

}  // namespace
