// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces dgtd_tpu/ops/msda.py::ms_deform_attn_pallas_fwd (the Pallas
// kernel _msda_level_kernel, one launch per level). One launch here covers
// every level:
//
//   out[n, q, m*D + d] = sum_{l, p} aw[n, q, m, l, p] *
//       bilinear(value[n, start_l : start_l + H_l*W_l, m, d],
//                x = loc[n, q, m, l, p, 0] * W_l - 0.5,
//                y = loc[n, q, m, l, p, 1] * H_l - 0.5)
//
// with F.grid_sample(align_corners=False, padding_mode='zeros') semantics:
// x0 = floor(x), y0 = floor(y), the four corners weighted by the fractional
// parts, and a corner outside the level contributes 0. value is (N, S, M, D)
// in fp32 or bf16; loc (N, Lq, M, L, P, 2) and aw (N, Lq, M, L, P) are fp32
// (the caller upcasts them, so the fractions are fp32 even for bf16
// callers); the sum is fp32 FMA (no TF32) and the output, (N, Lq, M*D), is
// stored in value's dtype.
//
// What bounds it on this card: bytes. At Deformable DETR's encoder shape
// (N2 M8 D32 P4, levels 64²/32²/16²/8², Lq = S = 5440) it reads value, loc
// and aw once and writes out once, ~39 MB in fp32, against ~0.36 GFLOP of
// corner FMAs: far below the fp32 ridge.
//
// The design is the reference CUDA im2col's gather (ms_deform_im2col_cuda.cuh),
// not the TPU's one-hot matmul: one thread per output element (n, q, m, d),
// looping over the L*P samples. Consecutive threads take consecutive d, so
// the reads of each corner's D values are coalesced and the sample's
// location and weight are one broadcast load per warp. D is any width.

#include "msda_common.cuh"

namespace {

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                const float* __restrict__ aw, T* __restrict__ out, Levels lv,
                                int64_t n_out, int64_t s_len, int lq, int m, int d, int n_levels,
                                int n_points) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int c = (int)(idx % d);
  const int64_t nqm = idx / d;  // (n * Lq + q) * M + mi
  const int mi = (int)(nqm % m);
  const int64_t n = nqm / ((int64_t)lq * m);
  const int64_t md = (int64_t)m * d;
  const T* vbase = value + n * s_len * md + (int64_t)mi * d + c;
  const float* lp = loc + nqm * n_levels * n_points * 2;
  const float* ap = aw + nqm * n_levels * n_points;
  float acc = 0.f;
  for (int l = 0; l < n_levels; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const T* vl = vbase + lv.start[l] * md;
    for (int p = 0; p < n_points; ++p) {
      const int sp = l * n_points + p;
      const float x = src_coord(lp[2 * sp], w);
      const float y = src_coord(lp[2 * sp + 1], h);
      const float a = ap[sp];
      const float xf = floorf(x), yf = floorf(y);
      const float fx = x - xf, fy = y - yf;
      const int x0 = (int)xf, y0 = (int)yf;
      float s = 0.f;
      if (y0 >= 0 && y0 < h) {
        if (x0 >= 0 && x0 < w) s = fmaf((1.f - fx) * (1.f - fy), load_f(vl + ((int64_t)y0 * w + x0) * md), s);
        if (x0 + 1 >= 0 && x0 + 1 < w) s = fmaf(fx * (1.f - fy), load_f(vl + ((int64_t)y0 * w + x0 + 1) * md), s);
      }
      if (y0 + 1 >= 0 && y0 + 1 < h) {
        if (x0 >= 0 && x0 < w) s = fmaf((1.f - fx) * fy, load_f(vl + ((int64_t)(y0 + 1) * w + x0) * md), s);
        if (x0 + 1 >= 0 && x0 + 1 < w) s = fmaf(fx * fy, load_f(vl + ((int64_t)(y0 + 1) * w + x0 + 1) * md), s);
      }
      acc = fmaf(a, s, acc);
    }
  }
  store_f(out + idx, acc);
}

}  // namespace

// shapes: host array of n_levels (H, W) pairs; levels start at the running
// sum of H*W along S. dtype: 0 = float32, 1 = bfloat16 (value and out);
// device: the CUDA ordinal of the tensors and of the stream. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dgtd_msda_fwd(const void* value, const float* loc, const float* aw, void* out,
                             const int* shapes, int n_levels, int n, long long s_len, int lq,
                             int m, int d, int n_points, int dtype, int device, void* stream) {
  // this library carries its own CUDA runtime: make the tensors' device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  err = make_levels(shapes, n_levels, s_len, &lv);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_out = (int64_t)n * lq * m * d;
  if (n_out <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_fwd_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(value), loc, aw, static_cast<float*>(out), lv, n_out, s_len, lq, m,
        d, n_levels, n_points);
  } else if (dtype == 1) {
    msda_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(value), loc, aw, static_cast<__nv_bfloat16*>(out), lv,
        n_out, s_len, lq, m, d, n_levels, n_points);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
