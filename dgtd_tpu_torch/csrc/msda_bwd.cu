// Multi-scale deformable attention backward for Hopper (sm_90a): two
// kernels, one launch each per backward call, every level in one launch.
//
// msda_dvalue_kernel replaces dgtd_tpu/ops/msda.py::ms_deform_attn_pallas_dvalue
// (the Pallas kernel _msda_dvalue_kernel): the scatter-add
//
//   dvalue[n, start_l + yc*W_l + xc, m, d] += g[n, q, m*D + d] * aw * w_corner
//
// over every in-range corner of every sample, into an fp32 buffer that the
// caller zeroes and, for a bf16 value, rounds to bf16 once at the end. One
// thread per (n, q, m, d), looping over the L*P samples, with atomicAdd (the
// reference CUDA col2im's approach); consecutive d hit consecutive
// addresses. The summation order is not fixed, so the result is not
// bit-reproducible.
//
// msda_dlocw_kernel replaces ms_deform_attn_pallas_dlocw (the Pallas kernel
// _msda_dlocw_kernel): for each sample (n, q, m, l, p), with s the bilinear
// sample of value and g the output gradient,
//
//   daw          = sum_d s * g
//   dloc[..., 0] = aw * sum_d (ds/dx) * g * W_l
//   dloc[..., 1] = aw * sum_d (ds/dy) * g * H_l
//
// where ds/dx uses the derivative of floor's fractional weight
// (d cx / dx = 1[x0 + 1] - 1[x0], the right-hand derivative at integer x) and
// out-of-range corners read as 0, as grid_sample's zero padding does. One
// warp per sample: the lanes stride over d, accumulate the three sums in
// fp32, and reduce with shuffles; lane 0 writes the sample's three numbers.
// value is read as fp32.
//
// Shared by both: value (N, S, M, D) and g (N, Lq, M*D) in fp32 or bf16 (one
// dtype), loc (N, Lq, M, L, P, 2) and aw (N, Lq, M, L, P) in fp32; dvalue,
// dloc and daw are fp32.
//
// What bounds them on this card: bytes. At the encoder shape (N2 M8 D32 P4,
// Lq = S = 5440) dvalue reads g, loc and aw and writes an 11 MB fp32 buffer
// (~39 MB in all, though 1.39M samples x 4 corners x 32 atomics go through
// L2); dlocw reads g, value, loc and aw (~39 MB) and writes 17 MB.

#include "msda_common.cuh"

namespace {

template <typename T>
__global__ void msda_dvalue_kernel(const T* __restrict__ g, const float* __restrict__ loc,
                                   const float* __restrict__ aw, float* __restrict__ dvalue,
                                   Levels lv, int64_t n_out, int64_t s_len, int lq, int m, int d,
                                   int n_levels, int n_points) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int c = (int)(idx % d);
  const int64_t nqm = idx / d;
  const int mi = (int)(nqm % m);
  const int64_t n = nqm / ((int64_t)lq * m);
  const int64_t md = (int64_t)m * d;
  float* dbase = dvalue + n * s_len * md + (int64_t)mi * d + c;
  const float* lp = loc + nqm * n_levels * n_points * 2;
  const float* ap = aw + nqm * n_levels * n_points;
  const float gv = load_f(g + idx);
  for (int l = 0; l < n_levels; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    float* dl = dbase + lv.start[l] * md;
    for (int p = 0; p < n_points; ++p) {
      const int sp = l * n_points + p;
      const float x = src_coord(lp[2 * sp], w);
      const float y = src_coord(lp[2 * sp + 1], h);
      const float ga = gv * ap[sp];
      const float xf = floorf(x), yf = floorf(y);
      const float fx = x - xf, fy = y - yf;
      const int x0 = (int)xf, y0 = (int)yf;
      if (y0 >= 0 && y0 < h) {
        if (x0 >= 0 && x0 < w) atomicAdd(dl + ((int64_t)y0 * w + x0) * md, ga * ((1.f - fx) * (1.f - fy)));
        if (x0 + 1 >= 0 && x0 + 1 < w) atomicAdd(dl + ((int64_t)y0 * w + x0 + 1) * md, ga * (fx * (1.f - fy)));
      }
      if (y0 + 1 >= 0 && y0 + 1 < h) {
        if (x0 >= 0 && x0 < w) atomicAdd(dl + ((int64_t)(y0 + 1) * w + x0) * md, ga * ((1.f - fx) * fy));
        if (x0 + 1 >= 0 && x0 + 1 < w) atomicAdd(dl + ((int64_t)(y0 + 1) * w + x0 + 1) * md, ga * (fx * fy));
      }
    }
  }
}

template <typename T>
__global__ void msda_dlocw_kernel(const T* __restrict__ g, const T* __restrict__ value,
                                  const float* __restrict__ loc, const float* __restrict__ aw,
                                  float* __restrict__ dloc, float* __restrict__ daw, Levels lv,
                                  int64_t n_samples, int64_t s_len, int lq, int m, int d,
                                  int n_levels, int n_points) {
  const int lane = threadIdx.x & 31;
  const int64_t sidx = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (sidx >= n_samples) return;  // whole warps leave together
  const int lp_count = n_levels * n_points;
  const int64_t nqm = sidx / lp_count;
  const int sp = (int)(sidx - nqm * lp_count);
  const int l = sp / n_points;
  const int mi = (int)(nqm % m);
  const int64_t n = nqm / ((int64_t)lq * m);
  const int64_t md = (int64_t)m * d;
  const int h = lv.h[l], w = lv.w[l];
  const T* vl = value + (n * s_len + lv.start[l]) * md + (int64_t)mi * d;
  const T* gp = g + nqm * d;
  const float x = src_coord(loc[2 * sidx], w);
  const float y = src_coord(loc[2 * sidx + 1], h);
  const float a = aw[sidx];
  const float xf = floorf(x), yf = floorf(y);
  const float fx = x - xf, fy = y - yf;
  const int x0 = (int)xf, y0 = (int)yf;
  const bool in_y0 = y0 >= 0 && y0 < h, in_y1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool in_x0 = x0 >= 0 && x0 < w, in_x1 = x0 + 1 >= 0 && x0 + 1 < w;
  const int64_t o00 = ((int64_t)y0 * w + x0) * md;
  const int64_t o01 = o00 + md;                   // (x0 + 1, y0)
  const int64_t o10 = o00 + (int64_t)w * md;      // (x0, y0 + 1)
  const int64_t o11 = o10 + md;                   // (x0 + 1, y0 + 1)
  float acc_w = 0.f, acc_x = 0.f, acc_y = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v00 = (in_y0 && in_x0) ? load_f(vl + o00 + c) : 0.f;
    const float v01 = (in_y0 && in_x1) ? load_f(vl + o01 + c) : 0.f;
    const float v10 = (in_y1 && in_x0) ? load_f(vl + o10 + c) : 0.f;
    const float v11 = (in_y1 && in_x1) ? load_f(vl + o11 + c) : 0.f;
    const float gv = load_f(gp + c);
    const float s = (1.f - fy) * ((1.f - fx) * v00 + fx * v01) + fy * ((1.f - fx) * v10 + fx * v11);
    const float sx = (1.f - fy) * (v01 - v00) + fy * (v11 - v10);
    const float sy = (1.f - fx) * (v10 - v00) + fx * (v11 - v01);
    acc_w = fmaf(s, gv, acc_w);
    acc_x = fmaf(sx, gv, acc_x);
    acc_y = fmaf(sy, gv, acc_y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc_w += __shfl_xor_sync(0xffffffffu, acc_w, off);
    acc_x += __shfl_xor_sync(0xffffffffu, acc_x, off);
    acc_y += __shfl_xor_sync(0xffffffffu, acc_y, off);
  }
  if (lane == 0) {
    daw[sidx] = acc_w;
    dloc[2 * sidx] = a * acc_x * w;
    dloc[2 * sidx + 1] = a * acc_y * h;
  }
}

}  // namespace

// shapes: host array of n_levels (H, W) pairs. dtype: 0 = float32,
// 1 = bfloat16 (g and value). dvalue must be zeroed by the caller. device:
// the CUDA ordinal of the tensors and of the stream. Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int dgtd_msda_dvalue(const void* g, const float* loc, const float* aw, float* dvalue,
                                const int* shapes, int n_levels, int n, long long s_len, int lq,
                                int m, int d, int n_points, int dtype, int device, void* stream) {
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
    msda_dvalue_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(g), loc, aw, dvalue, lv, n_out, s_len, lq, m, d, n_levels,
        n_points);
  } else if (dtype == 1) {
    msda_dvalue_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), loc, aw, dvalue, lv, n_out, s_len, lq, m, d,
        n_levels, n_points);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int dgtd_msda_dlocw(const void* g, const void* value, const float* loc,
                               const float* aw, float* dloc, float* daw, const int* shapes,
                               int n_levels, int n, long long s_len, int lq, int m, int d,
                               int n_points, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  err = make_levels(shapes, n_levels, s_len, &lv);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_samples = (int64_t)n * lq * m * n_levels * n_points;
  if (n_samples <= 0 || d <= 0) return (int)cudaSuccess;
  const int threads = 256;  // 8 samples per block, one warp each
  const int64_t blocks = (n_samples * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    msda_dlocw_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(value), loc, aw, dloc, daw, lv,
        n_samples, s_len, lq, m, d, n_levels, n_points);
  } else if (dtype == 1) {
    msda_dlocw_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(value), loc, aw,
        dloc, daw, lv, n_samples, s_len, lq, m, d, n_levels, n_points);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
