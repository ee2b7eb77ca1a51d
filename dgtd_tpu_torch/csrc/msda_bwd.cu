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
// out-of-range corners read as 0, as grid_sample's zero padding does. value
// is read as fp32. s, ds/dx and ds/dy are linear in the four corners, so
// the three channel sums follow from the four dot products
// G_c = sum_d g * corner_c (the form autograd of the plain version takes,
// through each corner's weight). It runs on the forward's plan
// (msda_common.cuh): a block stages its head's small levels in shared
// memory, and one warp takes one (n, q, m) at a time; lane i loads and
// locates sample i and hands its corner row and level to the lanes that
// gather it. The warp holds the query-head's g row in registers (each lane
// its V channels, where the row fits the lanes of a group), forms each
// sample's four dot products over the lane's channels and then over the
// group's lanes (3 shuffle levels at D = 32 fp32), and hands them back to
// lane i, which forms daw and dloc; the query-head's L*P weights and
// locations are stored in one coalesced 64-byte and one 128-byte store.
//
// Shared by both: value (N, S, M, D) and g (N, Lq, M*D) in fp32 or bf16 (one
// dtype), loc (N, Lq, M, L, P, 2) and aw (N, Lq, M, L, P) in fp32; dvalue,
// dloc and daw are fp32.
//
// What bounds them on this card: bytes. At the encoder shape (N2 M8 D32 P4,
// Lq = S = 5440) dvalue reads g, loc and aw and writes an 11 MB fp32 buffer
// (~39 MB in all, though 1.39M samples x 4 corners x 32 atomics go through
// L2); dlocw reads g, value, loc and aw (~39 MB) and writes 17 MB, while its
// gather reads ~640 MB of corner rows, 3/4 of them from the staged levels.

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

template <typename T, int V, typename Idx>
__global__ void __launch_bounds__(MSDA_THREADS, 1)
    msda_dlocw_kernel(const T* __restrict__ g, const T* __restrict__ value,
                      const float* __restrict__ loc, const float* __restrict__ aw,
                      float* __restrict__ dloc, float* __restrict__ daw, Levels lv, unsigned mask,
                      int64_t s_len, int lq, int m, int d, int n_levels, int n_points, int chunks) {
  extern __shared__ __align__(16) unsigned char msda_smem[];
  __shared__ LevelTab<T, Idx> tab;
  const int head = blockIdx.x / chunks, chunk = blockIdx.x - head * chunks;
  const int n = head / m, mi = head - n * m;
  const int per = (lq + chunks - 1) / chunks;
  const int q0 = chunk * per, q1 = min(lq, q0 + per);
  const int64_t md = (int64_t)m * d;
  stage_head<T, V, Idx>(tab, reinterpret_cast<T*>(msda_smem), value + (int64_t)n * s_len * md + (int64_t)mi * d,
                        lv, mask, n_levels, md, d);

  const int lp = n_levels * n_points;
  const int64_t row0 = ((int64_t)n * lq + q0) * m + mi;  // (n, q0, mi)
  const float* lbase = loc + row0 * lp * 2;
  const float* abase = aw + row0 * lp;
  const T* gbase = g + row0 * d;
  float* dlbase = dloc + row0 * lp * 2;
  float* dabase = daw + row0 * lp;
  const int nvec = d / V;
  const int lg = group_log2(nvec), G = 1 << lg, spp = 32 >> lg;
  const bool g_held = nvec <= G;  // the row fits a group: each lane holds its chunk
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), grp = lane >> lg;
  for (int q = q0 + (int)(threadIdx.x >> 5); q < q1; q += MSDA_THREADS / 32) {
    const Idx qs = (Idx)(q - q0) * (Idx)(m * lp);
    const float* ql = lbase + 2 * qs;
    const float* qa = abase + qs;
    const T* qg = gbase + (Idx)(q - q0) * (Idx)md;
    float gr[V];
    load_or_zero<T, V>(g_held && gl < nvec, qg + gl * V, gr);
    for (int b0 = 0; b0 < lp; b0 += 32) {
      // lane i locates sample b0 + i, and at the end takes the dot
      // products of g with its four corner rows
      const int nb = min(32, lp - b0);
      Sample sm{0, 0, 0.f, 0.f};
      float ma = 0.f;
      if (lane < nb) {
        const int l = (b0 + lane) / n_points;
        sm = locate(tab, l, src_coord(__ldg(ql + 2 * (b0 + lane)), tab.w[l]),
                    src_coord(__ldg(ql + 2 * (b0 + lane) + 1), tab.h[l]));
        ma = __ldg(qa + b0 + lane);
      }
      float r00 = 0.f, r01 = 0.f, r10 = 0.f, r11 = 0.f;
#pragma unroll 2  // two passes in flight
      for (int s0 = 0; s0 < nb; s0 += spp) {
        const int si = s0 + grp;  // this group's sample
        const int pix = __shfl_sync(MSDA_FULL, sm.pix, si);
        const int lb = __shfl_sync(MSDA_FULL, sm.lbits, si);
        // sum_d g * corner for the four corners (0 off the level)
        float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
        if (si < nb) {
          const Rows<T, Idx> r = rows_of(tab, pix, lb);
          for (int j = gl; j < nvec; j += G) {
            float gv[V];
            if (g_held) {
#pragma unroll
              for (int k = 0; k < V; ++k) gv[k] = gr[k];
            } else {
              load_chunk(qg + j * V, gv);
            }
            const T* p = r.p00 + j * V;
            float v00[V], v01[V], v10[V], v11[V];
            load_or_zero<T, V>(corner_in(lb, 0), p, v00);
            load_or_zero<T, V>(corner_in(lb, 1), p + r.sx, v01);
            load_or_zero<T, V>(corner_in(lb, 2), p + r.sy, v10);
            load_or_zero<T, V>(corner_in(lb, 3), p + r.sy + r.sx, v11);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              d00 = fmaf(gv[k], v00[k], d00);
              d01 = fmaf(gv[k], v01[k], d01);
              d10 = fmaf(gv[k], v10[k], d10);
              d11 = fmaf(gv[k], v11[k], d11);
            }
          }
        }
        // the group's lanes sum their channels; then lane s0 + k takes
        // group k's sums (sample s0 + k)
        for (int off = 1; off < G; off <<= 1) {
          d00 += __shfl_xor_sync(MSDA_FULL, d00, off);
          d01 += __shfl_xor_sync(MSDA_FULL, d01, off);
          d10 += __shfl_xor_sync(MSDA_FULL, d10, off);
          d11 += __shfl_xor_sync(MSDA_FULL, d11, off);
        }
        const int src = ((lane - s0) & (spp - 1)) << lg;
        const float t00 = __shfl_sync(MSDA_FULL, d00, src);
        const float t01 = __shfl_sync(MSDA_FULL, d01, src);
        const float t10 = __shfl_sync(MSDA_FULL, d10, src);
        const float t11 = __shfl_sync(MSDA_FULL, d11, src);
        if (lane >= s0 && lane < s0 + spp) {
          r00 = t00;
          r01 = t01;
          r10 = t10;
          r11 = t11;
        }
      }
      if (lane < nb) {
        // s, ds/dx and ds/dy are linear in the corners: their sums with g
        // follow from the four dot products
        const float fx = sm.fx, fy = sm.fy;
        const int l = sm.lbits & 0xff;
        const float sw = (1.f - fy) * ((1.f - fx) * r00 + fx * r01) + fy * ((1.f - fx) * r10 + fx * r11);
        const float sx = (1.f - fy) * (r01 - r00) + fy * (r11 - r10);
        const float sy = (1.f - fx) * (r10 - r00) + fx * (r11 - r01);
        dabase[qs + b0 + lane] = sw;
        reinterpret_cast<float2*>(dlbase + 2 * qs)[b0 + lane] =
            make_float2(ma * sx * tab.w[l], ma * sy * tab.h[l]);
      }
    }
  }
}

template <typename T, int V, typename Idx>
cudaError_t launch_dlocw(const void* g, const void* value, const float* loc, const float* aw,
                         float* dloc, float* daw, const Levels& lv, unsigned mask, int smem, int n,
                         long long s_len, int lq, int m, int d, int n_levels, int n_points,
                         int chunks, int device, cudaStream_t stream) {
  auto kernel = msda_dlocw_kernel<T, V, Idx>;
  // the stage plus the level table may pass the default 48 KB: lift the
  // kernel's limit once per device
  static bool raised[64] = {};
  if (smem > 0 && device < 64 && !raised[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MSDA_SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const long long blocks = (long long)n * m * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MSDA_THREADS, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(value), loc, aw, dloc, daw, lv, mask, s_len, lq,
      m, d, n_levels, n_points, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dlocw(int vec, int wide, const void* g, const void* value, const float* loc,
                           const float* aw, float* dloc, float* daw, const Levels& lv,
                           unsigned mask, int smem, int n, long long s_len, int lq, int m, int d,
                           int n_levels, int n_points, int chunks, int device,
                           cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  if (vec == VW)
    return wide ? launch_dlocw<T, VW, int64_t>(g, value, loc, aw, dloc, daw, lv, mask, smem, n, s_len,
                                               lq, m, d, n_levels, n_points, chunks, device, stream)
                : launch_dlocw<T, VW, int>(g, value, loc, aw, dloc, daw, lv, mask, smem, n, s_len, lq,
                                           m, d, n_levels, n_points, chunks, device, stream);
  return wide ? launch_dlocw<T, 1, int64_t>(g, value, loc, aw, dloc, daw, lv, mask, smem, n, s_len,
                                            lq, m, d, n_levels, n_points, chunks, device, stream)
              : launch_dlocw<T, 1, int>(g, value, loc, aw, dloc, daw, lv, mask, smem, n, s_len, lq, m,
                                        d, n_levels, n_points, chunks, device, stream);
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

// The plan's mask, vec, wide and chunks as for dgtd_msda_fwd (one plan
// serves both kernels); cudaErrorInvalidValue for a plan that does not fit
// the call.
extern "C" int dgtd_msda_dlocw(const void* g, const void* value, const float* loc,
                               const float* aw, float* dloc, float* daw, const int* shapes,
                               int n_levels, int n, long long s_len, int lq, int m, int d,
                               int n_points, int dtype, int device, void* stream, unsigned mask,
                               int vec, int wide, int chunks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  err = make_levels(shapes, n_levels, s_len, &lv);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((long long)n * lq * m <= 0 || n_points <= 0 || d <= 0) return (int)cudaSuccess;
  const int elt = dtype == 0 ? 4 : 2;
  const long long smem = plan_smem(lv, n_levels, mask, d, elt);
  const void* vec_ptrs[2] = {value, g};
  if (smem < 0 || !plan_fits(vec, wide, chunks, elt, d, s_len, lq, m, n_levels * n_points, vec_ptrs, 2) ||
      reinterpret_cast<uintptr_t>(dloc) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_dlocw<float>(vec, wide, g, value, loc, aw, dloc, daw, lv, mask, (int)smem, n, s_len,
                                lq, m, d, n_levels, n_points, chunks, device, s);
  else
    err = dispatch_dlocw<__nv_bfloat16>(vec, wide, g, value, loc, aw, dloc, daw, lv, mask, (int)smem, n,
                                        s_len, lq, m, d, n_levels, n_points, chunks, device, s);
  return (int)err;
}
