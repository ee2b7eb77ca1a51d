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
// callers); each corner's weight is (x weight * y weight) * aw, as the
// plain version forms it, the sum is fp32 FMA (no TF32) and the output,
// (N, Lq, M*D), is stored in value's dtype, rounded once.
//
// What bounds it on this card: the gather. At Deformable DETR's encoder
// shape (N2 M8 D32 P4, levels 64²/32²/16²/8², Lq = S = 5440) the inputs and
// the output are ~39 MB, but the 1.39M samples read 4 corner rows of 128
// bytes each: ~640 MB of rows, 16x the tensors' bytes, against ~0.36 GFLOP
// of corner FMAs. The design keeps most of those rows off L2:
//   * a block owns one (n, m) head and a chunk of its queries, and first
//     copies the head's rows of the levels that fit shared memory (the
//     plan's mask: at the encoder shape the three small levels, 168 KiB in
//     fp32, 84 KiB in bf16, 3/4 of the samples); the other levels' corners
//     come from L2;
//   * one warp per (n, q, m): lane i loads sample i's location and weight
//     (the query-head's L*P of them once, coalesced), locates it and forms
//     its four corner weights, and hands them with the sample's corner row
//     and level to the lanes that gather it, by shuffle; a lane loads 16
//     bytes of a corner row (vector route) or one element (scalar route:
//     odd widths, a misaligned base), so at D = 32 fp32 eight lanes cover a
//     row and the warp works on four samples at once; the groups' sums meet
//     in shuffles and the row is stored by one group, coalesced.
// See msda_common.cuh for the shared stage and sample geometry.

#include "msda_common.cuh"

namespace {

__device__ __forceinline__ void store_chunk(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_chunk(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename T, int V, typename Idx>
__global__ void __launch_bounds__(MSDA_THREADS, 1)
    msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ aw, T* __restrict__ out, Levels lv, unsigned mask,
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
  T* obase = out + row0 * d;
  const int nvec = d / V;
  const int lg = group_log2(nvec), G = 1 << lg, spp = 32 >> lg;
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), grp = lane >> lg;
  for (int q = q0 + (int)(threadIdx.x >> 5); q < q1; q += MSDA_THREADS / 32) {
    const Idx qs = (Idx)(q - q0) * (Idx)(m * lp);  // the query-head's first sample in the block
    const float* ql = lbase + 2 * qs;
    const float* qa = abase + qs;
    T* qo = obase + (Idx)(q - q0) * (Idx)md;
    for (int c0 = 0; c0 < nvec; c0 += G) {
      const int j = c0 + gl;
      const bool act = j < nvec;
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      for (int b0 = 0; b0 < lp; b0 += 32) {
        // lane i locates sample b0 + i and forms its four corner weights
        // (x weight * y weight * aw, as the plain version forms them; 0 off
        // the level)
        const int nb = min(32, lp - b0);
        float mw00 = 0.f, mw01 = 0.f, mw10 = 0.f, mw11 = 0.f;
        int mpix = 0, mlb = 0;
        if (lane < nb) {
          const int l = (b0 + lane) / n_points;
          const Sample sm = locate(tab, l, src_coord(__ldg(ql + 2 * (b0 + lane)), tab.w[l]),
                                   src_coord(__ldg(ql + 2 * (b0 + lane) + 1), tab.h[l]));
          const float a = __ldg(qa + b0 + lane);
          mw00 = corner_in(sm.lbits, 0) ? (1.f - sm.fx) * (1.f - sm.fy) * a : 0.f;
          mw01 = corner_in(sm.lbits, 1) ? sm.fx * (1.f - sm.fy) * a : 0.f;
          mw10 = corner_in(sm.lbits, 2) ? (1.f - sm.fx) * sm.fy * a : 0.f;
          mw11 = corner_in(sm.lbits, 3) ? sm.fx * sm.fy * a : 0.f;
          mpix = sm.pix;
          mlb = sm.lbits;
        }
#pragma unroll 2  // two passes in flight
        for (int s0 = 0; s0 < nb; s0 += spp) {
          const int si = s0 + grp;  // this group's sample
          const float w00 = __shfl_sync(MSDA_FULL, mw00, si);
          const float w01 = __shfl_sync(MSDA_FULL, mw01, si);
          const float w10 = __shfl_sync(MSDA_FULL, mw10, si);
          const float w11 = __shfl_sync(MSDA_FULL, mw11, si);
          const int pix = __shfl_sync(MSDA_FULL, mpix, si);
          const int lb = __shfl_sync(MSDA_FULL, mlb, si);
          if (act && si < nb) {
            const Rows<T, Idx> r = rows_of(tab, pix, lb);
            const T* p = r.p00 + j * V;
            float v00[V], v01[V], v10[V], v11[V];
            load_or_zero<T, V>(corner_in(lb, 0), p, v00);
            load_or_zero<T, V>(corner_in(lb, 1), p + r.sx, v01);
            load_or_zero<T, V>(corner_in(lb, 2), p + r.sy, v10);
            load_or_zero<T, V>(corner_in(lb, 3), p + r.sy + r.sx, v11);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              acc[k] = fmaf(w00, v00[k], acc[k]);
              acc[k] = fmaf(w01, v01[k], acc[k]);
              acc[k] = fmaf(w10, v10[k], acc[k]);
              acc[k] = fmaf(w11, v11[k], acc[k]);
            }
          }
        }
      }
      // the groups' partial sums (samples s0 + grp) meet in group 0
      for (int off = G; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += __shfl_xor_sync(MSDA_FULL, acc[k], off);
      }
      if (grp == 0 && act) store_chunk(qo + j * V, acc);
    }
  }
}

template <typename T, int V, typename Idx>
cudaError_t launch_fwd(const void* value, const float* loc, const float* aw, void* out,
                       const Levels& lv, unsigned mask, int smem, int n, long long s_len, int lq,
                       int m, int d, int n_levels, int n_points, int chunks, int device,
                       cudaStream_t stream) {
  auto kernel = msda_fwd_kernel<T, V, Idx>;
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
      static_cast<const T*>(value), loc, aw, static_cast<T*>(out), lv, mask, s_len, lq, m, d, n_levels,
      n_points, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(int vec, int wide, const void* value, const float* loc, const float* aw,
                         void* out, const Levels& lv, unsigned mask, int smem, int n,
                         long long s_len, int lq, int m, int d, int n_levels, int n_points,
                         int chunks, int device, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  if (vec == VW)
    return wide ? launch_fwd<T, VW, int64_t>(value, loc, aw, out, lv, mask, smem, n, s_len, lq, m, d,
                                             n_levels, n_points, chunks, device, stream)
                : launch_fwd<T, VW, int>(value, loc, aw, out, lv, mask, smem, n, s_len, lq, m, d,
                                         n_levels, n_points, chunks, device, stream);
  return wide ? launch_fwd<T, 1, int64_t>(value, loc, aw, out, lv, mask, smem, n, s_len, lq, m, d,
                                          n_levels, n_points, chunks, device, stream)
              : launch_fwd<T, 1, int>(value, loc, aw, out, lv, mask, smem, n, s_len, lq, m, d,
                                      n_levels, n_points, chunks, device, stream);
}

}  // namespace

// shapes: host array of n_levels (H, W) pairs; levels start at the running
// sum of H*W along S. dtype: 0 = float32, 1 = bfloat16 (value and out);
// device: the CUDA ordinal of the tensors and of the stream. The plan
// (ops/msda.py::msda_plan): mask, the staged levels; vec, the channels a
// lane loads at once (16 bytes or 1); wide, 64-bit offsets; chunks, query
// chunks per head. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a plan that does not fit the call.
extern "C" int dgtd_msda_fwd(const void* value, const float* loc, const float* aw, void* out,
                             const int* shapes, int n_levels, int n, long long s_len, int lq,
                             int m, int d, int n_points, int dtype, int device, void* stream,
                             unsigned mask, int vec, int wide, int chunks) {
  // this library carries its own CUDA runtime: make the tensors' device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  err = make_levels(shapes, n_levels, s_len, &lv);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((long long)n * lq * m * d <= 0 || n_points <= 0) return (int)cudaSuccess;
  const int elt = dtype == 0 ? 4 : 2;
  const long long smem = plan_smem(lv, n_levels, mask, d, elt);
  const void* vec_ptrs[2] = {value, out};
  if (smem < 0 || !plan_fits(vec, wide, chunks, elt, d, s_len, lq, m, n_levels * n_points, vec_ptrs, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_fwd<float>(vec, wide, value, loc, aw, out, lv, mask, (int)smem, n, s_len, lq, m, d,
                              n_levels, n_points, chunks, device, s);
  else
    err = dispatch_fwd<__nv_bfloat16>(vec, wide, value, loc, aw, out, lv, mask, (int)smem, n, s_len, lq,
                                      m, d, n_levels, n_points, chunks, device, s);
  return (int)err;
}
