// Multi-scale deformable attention backward for Hopper (sm_90a): two
// kernels, one launch each per backward call, every level in one launch.
//
// msda_dvalue_kernel replaces dgtd_tpu/ops/msda.py::ms_deform_attn_pallas_dvalue
// (the Pallas kernel _msda_dvalue_kernel): the scatter-add
//
//   dvalue[n, start_l + yc*W_l + xc, m, d] += g[n, q, m*D + d] * aw * w_corner
//
// over every in-range corner of every sample, into an fp32 buffer that the
// caller zeroes and, for a bf16 value, rounds to bf16 once at the end. It
// runs on its own plan (ops/msda.py::msda_plan with accumulate=True): a
// block owns one (n, m) head and a chunk of its queries and keeps fp32
// accumulator rows of the head's small levels in shared memory (4 bytes an
// element whatever g's dtype, so the plan counts them as fp32: levels 1-3,
// 168 KiB, at the encoder shape in fp32 and bf16 alike). It zeroes them,
// adds into them with shared-memory atomics, and at the block's end adds
// them into dvalue once, with 16-byte global reductions (red.global.add.v4.f32,
// which sm_90 has), skipping the chunks no sample
// touched. One warp takes one (n, q, m) at a time: lane i loads and
// locates sample i once and forms its four corner weights (x weight *
// y weight * aw, as the plain version forms them), which it hands, with
// the corner row and level, to the lanes that add them; the warp holds the
// query-head's g row in registers (each lane V channels from one 16-byte
// load: 4 fp32, 8 bf16). A lane adds weight * g into the four corner
// rows: on a staged level into shared memory, one element at a time, each
// group of lanes starting at another element of its chunk so that the
// groups of a warp meet different banks; on the other levels (level 0 at
// the encoder shape) into dvalue with 16-byte global atomics, or element
// atomics on the scalar route (odd widths, a misaligned base). The
// summation order is not fixed, so the result is not bit-reproducible.
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
// (~39 MB in all), while its 1.39M samples make 178M element adds: 3/4 of
// them land in shared memory, the rest (level 0) go through L2 as 11M
// 16-byte adds, and the flush adds 22 MB; dlocw reads g, value, loc and aw
// (~39 MB) and writes 17 MB, while its gather reads ~640 MB of corner rows,
// 3/4 of them from the staged levels.

#include "msda_common.cuh"

namespace {

// an fp32 add into shared memory at the generic address p (a
// compare-and-swap loop on this card, ATOMS.CAST.SPIN: it has no native
// shared fp32 add)
__device__ __forceinline__ void add_shared(float* p, float v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// fp32 adds into global memory at the generic address p, with no value
// returned: one element, or four as one 16-byte reduction (p 16-byte
// aligned; REDG.E.ADD.F32x4 on sm_90)
__device__ __forceinline__ void add_global(float* p, float v) {
  asm volatile("red.relaxed.gpu.global.add.f32 [%0], %1;\n" ::"l"(__cvta_generic_to_global(p)), "f"(v) : "memory");
}
__device__ __forceinline__ void add_global4(float* p, float a, float b, float c, float d) {
  asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(__cvta_generic_to_global(p)),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// dValue's counterpart of LevelTab: where a level's gradient rows of this
// block's head are summed, fp32 accumulators in shared memory (stride d) or
// dvalue itself (stride M*d)
template <typename Idx>
struct AccTab {
  float* base[MSDA_MAX_LEVELS];
  Idx stride[MSDA_MAX_LEVELS];
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
};

// Fill the table and zero the staged levels' accumulator rows (level after
// level, rows of d floats). Every thread of the block calls it; it ends with
// a barrier.
template <typename Idx>
__device__ void zero_head(AccTab<Idx>& tab, float* acc, float* dhead, const Levels& lv, unsigned mask,
                          int n_levels, int64_t md, int d) {
  int64_t off = 0;
  for (int l = 0; l < n_levels; ++l) {
    const bool staged = (mask >> l) & 1u;
    if (threadIdx.x == 0) {
      tab.base[l] = staged ? acc + off : dhead + lv.start[l] * md;
      tab.stride[l] = staged ? (Idx)d : (Idx)md;
      tab.h[l] = lv.h[l];
      tab.w[l] = lv.w[l];
    }
    if (staged) off += (int64_t)lv.h[l] * lv.w[l] * d;
  }
  for (int64_t i = threadIdx.x; i < off; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
}

// Add the staged levels' accumulator rows into dvalue, once a block: 16-byte
// global adds on the vector route (d a multiple of 4), element adds on the
// scalar one; a chunk that is all zero (no sample touched it) is skipped.
// Every thread of the block calls it after a barrier.
template <int V, typename Idx>
__device__ void flush_head(const float* acc, float* dhead, const Levels& lv, unsigned mask, int n_levels,
                           int64_t md, int d) {
  constexpr int F = V > 1 ? 4 : 1;
  const int nf = d / F;
  int64_t off = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (!((mask >> l) & 1u)) continue;
    const int rows = lv.h[l] * lv.w[l];
    float* const dst = dhead + lv.start[l] * md;
    const int total = rows * nf;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int pix = i / nf, j = i - pix * nf;
      const float* s = acc + off + (int64_t)pix * d + j * F;
      float* t = dst + (Idx)pix * (Idx)md + j * F;
      if constexpr (F == 4) {
        const float4 v = *reinterpret_cast<const float4*>(s);
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) add_global4(t, v.x, v.y, v.z, v.w);
      } else {
        if (*s != 0.f) add_global(t, *s);
      }
    }
    off += (int64_t)rows * d;
  }
}

// r[k] = v[(k + rot) % V]: the lane's channels in the order it adds them
// into shared memory
template <int V>
__device__ __forceinline__ void rotate(const float (&v)[V], int rot, float (&r)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int e = (k + rot) & (V - 1);
    float t = v[0];
#pragma unroll
    for (int i = 1; i < V; ++i) t = e == i ? v[i] : t;
    r[k] = t;
  }
}

// wgt * g into the lane's V channels of a corner row at p: on a staged
// level (on_chip) one shared-memory add an element, element (k + rot) % V
// at step k (gr holds g in that order), so that the groups of a warp meet
// different banks; else into dvalue, 16-byte adds on the vector route and
// element adds on the scalar one.
template <int V>
__device__ __forceinline__ void add_corner(float* p, bool on_chip, float wgt, const float (&gv)[V],
                                           const float (&gr)[V], int rot) {
  if (on_chip) {
#pragma unroll
    for (int k = 0; k < V; ++k) add_shared(p + ((k + rot) & (V - 1)), wgt * gr[k]);
  } else if constexpr (V == 1) {
    add_global(p, wgt * gv[0]);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) add_global4(p + k, wgt * gv[k], wgt * gv[k + 1], wgt * gv[k + 2], wgt * gv[k + 3]);
  }
}

// weight * g into the four corner rows of a located sample (the in-range
// ones), the lane's chunk of each at p (corner 00), p + sx, p + sy, p + sy + sx
template <int V, typename Idx>
__device__ __forceinline__ void add_sample(float* p, Idx sx, Idx sy, int lb, bool on_chip, float w00, float w01,
                                           float w10, float w11, const float (&gv)[V], const float (&gr)[V],
                                           int rot) {
  if (corner_in(lb, 0)) add_corner<V>(p, on_chip, w00, gv, gr, rot);
  if (corner_in(lb, 1)) add_corner<V>(p + sx, on_chip, w01, gv, gr, rot);
  if (corner_in(lb, 2)) add_corner<V>(p + sy, on_chip, w10, gv, gr, rot);
  if (corner_in(lb, 3)) add_corner<V>(p + sy + sx, on_chip, w11, gv, gr, rot);
}

template <typename T, int V, typename Idx>
__global__ void __launch_bounds__(MSDA_THREADS, 1)
    msda_dvalue_kernel(const T* __restrict__ g, const float* __restrict__ loc, const float* __restrict__ aw,
                       float* __restrict__ dvalue, Levels lv, unsigned mask, int64_t s_len, int lq, int m, int d,
                       int n_levels, int n_points, int chunks) {
  extern __shared__ __align__(16) unsigned char msda_smem[];
  __shared__ AccTab<Idx> tab;
  const int head = blockIdx.x / chunks, chunk = blockIdx.x - head * chunks;
  const int n = head / m, mi = head - n * m;
  const int per = (lq + chunks - 1) / chunks;
  const int q0 = chunk * per, q1 = min(lq, q0 + per);
  const int64_t md = (int64_t)m * d;
  float* const acc = reinterpret_cast<float*>(msda_smem);
  float* const dhead = dvalue + (int64_t)n * s_len * md + (int64_t)mi * d;
  zero_head<Idx>(tab, acc, dhead, lv, mask, n_levels, md, d);

  const int lp = n_levels * n_points;
  const int64_t row0 = ((int64_t)n * lq + q0) * m + mi;  // (n, q0, mi)
  const float* lbase = loc + row0 * lp * 2;
  const float* abase = aw + row0 * lp;
  const T* gbase = g + row0 * d;
  const int nvec = d / V;
  const int lg = group_log2(nvec), G = 1 << lg, spp = 32 >> lg;
  const bool g_held = nvec <= G;  // the row fits a group: each lane holds its chunk
  const int lane = threadIdx.x & 31, gl = lane & (G - 1), grp = lane >> lg;
  const int rot = grp & (V - 1);
  for (int q = q0 + (int)(threadIdx.x >> 5); q < q1; q += MSDA_THREADS / 32) {
    const Idx qs = (Idx)(q - q0) * (Idx)(m * lp);  // the query-head's first sample in the block
    const float* ql = lbase + 2 * qs;
    const float* qa = abase + qs;
    const T* qg = gbase + (Idx)(q - q0) * (Idx)md;
    float gh[V], ghr[V];
    load_or_zero<T, V>(g_held && gl < nvec, qg + gl * V, gh);
    rotate(gh, rot, ghr);
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
      for (int s0 = 0; s0 < nb; s0 += spp) {
        const int si = s0 + grp;  // this group's sample
        const float w00 = __shfl_sync(MSDA_FULL, mw00, si);
        const float w01 = __shfl_sync(MSDA_FULL, mw01, si);
        const float w10 = __shfl_sync(MSDA_FULL, mw10, si);
        const float w11 = __shfl_sync(MSDA_FULL, mw11, si);
        const int pix = __shfl_sync(MSDA_FULL, mpix, si);
        const int lb = __shfl_sync(MSDA_FULL, mlb, si);
        if (si < nb) {
          const int l = lb & 0xff;
          const bool on_chip = (mask >> l) & 1u;
          const Idx sx = tab.stride[l], sy = (Idx)tab.w[l] * sx;
          float* const p00 = tab.base[l] + (Idx)pix * sx;
          if (g_held) {
            if (gl < nvec) add_sample<V>(p00 + gl * V, sx, sy, lb, on_chip, w00, w01, w10, w11, gh, ghr, rot);
          } else {
            for (int j = gl; j < nvec; j += G) {
              float gv[V], gr[V];
              load_chunk(qg + j * V, gv);
              rotate(gv, rot, gr);
              add_sample<V>(p00 + j * V, sx, sy, lb, on_chip, w00, w01, w10, w11, gv, gr, rot);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // every add into the accumulators done
  flush_head<V, Idx>(acc, dhead, lv, mask, n_levels, md, d);
}

template <typename T, int V, typename Idx>
cudaError_t launch_dvalue(const void* g, const float* loc, const float* aw, float* dvalue, const Levels& lv,
                          unsigned mask, int smem, int n, long long s_len, int lq, int m, int d, int n_levels,
                          int n_points, int chunks, int device, cudaStream_t stream) {
  auto kernel = msda_dvalue_kernel<T, V, Idx>;
  // the accumulators plus the level table may pass the default 48 KB: lift
  // the kernel's limit once per device
  static bool raised[64] = {};
  if (smem > 0 && device < 64 && !raised[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MSDA_SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const long long blocks = (long long)n * m * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MSDA_THREADS, smem, stream>>>(static_cast<const T*>(g), loc, aw, dvalue, lv, mask,
                                                           s_len, lq, m, d, n_levels, n_points, chunks);
  return cudaGetLastError();
}

// vec 4: a lane adds 4 channels at once (16 bytes of the fp32 gradient,
// from 16 bytes of fp32 g or 8 of bf16 g)
template <typename T>
cudaError_t dispatch_dvalue(int vec, int wide, const void* g, const float* loc, const float* aw, float* dvalue,
                            const Levels& lv, unsigned mask, int smem, int n, long long s_len, int lq, int m,
                            int d, int n_levels, int n_points, int chunks, int device, cudaStream_t stream) {
  constexpr int VW = 4;
  if (vec == VW)
    return wide ? launch_dvalue<T, VW, int64_t>(g, loc, aw, dvalue, lv, mask, smem, n, s_len, lq, m, d, n_levels,
                                                n_points, chunks, device, stream)
                : launch_dvalue<T, VW, int>(g, loc, aw, dvalue, lv, mask, smem, n, s_len, lq, m, d, n_levels,
                                            n_points, chunks, device, stream);
  return wide ? launch_dvalue<T, 1, int64_t>(g, loc, aw, dvalue, lv, mask, smem, n, s_len, lq, m, d, n_levels,
                                             n_points, chunks, device, stream)
              : launch_dvalue<T, 1, int>(g, loc, aw, dvalue, lv, mask, smem, n, s_len, lq, m, d, n_levels, n_points,
                                         chunks, device, stream);
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
// 1 = bfloat16 (g, and value for dgtd_msda_dlocw). device: the CUDA ordinal
// of the tensors and of the stream. Each returns cudaGetLastError() after
// its launch (0 on success), cudaErrorInvalidValue for a plan that does not
// fit the call.
//
// dValue's plan (ops/msda.py::msda_plan with accumulate=True): mask, the
// levels whose fp32 accumulator rows a block keeps in shared memory; vec,
// the channels of g a lane loads at once (16 bytes or 1); wide, 64-bit
// offsets; chunks, query chunks per head. dvalue must be zeroed by the
// caller.
extern "C" int dgtd_msda_dvalue(const void* g, const float* loc, const float* aw, float* dvalue,
                                const int* shapes, int n_levels, int n, long long s_len, int lq,
                                int m, int d, int n_points, int dtype, int device, void* stream,
                                unsigned mask, int vec, int wide, int chunks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  err = make_levels(shapes, n_levels, s_len, &lv);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((long long)n * lq * m <= 0 || n_points <= 0 || d <= 0) return (int)cudaSuccess;
  // fp32 accumulators, and vec counts their elements (4: 16 bytes)
  const long long smem = plan_smem(lv, n_levels, mask, d, 4);
  const void* vec_ptrs[2] = {g, dvalue};
  if (smem < 0 || !plan_fits(vec, wide, chunks, 4, d, s_len, lq, m, n_levels * n_points, vec_ptrs, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_dvalue<float>(vec, wide, g, loc, aw, dvalue, lv, mask, (int)smem, n, s_len, lq, m, d, n_levels,
                                 n_points, chunks, device, s);
  else
    err = dispatch_dvalue<__nv_bfloat16>(vec, wide, g, loc, aw, dvalue, lv, mask, (int)smem, n, s_len, lq, m, d,
                                         n_levels, n_points, chunks, device, s);
  return (int)err;
}

// dLocation/dWeight's plan: mask, vec, wide and chunks as for dgtd_msda_fwd
// (one plan serves both kernels).
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
