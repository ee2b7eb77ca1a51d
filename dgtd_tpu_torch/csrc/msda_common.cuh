// What the multi-scale deformable attention kernels (msda_fwd.cu,
// msda_bwd.cu) share: the level table, the sampling coordinate and the
// loads. One copy, so that the forward and backward kernels take the same
// floor at every sample.
//
// The forward and dLocation/dWeight kernels also share their plan and its
// stage (ops/msda.py::msda_plan computes the plan; plan_smem and
// plan_fits below check it): a block owns one (n, m) head and a chunk of
// its queries, copies the head's rows of the levels the plan names into
// shared memory, then gives each warp one (n, q, m) at a time. A lane loads
// `V` channels of a corner row at once: 16 bytes (4 fp32, 8 bf16) on the
// vector route, one element on the scalar route; G lanes (the row's chunks
// rounded up to a power of two, at most 32) cover a row, so a warp works on
// 32 / G samples at once.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 16
// threads of a forward or dLocation/dWeight block (ops/msda.py THREADS):
// one block an SM, so at most 64 registers a thread
#define MSDA_THREADS 1024
// dynamic shared memory a block may stage (ops/msda.py SMEM_MAX): the
// 227 KB a Hopper block can have, less 1 KB for the level table
#define MSDA_SMEM_MAX (232448 - 1024)
#define MSDA_FULL 0xffffffffu

namespace {

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int64_t start[MSDA_MAX_LEVELS];
};

// shapes: host array of n_levels (H, W) pairs; levels start at the running
// sum of H*W along S, which must come to s_len
cudaError_t make_levels(const int* shapes, int n_levels, long long s_len, Levels* lv) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS) return cudaErrorInvalidValue;
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = start;
    start += (int64_t)lv->h[l] * lv->w[l];
  }
  return start == s_len ? cudaSuccess : cudaErrorInvalidValue;
}

// the sampling coordinate loc * size - 0.5, rounded after the product and
// after the difference as the plain version rounds it (no FMA contraction),
// so that both take the same floor where a sample sits on a pixel
// coordinate, where the location gradient jumps
__device__ __forceinline__ float src_coord(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ---------------------------------------------------------------------------
// the plan, checked on the host
// ---------------------------------------------------------------------------

// bytes of shared memory the staged levels take (their H*W rows of d
// elements), or -1 if the mask names a level past n_levels or the levels
// do not fit MSDA_SMEM_MAX
long long plan_smem(const Levels& lv, int n_levels, unsigned mask, int d, int elt) {
  if ((mask >> n_levels) != 0) return -1;
  long long bytes = 0;
  for (int l = 0; l < n_levels; ++l)
    if ((mask >> l) & 1u) bytes += (long long)lv.h[l] * lv.w[l] * d * elt;
  return bytes <= MSDA_SMEM_MAX ? bytes : -1;
}

// the vector width, the offsets' width and the chunks agree with the call:
// 16-byte loads only on rows of whole 16-byte chunks from 16-byte aligned
// tensors; 32-bit offsets only where a head's value and the queries' rows
// stay within 2^31 - 1 elements
bool plan_fits(int vec, int wide, int chunks, int elt, int d, long long s_len, int lq, int m,
               int samples, const void* const* vec_ptrs, int n_ptrs) {
  if (chunks < 1) return false;
  if (vec != 1) {
    if (vec * elt != 16 || d % vec != 0) return false;
    for (int i = 0; i < n_ptrs; ++i)
      if (reinterpret_cast<uintptr_t>(vec_ptrs[i]) % 16 != 0) return false;
  }
  if (!wide) {
    const long long lim = 0x7fffffffLL;
    if (s_len * m * d > lim || (long long)lq * m * samples * 2 > lim || (long long)lq * m * d > lim)
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// on the card
// ---------------------------------------------------------------------------

// where a level's rows of this block's head lie: in shared memory (stride
// d) or in value (stride M*d), as a generic pointer so that one load serves
// both
template <typename T, typename Idx>
struct LevelTab {
  const T* base[MSDA_MAX_LEVELS];
  Idx stride[MSDA_MAX_LEVELS];
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gsrc) : "memory");
}

// Fill the level table and copy the head's rows of the staged levels into
// smem (level after level, rows of d elements): 16-byte cp.async copies on
// the vector route, element copies on the scalar route. Every thread of
// the block calls it; it ends with a barrier.
template <typename T, int V, typename Idx>
__device__ void stage_head(LevelTab<T, Idx>& tab, T* smem, const T* vhead, const Levels& lv,
                           unsigned mask, int n_levels, int64_t md, int d) {
  const int tid = threadIdx.x;
  int64_t off = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const T* src = vhead + lv.start[l] * md;
    const bool staged = (mask >> l) & 1u;
    if (tid == 0) {
      tab.base[l] = staged ? smem + off : src;
      tab.stride[l] = staged ? (Idx)d : (Idx)md;
      tab.h[l] = h;
      tab.w[l] = w;
    }
    if (!staged) continue;
    T* dst = smem + off;
    const int nvec = d / V;
    const int total = h * w * nvec;
    for (int c = tid; c < total; c += blockDim.x) {
      const int pix = c / nvec, j = c - pix * nvec;
      const T* s = src + (Idx)pix * (Idx)md + j * V;
      T* t = dst + pix * d + j * V;
      if constexpr (V * sizeof(T) == 16) {
        cp_async16(t, s);
      } else {
        *t = *s;
      }
    }
    off += (int64_t)h * w * d;
  }
  if constexpr (V * sizeof(T) == 16) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// V channels of a row at p (generic: shared or global memory) as fp32
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_or_zero(bool ok, const T* p, float (&v)[V]) {
  if (ok) {
    load_chunk(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.f;
  }
}

// A sample on level l at source coordinates (x, y): the pixel index of its
// corner (x0, y0), the fractions, and the level with the corners that lie
// on it (bit 8 + c for corner c = 00, 01, 10, 11) packed in one int. The
// lane that loaded the sample forms it once; the lanes that gather the
// sample's rows take pix and lbits by shuffle.
struct Sample {
  int pix, lbits;
  float fx, fy;
};

template <typename T, typename Idx>
__device__ __forceinline__ Sample locate(const LevelTab<T, Idx>& tab, int l, float x, float y) {
  Sample s;
  const int h = tab.h[l], w = tab.w[l];
  const float xf = floorf(x), yf = floorf(y);
  s.fx = x - xf;
  s.fy = y - yf;
  const int x0 = (int)xf, y0 = (int)yf;
  const bool in_y0 = y0 >= 0 && y0 < h, in_y1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool in_x0 = x0 >= 0 && x0 < w, in_x1 = x0 + 1 >= 0 && x0 + 1 < w;
  s.pix = y0 * w + x0;
  s.lbits = l | (in_y0 && in_x0) << 8 | (in_y0 && in_x1) << 9 | (in_y1 && in_x0) << 10 |
            (in_y1 && in_x1) << 11;
  return s;
}

__device__ __forceinline__ bool corner_in(int lbits, int c) { return (lbits >> (8 + c)) & 1; }

// the row of corner (x0, y0) of a located sample (shared or global memory),
// and the steps to the corners at x0 + 1 and y0 + 1
template <typename T, typename Idx>
struct Rows {
  const T* p00;
  Idx sx, sy;
};

template <typename T, typename Idx>
__device__ __forceinline__ Rows<T, Idx> rows_of(const LevelTab<T, Idx>& tab, int pix, int lbits) {
  const int l = lbits & 0xff;
  Rows<T, Idx> r;
  r.sx = tab.stride[l];
  r.sy = (Idx)tab.w[l] * r.sx;
  r.p00 = tab.base[l] + (Idx)pix * r.sx;
  return r;
}

// lanes per row (G, a power of two up to 32) for nvec chunks, and its log2
__device__ __forceinline__ int group_log2(int nvec) {
  return nvec >= 32 ? 5 : (nvec <= 1 ? 0 : 32 - __clz(nvec - 1));
}

}  // namespace
