// What the multi-scale deformable attention kernels (msda_fwd.cu,
// msda_bwd.cu) share: the level table, the sampling coordinate and the
// loads. One copy, so that the forward and backward kernels take the same
// floor at every sample.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 16

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

}  // namespace
