// Shared by diffusion_stencil.cu and diffusion_stencil_bwd.cu: element loads
// and stores in fp32 or bf16, the limit of the fused (all steps in one
// launch) kernels, which ops/diffusion.py::fused_path mirrors, and the route
// of a plane among the fused, cluster and per-step kernels with the cluster
// kernels' strip split, which ops/diffusion.py::stencil_route and
// cluster_split mirror.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// The cluster kernels take the planes above the fused limit that a thread
// block cluster can hold: the plane split into `blocks` strips of `rows`
// rows (the last strip may be shorter), one block of at most
// FUSED_MAX_PIXELS threads a strip, at most CLUSTER_MAX_BLOCKS blocks (the
// portable cluster size). The strips are as even as the fewest blocks allow.
constexpr int CLUSTER_MAX_BLOCKS = 8;

struct ClusterSplit {
  int blocks, rows;
};

inline ClusterSplit cluster_split(int h, int wd) {
  const int most = wd > 0 ? FUSED_MAX_PIXELS / wd : 0;  // rows a block can hold
  if (h <= 0 || most == 0) return {0, 0};
  const int blocks = (h + most - 1) / most;
  return {blocks, (h + blocks - 1) / blocks};
}

// Shared memory of the cluster backward, the larger of the two cluster
// kernels: four padded fp32 strips (the gradient's and the step input's
// ping-pong pairs, r halo rows above and below) and the k*k weight planes
// of the strip and its halo rows in their own dtype, with r guard values at
// either end (the transpose's column taps read up to r values past a row).
inline size_t cluster_bwd_smem(int rows, int wd, int k, int elem_bytes) {
  const int r = k / 2;
  return 4 * sizeof(float) * (size_t)(rows + 2 * r) * (size_t)(wd + 2 * r) +
         ((size_t)k * k * (rows + 2 * r) * wd + 2 * r) * elem_bytes;
}

// Which kernels run an (h, wd) plane at this k and element size: the fused
// ones, the cluster ones (a halo comes from the adjacent strip only, so a
// strip needs r rows), or the per-step ones. ops/diffusion.py::stencil_route
// mirrors it.
enum StencilRoute { ROUTE_FUSED = 0, ROUTE_CLUSTER = 1, ROUTE_PER_STEP = 2 };

inline int stencil_route(int h, int wd, int k, int elem_bytes) {
  if (fused_fits(h, wd, k, elem_bytes)) return ROUTE_FUSED;
  const ClusterSplit sp = cluster_split(h, wd);
  const bool cluster = (k == 1 || k == 3 || k == 5 || k == 7) && sp.blocks > 0 &&
                       sp.blocks <= CLUSTER_MAX_BLOCKS && sp.rows >= k / 2 &&
                       cluster_bwd_smem(sp.rows, wd, k, elem_bytes) <= FUSED_SMEM_LIMIT;
  return cluster ? ROUTE_CLUSTER : ROUTE_PER_STEP;
}

// Threads of a cluster kernel's block: one a pixel of a strip, in whole warps.
inline int strip_threads(int rows, int wd) { return (rows * wd + 31) / 32 * 32; }

// The launch configuration of `grid` blocks in 1-D clusters of `blocks`, for
// cudaLaunchKernelEx and cudaOccupancyMaxActiveClusters. cfg points into
// the object, so it is used where it is built and never copied.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(unsigned grid, int blocks, int threads, size_t smem, cudaStream_t s) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The error of a runtime call that launched or queried a kernel, and the
// runtime's last error cleared with it.
inline cudaError_t launch_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// A strip's write of one pixel's value v into the padded fp32 buffer at
// offset `off` of every block's shared memory: its own place (strip row ly,
// column xx), and, through distributed shared memory, the halo row it fills
// in the block above (`up`, the strip's first r rows; that strip has `rows`
// rows) or below (`down`, its last r rows). up and down are the neighbours'
// shared memory as cluster.map_shared_rank gives it, null at the plane's
// edge. pw is the padded row length.
template <int R>
__device__ __forceinline__ void put_strip(float* self, float* up, float* down, int off, int rows,
                                          int nrows, int pw, int ly, int xx, float v) {
  self[off + (ly + R) * pw + xx + R] = v;
  if (up != nullptr && ly < R) up[off + (rows + R + ly) * pw + xx + R] = v;
  if (down != nullptr && ly >= nrows - R) down[off + (ly - nrows + R) * pw + xx + R] = v;
}

}  // namespace
