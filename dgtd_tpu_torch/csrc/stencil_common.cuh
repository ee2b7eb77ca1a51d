// Shared by diffusion_stencil.cu and diffusion_stencil_bwd.cu: element loads
// and stores in fp32 or bf16, the limit of the fused (all steps in one
// launch) kernels, which ops/diffusion.py::fused_path mirrors, the route of
// a plane among the fused, cluster, tiled and per-step kernels with the
// cluster kernels' strip split and the tiled kernels' plan, which
// ops/diffusion.py::stencil_route, cluster_split and tiled_plan mirror.
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
// a read-only load of an element in its own dtype
__device__ __forceinline__ float ld_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_raw(const __nv_bfloat16* p) { return __ldg(p); }
// read-only loads of V consecutive elements, p aligned to V elements for V = 2
__device__ __forceinline__ void ld_group(const float* p, float (&r)[1]) { r[0] = __ldg(p); }
__device__ __forceinline__ void ld_group(const __nv_bfloat16* p, __nv_bfloat16 (&r)[1]) { r[0] = __ldg(p); }
__device__ __forceinline__ void ld_group(const float* p, float (&r)[2]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  r[0] = v.x;
  r[1] = v.y;
}
__device__ __forceinline__ void ld_group(const __nv_bfloat16* p, __nv_bfloat16 (&r)[2]) {
  const __nv_bfloat162 v = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  r[0] = v.x;
  r[1] = v.y;
}
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
// strip needs r rows), the tiled ones (any other plane at an odd k up to
// TILED_MAX_KERNEL), or the per-step ones (k >= 13).
// ops/diffusion.py::stencil_route mirrors it.
enum StencilRoute { ROUTE_FUSED = 0, ROUTE_CLUSTER = 1, ROUTE_PER_STEP = 2, ROUTE_TILED = 3 };

// k is a template argument of the tiled kernels: 1, 3, ..., 11, the range of
// the kernel3..kernel11 ablations
constexpr int TILED_MAX_KERNEL = 11;

inline int stencil_route(int h, int wd, int k, int elem_bytes) {
  if (fused_fits(h, wd, k, elem_bytes)) return ROUTE_FUSED;
  const ClusterSplit sp = cluster_split(h, wd);
  const bool cluster = (k == 1 || k == 3 || k == 5 || k == 7) && sp.blocks > 0 &&
                       sp.blocks <= CLUSTER_MAX_BLOCKS && sp.rows >= k / 2 &&
                       cluster_bwd_smem(sp.rows, wd, k, elem_bytes) <= FUSED_SMEM_LIMIT;
  if (cluster) return ROUTE_CLUSTER;
  return k >= 1 && k % 2 == 1 && k <= TILED_MAX_KERNEL && h > 0 && wd > 0 ? ROUTE_TILED : ROUTE_PER_STEP;
}

// The tiled kernels (temporal blocking): one block a (plane, tile), all the
// steps of a call in one launch. A tile's interior is th x tw pixels; step t
// of s computes the interior grown by (s-1-t)*r on each side, so the block
// loads x on the interior grown by s*r, and the region grown beyond the
// plane is the plane's zero edge, never computed. A plane that one tile
// holds is computed once, with no recomputed halo. The backward runs the
// steps in reverse with the gradient's region shrinking by r a step.
//
// Shared memory of a tile (fp32 unless named):
//   both: two ping-pong buffers of the interior grown by s*r (clipped to r
//     beyond the plane): x's steps forward, the gradient's backward;
//   backward: every step's gradient on the interior (dw is formed from them
//     after the step loop, tap by tap, and written once) and every step's
//     input on the interior grown by r;
//   ws mode (backward only): the tile's k*k weight planes in their own
//     dtype, on the region that its steps read them (the interior grown by
//     s*r, within the plane), staged by the first step's reads and read
//     from shared memory by the later steps.
// Without ws (the forward always), every step reads w from device memory
// (L2 serves the later steps' re-reads).
// threads of a tiled block: 512 for k <= 7, 256 for k = 9 and 11. The
// forward keeps to 64 registers a thread (tiled_min_blocks blocks an SM),
// so that the register file holds 1024 threads, whose loads hide each
// other's latency; so does the backward at k = 9 and 11. The backward at
// k <= 7 takes the registers it needs (128 at 512 threads): under 64 or 80
// it spills, and it ran slower on the card both ways. Both unroll the k
// rows of taps at k <= 7 only (tiled_row_unroll): at 9 and 11 a fully
// unrolled window's addresses alone would fill the registers.
__host__ __device__ constexpr int tiled_threads(int k) { return k <= 7 ? 512 : 256; }
__host__ __device__ constexpr int tiled_min_blocks(int k) { return 1024 / tiled_threads(k); }
__host__ __device__ constexpr int tiled_bwd_min_blocks(int k) { return k <= 7 ? 1 : tiled_min_blocks(k); }
__host__ __device__ constexpr int tiled_row_unroll(int k) { return k <= 7 ? k : 1; }
constexpr int TILED_MAX_TILE_ROWS = 256;
// the backward's ws mode is taken at 2 or more steps (at one step no later
// step reads what it stages) when its tiles read at most 3/2 times the
// plane's w from memory (the halo's recompute): its one block an SM cannot
// overlap the loads with the steps, and without ws two or more blocks an
// SM do, L2 serving the later steps' re-reads. The forward has no ws mode:
// on the card it ran slower than streaming at kernel11's (240, 12, 12) and
// at (24, 512, 512).
constexpr int TILED_WS_MAX_RATIO_NUM = 3, TILED_WS_MAX_RATIO_DEN = 2;
// without ws, a tile of at most this many pixels, so that a plane gives
// blocks enough to fill the card (a 96 x 96 plane 5 tiles), and at most
// TILED_STREAM_SMEM bytes: two blocks an SM (228 KB, less 1 KB a block
// that the runtime keeps)
constexpr int TILED_STREAM_MAX_PIXELS = 2048;
constexpr size_t TILED_STREAM_SMEM = 233472 / 2 - 1024;

struct TiledPlan {
  int th, tw, ws;  // th = 0: no tile fits shared memory
};

inline int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

// The halo of the region a tile reads w on: (s-1)*r forward, s*r backward.
inline int64_t tiled_w_halo(int k, int steps, bool bwd) {
  return (int64_t)(k / 2) * (bwd ? steps : steps - 1);
}

inline size_t tiled_smem(int th, int tw, int h, int wd, int k, int steps, int elem_bytes, bool bwd, bool ws) {
  const int64_t r = k / 2, halo = (int64_t)steps * r;
  const int64_t bh = imin64(th + 2 * halo, h + 2 * r), bw = imin64(tw + 2 * halo, wd + 2 * r);
  int64_t bytes = 2 * 4 * bh * bw;
  if (bwd) bytes += 4 * (int64_t)steps * ((int64_t)th * tw + (th + 2 * r) * (tw + 2 * r));
  if (ws) {
    const int64_t wh = tiled_w_halo(k, steps, bwd);
    bytes += (int64_t)k * k * imin64(th + 2 * wh, h) * imin64(tw + 2 * wh, wd) * elem_bytes;
  }
  return (size_t)bytes;
}

// The tile within `budget` bytes of shared memory that reads the fewest w
// values in all (tiles x the w region of a tile), fewer tiles on a tie; rows
// and columns split as evenly as their tile counts allow (without ws, at
// most TILED_STREAM_MAX_PIXELS pixels a tile). cost receives
// that count; th = 0 if no tile fits.
inline TiledPlan tiled_search(int h, int wd, int k, int steps, int elem_bytes, bool bwd, bool ws, size_t budget,
                              int64_t* cost) {
  TiledPlan best = {0, 0, ws ? 1 : 0};
  int64_t best_cost = -1, best_tiles = 0;
  const int64_t wh = tiled_w_halo(k, steps, bwd);
  const int top = h < TILED_MAX_TILE_ROWS ? h : TILED_MAX_TILE_ROWS;
  for (int th0 = 1; th0 <= top; ++th0) {
    const int ny = (h + th0 - 1) / th0, th = (h + ny - 1) / ny;
    if (tiled_smem(th, 1, h, wd, k, steps, elem_bytes, bwd, ws) > budget) break;
    int lo = 1, hi = ws ? wd : min(wd, TILED_STREAM_MAX_PIXELS / th);  // the widest tile of th rows that fits
    while (lo < hi) {
      const int mid = lo + (hi - lo + 1) / 2;
      if (tiled_smem(th, mid, h, wd, k, steps, elem_bytes, bwd, ws) <= budget) lo = mid; else hi = mid - 1;
    }
    const int nx = (wd + lo - 1) / lo, tw = (wd + nx - 1) / nx;
    const int64_t tiles = (int64_t)ny * nx;
    const int64_t c = tiles * imin64(th + 2 * wh, h) * imin64(tw + 2 * wh, wd);
    if (best_cost < 0 || c < best_cost || (c == best_cost && tiles < best_tiles)) {
      best = {th, tw, ws ? 1 : 0};
      best_cost = c;
      best_tiles = tiles;
    }
  }
  *cost = best_cost;
  return best;
}

// The tiled kernels' plan of an (h, wd) plane at k, steps and element
// size, forward or backward: in backward at 2 or more steps ws mode where
// its tiles read at most 3/2 times the plane's w; else w from memory at
// every step in a tile of at most TILED_STREAM_SMEM bytes (two blocks an
// SM) or, failing that, a block's whole shared memory.
// ops/diffusion.py::tiled_plan mirrors it.
inline TiledPlan tiled_plan(int h, int wd, int k, int steps, int elem_bytes, bool bwd) {
  if (h < 1 || wd < 1 || steps < 1 || k < 1 || k % 2 == 0 || k > TILED_MAX_KERNEL) return {0, 0, 0};
  int64_t cost = 0;
  if (bwd && steps > 1) {
    const TiledPlan ws = tiled_search(h, wd, k, steps, elem_bytes, bwd, true, FUSED_SMEM_LIMIT, &cost);
    if (ws.th > 0 && cost * TILED_WS_MAX_RATIO_DEN <= (int64_t)TILED_WS_MAX_RATIO_NUM * h * wd) return ws;
  }
  const TiledPlan half = tiled_search(h, wd, k, steps, elem_bytes, bwd, false, TILED_STREAM_SMEM, &cost);
  if (half.th > 0) return half;
  return tiled_search(h, wd, k, steps, elem_bytes, bwd, false, FUSED_SMEM_LIMIT, &cost);
}

// Plane element (yy, xx) of a (h, wd) plane at base, 0 beyond the plane:
// the load is unconditional, from the clamped address, so that a loop of
// them keeps several in flight.
template <typename T>
__device__ __forceinline__ float load_or_zero(const T* base, int yy, int xx, int h, int wd) {
  const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < wd;
  const float v = to_f(ld_raw(base + (int64_t)min(max(yy, 0), h - 1) * wd + min(max(xx, 0), wd - 1)));
  return inside ? v : 0.f;
}

// Where a tile lies: its interior [y0, y1) x [x0, x1), the buffer of the
// interior grown by `halo` within r of the plane ([by0, by0 + bh) x
// [bx0, bx0 + bw)), and the w region grown by `whalo` within the plane.
struct TileBox {
  int y0, y1, x0, x1;
  int by0, bh, bx0, bw;
  int wy0, wh, wx0, ww;
};

__device__ __forceinline__ TileBox tile_box(int tile, int h, int wd, int th, int tw, int r, int halo, int whalo) {
  const int nx = (wd + tw - 1) / tw;
  const int ty = tile / nx, tx = tile - ty * nx;
  TileBox b;
  b.y0 = ty * th;
  b.y1 = min(b.y0 + th, h);
  b.x0 = tx * tw;
  b.x1 = min(b.x0 + tw, wd);
  b.by0 = max(b.y0 - halo, -r);
  b.bh = min(b.y1 + halo, h + r) - b.by0;
  b.bx0 = max(b.x0 - halo, -r);
  b.bw = min(b.x1 + halo, wd + r) - b.bx0;
  b.wy0 = max(b.y0 - whalo, 0);
  b.wh = min(b.y1 + whalo, h) - b.wy0;
  b.wx0 = max(b.x0 - whalo, 0);
  b.ww = min(b.x1 + whalo, wd) - b.wx0;
  return b;
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
