// Depth-diffusion stencil steps for Hopper (sm_90a), in plane layout and in
// NHWC with tap-major weights.
//
// Replaces dgtd_tpu/ops/diffusion_pallas.py::diffusion_step_pallas_v2
// (the Pallas kernel _stencil_kernel_v2) and its chain of one call per step
// (diffusion_pallas_v2_planes). One step computes
//
//   out[p, y, x] = sum_{t < k*k} x[p, y + t/k - r, x + t%k - r] * w[p, t, y, x]
//
// with a zero halo (r = k/2), fp32 accumulation, and the result stored in
// x's dtype (fp32 or bf16). x is (P, H, W); w is (P, k*k, H, W), contiguous.
//
// What bounds it on this card: bytes and launches. Each step reads the k*k
// weight planes once (k*k*P*H*W values) and does 2 flops per weight value,
// far below the ~20 flop/byte ridge of the fp32 CUDA cores. At the served
// shape (P = 8*24 planes of 12x12, k = 7) a step moves ~2.7 MB in bf16,
// under a microsecond of DRAM time that the 50 MB L2 mostly absorbs, so
// launches and their host calls set the time.
//
// Four kernels compute the plane steps, chosen by shape and dtype alone
// (stencil_route in stencil_common.cuh, which ops/diffusion.py::stencil_route
// mirrors): the fused kernel, the cluster kernel, the tiled kernel, the
// per-step kernel.
//
// stencil_fused_fwd_kernel runs all the steps in one launch. One block per
// plane, one thread per pixel (at most FUSED_MAX_PIXELS = 512 pixels, the
// cod recipe's 12x12 grid and smaller), k in {1, 3, 5, 7} as a template
// argument. The padded plane lives in shared memory as fp32 in two
// ping-pong buffers whose zero halo is never written; each thread keeps its
// pixel's k*k weights in registers for all the steps (read from memory
// once), and a __syncthreads() separates the steps. Each step's result is
// rounded to x's dtype before it goes back into shared memory, as the plain
// version and the chained Pallas calls round it. Shared memory: two padded
// fp32 planes, at most 29 KB for 512 pixels.
//
// When autograd needs them, the kernel also writes every step's input into
// one (steps, P, H, W) tensor: x itself as it is loaded, then each step's
// result but the last. The backward (diffusion_stencil_bwd.cu) reads them
// rather than recompute them on chip: they are P*H*W values a step, and the
// forward already holds each one in a register, so writing them is nearly
// free and the backward cannot drift from the forward's rounding.
//
// stencil_cluster_fwd_kernel runs all the steps of a larger plane in one
// launch: up to 8 strips of at most 512 pixels (the paper's grid-64
// ablation: 8 strips of 8 rows of 64), one block a strip, the blocks of a
// plane one thread block cluster. As in the fused kernel, one thread per
// pixel keeps its k*k weights in registers, read from memory once per call,
// and the strip lives in shared memory as fp32 ping-pong buffers, here with
// r halo rows above and below. After each step a thread writes its rounded
// result into its own buffer and, if its row is among the strip's first or
// last r, into the halo row of the neighbouring block through distributed
// shared memory (put_strip); one cluster.sync() a step then separates the
// steps for the whole plane. Rows beyond the plane's edge stay zero. At
// (192, 64, 64) bf16, k = 7 the call's bytes are ~80 MB (w read once), not
// the per-step kernels' 4 x 77 MB of w, which do not fit the 50 MB L2.
//
// stencil_tiled_fwd_kernel runs all the steps of any other plane at an odd
// k up to 11 (k a template argument) in one launch, by temporal blocking:
// one block a (plane, tile), the tile planned by tiled_plan. Step t of s
// computes the tile's interior grown by (s-1-t)*r, so the block loads x on
// the interior grown by s*r into an fp32 buffer (the plane's zero edge
// beyond it) and keeps the steps in two ping-pong buffers, rounding each to
// x's dtype; the halo is computed again by the neighbouring tiles. A plane
// that one tile holds (the kernel9 and kernel11 ablations' 12x12) has no
// recomputed halo. It writes the interior's step inputs and its output.
// Bound: the bytes of w, 98 a pixel at k = 7 in bf16, read by every step.
// Every step reads w from memory, L2 serving the later steps' re-reads, in
// tiles of at most 2048 pixels and two blocks an SM (tiled_plan); a thread
// takes two pixels of a row when the row length is even, whose weights are
// one 4-byte (bf16) or 8-byte load a tap. The k taps of a row are loaded
// together before they are summed, so that their latencies overlap. At (192, 96, 96), k = 7, a plane is 5 row
// strips of 20 rows (tiles 20 x 96): the call reads ~5.5x the plane's w
// through L2 but once from memory, where the per-step kernel reads it from
// memory 4 times.
//
// stencil_step_kernel, one thread per output pixel and one launch per step
// (the caller ping-pongs two buffers), takes k >= 13 (no tiled template) and
// step counts whose halo no tile holds. Consecutive threads take consecutive x of one row, so the reads of
// w[p, t, y, :] and of x are coalesced; taps that fall outside the plane are
// skipped (the halo is zero), which also masks ragged and rectangular
// H x W. No shared memory: the k*k neighbourhood reads of x hit L1.
//
// The NHWC kernels replace dgtd_tpu/ops/diffusion_pallas.py::diffusion_step_pallas
// (the Pallas kernel _stencil_kernel) and its chain of one call per step:
// the same step on NHWC x (B, H, W, C) with tap-major weights
// (B, H, W, k*k*C), whose index is t*C + c (to_tap_major):
//
//   out[b, y, x, c] = sum_t x[b, y + t/k - r, x + t%k - r, c] * w[b, y, x, t*C + c]
//
// read in place, without a copy into plane layout (w is k*k times x).
//
// What bounds them on this card: the bytes of w, k*k values a pixel and
// channel (98 bytes in bf16 at k = 7), and how they are read. In
// tap-major NHWC a pixel's taps are rows of C channels (48 bytes at C = 24
// in bf16): a block that reads only its own 16-byte channel group of each
// uses half of every 32-byte sector, and a warp whose lanes take 32 pixels
// touches 32 lines a load; measured on the card, such a kernel (a tile of
// pixels with a recomputed halo a block) moved 0.2 sectors a cycle an SM
// and ran slower than the per-step kernel at 96x96 and 512x512. So the
// route (nhwc_route, by shape and dtype) picks one of two layouts, both
// running every step of a call in one launch:
//
// stencil_nhwc_plane_kernel: a block owns one image b and one 16-byte
// channel group (4 fp32 or 8 bf16 channels; a C that is not a multiple of
// the group leaves the last group a masked tail), and holds the whole
// plane padded by r as two fp32 ping-pong buffers and the plane's w for
// its group, copied into shared memory once (cp.async) and read there by
// every step, where they fit a block (the cod recipe's 12x12 at k <= 9).
// A thread computes 4 channels of a pixel (the group's one quad in fp32,
// one of its two in bf16): for each tap one read of w's copy and one of the
// window, each step rounded to x's dtype as the chained steps round it.
//
// stencil_nhwc_grid_kernel: every other plane at an odd k up to 11. A
// cooperative launch of as many blocks as the card holds at once; each
// step, a thread computes (b, pixel, 4 channels) items, a pixel's quads on
// neighbouring lanes, so that a warp's loads of a tap take its C channels
// contiguously (whole sectors, L1 serving the neighbouring tap's bytes).
// It reads w in place every step (from memory: at 96x96 and beyond w
// passes L2) and the step's input from the previous step's output in
// global memory (x's dtype, through L2: L1 is not coherent across SMs),
// with a grid barrier between steps; the k taps of a row of both are
// loaded as raw words (16 bytes of fp32, 8 of bf16) before the first is
// used.
//
// With autograd both write every step's input into one (steps, B, H, W, C)
// tensor, as the plane kernels do (the grid kernel runs the steps through
// it; without, through two scratch tensors).
//
// stencil_step_nhwc_kernel, one launch per step, takes k >= 13 (no
// template of the other two). One thread per output element;
// consecutive threads take consecutive c, so for each tap the reads of x
// and of w[b, y, x, t*C : (t+1)*C] are coalesced.

#include "stencil_common.cuh"

#include <algorithm>

namespace {

// The NHWC kernels' route, which ops/diffusion.py::nhwc_route mirrors:
// shape and dtype alone decide it. A block of the plane kernel holds one image's whole plane for one 16-byte
// channel group (4 fp32 or 8 bf16 channels: nhwc_group), the plane padded
// by r as two fp32 buffers and the plane's w for the group, so that w is
// read from memory once for all the steps: the shared memory of a plane
// tile of the tiled plane kernels in ws mode (tiled_smem) times the group's
// channels. Every other plane at an odd k up to TILED_MAX_KERNEL takes the
// grid kernel; k >= 13 the per-step kernel.
enum NhwcRoute { NHWC_PLANE = 0, NHWC_GRID = 1, NHWC_PER_STEP = 2 };

__host__ __device__ constexpr int nhwc_group(int elem_bytes) { return 16 / elem_bytes; }

inline size_t nhwc_plane_smem(int h, int wd, int k, int elem_bytes) {
  return tiled_smem(h, wd, h, wd, k, 1, elem_bytes, false, true) * nhwc_group(elem_bytes);
}

inline int nhwc_route(int h, int wd, int k, int elem_bytes) {
  if (h < 1 || wd < 1 || k < 1 || k % 2 == 0 || k > TILED_MAX_KERNEL) return NHWC_PER_STEP;
  return nhwc_plane_smem(h, wd, k, elem_bytes) <= FUSED_SMEM_LIMIT ? NHWC_PLANE : NHWC_GRID;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gsrc) : "memory");
}

// threads of a block of the NHWC grid kernel
constexpr int NHWC_GRID_THREADS = 128;


template <typename T, int K>
__global__ void __launch_bounds__(FUSED_MAX_PIXELS)
stencil_fused_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ xs,
                         T* __restrict__ out, int64_t planes, int h, int wd, int steps) {
  constexpr int R = K / 2;
  extern __shared__ float smem[];
  const int pw = wd + 2 * R, pn = (h + 2 * R) * pw, hw = h * wd;
  float* src = smem;
  float* dst = smem + pn;
  for (int i = threadIdx.x; i < 2 * pn; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  const int64_t p = blockIdx.x;
  const int pix = threadIdx.x;
  const bool live = pix < hw;
  const int y = live ? pix / wd : 0;
  const int xx = live ? pix - y * wd : 0;
  const int centre = (y + R) * pw + xx + R;
  float wr[K * K];
  if (live) {
    const T xv = x[p * hw + pix];
    if (xs != nullptr) xs[p * hw + pix] = xv;
    src[centre] = to_f(xv);
    const T* wp = w + p * (int64_t)K * K * hw + pix;
#pragma unroll
    for (int t = 0; t < K * K; ++t) wr[t] = load_f(wp + (int64_t)t * hw);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    if (live) {
      const float* win = src + y * pw + xx;  // top-left tap of this pixel's window
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc = fmaf(win[dy * pw + dx], wr[dy * K + dx], acc);
      }
      if (s == steps - 1) {
        store_f(out + p * hw + pix, acc);
      } else {
        if (xs != nullptr) store_f(xs + ((s + 1) * planes + p) * hw + pix, acc);
        dst[centre] = round_to(acc, x);
      }
    }
    __syncthreads();  // every read of src and write of dst done before the swap
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <typename T, int K>
cudaError_t launch_fused(const void* x, const void* w, void* xs, void* out, int64_t planes, int h,
                         int wd, int steps, cudaStream_t s) {
  constexpr int R = K / 2;
  const int threads = (h * wd + 31) / 32 * 32;
  const size_t smem = 2 * sizeof(float) * (size_t)(h + 2 * R) * (wd + 2 * R);
  stencil_fused_fwd_kernel<T, K><<<(unsigned)planes, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(xs), static_cast<T*>(out),
      planes, h, wd, steps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused_k(const void* x, const void* w, void* xs, void* out, int64_t planes, int h,
                           int wd, int k, int steps, cudaStream_t s) {
  switch (k) {
    case 1: return launch_fused<T, 1>(x, w, xs, out, planes, h, wd, steps, s);
    case 3: return launch_fused<T, 3>(x, w, xs, out, planes, h, wd, steps, s);
    case 5: return launch_fused<T, 5>(x, w, xs, out, planes, h, wd, steps, s);
    case 7: return launch_fused<T, 7>(x, w, xs, out, planes, h, wd, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(FUSED_MAX_PIXELS)
stencil_cluster_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ xs,
                           T* __restrict__ out, int64_t planes, int h, int wd, int steps,
                           int blocks, int rows) {
  constexpr int R = K / 2;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int pw = wd + 2 * R, pn = (rows + 2 * R) * pw, hw = h * wd;
  const int rank = (int)cluster.block_rank();
  const int64_t p = blockIdx.x / blocks;
  const int y0 = rank * rows;
  const int nrows = min(rows, h - y0);
  const int pix = threadIdx.x;  // pixel of the strip
  const bool live = pix < nrows * wd;
  const int ly = live ? pix / wd : 0;
  const int xx = live ? pix - ly * wd : 0;
  const int64_t at = p * hw + (int64_t)y0 * wd + pix;  // the pixel in (P, H, W)
  float* const up = rank > 0 ? cluster.map_shared_rank(smem, rank - 1) : nullptr;
  float* const down = rank + 1 < blocks ? cluster.map_shared_rank(smem, rank + 1) : nullptr;
  for (int i = threadIdx.x; i < 2 * pn; i += blockDim.x) smem[i] = 0.f;
  cluster.sync();  // every block's buffers zeroed before a neighbour writes its halo

  float wr[K * K];
  int src = 0, dst = pn;  // the ping-pong buffers' offsets, the same in every block
  if (live) {
    const T xv = x[at];
    if (xs != nullptr) xs[at] = xv;
    put_strip<R>(smem, up, down, src, rows, nrows, pw, ly, xx, to_f(xv));
    const T* wp = w + p * (int64_t)K * K * hw + (at - p * hw);
#pragma unroll
    for (int t = 0; t < K * K; ++t) wr[t] = load_f(wp + (int64_t)t * hw);
  }
  cluster.sync();  // the strips and their halos in place

  for (int s = 0; s < steps; ++s) {
    float acc = 0.f;
    if (live) {
      const float* win = smem + src + ly * pw + xx;  // top-left tap of this pixel's window
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc = fmaf(win[dy * pw + dx], wr[dy * K + dx], acc);
      }
    }
    if (s == steps - 1) {
      if (live) store_f(out + at, acc);
    } else {
      if (live) {
        if (xs != nullptr) store_f(xs + (s + 1) * planes * hw + at, acc);
        put_strip<R>(smem, up, down, dst, rows, nrows, pw, ly, xx, round_to(acc, x));
      }
      // every read of src and every write of dst, here and in the
      // neighbours, done before the swap; the last step touches no other
      // block's memory, so this is also the last sync a block needs before
      // it exits
      cluster.sync();
      const int t = src;
      src = dst;
      dst = t;
    }
  }
}

template <typename T, int K>
cudaError_t launch_cluster(const void* x, const void* w, void* xs, void* out, int64_t planes, int h,
                           int wd, int steps, cudaStream_t s) {
  constexpr int R = K / 2;
  const ClusterSplit sp = cluster_split(h, wd);
  // two padded fp32 strips of at most 512 pixels: under 29 KB, as in the
  // fused forward
  const size_t smem = 2 * sizeof(float) * (size_t)(sp.rows + 2 * R) * (wd + 2 * R);
  const ClusterLaunch launch((unsigned)(planes * sp.blocks), sp.blocks, strip_threads(sp.rows, wd), smem, s);
  return launch_error(cudaLaunchKernelEx(
      &launch.cfg, stencil_cluster_fwd_kernel<T, K>, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(xs), static_cast<T*>(out), planes, h, wd, steps, sp.blocks, sp.rows));
}

template <typename T>
cudaError_t launch_cluster_k(const void* x, const void* w, void* xs, void* out, int64_t planes,
                             int h, int wd, int k, int steps, cudaStream_t s) {
  switch (k) {
    case 1: return launch_cluster<T, 1>(x, w, xs, out, planes, h, wd, steps, s);
    case 3: return launch_cluster<T, 3>(x, w, xs, out, planes, h, wd, steps, s);
    case 5: return launch_cluster<T, 5>(x, w, xs, out, planes, h, wd, steps, s);
    case 7: return launch_cluster<T, 7>(x, w, xs, out, planes, h, wd, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(tiled_threads(K), tiled_min_blocks(K))
stencil_tiled_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ xs,
                         T* __restrict__ out, int64_t planes, int h, int wd, int steps, int th, int tw,
                         int tiles) {
  constexpr int R = K / 2, KK = K * K;
  extern __shared__ float smem[];
  const int64_t p = blockIdx.x / tiles;
  const TileBox b = tile_box((int)(blockIdx.x - p * tiles), h, wd, th, tw, R, steps * R, (steps - 1) * R);
  const int64_t hw = (int64_t)h * wd;
  const int bn = b.bh * b.bw;
  float* src = smem;
  float* dst = smem + bn;
  const T* const xp = x + p * hw;
  const T* const wp = w + p * KK * hw;

  // x on the buffer (zero beyond the plane), the second buffer zeroed, the
  // interior's step-0 input saved
#pragma unroll 4
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const int yy = b.by0 + i / b.bw, xx = b.bx0 + i % b.bw;
    const float v = load_or_zero(xp, yy, xx, h, wd);
    src[i] = v;
    dst[i] = 0.f;
    if (xs != nullptr && yy >= b.y0 && yy < b.y1 && xx >= b.x0 && xx < b.x1)
      store_f(xs + p * hw + (int64_t)yy * wd + xx, v);  // x's own value: exact in its dtype
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    // the region of this step: the interior grown by (steps-1-s)*r, within
    // the plane, in groups of V pixels of a row from a column that is a
    // multiple of V (so that a group's weights are one aligned load)
    const int e = (steps - 1 - s) * R;
    const int cy0 = max(b.y0 - e, 0), cx0 = max(b.x0 - e, 0);
    const int ch = min(b.y1 + e, h) - cy0, cx1 = min(b.x1 + e, wd);
    const int gx0 = cx0 - cx0 % V, gw = (cx1 - gx0 + V - 1) / V;
    for (int i = threadIdx.x; i < ch * gw; i += blockDim.x) {
      const int yy = cy0 + i / gw, xg = gx0 + V * (i % gw);
      // a pixel of the group outside the region is computed from its
      // neighbour's window (which the buffer holds) and not stored
      bool valid[V];
      const float* win[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        valid[v] = xg + v >= cx0 && xg + v < cx1;
        const int xv = valid[v] ? xg + v : (valid[0] ? xg : xg + V - 1);
        win[v] = src + (yy - R - b.by0) * b.bw + (xv - R - b.bx0);  // top-left tap
      }
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      // w from memory, a row of k taps' loads at a time
      const T* wq = wp + (int64_t)yy * wd + xg;
#pragma unroll tiled_row_unroll(K)
      for (int dy = 0; dy < K; ++dy) {
        T raw[K][V];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) ld_group(wq + (int64_t)(dy * K + dx) * hw, raw[dx]);
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(win[v][dy * b.bw + dx], to_f(raw[dx][v]), acc[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!valid[v]) continue;
        const int xx = xg + v;
        const int64_t at = (int64_t)yy * wd + xx;
        if (s == steps - 1) {
          store_f(out + p * hw + at, acc[v]);  // the last region is the interior
        } else {
          dst[(yy - b.by0) * b.bw + (xx - b.bx0)] = round_to(acc[v], x);
          if (xs != nullptr && yy >= b.y0 && yy < b.y1 && xx >= b.x0 && xx < b.x1)
            store_f(xs + ((s + 1) * planes + p) * hw + at, acc[v]);
        }
      }
    }
    __syncthreads();  // every read of src and write of dst done before the swap
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <typename T, int K>
cudaError_t launch_tiled(const void* x, const void* w, void* xs, void* out, int64_t planes, int h, int wd,
                         int steps, cudaStream_t s) {
  const TiledPlan plan = tiled_plan(h, wd, K, steps, sizeof(T), false);
  if (plan.th == 0) return cudaErrorInvalidValue;
  const int tiles = ((h + plan.th - 1) / plan.th) * ((wd + plan.tw - 1) / plan.tw);
  if (planes * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = tiled_smem(plan.th, plan.tw, h, wd, K, steps, sizeof(T), false, false);
  // an even row length (and w aligned to two elements): every row starts at
  // an even element, so pairs of pixels from an even column load their
  // weights as one aligned 4- or 8-byte value
  const bool pairs = wd % 2 == 0 && reinterpret_cast<uintptr_t>(w) % (2 * sizeof(T)) == 0;
  auto kern = pairs ? stencil_tiled_fwd_kernel<T, K, 2> : stencil_tiled_fwd_kernel<T, K, 1>;
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)(planes * tiles), tiled_threads(K), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(xs), static_cast<T*>(out), planes, h, wd,
      steps, plan.th, plan.tw, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled_k(const void* x, const void* w, void* xs, void* out, int64_t planes, int h, int wd,
                           int k, int steps, cudaStream_t s) {
  switch (k) {
    case 1: return launch_tiled<T, 1>(x, w, xs, out, planes, h, wd, steps, s);
    case 3: return launch_tiled<T, 3>(x, w, xs, out, planes, h, wd, steps, s);
    case 5: return launch_tiled<T, 5>(x, w, xs, out, planes, h, wd, steps, s);
    case 7: return launch_tiled<T, 7>(x, w, xs, out, planes, h, wd, steps, s);
    case 9: return launch_tiled<T, 9>(x, w, xs, out, planes, h, wd, steps, s);
    case 11: return launch_tiled<T, 11>(x, w, xs, out, planes, h, wd, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
__global__ void stencil_step_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                    T* __restrict__ out, int64_t planes, int h, int wd,
                                    int k) {
  const int64_t hw = (int64_t)h * wd;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= planes * hw) return;
  const int64_t p = idx / hw;
  const int64_t pix = idx - p * hw;
  const int y = (int)(pix / wd);
  const int xx = (int)(pix - (int64_t)y * wd);
  const int r = k / 2;
  const T* xp = x + p * hw;
  const T* wp = w + p * (int64_t)k * k * hw + pix;
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - r;
    if (sy < 0 || sy >= h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int sx = xx + dx - r;
      if (sx < 0 || sx >= wd) continue;
      const int t = dy * k + dx;
      acc = fmaf(load_f(xp + (int64_t)sy * wd + sx), load_f(wp + (int64_t)t * hw), acc);
    }
  }
  store_f(out + idx, acc);
}

template <typename T>
__global__ void stencil_step_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                         T* __restrict__ out, int64_t total, int h, int wd,
                                         int c, int k) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  const int64_t pix = idx / c;  // (b * H + y) * W + x
  const int xx = (int)(pix % wd);
  const int64_t by = pix / wd;
  const int y = (int)(by % h);
  const int64_t b = by / h;
  const int r = k / 2;
  const T* xb = x + b * h * (int64_t)wd * c + ch;
  const T* wp = w + pix * k * k * (int64_t)c + ch;
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int sy = y + dy - r;
    if (sy < 0 || sy >= h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int sx = xx + dx - r;
      if (sx < 0 || sx >= wd) continue;
      const int t = dy * k + dx;
      acc = fmaf(load_f(xb + ((int64_t)sy * wd + sx) * c), load_f(wp + (int64_t)t * c), acc);
    }
  }
  store_f(out + idx, acc);
}

// 4 fp32 values of the shared buffers (16-byte aligned)
__device__ __forceinline__ void ld_buf(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void st_buf(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// 4 channels (a quad) of T as one raw word, 16 bytes of fp32 or 8 of
// bf16: loads through the read-only path (ldg) or past L1 (ldcg), and the
// word's channels as fp32
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw ldg(const float* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ Raw ldcg(const float* p) { return __ldcg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ void unpack(const Raw& t, float (&v)[4]) {
    v[0] = __uint_as_float(t.x);
    v[1] = __uint_as_float(t.y);
    v[2] = __uint_as_float(t.z);
    v[3] = __uint_as_float(t.w);
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw ldg(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  static __device__ __forceinline__ Raw ldcg(const __nv_bfloat16* p) { return __ldcg(reinterpret_cast<const uint2*>(p)); }
  static __device__ __forceinline__ void unpack(const Raw& t, float (&v)[4]) {
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  }
};

// the first `valid` of 4 channels at p (the masked tail of C) as fp32,
// the rest 0: element loads
__device__ __forceinline__ void ld_elems(const float* p, int valid, float (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < valid ? p[k] : 0.f;
}
__device__ __forceinline__ void ld_elems(const __nv_bfloat16* p, int valid, float (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < valid ? __bfloat162float(p[k]) : 0.f;
}

// 4 channels into global memory at p in its dtype: one access on the
// vector route, else element stores of the first `valid`
template <bool VEC>
__device__ __forceinline__ void st_quad(float* p, int valid, const float (&v)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < valid) p[k] = v[k];
  }
}
template <bool VEC>
__device__ __forceinline__ void st_quad(__nv_bfloat16* p, int valid, const float (&v)[4]) {
  if constexpr (VEC) {
    __nv_bfloat162 b[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(b);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < valid) p[k] = __float2bfloat16_rn(v[k]);
  }
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(tiled_threads(K), 1)
stencil_nhwc_plane_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ xs, T* __restrict__ out,
                          int64_t batch, int h, int wd, int c, int steps, int groups) {
  constexpr int R = K / 2, KK = K * K, V = nhwc_group(sizeof(T));
  extern __shared__ __align__(16) float nhwc_smem[];
  const int grp = (int)(blockIdx.x % groups);
  const int64_t b = blockIdx.x / groups;
  const int c0 = grp * V, valid = min(V, c - c0);
  const int pw = wd + 2 * R, pn = (h + 2 * R) * pw;  // the plane padded by r
  const int hw = h * wd;
  float* src = nhwc_smem;
  float* dst = nhwc_smem + (size_t)pn * V;
  T* const wsm = reinterpret_cast<T*>(nhwc_smem + 2 * (size_t)pn * V);  // [pixel][tap][V]
  const int64_t img = b * hw * c + c0;  // pixel p's group at img + p*c in x, out and each step of xs
  const int64_t xs_step = batch * hw * c;
  const T* const wb = w + b * hw * KK * c + c0;  // pixel p's tap t at wb + (p*KK + t)*c

  // x on the padded buffer (the r-wide edge zero), the second buffer zeroed,
  // the step-0 input saved; a quad of 4 channels at a time (the group's
  // S quads of a pixel are neighbours in the buffers)
  constexpr int S = V / 4;  // quads a group
  for (int i = threadIdx.x; i < pn * S; i += blockDim.x) {
    const int pp = i / S, q = i - pp * S;
    const int yy = pp / pw - R, xx = pp % pw - R;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const int qvalid = valid - q * 4;
    if (yy >= 0 && yy < h && xx >= 0 && xx < wd && qvalid > 0) {
      const int64_t at = img + ((int64_t)yy * wd + xx) * c + q * 4;
      if constexpr (VEC) {
        Quad<T>::unpack(Quad<T>::ldg(x + at), v);
      } else {
        ld_elems(x + at, qvalid, v);
      }
      if (xs != nullptr) st_quad<VEC>(xs + at, qvalid, v);  // x's own value: exact in its dtype
    }
    st_buf(src + (size_t)i * 4, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = 0.f;
    st_buf(dst + (size_t)i * 4, v);
  }
  // the plane's w for the group, one 16-byte copy a (pixel, tap): cp.async
  // on the vector route, element copies (the tail zero) on the other
  for (int i = threadIdx.x; i < hw * KK; i += blockDim.x) {
    const T* s = wb + (int64_t)i * c;
    T* d = wsm + (size_t)i * V;
    if constexpr (VEC) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = k < valid ? s[k] : T{};
    }
  }
  if constexpr (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // a thread computes a quad of a pixel (the group's one in fp32, one of
  // its two in bf16), so that a bf16 block has twice the threads of an fp32
  // one for the same work a thread
  for (int s = 0; s < steps; ++s) {
    for (int it = threadIdx.x; it < hw * S; it += blockDim.x) {
      const int pix = it / S, q = it - pix * S;
      const int y = pix / wd, xx = pix - (pix / wd) * wd;
      const float* win = src + ((size_t)y * pw + xx) * V + q * 4;  // top-left tap in the padded buffer
      const T* wq = wsm + (size_t)pix * KK * V + q * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll tiled_row_unroll(K)
      for (int dy = 0; dy < K; ++dy) {
        float wv[K][4];
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          Quad<T>::unpack(*reinterpret_cast<const typename Quad<T>::Raw*>(wq + (size_t)(dy * K + dx) * V), wv[dx]);
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float xv[4];
          ld_buf(win + (size_t)(dy * pw + dx) * V, xv);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] = fmaf(xv[v], wv[dx][v], acc[v]);
        }
      }
      const int64_t at = img + (int64_t)pix * c + q * 4;
      const int qvalid = valid - q * 4;
      if (s == steps - 1) {
        if (qvalid > 0) st_quad<VEC>(out + at, qvalid, acc);
      } else {
        float rv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) rv[v] = round_to(acc[v], x);
        st_buf(dst + ((size_t)(y + R) * pw + xx + R) * V + q * 4, rv);
        if (xs != nullptr && qvalid > 0) st_quad<VEC>(xs + (s + 1) * xs_step + at, qvalid, acc);
      }
    }
    __syncthreads();  // every read of src and write of dst done before the swap
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <typename T, int K>
cudaError_t launch_nhwc_plane(const void* x, const void* w, void* xs, void* out, int64_t batch, int h, int wd, int c,
                              int steps, int device, cudaStream_t s) {
  constexpr int V = nhwc_group(sizeof(T));
  const int groups = (c + V - 1) / V;
  if (batch * groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = nhwc_plane_smem(h, wd, K, sizeof(T));
  // 16-byte accesses of x, out and xs need whole groups and aligned tensors
  const bool vec = c % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xs) % 16 == 0;
  auto kern = vec ? stencil_nhwc_plane_kernel<T, K, true> : stencil_nhwc_plane_kernel<T, K, false>;
  // lift each kernel's shared-memory limit once per device
  static bool raised[2][64] = {};
  if (smem > STATIC_SMEM_LIMIT && !(device < 64 && raised[vec][device])) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FUSED_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    if (device < 64) raised[vec][device] = true;
  }
  const int threads = std::min(tiled_threads(K), (h * wd * (V / 4) + 31) / 32 * 32);
  kern<<<(unsigned)(batch * groups), threads, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                          static_cast<T*>(xs), static_cast<T*>(out), batch, h, wd, c,
                                                          steps, groups);
  return cudaGetLastError();
}

// A grid barrier for a cooperative launch (every block resident): the
// k-th barrier of a launch returns once all gridDim.x blocks have arrived at
// it, count starting at 0.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's stores of the step before every arrival
    atomicAdd(count, 1u);
    const unsigned target = k * gridDim.x;
    while (*reinterpret_cast<volatile unsigned*>(count) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// the first `valid` of 4 channels at p (global, written earlier in this
// launch by other blocks), the rest 0: element loads that skip L1, which
// is not coherent across SMs
__device__ __forceinline__ void ld_elems_cg(const float* p, int valid, float (&v)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < valid ? __ldcg(p + k) : 0.f;
}
__device__ __forceinline__ void ld_elems_cg(const __nv_bfloat16* p, int valid, float (&v)[4]) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < valid ? __uint_as_float((unsigned)__ldcg(q + k) << 16) : 0.f;
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(NHWC_GRID_THREADS, K <= 7 ? 4 : 2)
stencil_nhwc_grid_kernel(const T* __restrict__ x, const T* __restrict__ w, T* xs, T* out, T* scratch,
                         unsigned* count, int64_t batch, int h, int wd, int c, int steps) {
  constexpr int R = K / 2, KK = K * K;
  using Q = Quad<T>;
  const int quads = (c + 3) / 4;
  const int64_t hw = (int64_t)h * wd, n = batch * hw * c;  // elements of one step's tensor
  const int64_t items = batch * hw * quads;
  for (int s = 0; s < steps; ++s) {
    if (s > 0) grid_barrier(count, s);  // step s - 1's outputs all stored
    const T* src = s == 0 ? x : (xs != nullptr ? xs + s * n : scratch + ((s - 1) & 1) * n);
    T* dst = s == steps - 1 ? out : (xs != nullptr ? xs + (s + 1) * n : scratch + (s & 1) * n);
    for (int64_t it = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; it < items;
         it += (int64_t)gridDim.x * blockDim.x) {
      // (b, pixel, quad of 4 channels), the quad fastest: a pixel's quads
      // are neighbouring lanes, whose loads of a tap's C channels are
      // contiguous
      const int qd = (int)(it % quads);
      const int64_t pl = it / quads;  // b * H * W + pixel
      const int64_t b = pl / hw;
      const int pix = (int)(pl - b * hw);
      const int y = pix / wd, xx = pix - (pix / wd) * wd;
      const int c0 = qd * 4, valid = min(4, c - c0);
      const T* sb = src + b * hw * c + c0;
      const T* wq = w + pl * KK * c + c0;
      if (s == 0 && xs != nullptr) {
        float v[4];
        if constexpr (VEC) {
          Q::unpack(Q::ldg(x + pl * c + c0), v);
        } else {
          ld_elems(x + pl * c + c0, valid, v);
        }
        st_quad<VEC>(xs + pl * c + c0, valid, v);  // x's own value: exact in its dtype
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll tiled_row_unroll(K)
      for (int dy = 0; dy < K; ++dy) {
        const int yy = y + dy - R;
        if (yy < 0 || yy >= h) continue;
        if constexpr (VEC) {
          // the row's k taps of w and of the step's input as raw words (16
          // bytes of fp32, 8 of bf16), all loads in flight before the
          // first is used, converted at the multiply
          typename Q::Raw rw[K], rx[K];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            rw[dx] = Q::ldg(wq + (int64_t)(dy * K + dx) * c);
            const int xc = xx + dx - R;
            rx[dx] = xc >= 0 && xc < wd ? Q::ldcg(sb + ((int64_t)yy * wd + xc) * c) : typename Q::Raw{};
          }
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            float wv[4], xv[4];
            Q::unpack(rw[dx], wv);
            Q::unpack(rx[dx], xv);
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[v] = fmaf(xv[v], wv[v], acc[v]);
          }
        } else {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            float wv[4], xv[4];
            ld_elems(wq + (int64_t)(dy * K + dx) * c, valid, wv);
            const int xc = xx + dx - R;
            if (xc >= 0 && xc < wd) {
              ld_elems_cg(sb + ((int64_t)yy * wd + xc) * c, valid, xv);
            } else {
#pragma unroll
              for (int v = 0; v < 4; ++v) xv[v] = 0.f;
            }
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[v] = fmaf(xv[v], wv[v], acc[v]);
          }
        }
      }
      st_quad<VEC>(dst + pl * c + c0, valid, acc);  // rounded to T, as the chain rounds each step
    }
  }
}

template <typename T, int K>
cudaError_t launch_nhwc_grid(const void* x, const void* w, void* xs, void* out, void* scratch, unsigned* count,
                             int64_t batch, int h, int wd, int c, int steps, int device, cudaStream_t s) {
  // a quad's one access needs whole quads and aligned tensors
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xs) % 16 == 0 && reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
  auto kern = vec ? stencil_nhwc_grid_kernel<T, K, true> : stencil_nhwc_grid_kernel<T, K, false>;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NHWC_GRID_THREADS, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t items = batch * h * wd * ((c + 3) / 4);
  const int64_t want = (items + NHWC_GRID_THREADS - 1) / NHWC_GRID_THREADS;
  const int grid = (int)std::min<int64_t>(want, (int64_t)per_sm * sms);
  if (grid < 1) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* xsp = static_cast<T*>(xs);
  T* op = static_cast<T*>(out);
  T* sp = static_cast<T*>(scratch);
  void* args[] = {&xp, &wp, &xsp, &op, &sp, &count, &batch, &h, &wd, &c, &steps};
  return launch_error(cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NHWC_GRID_THREADS), args, 0, s));
}

template <typename T>
cudaError_t launch_nhwc_grid_k(const void* x, const void* w, void* xs, void* out, void* scratch, unsigned* count,
                               int64_t batch, int h, int wd, int c, int k, int steps, int device, cudaStream_t s) {
  switch (k) {
    case 1: return launch_nhwc_grid<T, 1>(x, w, xs, out, scratch, count, batch, h, wd, c, steps, device, s);
    case 3: return launch_nhwc_grid<T, 3>(x, w, xs, out, scratch, count, batch, h, wd, c, steps, device, s);
    case 5: return launch_nhwc_grid<T, 5>(x, w, xs, out, scratch, count, batch, h, wd, c, steps, device, s);
    case 7: return launch_nhwc_grid<T, 7>(x, w, xs, out, scratch, count, batch, h, wd, c, steps, device, s);
    case 9: return launch_nhwc_grid<T, 9>(x, w, xs, out, scratch, count, batch, h, wd, c, steps, device, s);
    case 11: return launch_nhwc_grid<T, 11>(x, w, xs, out, scratch, count, batch, h, wd, c, steps, device, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_nhwc_plane_k(const void* x, const void* w, void* xs, void* out, int64_t batch, int h, int wd, int c,
                          int k, int steps, int device, cudaStream_t s) {
  switch (k) {
    case 1: return launch_nhwc_plane<T, 1>(x, w, xs, out, batch, h, wd, c, steps, device, s);
    case 3: return launch_nhwc_plane<T, 3>(x, w, xs, out, batch, h, wd, c, steps, device, s);
    case 5: return launch_nhwc_plane<T, 5>(x, w, xs, out, batch, h, wd, c, steps, device, s);
    case 7: return launch_nhwc_plane<T, 7>(x, w, xs, out, batch, h, wd, c, steps, device, s);
    case 9: return launch_nhwc_plane<T, 9>(x, w, xs, out, batch, h, wd, c, steps, device, s);
    case 11: return launch_nhwc_plane<T, 11>(x, w, xs, out, batch, h, wd, c, steps, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA ordinal of the tensors
// and of the stream. Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int dgtd_diffusion_step(const void* x, const void* w, void* out, long long planes,
                                   int h, int wd, int k, int dtype, int device, void* stream) {
  // this library carries its own CUDA runtime: make the tensors' device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)planes * h * wd;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    stencil_step_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
        planes, h, wd, k);
  } else if (dtype == 1) {
    stencil_step_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), planes, h, wd, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Fused entry: all `steps` (>= 1) steps in one launch, for planes within
// fused_fits (else cudaErrorInvalidValue). x and out (P, H, W), w
// (P, k*k, H, W); xs, when not null, (steps, P, H, W) receives every step's
// input. dtype and device as above. Returns cudaGetLastError() after the
// launch.
extern "C" int dgtd_diffusion_fused(const void* x, const void* w, void* xs, void* out,
                                    long long planes, int h, int wd, int k, int steps, int dtype,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!fused_fits(h, wd, k, dtype == 0 ? 4 : 2) || steps < 1 || planes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (planes <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fused_k<float>(x, w, xs, out, planes, h, wd, k, steps, s);
  return (int)launch_fused_k<__nv_bfloat16>(x, w, xs, out, planes, h, wd, k, steps, s);
}

// Cluster entry: all `steps` (>= 1) steps in one launch, for planes whose
// stencil_route is ROUTE_CLUSTER (else cudaErrorInvalidValue); arguments as
// the fused entry's. Returns the launch's error (0 on success).
extern "C" int dgtd_diffusion_cluster(const void* x, const void* w, void* xs, void* out,
                                      long long planes, int h, int wd, int k, int steps, int dtype,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (stencil_route(h, wd, k, dtype == 0 ? 4 : 2) != ROUTE_CLUSTER || steps < 1 ||
      planes > 0x7fffffffLL / CLUSTER_MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  if (planes <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_cluster_k<float>(x, w, xs, out, planes, h, wd, k, steps, s);
  return (int)launch_cluster_k<__nv_bfloat16>(x, w, xs, out, planes, h, wd, k, steps, s);
}

// Tiled entry: all `steps` (>= 1) steps in one launch, for planes whose
// stencil_route is ROUTE_TILED and that have a tiled_plan (else
// cudaErrorInvalidValue); arguments as the fused entry's. Returns the
// launch's error.
extern "C" int dgtd_diffusion_tiled(const void* x, const void* w, void* xs, void* out, long long planes, int h,
                                    int wd, int k, int steps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (stencil_route(h, wd, k, dtype == 0 ? 4 : 2) != ROUTE_TILED || steps < 1) return (int)cudaErrorInvalidValue;
  if (planes <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tiled_k<float>(x, w, xs, out, planes, h, wd, k, steps, s);
  return (int)launch_tiled_k<__nv_bfloat16>(x, w, xs, out, planes, h, wd, k, steps, s);
}

// The tiled kernels' plan of an (h, wd) plane (forward, or backward when
// `backward` is not 0): the tile's rows, columns and mode into *th, *tw and
// *ws (th = 0: no tile fits), and its shared memory in bytes as the return.
extern "C" long long dgtd_tiled_plan(int h, int wd, int k, int steps, int elem_bytes, int backward, int* th,
                                     int* tw, int* ws) {
  const TiledPlan plan = tiled_plan(h, wd, k, steps, elem_bytes, backward != 0);
  *th = plan.th;
  *tw = plan.tw;
  *ws = plan.ws;
  if (plan.th == 0) return 0;
  return (long long)tiled_smem(plan.th, plan.tw, h, wd, k, steps, elem_bytes, backward != 0, plan.ws);
}

// The route of an (h, wd) plane at kernel k and element size elem_bytes, as
// the entries above decide it: 0 fused, 1 cluster, 2 per-step, 3 tiled; and
// the cluster split into *blocks and *rows.
extern "C" int dgtd_stencil_route(int h, int wd, int k, int elem_bytes, int* blocks, int* rows) {
  const ClusterSplit sp = cluster_split(h, wd);
  *blocks = sp.blocks;
  *rows = sp.rows;
  return stencil_route(h, wd, k, elem_bytes);
}

// How many clusters of the k = 7 cluster forward (bf16) the card holds at
// once, each of `blocks` blocks of `rows` x wd pixels, from
// cudaOccupancyMaxActiveClusters, into *clusters. blocks above the portable
// 8 are allowed for this query (cudaFuncAttributeNonPortableClusterSizeAllowed).
// Returns the query's error.
extern "C" int dgtd_diffusion_cluster_occupancy(int blocks, int rows, int wd, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int R = 3;
  auto kern = stencil_cluster_fwd_kernel<__nv_bfloat16, 7>;
  if (blocks > CLUSTER_MAX_BLOCKS) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  const ClusterLaunch launch((unsigned)blocks, blocks, strip_threads(rows, wd),
                             2 * sizeof(float) * (size_t)(rows + 2 * R) * (wd + 2 * R), nullptr);
  return (int)launch_error(cudaOccupancyMaxActiveClusters(clusters, kern, &launch.cfg));
}

// NHWC plane entry: all `steps` (>= 1) steps in one launch, for planes
// whose nhwc_route is NHWC_PLANE (else cudaErrorInvalidValue). x and out
// (B, H, W, C), w (B, H, W, k*k*C) tap-major; xs, when not null,
// (steps, B, H, W, C) receives every step's input. dtype and device as
// above. Returns the launch's error.
extern "C" int dgtd_diffusion_nhwc_plane(const void* x, const void* w, void* xs, void* out, long long batch, int h,
                                         int wd, int c, int k, int steps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || steps < 1 || nhwc_route(h, wd, k, dtype == 0 ? 4 : 2) != NHWC_PLANE)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || c <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_nhwc_plane_k<float>(x, w, xs, out, batch, h, wd, c, k, steps, device, s);
  return (int)launch_nhwc_plane_k<__nv_bfloat16>(x, w, xs, out, batch, h, wd, c, k, steps, device, s);
}

// NHWC grid entry: all `steps` (>= 1) steps in one cooperative launch at an
// odd k up to 11, every step's outputs stored in x's dtype and read back by
// the next step after a grid barrier. x and out (B, H, W, C), w
// (B, H, W, k*k*C) tap-major; xs, when not null, (steps, B, H, W, C)
// receives every step's input, else scratch (min(steps - 1, 2) tensors
// like x) holds the steps between; count: one zeroed-by-the-entry unsigned.
extern "C" int dgtd_diffusion_nhwc_grid(const void* x, const void* w, void* xs, void* out, void* scratch,
                                        unsigned* count, long long batch, int h, int wd, int c, int k, int steps,
                                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || k < 1 || k % 2 == 0 || k > TILED_MAX_KERNEL || steps < 1 ||
      (xs == nullptr && steps > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || c <= 0 || h <= 0 || wd <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_nhwc_grid_k<float>(x, w, xs, out, scratch, count, batch, h, wd, c, k, steps, device, s);
  return (int)launch_nhwc_grid_k<__nv_bfloat16>(x, w, xs, out, scratch, count, batch, h, wd, c, k, steps, device, s);
}

// The NHWC route of an (h, wd) plane at kernel k and element size
// elem_bytes, as the entries above decide it: 0 plane, 1 grid, 2 per-step;
// the plane kernel's shared memory in bytes into *smem.
extern "C" int dgtd_nhwc_route(int h, int wd, int k, int elem_bytes, long long* smem) {
  *smem = h > 0 && wd > 0 && k > 0 && k % 2 == 1 && k <= TILED_MAX_KERNEL ? (long long)nhwc_plane_smem(h, wd, k, elem_bytes) : 0;
  return nhwc_route(h, wd, k, elem_bytes);
}

// NHWC per-step entry: one step; x and out (B, H, W, C), w (B, H, W, k*k*C)
// tap-major; dtype and device as above. Returns cudaGetLastError() after the
// launch.
extern "C" int dgtd_diffusion_step_nhwc(const void* x, const void* w, void* out, long long batch,
                                        int h, int wd, int c, int k, int dtype, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)batch * h * wd * c;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    stencil_step_nhwc_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
        total, h, wd, c, k);
  } else if (dtype == 1) {
    stencil_step_nhwc_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), total, h, wd, c, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
