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
// The fourth kernel, stencil_step_nhwc_kernel, replaces
// dgtd_tpu/ops/diffusion_pallas.py::diffusion_step_pallas (the Pallas kernel
// _stencil_kernel): the same step on NHWC x (B, H, W, C) with tap-major
// weights (B, H, W, k*k*C), whose index is t*C + c (to_tap_major):
//
//   out[b, y, x, c] = sum_t x[b, y + t/k - r, x + t%k - r, c] * w[b, y, x, t*C + c]
//
// read in place, without a copy into plane layout (w is k*k times x). One
// thread per output element; consecutive threads take consecutive c, so
// for each tap the reads of x and of w[b, y, x, t*C : (t+1)*C] are
// coalesced. Bound and launch pattern as above.

#include "stencil_common.cuh"

namespace {

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

// NHWC entry: x and out (B, H, W, C), w (B, H, W, k*k*C) tap-major; dtype and
// device as above. Returns cudaGetLastError() after the launch.
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
