// Backward of the depth-diffusion stencil steps for Hopper (sm_90a), plane
// layout.
//
// Replaces dgtd_tpu/ops/diffusion_pallas.py::diffusion_step_bwd_pallas, whose
// two Pallas kernels, chained over the steps in reverse
// (_diffusion_v2p_bwd), compute for each step
//   _stencil_bwd_x_kernel (transpose stencil)
//     dx[p, q] = sum_t g[p, q - o_t] * w[p, t, q - o_t]
//   _stencil_bwd_w_kernel (per-tap product)
//     dw[p, t, q] = g[p, q] * x[p, q + o_t]
// with o_t = (t/k - r, t%k - r), r = k/2, and every tap that falls outside
// the plane skipped (the forward's halo is zero). x is the step's input
// (P, H, W), g the gradient of its output (P, H, W), w the normalized weights
// (P, k*k, H, W); all contiguous, fp32 or bf16, fp32 accumulation. dx is
// rounded to g's dtype after every step; dw is summed over the steps in fp32
// and rounded to w's dtype once.
//
// What bounds it on this card: bytes and launches. The backward reads w and
// writes dw once (2 k*k values per pixel) and does about 3 flops per tap and
// step, far below the fp32 ridge. At the train shape (P = 10*24 planes of
// 12x12, k = 7) that is a few MB that the 50 MB L2 holds, so launches and
// their host calls set the time.
//
// Four kernels, chosen by shape and dtype alone as the forward's are
// (stencil_route in stencil_common.cuh, mirrored by
// ops/diffusion.py::stencil_route):
//
// stencil_fused_bwd_kernel runs all the steps in reverse in one launch. One
// block per plane, one thread per pixel, k a template argument. In shared
// memory: g as a padded fp32 plane in two ping-pong buffers with a zero
// halo, the step's input x_s as a third padded plane (loaded from the
// forward's (steps, P, H, W) tensor of step inputs), and the plane's k*k
// weight planes in w's dtype. The transpose reads the weights of the
// *neighbour* pixel q - o_t, not its own, so a thread's registers cannot
// serve it: the weights are staged once and read from shared memory by every
// step (28 KB in fp32 at 12x12, k = 7). The dw sums stay on chip across the
// steps, k*k fp32 registers a pixel, and are written once, in w's dtype; no
// fp32 dw tensor goes through memory. A __syncthreads() separates the steps.
// Each dw term is a product rounded to fp32 and then added (__fmul_rn keeps
// the compiler from fusing it into an FMA), in the order of the plain
// version's sum, so dw matches it to the last bit wherever g does.
//
// stencil_cluster_bwd_kernel runs all the steps of a larger plane in
// reverse in one launch, the plane split into strips over a thread block
// cluster as the cluster forward splits it (one block a strip of at most
// 512 pixels, up to 8 blocks). In each block's shared memory: g and the step
// input as padded fp32 strips in ping-pong pairs with r halo rows, and the
// k*k weight planes of the strip and of its r halo rows, staged once per
// call: the strip's own from device memory, the halo rows' from the
// neighbouring blocks through distributed shared memory. Each step writes
// its rounded dx, and the next step's input (prefetched while it computes),
// into the next buffers and, for a strip's first or last r rows, into the
// neighbour's halo rows (put_strip); one cluster.sync() a step. dw stays in
// k*k fp32 registers a pixel across the steps and is written once, in w's
// dtype, as in the fused kernel (same product-then-add order). At
// (192, 64, 64), k = 7, 8 rows a block: 103 KB of shared memory in bf16,
// 191 KB in fp32, so one block an SM; w is read and dw written once per
// call, where the per-step kernels read w 4 times and move an fp32 dw sum
// of 154 MB three times.
//
// stencil_tiled_bwd_kernel runs the backward of all the steps of any other
// plane at an odd k up to 11 in one launch over the tiles tiled_plan gives
// it, in reverse: the gradient of step t's input is computed on the
// interior grown by t*r, from the gradient of its output on the interior
// grown by (t+1)*r, so the block loads g on the interior grown by s*r and
// the region shrinks by r a step (the plane's zero edge beyond it). Each
// step's gradient is rounded to g's dtype, as the chained per-step calls
// store it. The transpose reads w at the tap's source pixel: its address is
// clamped into the plane and its value masked, so that each row's k loads
// are unbranched and in flight together (at k <= 7 a pixel whose window
// lies in the plane skips the clamp and the mask). In shared memory the block keeps
// every step's gradient on the interior and every step's input on the
// interior grown by r; after the step loop it forms dw from them, a row of
// k taps of a pixel at a time (k fp32 sums in registers, not k*k: at
// k = 11 121 sums a pixel would not fit), each product rounded to fp32 and
// added last step first, as the plain version sums, and writes it once in
// w's dtype: no fp32 dw goes through memory between steps. ws mode
// (tiled_plan takes it at 2 or more steps where the tiles read at most
// 1.5x the plane's w, as kernel11's 12x12 planes, one tile a plane) stages
// w on the interior grown by s*r during the first step for the later
// ones. Bound: the bytes of w and dw; at (192, 96, 96), k = 7 the per-step
// kernels move ~2.9 GB a call, this kernel reads w through L2 ~5x and
// writes dw once.
//
// stencil_bwd_kernel, one step a launch, takes k >= 13 and step counts
// whose halo no tile holds:
// one thread per (plane, pixel), which gathers dx (no atomics) and writes
// its k*k dw taps. The caller chains the steps in reverse; a step adds dw_in
// (fp32, null for the first step of the chain) to its own product and
// writes dw_out, in fp32 for every step but the last and in the weights'
// dtype for the last, so bf16 weights round once. In fp32 dw_in and dw_out
// may be the same buffer: each thread reads its element before it writes
// it. Consecutive threads take consecutive x of one row, so the reads of g,
// w[p, t, ...] and the writes of dw[p, t, ...] are coalesced; the
// neighbourhood reads hit L1.

#include "stencil_common.cuh"

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(FUSED_MAX_PIXELS)
stencil_fused_bwd_kernel(const T* __restrict__ g, const T* __restrict__ xs, const T* __restrict__ w,
                         T* __restrict__ dx, T* __restrict__ dw, int64_t planes, int h, int wd,
                         int steps) {
  constexpr int R = K / 2, KK = K * K;
  extern __shared__ float smem[];
  const int pw = wd + 2 * R, pn = (h + 2 * R) * pw, hw = h * wd;
  float* gsrc = smem;
  float* gdst = smem + pn;
  float* xpad = smem + 2 * pn;
  T* ws = reinterpret_cast<T*>(smem + 3 * pn);
  const int64_t p = blockIdx.x;
  const int pix = threadIdx.x;
  const bool live = pix < hw;
  for (int i = threadIdx.x; i < 3 * pn; i += blockDim.x) smem[i] = 0.f;
  // each thread stages its own pixel's k*k weights: KK independent
  // coalesced loads in flight, as the forward loads them into registers
  if (live) {
    const T* wp = w + p * KK * hw + pix;
#pragma unroll
    for (int t = 0; t < KK; ++t) ws[t * hw + pix] = wp[(int64_t)t * hw];
  }
  __syncthreads();

  const int y = live ? pix / wd : 0;
  const int xx = live ? pix - y * wd : 0;
  const int centre = (y + R) * pw + xx + R;
  const T* xq = xs + p * hw + pix;  // this pixel of step 0's input
  const int64_t step_stride = planes * hw;
  float xnext = 0.f;
  if (live) {
    gsrc[centre] = load_f(g + p * hw + pix);
    xnext = load_f(xq + (steps - 1) * step_stride);
  }
  float acc[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = 0.f;

  for (int s = steps - 1; s >= 0; --s) {
    if (live) xpad[centre] = xnext;
    __syncthreads();  // g and x_s in place
    // the next step's input, loaded while this step computes
    if (live && s > 0) xnext = load_f(xq + (s - 1) * step_stride);
    if (live) {
      const float gq = gsrc[centre];
      float d = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int sy = y + R - dy;  // q - o_t, row
#pragma unroll
        for (int ddx = 0; ddx < K; ++ddx) {
          const int t = dy * K + ddx;
          acc[t] += __fmul_rn(gq, xpad[(y + dy) * pw + xx + ddx]);
          const int sx = xx + R - ddx;
          if (sy >= 0 && sy < h && sx >= 0 && sx < wd)
            d = fmaf(gsrc[(sy + R) * pw + sx + R], to_f(ws[t * hw + sy * wd + sx]), d);
        }
      }
      if (s == 0) {
        store_f(dx + p * hw + pix, d);
      } else {
        gdst[centre] = round_to(d, g);
      }
    }
    __syncthreads();  // every read of gsrc and xpad done before they change
    float* t = gsrc;
    gsrc = gdst;
    gdst = t;
  }
  if (live) {
#pragma unroll
    for (int t = 0; t < KK; ++t) store_f(dw + (p * KK + t) * hw + pix, acc[t]);
  }
}

template <typename T, int K>
cudaError_t launch_fused(const void* g, const void* xs, const void* w, void* dx, void* dw,
                         int64_t planes, int h, int wd, int steps, cudaStream_t s) {
  const int threads = (h * wd + 31) / 32 * 32;
  const size_t smem = fused_bwd_smem(h, wd, K, sizeof(T));
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(stencil_fused_bwd_kernel<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  stencil_fused_bwd_kernel<T, K><<<(unsigned)planes, threads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(xs), static_cast<const T*>(w),
      static_cast<T*>(dx), static_cast<T*>(dw), planes, h, wd, steps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused_k(const void* g, const void* xs, const void* w, void* dx, void* dw,
                           int64_t planes, int h, int wd, int k, int steps, cudaStream_t s) {
  switch (k) {
    case 1: return launch_fused<T, 1>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 3: return launch_fused<T, 3>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 5: return launch_fused<T, 5>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 7: return launch_fused<T, 7>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(FUSED_MAX_PIXELS)
stencil_cluster_bwd_kernel(const T* __restrict__ g, const T* __restrict__ xs,
                           const T* __restrict__ w, T* __restrict__ dx, T* __restrict__ dw,
                           int64_t planes, int h, int wd, int steps, int blocks, int rows) {
  constexpr int R = K / 2, KK = K * K;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int pw = wd + 2 * R, pn = (rows + 2 * R) * pw, hw = h * wd;
  const int wn = (rows + 2 * R) * wd;  // a staged weight plane: the strip and its halo rows
  const int rank = (int)cluster.block_rank();
  const int64_t p = blockIdx.x / blocks;
  const int y0 = rank * rows;
  const int nrows = min(rows, h - y0);
  const int nrows_down = min(rows, h - y0 - rows);  // the strip below, if any
  const int pix = threadIdx.x;
  const bool live = pix < nrows * wd;
  const int ly = live ? pix / wd : 0;
  const int xx = live ? pix - ly * wd : 0;
  const int64_t at = p * hw + (int64_t)y0 * wd + pix;
  const int64_t step_stride = planes * hw;
  // shared memory: g's ping-pong pair at offsets 0 and pn, the step input's
  // at 2 pn and 3 pn, then the weights (R guard values first)
  T* const ws = reinterpret_cast<T*>(smem + 4 * pn) + R;
  const int ws_len = KK * wn + 2 * R;
  float* const up = rank > 0 ? cluster.map_shared_rank(smem, rank - 1) : nullptr;
  float* const down = rank + 1 < blocks ? cluster.map_shared_rank(smem, rank + 1) : nullptr;
  for (int i = threadIdx.x; i < 4 * pn; i += blockDim.x) smem[i] = 0.f;
  for (int i = threadIdx.x; i < ws_len; i += blockDim.x) store_f(ws + i - R, 0.f);
  __syncthreads();
  // each thread stages its own pixel's k*k weights: KK independent
  // coalesced loads in flight, read from memory once per call
  if (live) {
    const T* wp = w + p * KK * hw + (at - p * hw);
#pragma unroll
    for (int t = 0; t < KK; ++t) ws[t * wn + (ly + R) * wd + xx] = wp[(int64_t)t * hw];
  }
  cluster.sync();  // every block zeroed and its own weights staged

  // the transpose reads the weights of the r rows beyond the strip: copy
  // them once from the neighbours' shared memory (their first or last r
  // rows), never again from device memory
  if constexpr (R > 0) {
    const T* const ws_up = up != nullptr ? cluster.map_shared_rank(ws, rank - 1) : nullptr;
    const T* const ws_down = down != nullptr ? cluster.map_shared_rank(ws, rank + 1) : nullptr;
    for (int i = threadIdx.x; i < KK * R * wd; i += blockDim.x) {
      const int t = i / (R * wd), j = i - t * (R * wd);
      const int hr = j / wd, c = j - hr * wd;
      // above: that strip's rows rows - R + hr (it has `rows`) -> halo row hr
      if (ws_up != nullptr) ws[t * wn + hr * wd + c] = ws_up[t * wn + (rows + hr) * wd + c];
      // below: that strip's row hr, if it has one -> row R + nrows + hr
      if (ws_down != nullptr && hr < nrows_down)
        ws[t * wn + (R + nrows + hr) * wd + c] = ws_down[t * wn + (R + hr) * wd + c];
    }
  }
  int gcur = 0, gnxt = pn, xcur = 2 * pn, xnxt = 3 * pn;
  if (live) {
    put_strip<R>(smem, up, down, gcur, rows, nrows, pw, ly, xx, load_f(g + at));
    put_strip<R>(smem, up, down, xcur, rows, nrows, pw, ly, xx, load_f(xs + (steps - 1) * step_stride + at));
  }
  cluster.sync();  // weights, g and the last step's input in place, halos included

  float acc[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = 0.f;
  for (int s = steps - 1; s >= 0; --s) {
    // the next step's input, loaded while this step computes
    const float xn = live && s > 0 ? load_f(xs + (s - 1) * step_stride + at) : 0.f;
    float d = 0.f;
    if (live) {
      const float* gp = smem + gcur;
      const float* xp = smem + xcur;
      const float gq = gp[(ly + R) * pw + xx + R];
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int ddx = 0; ddx < K; ++ddx) {
          const int t = dy * K + ddx;
          acc[t] += __fmul_rn(gq, xp[(ly + dy) * pw + xx + ddx]);
          // transpose tap: source pixel (ly + R - dy, xx + R - ddx) of the
          // strip; rows beyond the plane hold zeros in g and w, columns
          // beyond it are masked (their padded g is zero too, but the
          // weight read wraps into the next row)
          const int sx = xx + R - ddx;
          const float wv = sx >= 0 && sx < wd ? to_f(ws[t * wn + (ly + 2 * R - dy) * wd + sx]) : 0.f;
          d = fmaf(gp[(ly + 2 * R - dy) * pw + xx + 2 * R - ddx], wv, d);
        }
      }
    }
    if (s == 0) {
      if (live) store_f(dx + at, d);
    } else {
      if (live) {
        put_strip<R>(smem, up, down, gnxt, rows, nrows, pw, ly, xx, round_to(d, g));
        put_strip<R>(smem, up, down, xnxt, rows, nrows, pw, ly, xx, xn);
      }
      // every read of the current buffers and write of the next ones, here
      // and in the neighbours, done before the swap; step 0 touches no other
      // block's memory, so this is also the last sync a block needs before
      // it exits
      cluster.sync();
      int t = gcur;
      gcur = gnxt;
      gnxt = t;
      t = xcur;
      xcur = xnxt;
      xnxt = t;
    }
  }
  if (live) {
#pragma unroll
    for (int t = 0; t < KK; ++t) store_f(dw + (p * KK + t) * hw + (at - p * hw), acc[t]);
  }
}

template <typename T, int K>
cudaError_t launch_cluster(const void* g, const void* xs, const void* w, void* dx, void* dw,
                           int64_t planes, int h, int wd, int steps, cudaStream_t s) {
  const ClusterSplit sp = cluster_split(h, wd);
  const size_t smem = cluster_bwd_smem(sp.rows, wd, K, sizeof(T));
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(stencil_cluster_bwd_kernel<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const ClusterLaunch launch((unsigned)(planes * sp.blocks), sp.blocks, strip_threads(sp.rows, wd), smem, s);
  return launch_error(cudaLaunchKernelEx(
      &launch.cfg, stencil_cluster_bwd_kernel<T, K>, static_cast<const T*>(g), static_cast<const T*>(xs),
      static_cast<const T*>(w), static_cast<T*>(dx), static_cast<T*>(dw), planes, h, wd, steps,
      sp.blocks, sp.rows));
}

template <typename T>
cudaError_t launch_cluster_k(const void* g, const void* xs, const void* w, void* dx, void* dw,
                             int64_t planes, int h, int wd, int k, int steps, cudaStream_t s) {
  switch (k) {
    case 1: return launch_cluster<T, 1>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 3: return launch_cluster<T, 3>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 5: return launch_cluster<T, 5>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 7: return launch_cluster<T, 7>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K, bool WS>
__global__ void __launch_bounds__(tiled_threads(K), tiled_bwd_min_blocks(K))
stencil_tiled_bwd_kernel(const T* __restrict__ g, const T* __restrict__ xs, const T* __restrict__ w,
                         T* __restrict__ dx, T* __restrict__ dw, int64_t planes, int h, int wd, int steps, int th,
                         int tw, int tiles) {
  constexpr int R = K / 2, KK = K * K;
  extern __shared__ float smem[];
  const int64_t p = blockIdx.x / tiles;
  const TileBox b = tile_box((int)(blockIdx.x - p * tiles), h, wd, th, tw, R, steps * R, steps * R);
  const int64_t hw = (int64_t)h * wd;
  const int bn = b.bh * b.bw, wn = b.wh * b.ww;
  const int ih = b.y1 - b.y0, iw = b.x1 - b.x0, in = ih * iw;
  const int xw = iw + 2 * R, xn = (ih + 2 * R) * xw;  // a step input on the interior grown by r
  // shared memory: the gradient's ping-pong pair, every step's gradient on
  // the interior, every step's input on the interior grown by r, then w
  float* src = smem;
  float* dst = smem + bn;
  float* const ghist = smem + 2 * bn;
  float* const xhist = ghist + steps * in;
  T* const ws = reinterpret_cast<T*>(xhist + steps * xn);
  const T* const wp = w + p * KK * hw;

#pragma unroll 4
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    src[i] = load_or_zero(g + p * hw, b.by0 + i / b.bw, b.bx0 + i % b.bw, h, wd);
    dst[i] = 0.f;
  }
  for (int t = 0; t < steps; ++t) {
#pragma unroll 4
    for (int j = threadIdx.x; j < xn; j += blockDim.x)
      xhist[t * xn + j] = load_or_zero(xs + (t * planes + p) * hw, b.y0 - R + j / xw, b.x0 - R + j % xw, h, wd);
  }
  __syncthreads();

  for (int s = steps - 1; s >= 0; --s) {
    // src holds the gradient of step s's output on the interior grown by
    // (s+1)*r; keep its interior for dw
    for (int i = threadIdx.x; i < in; i += blockDim.x) {
      const int iy = i / iw, ix = i - iy * iw;
      ghist[s * in + i] = src[(b.y0 + iy - b.by0) * b.bw + (b.x0 + ix - b.bx0)];
    }
    // the gradient of step s's input on the interior grown by s*r (the
    // transpose stencil): d[q] = sum_t g[q - o_t] * w[t, q - o_t]
    const bool staged = WS && s < steps - 1;
    const int e = s * R;
    const int cy0 = max(b.y0 - e, 0), cx0 = max(b.x0 - e, 0);
    const int ch = min(b.y1 + e, h) - cy0, cw = min(b.x1 + e, wd) - cx0;
    for (int i = threadIdx.x; i < ch * cw; i += blockDim.x) {
      const int yy = cy0 + i / cw, xx = cx0 + i % cw;
      // tap t's source pixel (yy + r - dy, xx + r - dx); beyond the plane
      // the gradient is zero in the buffer and the weight is masked (read
      // from the clamped address, so that every load is unbranched)
      const float* gwin = src + (yy + R - b.by0) * b.bw + (xx + R - b.bx0);  // the (0, 0) tap's source
      float d = 0.f;
      if (K <= 7 && yy >= R && yy + R < h && xx >= R && xx + R < wd) {
        // every source of the window lies in the plane: no clamp, no mask
        // (at k = 9 and 11 the second copy of the loop ran slower on the
        // card: few pixels of a small plane are that far from its edge)
#pragma unroll tiled_row_unroll(K)
        for (int dy = 0; dy < K; ++dy) {
          const int sy = yy + R - dy;
          if (staged) {
            const T* wrow = ws + dy * K * wn + (sy - b.wy0) * b.ww + (xx + R - b.wx0);
#pragma unroll
            for (int ddx = 0; ddx < K; ++ddx) d = fmaf(gwin[-dy * b.bw - ddx], to_f(wrow[ddx * wn - ddx]), d);
          } else {
            const T* wrow = wp + (int64_t)dy * K * hw + (int64_t)sy * wd + xx + R;
            T raw[K];
#pragma unroll
            for (int ddx = 0; ddx < K; ++ddx) raw[ddx] = ld_raw(wrow + (int64_t)ddx * hw - ddx);
#pragma unroll
            for (int ddx = 0; ddx < K; ++ddx) {
              if (WS) ws[(dy * K + ddx) * wn + (sy - b.wy0) * b.ww + (xx + R - ddx - b.wx0)] = raw[ddx];
              d = fmaf(gwin[-dy * b.bw - ddx], to_f(raw[ddx]), d);
            }
          }
        }
      } else if (staged) {
        // the clamped source lies in the staged region, which reaches the
        // plane's edge wherever the taps cross it
#pragma unroll tiled_row_unroll(K)
        for (int dy = 0; dy < K; ++dy) {
          const int sy = yy + R - dy;
          const bool row_in = sy >= 0 && sy < h;
          const T* wrow = ws + (min(max(sy, 0), h - 1) - b.wy0) * b.ww - b.wx0;
#pragma unroll
          for (int ddx = 0; ddx < K; ++ddx) {
            const int sx = xx + R - ddx;
            const bool inside = row_in && sx >= 0 && sx < wd;
            const float wv = to_f(wrow[(dy * K + ddx) * wn + min(max(sx, 0), wd - 1)]);
            d = fmaf(gwin[-dy * b.bw - ddx], inside ? wv : 0.f, d);
          }
        }
      } else {
        // the first step reads w from memory, a row of k taps' loads at
        // a time (and, in ws mode, stages each (tap, pixel) of the w region
        // once)
#pragma unroll tiled_row_unroll(K)
        for (int dy = 0; dy < K; ++dy) {
          const int sy = yy + R - dy;
          const bool row_in = sy >= 0 && sy < h;
          const int64_t row = (int64_t)min(max(sy, 0), h - 1) * wd;
          T raw[K];
#pragma unroll
          for (int ddx = 0; ddx < K; ++ddx)
            raw[ddx] = ld_raw(wp + (int64_t)(dy * K + ddx) * hw + row + min(max(xx + R - ddx, 0), wd - 1));
#pragma unroll
          for (int ddx = 0; ddx < K; ++ddx) {
            const int sx = xx + R - ddx;
            const bool inside = row_in && sx >= 0 && sx < wd;
            if (WS && inside) ws[(dy * K + ddx) * wn + (sy - b.wy0) * b.ww + (sx - b.wx0)] = raw[ddx];
            d = fmaf(gwin[-dy * b.bw - ddx], inside ? to_f(raw[ddx]) : 0.f, d);
          }
        }
      }
      if (s == 0) {
        store_f(dx + p * hw + (int64_t)yy * wd + xx, d);  // the last region is the interior
      } else {
        dst[(yy - b.by0) * b.bw + (xx - b.bx0)] = round_to(d, g);
      }
    }
    __syncthreads();  // every read of src (and ws) and write of dst done before the swap
    float* t = src;
    src = dst;
    dst = t;
  }

  // dw on the interior, tap by tap: the product of each step's gradient and
  // input rounded to fp32 and added in the plain version's order (the last
  // step first), written once in w's dtype
  // A thread takes a pixel (consecutive threads consecutive pixels, so the
  // writes of each tap are coalesced) and its taps a row of k at a time, k
  // sums in registers.
  for (int j = threadIdx.x; j < in; j += blockDim.x) {
    const int iy = j / iw, ix = j - iy * iw;
    T* const dq = dw + p * KK * hw + (int64_t)(b.y0 + iy) * wd + b.x0 + ix;
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
      const float* xq = xhist + (iy + dy) * xw + ix;
      float acc[K];
#pragma unroll
      for (int ddx = 0; ddx < K; ++ddx) acc[ddx] = 0.f;
      for (int s = steps - 1; s >= 0; --s) {
        const float gs = ghist[s * in + j];
#pragma unroll
        for (int ddx = 0; ddx < K; ++ddx) acc[ddx] += __fmul_rn(gs, xq[s * xn + ddx]);
      }
#pragma unroll
      for (int ddx = 0; ddx < K; ++ddx) store_f(dq + (int64_t)(dy * K + ddx) * hw, acc[ddx]);
    }
  }
}

template <typename T, int K>
cudaError_t launch_tiled(const void* g, const void* xs, const void* w, void* dx, void* dw, int64_t planes, int h,
                         int wd, int steps, cudaStream_t s) {
  const TiledPlan plan = tiled_plan(h, wd, K, steps, sizeof(T), true);
  if (plan.th == 0) return cudaErrorInvalidValue;
  const int tiles = ((h + plan.th - 1) / plan.th) * ((wd + plan.tw - 1) / plan.tw);
  if (planes * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = tiled_smem(plan.th, plan.tw, h, wd, K, steps, sizeof(T), true, plan.ws);
  auto kern = plan.ws ? stencil_tiled_bwd_kernel<T, K, true> : stencil_tiled_bwd_kernel<T, K, false>;
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)(planes * tiles), tiled_threads(K), smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(xs), static_cast<const T*>(w), static_cast<T*>(dx),
      static_cast<T*>(dw), planes, h, wd, steps, plan.th, plan.tw, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled_k(const void* g, const void* xs, const void* w, void* dx, void* dw, int64_t planes, int h,
                           int wd, int k, int steps, cudaStream_t s) {
  switch (k) {
    case 1: return launch_tiled<T, 1>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 3: return launch_tiled<T, 3>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 5: return launch_tiled<T, 5>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 7: return launch_tiled<T, 7>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 9: return launch_tiled<T, 9>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    case 11: return launch_tiled<T, 11>(g, xs, w, dx, dw, planes, h, wd, steps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename TO>
__global__ void stencil_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                   const T* __restrict__ w, T* __restrict__ dx,
                                   const float* dw_in, TO* dw_out, int64_t planes, int h,
                                   int wd, int k) {
  const int64_t hw = (int64_t)h * wd;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= planes * hw) return;
  const int64_t p = idx / hw;
  const int64_t pix = idx - p * hw;
  const int y = (int)(pix / wd);
  const int xx = (int)(pix - (int64_t)y * wd);
  const int r = k / 2;
  const int64_t kk = (int64_t)k * k;
  const T* gp = g + p * hw;
  const T* xp = x + p * hw;
  const T* wp = w + p * kk * hw;
  const float gq = load_f(gp + pix);
  float acc = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int oy = dy - r;
    const int sy = y - oy;  // transpose tap (dx)
    const int fy = y + oy;  // forward tap (dw)
    for (int ddx = 0; ddx < k; ++ddx) {
      const int ox = ddx - r;
      const int t = dy * k + ddx;
      const int sx = xx - ox;
      if (sy >= 0 && sy < h && sx >= 0 && sx < wd) {
        const int64_t s = (int64_t)sy * wd + sx;
        acc = fmaf(load_f(gp + s), load_f(wp + (int64_t)t * hw + s), acc);
      }
      const int fx = xx + ox;
      float v = 0.f;
      if (fy >= 0 && fy < h && fx >= 0 && fx < wd) v = gq * load_f(xp + (int64_t)fy * wd + fx);
      const int64_t o = (p * kk + t) * hw + pix;
      if (dw_in != nullptr) v += dw_in[o];
      store_f(dw_out + o, v);
    }
  }
  store_f(dx + idx, acc);
}

template <typename T, typename TO>
cudaError_t launch(const void* g, const void* x, const void* w, void* dx, const float* dw_in,
                   void* dw_out, int64_t planes, int h, int wd, int k, cudaStream_t s) {
  const int threads = 256;
  const int64_t blocks = (planes * h * wd + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stencil_bwd_kernel<T, TO><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(dx), dw_in, static_cast<TO*>(dw_out), planes, h, wd, k);
  return cudaGetLastError();
}

}  // namespace

// Fused entry: the backward of all `steps` (>= 1) steps in one launch, for
// planes within fused_fits (else cudaErrorInvalidValue). g and dx (P, H, W);
// xs (steps, P, H, W) the step inputs; w and dw (P, k*k, H, W); all of one
// dtype: 0 = float32, 1 = bfloat16. device: the CUDA ordinal of the tensors
// and of the stream. Returns cudaGetLastError() after the launch.
extern "C" int dgtd_diffusion_fused_bwd(const void* g, const void* xs, const void* w, void* dx,
                                        void* dw, long long planes, int h, int wd, int k,
                                        int steps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!fused_fits(h, wd, k, dtype == 0 ? 4 : 2) || steps < 1 || planes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (planes <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fused_k<float>(g, xs, w, dx, dw, planes, h, wd, k, steps, s);
  return (int)launch_fused_k<__nv_bfloat16>(g, xs, w, dx, dw, planes, h, wd, k, steps, s);
}

// Cluster entry: the backward of all `steps` (>= 1) steps in one launch, for
// planes whose stencil_route is ROUTE_CLUSTER (else cudaErrorInvalidValue);
// arguments as the fused entry's. Returns the launch's error.
extern "C" int dgtd_diffusion_cluster_bwd(const void* g, const void* xs, const void* w, void* dx,
                                          void* dw, long long planes, int h, int wd, int k,
                                          int steps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (stencil_route(h, wd, k, dtype == 0 ? 4 : 2) != ROUTE_CLUSTER || steps < 1 ||
      planes > 0x7fffffffLL / CLUSTER_MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  if (planes <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_cluster_k<float>(g, xs, w, dx, dw, planes, h, wd, k, steps, s);
  return (int)launch_cluster_k<__nv_bfloat16>(g, xs, w, dx, dw, planes, h, wd, k, steps, s);
}

// Tiled entry: the backward of all `steps` (>= 1) steps in one launch, for
// planes whose stencil_route is ROUTE_TILED and that have a backward
// tiled_plan (else cudaErrorInvalidValue); arguments as the fused entry's.
// Returns the launch's error.
extern "C" int dgtd_diffusion_tiled_bwd(const void* g, const void* xs, const void* w, void* dx, void* dw,
                                        long long planes, int h, int wd, int k, int steps, int dtype, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (stencil_route(h, wd, k, dtype == 0 ? 4 : 2) != ROUTE_TILED || steps < 1) return (int)cudaErrorInvalidValue;
  if (planes <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tiled_k<float>(g, xs, w, dx, dw, planes, h, wd, k, steps, s);
  return (int)launch_tiled_k<__nv_bfloat16>(g, xs, w, dx, dw, planes, h, wd, k, steps, s);
}

// How many clusters of the k = 7 cluster backward (bf16) the card holds at
// once, each of `blocks` blocks of `rows` x wd pixels, from
// cudaOccupancyMaxActiveClusters, into *clusters; blocks above the portable
// 8 are allowed for this query. Returns the query's error.
extern "C" int dgtd_diffusion_cluster_bwd_occupancy(int blocks, int rows, int wd, int device,
                                                    int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kern = stencil_cluster_bwd_kernel<__nv_bfloat16, 7>;
  const size_t smem = cluster_bwd_smem(rows, wd, 7, sizeof(__nv_bfloat16));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && blocks > CLUSTER_MAX_BLOCKS)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const ClusterLaunch launch((unsigned)blocks, blocks, strip_threads(rows, wd), smem, nullptr);
  return (int)launch_error(cudaOccupancyMaxActiveClusters(clusters, kern, &launch.cfg));
}

// Per-step entry. dtype: 0 = float32, 1 = bfloat16 (g, x, w, dx); dw_dtype:
// 0 = float32, 1 = bfloat16 (dw_out; bf16 only with bf16 inputs). dw_in is
// fp32 or null. device: the CUDA ordinal of the tensors and of the stream.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dgtd_diffusion_step_bwd(const void* g, const void* x, const void* w, void* dx,
                                       const float* dw_in, void* dw_out, long long planes,
                                       int h, int wd, int k, int dtype, int dw_dtype,
                                       int device, void* stream) {
  // this library carries its own CUDA runtime: make the tensors' device current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)planes * h * wd <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dw_dtype == 0) {
    err = launch<float, float>(g, x, w, dx, dw_in, dw_out, planes, h, wd, k, s);
  } else if (dtype == 1 && dw_dtype == 0) {
    err = launch<__nv_bfloat16, float>(g, x, w, dx, dw_in, dw_out, planes, h, wd, k, s);
  } else if (dtype == 1 && dw_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, x, w, dx, dw_in, dw_out, planes, h, wd, k, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
