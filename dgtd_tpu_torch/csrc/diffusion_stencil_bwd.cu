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
// Two kernels, chosen by shape alone as the forward's are (fused_fits in
// stencil_common.cuh, mirrored by ops/diffusion.py::fused_path):
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
// stencil_bwd_kernel, one step a launch, takes the planes above that limit:
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
