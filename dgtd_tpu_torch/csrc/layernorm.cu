// LayerNorm over the last axis for Hopper (sm_90a).
//
// Replaces dgtd_tpu/ops/layernorm_pallas.py::layer_norm_pallas (the Pallas
// kernel _ln_kernel). For each row of x (rows, C):
//
//   mean = sum(x) / C;  var = sum((x - mean)^2) / C
//   out  = (x - mean) * rsqrt(var + eps) * scale + bias
//
// in fp32 (the mean first, then the centred variance: a one-pass
// E[x^2] - E[x]^2 loses the variance of rows with a large mean), stored in
// x's dtype (fp32 or bf16). scale and bias are fp32 vectors of C.
//
// What bounds it on this card: bytes (x read once, out written once; about
// 8 flops per value).
//
// Two shapes of the same two-pass algorithm, both holding the row on chip
// so that x is read from device memory once:
//  - C <= 1024: one warp per row, each lane keeping VPT = ceil(C/32)
//    (rounded up to a power of two) values in registers; 8 rows per block.
//  - C > 1024: one block of 256 threads per row, the row cached in fp32 in
//    dynamic shared memory (C * 4 bytes, up to the card's 227 KB), the sums
//    reduced through shuffles and a small shared array.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VPT>
__global__ void ln_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               const float* __restrict__ bias, T* __restrict__ out,
                               int64_t rows, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * c;
  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = lane + 32 * i;
    v[i] = col < c ? load_f(xr + col) : 0.f;
    sum += v[i];
  }
  const float mean = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = lane + 32 * i;
    const float dv = col < c ? v[i] - mean : 0.f;
    sq = fmaf(dv, dv, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / c + eps);
  T* orow = out + row * c;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = lane + 32 * i;
    if (col < c) store_f(orow + col, fmaf((v[i] - mean) * rstd, scale[col], bias[col]));
  }
}

// sum over the block (blockDim.x a multiple of 32, at most 1024); every
// thread gets the result
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : 0.f;
  return warp_sum(t);
}

template <typename T>
__global__ void ln_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ bias, T* __restrict__ out, int c,
                                float eps) {
  extern __shared__ float rowbuf[];
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * c;
  float sum = 0.f;
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    const float v = load_f(xr + col);
    rowbuf[col] = v;
    sum += v;
  }
  const float mean = block_sum(sum, red) / c;
  float sq = 0.f;
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    const float dv = rowbuf[col] - mean;
    sq = fmaf(dv, dv, sq);
  }
  const float rstd = rsqrtf(block_sum(sq, red) / c + eps);
  T* orow = out + row * c;
  for (int col = threadIdx.x; col < c; col += blockDim.x)
    store_f(orow + col, fmaf((rowbuf[col] - mean) * rstd, scale[col], bias[col]));
}

template <typename T, int VPT>
cudaError_t launch_warp(const void* x, const float* scale, const float* bias, void* out,
                        int64_t rows, int c, float eps, cudaStream_t s) {
  const int threads = 256;  // 8 rows per block
  const int64_t blocks = (rows * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ln_warp_kernel<T, VPT><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, c, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* out, int64_t rows,
                   int c, float eps, cudaStream_t s) {
  if (c <= 32) return launch_warp<T, 1>(x, scale, bias, out, rows, c, eps, s);
  if (c <= 64) return launch_warp<T, 2>(x, scale, bias, out, rows, c, eps, s);
  if (c <= 128) return launch_warp<T, 4>(x, scale, bias, out, rows, c, eps, s);
  if (c <= 256) return launch_warp<T, 8>(x, scale, bias, out, rows, c, eps, s);
  if (c <= 512) return launch_warp<T, 16>(x, scale, bias, out, rows, c, eps, s);
  if (c <= 1024) return launch_warp<T, 32>(x, scale, bias, out, rows, c, eps, s);
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)c * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_block_kernel<T><<<(unsigned)rows, 256, smem, s>>>(static_cast<const T*>(x), scale, bias,
                                                      static_cast<T*>(out), c, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, c) contiguous, dtype 0 = float32, 1 = bfloat16; scale, bias:
// fp32 (c). device: the CUDA ordinal of the tensors and of the stream.
// Returns cudaGetLastError() after the launch (0 on success); a row too
// long for shared memory is refused there.
extern "C" int dgtd_layer_norm(const void* x, const float* scale, const float* bias, void* out,
                               long long rows, int c, float eps, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaSuccess;
  if (c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, scale, bias, out, rows, c, eps, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, scale, bias, out, rows, c, eps, s);
  return (int)cudaErrorInvalidValue;
}
