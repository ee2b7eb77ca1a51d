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
// 8 flops per value). At the served shapes a row is short (C = 64 bf16 is
// 128 bytes), so what costs is the number of memory requests and how many
// are in flight, not arithmetic.
//
// Three routes of the same two-pass algorithm, each holding the row on chip
// so that x is read from device memory once; ln_route() picks one from C,
// the element size and the two pointers alone (ops/layernorm.py::ln_route
// mirrors it):
//  - "group" (C <= 1024, a row a multiple of 16 bytes, x and out 16-byte
//    aligned): a row belongs to G lanes of a warp, G the row's 16-byte
//    vectors rounded up to a power of two, at most 32 (C = 64 bf16: 8 lanes,
//    4 rows a warp); a row wider than 32 vectors gives each lane VPL of
//    them. Loads are 16 bytes (ld.global.nc), stores 16 bytes, the sums
//    reduce by shuffles within the group. Each lane keeps the scale and bias
//    of its own columns in registers. The grid is persistent (the SMs times
//    the blocks an SM holds) and strides over rows; a lane issues the next
//    row's loads before the current row's two reductions, so two rows are in
//    flight a lane.
//  - "scalar" (C <= 1024 otherwise: a row not a multiple of 16 bytes, or a
//    view off a 16-byte boundary): one warp a row, each lane keeping
//    ceil(C/32) (rounded up to a power of two) values, scalar loads at a
//    stride of 32 elements; 8 rows a block.
//  - "block" (C > 1024): one block of 256 threads a row, the row cached in
//    fp32 in dynamic shared memory (C * 4 bytes, up to the card's 227 KB),
//    the sums reduced through shuffles and a small shared array.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Route { ROUTE_GROUP = 0, ROUTE_SCALAR = 1, ROUTE_BLOCK = 2 };
constexpr int WARP_MAX_C = 1024;
constexpr int GROUP_THREADS = 256;

int ln_route(int c, int esize, const void* x, const void* out) {
  if (c > WARP_MAX_C) return ROUTE_BLOCK;
  if (((long long)c * esize) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return ROUTE_SCALAR;
  return ROUTE_GROUP;
}

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

// sum over the G lanes of a group (G a power of two; xor offsets below G
// stay inside it). Every lane of the warp takes part.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes <-> E fp32 values
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4], float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// the group route: a row on G lanes, VPL 16-byte vectors a lane
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(GROUP_THREADS)
    ln_group_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ out, int64_t rows, int c,
                    float eps) {
  constexpr int E = 16 / sizeof(T);  // values a vector
  constexpr int RPW = 32 / G;        // rows a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % G, grp = lane / G;
  const int nvec = c / E;
  const int64_t warp = (int64_t)blockIdx.x * (GROUP_THREADS / 32) + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * (GROUP_THREADS / 32) * RPW;
  bool has[VPL];
  float sc[VPL][E], bi[VPL][E];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int v = sub + G * j;
    has[j] = v < nvec;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sc[j][e] = has[j] ? __ldg(scale + v * E + e) : 0.f;
      bi[j][e] = has[j] ? __ldg(bias + v * E + e) : 0.f;
    }
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 cur[VPL], nxt[VPL];
  int64_t row = warp * RPW + grp;
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    cur[j] = (row < rows && has[j]) ? __ldg(xv + row * nvec + sub + G * j) : make_uint4(0, 0, 0, 0);
  // base is the warp's first row: the loop is warp-uniform, so every lane
  // takes part in the shuffles; a group past the last row stores nothing
  for (int64_t base = warp * RPW; base < rows; base += stride, row += stride) {
    const int64_t next = row + stride;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      nxt[j] = (next < rows && has[j]) ? __ldg(xv + next * nvec + sub + G * j) : make_uint4(0, 0, 0, 0);
    float v[VPL][E];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      unpack(cur[j], v[j], T());
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[j][e];
    }
    const float mean = group_sum<G>(sum) / c;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = has[j] ? v[j][e] - mean : 0.f;
        sq = fmaf(d, d, sq);
      }
    const float rstd = rsqrtf(group_sum<G>(sq) / c + eps);
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (!has[j]) continue;
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = fmaf((v[j][e] - mean) * rstd, sc[j][e], bi[j][e]);
        ov[row * nvec + sub + G * j] = pack(o, T());
      }
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j) cur[j] = nxt[j];
  }
}

// the scalar route: one warp a row
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

// the block route: one block a row
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

// the SM count of each device, read once
int sm_count(int device) {
  static int cache[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    cache[device] = n;
  }
  return cache[device];
}

template <typename T, int G, int VPL>
cudaError_t launch_group(const void* x, const float* scale, const float* bias, void* out,
                         int64_t rows, int c, float eps, int device, cudaStream_t s) {
  // blocks an SM holds, read once for each instantiation
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_group_kernel<T, G, VPL>, GROUP_THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidDevice;
  const int64_t rows_per_block = (GROUP_THREADS / 32) * (32 / G);
  const int64_t needed = (rows + rows_per_block - 1) / rows_per_block;
  const int64_t resident = (int64_t)sms * per_sm;
  const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
  ln_group_kernel<T, G, VPL><<<blocks, GROUP_THREADS, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, c, eps);
  return cudaGetLastError();
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
                   int c, float eps, int device, cudaStream_t s) {
  const int route = ln_route(c, sizeof(T), x, out);
  if (route == ROUTE_GROUP) {
    const int nvec = c * (int)sizeof(T) / 16;
    if (nvec <= 1) return launch_group<T, 1, 1>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 2) return launch_group<T, 2, 1>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 4) return launch_group<T, 4, 1>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 8) return launch_group<T, 8, 1>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 16) return launch_group<T, 16, 1>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 32) return launch_group<T, 32, 1>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 64) return launch_group<T, 32, 2>(x, scale, bias, out, rows, c, eps, device, s);
    if (nvec <= 128) return launch_group<T, 32, 4>(x, scale, bias, out, rows, c, eps, device, s);
    return launch_group<T, 32, 8>(x, scale, bias, out, rows, c, eps, device, s);
  }
  if (route == ROUTE_SCALAR) {
    if (c <= 32) return launch_warp<T, 1>(x, scale, bias, out, rows, c, eps, s);
    if (c <= 64) return launch_warp<T, 2>(x, scale, bias, out, rows, c, eps, s);
    if (c <= 128) return launch_warp<T, 4>(x, scale, bias, out, rows, c, eps, s);
    if (c <= 256) return launch_warp<T, 8>(x, scale, bias, out, rows, c, eps, s);
    if (c <= 512) return launch_warp<T, 16>(x, scale, bias, out, rows, c, eps, s);
    return launch_warp<T, 32>(x, scale, bias, out, rows, c, eps, s);
  }
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

// The route a call on these arguments takes: 0 = group, 1 = scalar, 2 =
// block; -1 for a dtype code the kernel does not take.
extern "C" int dgtd_layer_norm_route(int c, int dtype, const void* x, const void* out) {
  if (dtype != 0 && dtype != 1) return -1;
  return ln_route(c, dtype == 0 ? 4 : 2, x, out);
}

// x, out: (rows, c) contiguous, dtype 0 = float32, 1 = bfloat16; scale, bias:
// fp32 (c). device: the CUDA ordinal of the tensors and of the stream.
// Returns cudaGetLastError() after the launch (0 on success); a row too
// long for shared memory is refused there.
extern "C" int dgtd_layer_norm(const void* x, const float* scale, const float* bias, void* out,
                               long long rows, int c, float eps, int dtype, int device,
                               void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  if (rows <= 0) return (int)cudaSuccess;
  if (c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, scale, bias, out, rows, c, eps, device, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, scale, bias, out, rows, c, eps, device, s);
  return (int)cudaErrorInvalidValue;
}
