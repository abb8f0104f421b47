// RMSNorm backward for Hopper (sm_90a): the gradient of
// y = x * rsqrt(mean(x^2) + eps) * (1 + scale) over the last dim.
//
// It is the gradient of the Pallas TPU kernel
// src/repro/kernels/rmsnorm/kernel.py (`rmsnorm`), which has no backward of
// its own, and on the model path the vjp of the jnp function
// src/repro/models/layers.py `rms_norm`.  With r = rsqrt(mean(x^2) + eps),
// s' = 1 + scale and g = dy, in fp32:
//   dx     = r * (s' g - x r^2 mean(s' g x))    in x's dtype;
//   dscale = sum over rows of g * (x r)         in scale's dtype.
//
// Bound: bytes.  x and dy are read and dx written once, ~10 operations an
// element, far below the H100's ~295 op/byte balance point: at the llama
// train shape [8192, 2048] bf16 that is 100.7 MB, 0.030 ms at 3.35 TB/s.
//
// Design (simple and right first):
//  * launch 1: a block of 4 warps, one row a warp at a time, the grid
//    striding over the rows (at most 4 blocks a SM).  A warp reads its row
//    twice: once for the two sums (x^2 and s' g x, reduced by shuffles),
//    once for dx; the second read mostly hits L1 / L2.  16-byte loads when
//    d and the pointers allow, scalar loads otherwise.
//  * dscale without atomics: each warp adds its rows' g * x * r into its
//    own fp32 row of shared memory; at the end the block adds its 4 warps'
//    rows in warp order and writes one fp32 partial row [blocks, d];
//  * launch 2 folds the partial rows in block order, one thread a column,
//    and casts to scale's dtype.  The result is bitwise repeatable.
// Left for later: holding the row in registers between the two passes
// (the forward's design), and a fold that does not re-read the partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// E consecutive elements of T starting at p (16 bytes when E * sizeof(T) == 16).
template <typename T, int E>
__device__ __forceinline__ void load(const T* p, float (&out)[E]) {
  if constexpr (E * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_f(p[i]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store(T* p, const float (&v)[E]) {
  if constexpr (E * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) p[i] = from_f<T>(v[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// E elements a lane a step: 16 / sizeof(T) on the vector path, 1 on the
// scalar path (d not a multiple of the vector width, or unaligned rows).
template <typename T, typename S, int E>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int n, int d, float eps) {
  extern __shared__ float wsum[];  // [kWarps][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = wsum + static_cast<int64_t>(warp) * d;
  for (int c = lane; c < d; c += 32) mine[c] = 0.f;
  const float inv_d = 1.f / static_cast<float>(d);

  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    const T* xr = x + static_cast<int64_t>(row) * d;
    const T* gr = dy + static_cast<int64_t>(row) * d;
    float ss = 0.f, sgx = 0.f;
    for (int c = lane * E; c < d; c += 32 * E) {
      float xv[E], gv[E];
      load<T, E>(xr + c, xv);
      load<T, E>(gr + c, gv);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float sp = 1.f + to_f(scale[c + i]);
        ss += xv[i] * xv[i];
        sgx += sp * gv[i] * xv[i];
      }
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    const float r = rsqrtf(ss * inv_d + eps);
    const float cr = sgx * inv_d * (r * r);
    T* dr = dx + static_cast<int64_t>(row) * d;
    for (int c = lane * E; c < d; c += 32 * E) {
      float xv[E], gv[E], out[E];
      load<T, E>(xr + c, xv);
      load<T, E>(gr + c, gv);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float sp = 1.f + to_f(scale[c + i]);
        out[i] = r * (sp * gv[i] - xv[i] * cr);
        mine[c + i] += gv[i] * (xv[i] * r);
      }
      store<T, E>(dr + c, out);
    }
  }
  __syncthreads();
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += wsum[static_cast<int64_t>(w) * d + c];
    prow[c] = acc;
  }
}

template <typename S>
__global__ void rmsnorm_bwd_fold_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                                        int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<int64_t>(b) * d + c];
  dscale[c] = from_f<S>(acc);
}

template <typename T, typename S, int E>
int launch(const void* x, const void* scale, const void* dy, void* dx, float* partial,
           void* dscale, int n, int d, float eps, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * d * sizeof(float);
  auto kernel = rmsnorm_bwd_kernel<T, S, E>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, n, d, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_fold_kernel<S><<<(d + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<S*>(dscale), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_path(const void* x, const void* scale, const void* dy, void* dx, float* partial,
                void* dscale, int n, int d, float eps, int blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return vec ? launch<T, S, kVec>(x, scale, dy, dx, partial, dscale, n, d, eps, blocks, stream)
             : launch<T, S, 1>(x, scale, dy, dx, partial, dscale, n, d, eps, blocks, stream);
}

}  // namespace

// x, dy, dx [n, d] of one type, scale and dscale [d] of one type (fp32 or
// bf16 each), partial fp32 [blocks, d] scratch; all contiguous.  The
// caller checks shapes, types and devices.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy, void* dx,
                                  void* partial, void* dscale, int n, int d, float eps,
                                  int x_bf16, int scale_bf16, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  using bf = __nv_bfloat16;
  if (x_bf16) {
    return scale_bf16
               ? launch_path<bf, bf>(x, scale, dy, dx, part, dscale, n, d, eps, blocks, s)
               : launch_path<bf, float>(x, scale, dy, dx, part, dscale, n, d, eps, blocks, s);
  }
  return scale_bf16
             ? launch_path<float, bf>(x, scale, dy, dx, part, dscale, n, d, eps, blocks, s)
             : launch_path<float, float>(x, scale, dy, dx, part, dscale, n, d, eps, blocks, s);
}
