// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (`rmsnorm`, body `_rmsnorm_kernel`), and on the model path the jnp
// function src/repro/models/layers.py `rms_norm`.
//
// Bound: bytes.  The work is ~3 flops per element against 2*n*d*itemsize
// bytes of traffic, far below the H100's ~295 flop/byte balance point, so
// the floor is 2*n*d*itemsize / 3.35 TB/s.  Design for that: one block per
// row, 16-byte vector loads (8 bf16 or 4 fp32 per thread per load), the
// row kept in shared memory so it is read from device memory once and
// written once, an fp32 sum of squares reduced by warp shuffles and one
// shared-memory step across the block's 8 warps.  A ragged d (not a
// multiple of the vector width) or an unaligned pointer takes a scalar loop.
//
// Triton would serve a reduction like this equally well; it is CUDA C++
// only so the port keeps one build path and one toolchain (nvcc -> one .so
// with a plain C interface, loaded with ctypes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int d, float eps, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row_s = reinterpret_cast<T*>(smem_raw);
  __shared__ float warp_sums[kThreads / 32];

  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  const int nv = vec ? d / E : 0;
  const int tail0 = nv * E;

  // pass 1: device memory -> shared memory, fp32 sum of squares
  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const uint4 p = reinterpret_cast<const uint4*>(xr)[i];
    reinterpret_cast<uint4*>(row_s)[i] = p;
    const T* e = reinterpret_cast<const T*>(&p);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float f = to_f(e[k]);
      ss += f * f;
    }
  }
  for (int i = tail0 + threadIdx.x; i < d; i += kThreads) {
    const T v = xr[i];
    row_s[i] = v;
    const float f = to_f(v);
    ss += f * f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  // pass 2: shared memory -> device memory.  Each thread reads back the
  // elements it wrote itself, so no barrier is needed beyond the one above.
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const uint4 p = reinterpret_cast<const uint4*>(row_s)[i];
    const T* e = reinterpret_cast<const T*>(&p);
    uint4 outv;
    T* oe = reinterpret_cast<T*>(&outv);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float s = 1.f + to_f(scale[i * E + k]);
      oe[k] = from_f<T>((to_f(e[k]) * r) * s);
    }
    reinterpret_cast<uint4*>(yr)[i] = outv;
  }
  for (int i = tail0 + threadIdx.x; i < d; i += kThreads) {
    const float s = 1.f + to_f(scale[i]);
    yr[i] = from_f<T>((to_f(row_s[i]) * r) * s);
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int n, int d, float eps,
           cudaStream_t stream) {
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(T);
  rmsnorm_kernel<T, S><<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, d] (fp32 or bf16), scale [d] (fp32 or bf16), y [n, d] in x's type.
// The caller checks shapes, contiguity and d * itemsize <= 48 KB.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int n,
                              int d, float eps, int x_bf16, int scale_bf16,
                              void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n, d, eps, s)
                      : launch<__nv_bfloat16, float>(x, scale, y, n, d, eps, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, y, n, d, eps, s)
                    : launch<float, float>(x, scale, y, n, d, eps, s);
}
