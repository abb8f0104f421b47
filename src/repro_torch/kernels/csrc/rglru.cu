// RG-LRU scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t per channel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru/kernel.py
// (`rglru`, body `_rglru_kernel`, wrapper ops.py `rglru_scan`), and on the
// model path the two functions of src/repro/models/recurrent.py that run
// the recurrence in its place: the `lax.associative_scan` of
// `griffin_rec_apply` (prefill, h_{-1} = 0) and `rglru_step` (decode,
// T = 1 from the cached fp32 state, passed here as h0).
//
// Layout: a, b, h [B, T, C] contiguous, fp32 or bf16 (one type); h0 [B, C]
// fp32 or null.  The carry is fp32; h is written in a's type.
//
// Bound: bytes.  The work is one FMA per element against reading a and b
// and writing h once, 12 * B * T * C bytes at fp32: at the serve path's
// prefill shape [4, 2560, 2560] that is 314.6 MB, about 0.094 ms at
// 3.35 TB/s.  Design for that, kept simple:
//  * parallel over (batch, channel): one thread per channel, consecutive
//    threads on consecutive channels, so every time step's loads and stores
//    are coalesced 128-byte (fp32) transactions per warp;
//  * sequential over T with the carry in a register;
//  * the time loop is unrolled by kUnroll steps, and those steps' a / b
//    loads are all issued before the dependent FMA chain: they do not
//    depend on h, so their latency hides behind each other instead of
//    adding up step by step;
//  * any T (a scalar tail after the unrolled part) and any C (threads past
//    C return), so the Pallas kernel's divisibility rule is not carried
//    over.
// With only B * C = 10,240 channels on the path, this fills about 80 blocks
// of 128 threads on the card's 132 SMs and relies on the unrolled loads for
// memory parallelism.  A chunked two-pass scan over time (per-chunk
// (prod a, partial h), then a carry fix-up) that puts T across blocks too,
// and fusing `_rglru_coeffs`' gate math into the kernel so a and b never
// reach device memory, are later PRs' work.
//
// Triton would suit a scan like this as well; it is CUDA C++ so that the
// port keeps one build path (nvcc -> one .so with a plain C interface,
// loaded with ctypes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ h, int steps, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t bi = blockIdx.y;
  const int64_t base = bi * steps * C + c;  // element (bi, 0, c)
  float carry = h0 ? h0[bi * C + c] : 0.f;

  int t = 0;
  for (; t + kUnroll <= steps; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t + u) * C;
      av[u] = to_f(a[off]);
      bv[u] = to_f(b[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      h[base + static_cast<int64_t>(t + u) * C] = from_f<T>(carry);
    }
  }
  for (; t < steps; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * C;
    carry = fmaf(to_f(a[off]), carry, to_f(b[off]));
    h[off] = from_f<T>(carry);
  }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h, int B, int steps,
           int C, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, static_cast<T*>(h), steps, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h [B, T, C] contiguous, one type (fp32 or bf16); h0 [B, C] fp32 or
// null (start from 0).  The caller checks shapes, types and B, T, C > 0.
extern "C" int rglru_launch(const void* a, const void* b, const void* h0, void* h,
                            int B, int steps, int C, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  if (is_bf16) return launch<__nv_bfloat16>(a, b, h0f, h, B, steps, C, s);
  return launch<float>(a, b, h0f, h, B, steps, C, s);
}
