// Blockwise int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference computes these in jnp
// (src/repro/core/quant.py `quantize_flat`, `dequantize_flat`) and XLA
// fuses each into one pass; eager PyTorch would run about 8 passes for
// quantize (cast, pad, abs, amax, divide, round, clamp, cast) and 4 for
// dequantize.  Decode dequantizes every layer's stored int8 row at every
// step, and the int8 gather and gradient wires quantize every payload, so
// these kernels are the port's counterpart of XLA's fusion.
//
// quantize: x [R, L] fp32 / bf16 -> q int8 [R, L], scale fp32 [R, ceil(L/128)].
//   A warp takes one block of 128 values, 4 a lane: the block's absmax by
//   warp shuffles (max is exact, so the order does not matter), the scale
//   absmax / 127 (1 where the block is all zero), v = x / scale, then
//   nearest (rintf: half to even, as torch.round and jnp.round) or
//   stochastic rounding q = floor(v) + (u < v - floor(v)) (exact in fp32),
//   clamped to +-127.  A ragged last block is read as if padded with
//   zeros and uses its own absmax.  u = (h >> 8) * 2^-24 with
//   h = mix32(mix32(i ^ k_lo) ^ k_hi), i the value's flat index plus the
//   call's offset; where the step component is a device scalar (a
//   payload's fingerprint), k_lo ^= mix32(step) is read here, so the host
//   never waits for it.  The wrapper's plain version
//   (kernels/quant/kernel.py) computes the same 32-bit operations.
// dequantize: q int8 + scale -> q * scale rounded to bf16 / fp32; with
//   k > 1 chunks, the fp32 sum of the k dequantized chunks in chunk order
//   (one qgZ exchange stage's reduction): acc = q0 * s0, then each later
//   chunk adds its product with one rounding, acc = fma(qc, sc, acc), as
//   the reference's fused reduction does on the CPU (XLA contracts it).
//   The product is exact in double (8 x 24 bits), so the sum is taken in
//   double and rounded once to fp32, the same operations the plain
//   version runs.  A thread takes 4 values of a row, which share a scale.
//
// Every other product, sum and quotient uses the _rn intrinsics, so nvcc
// cannot contract them into FMAs and the results are bitwise the plain
// versions'.  The build has no --use_fast_math; keep it so.
//
// Bound: bytes.  quantize reads 4 B (fp32) and writes 1 + 4/128 B a value;
// dequantize reads k (1 + 4/128) B and writes 2 (bf16) or 4 B.  The work is
// a few operations a value, far below the card's balance point.  Loads
// and stores are 16 / 8 / 4 bytes a lane where the row length is a
// multiple of 4 and the pointers aligned (the wrapper checks), else
// scalar; a grid sized to the card strides over the blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ void load4(const T* p, float v[4]);
template <> __device__ __forceinline__ void load4<float>(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float v[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

template <typename T, bool kVec, bool kStoch>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                long long rows, int L, int nb, uint32_t k_lo, uint32_t k_hi,
                const int32_t* __restrict__ step, uint32_t offset) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  uint32_t klo = k_lo;
  if (kStoch && step != nullptr) klo ^= mix32(static_cast<uint32_t>(__ldg(step)));
  for (long long w = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
       w < rows * nb; w += nwarps) {
    const long long r = w / nb;
    const int b = static_cast<int>(w - r * nb);
    const int c0 = b * kBlock + lane * 4;
    const T* xr = x + r * L;
    float v[4];
    if (kVec && c0 < L) {
      load4<T>(xr + c0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = c0 + j < L ? to_f(xr[c0 + j]) : 0.f;
    }
    float m = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float scale = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
    if (lane == 0) s[r * nb + b] = scale;
    char4 out;
    int8_t* o8 = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = __fdiv_rn(v[j], scale);
      float qf;
      if (kStoch) {
        const float f = floorf(t);
        const uint32_t i = offset + static_cast<uint32_t>(r * L + c0 + j);
        const uint32_t h = mix32(mix32(i ^ klo) ^ k_hi);
        const float u = __fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-08f);
        qf = u < __fsub_rn(t, f) ? __fadd_rn(f, 1.f) : f;
      } else {
        qf = rintf(t);
      }
      o8[j] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(qf, -127.f), 127.f)));
    }
    int8_t* qr = q + r * L;
    if (kVec && c0 < L) {
      *reinterpret_cast<char4*>(qr + c0) = out;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < L) qr[c0 + j] = o8[j];
    }
  }
}

template <typename O> __device__ __forceinline__ O from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename O> __device__ __forceinline__ void store4(O* p, const float v[4]);
template <> __device__ __forceinline__ void store4<float>(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                                  const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<uint32_t*>(&lo);
  a.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

// out [rows, L] = sum over c < k of q[c * rows + r] * s[c * rows + r, block].
template <typename O, bool kVec>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  O* __restrict__ out, long long rows, int L, int nb, int k) {
  const long long groups = (L + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       t < rows * groups; t += stride) {
    const long long r = t / groups;
    const int c0 = static_cast<int>(t - r * groups) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < k; ++c) {
      const long long rr = static_cast<long long>(c) * rows + r;
      const float sc = __ldg(s + rr * nb + c0 / kBlock);
      const int8_t* qr = q + rr * L;
      int8_t qv[4];
      if (kVec) {
        *reinterpret_cast<char4*>(qv) = *reinterpret_cast<const char4*>(qr + c0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = c0 + j < L ? qr[c0 + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = c == 0 ? __fmul_rn(static_cast<float>(qv[j]), sc)
                        : __double2float_rn(__dadd_rn(
                              static_cast<double>(acc[j]),
                              __dmul_rn(static_cast<double>(qv[j]), static_cast<double>(sc))));
      }
    }
    O* orow = out + r * L;
    if (kVec) {
      store4<O>(orow + c0, acc);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < L) orow[c0 + j] = from_f<O>(acc[j]);
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* s, long long rows, int L, int nb,
                            int stochastic, uint32_t k_lo, uint32_t k_hi, const void* step,
                            uint32_t offset, int vec, int blocks, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  const int32_t* stp = static_cast<const int32_t*>(step);
  if (vec) {
    if (stochastic)
      quantize_kernel<T, true, true><<<blocks, kThreads, 0, st>>>(xp, qp, sp, rows, L, nb,
                                                                 k_lo, k_hi, stp, offset);
    else
      quantize_kernel<T, true, false><<<blocks, kThreads, 0, st>>>(xp, qp, sp, rows, L, nb,
                                                                  k_lo, k_hi, stp, offset);
  } else {
    if (stochastic)
      quantize_kernel<T, false, true><<<blocks, kThreads, 0, st>>>(xp, qp, sp, rows, L, nb,
                                                                  k_lo, k_hi, stp, offset);
    else
      quantize_kernel<T, false, false><<<blocks, kThreads, 0, st>>>(xp, qp, sp, rows, L, nb,
                                                                   k_lo, k_hi, stp, offset);
  }
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_dequantize(const void* q, const void* s, void* out, long long rows, int L,
                              int nb, int k, int vec, int blocks, cudaStream_t st) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  O* op = static_cast<O*>(out);
  if (vec)
    dequantize_kernel<O, true><<<blocks, kThreads, 0, st>>>(qp, sp, op, rows, L, nb, k);
  else
    dequantize_kernel<O, false><<<blocks, kThreads, 0, st>>>(qp, sp, op, rows, L, nb, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int quantize_launch(const void* x, void* q, void* s, long long rows, int L, int nb,
                               int x_bf16, int stochastic, unsigned int k_lo,
                               unsigned int k_hi, const void* step, unsigned int offset,
                               int vec, int blocks, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows < 0 || L < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  return static_cast<int>(
      x_bf16 ? launch_quantize<__nv_bfloat16>(x, q, s, rows, L, nb, stochastic, k_lo, k_hi,
                                              step, offset, vec, blocks, st)
             : launch_quantize<float>(x, q, s, rows, L, nb, stochastic, k_lo, k_hi, step,
                                      offset, vec, blocks, st));
}

extern "C" int dequantize_launch(const void* q, const void* s, void* out, long long rows,
                                 int L, int nb, int k, int out_bf16, int vec, int blocks,
                                 void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows < 0 || L < 1 || k < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  return static_cast<int>(
      out_bf16 ? launch_dequantize<__nv_bfloat16>(q, s, out, rows, L, nb, k, vec, blocks, st)
               : launch_dequantize<float>(q, s, out, rows, L, nb, k, vec, blocks, st));
}
