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
// Two routes, chosen by a plain rule in the wrapper (kernel.py `bwd_route`):
//  * "regs" (rmsnorm_bwd_regs_kernel): bf16 x and dy, d = 256 * VPL with
//    VPL <= 8 (d <= 2048), 16-byte aligned rows -- the training path's
//    shapes.  A warp owns a row at a time; each lane loads its VPL 16-byte
//    pieces of x and dy once and keeps them packed in bf16 (4 * VPL
//    registers each), forms the two sums by shuffles and writes dx from the
//    registers: x and dy are read once and dx written once, the bound's
//    bytes.  dscale: each lane owns the same 8 * VPL columns of every row
//    and adds g * x * r for its warp's rows into fp32 registers in row
//    order.  d is capped at 2048 by registers: 8 * VPL accumulators and
//    8 * VPL packed words a lane (128 at VPL 8), beyond which they spill.
//  * "smem" (rmsnorm_bwd_kernel): every other shape (fp32 rows, ragged or
//    wider d, unaligned rows).  A warp reads its row twice (once for the
//    sums, once for dx; the second read mostly hits L1 / L2) and adds each
//    row's g * x * r into its own fp32 row of shared memory.  16-byte loads
//    when d and the pointers allow, scalar loads otherwise.
// Both: a block of 4 warps, one row a warp at a time, the grid striding
// over the rows (kernel.py `plan_rmsnorm_bwd`).  dscale without atomics: at
// the end the block adds its 4 warps' rows in warp order and writes one
// fp32 partial row [blocks, d]; a second launch folds the partial rows, 8
// contiguous runs of them a column in block order and then the runs in
// order, and casts to scale's dtype.  The order of every sum is fixed and
// the same on both routes, so the result is bitwise repeatable.
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

// The fold: kFoldGroups threads a column each add a contiguous run of the
// partial rows in block order (loads kFoldBatch ahead of their adds), then
// the first adds the runs in order.  A fixed order, so bitwise repeatable;
// a column's 500-odd dependent loads split 8 ways, so the fold is not one
// long chain of cache misses a column.
constexpr int kFoldCols = 32;
constexpr int kFoldGroups = 8;
constexpr int kFoldBatch = 8;

template <typename S>
__global__ void __launch_bounds__(kFoldCols * kFoldGroups)
rmsnorm_bwd_fold_kernel(const float* __restrict__ partial, S* __restrict__ dscale, int blocks,
                        int d) {
  __shared__ float run[kFoldGroups][kFoldCols];
  const int cx = threadIdx.x % kFoldCols, gy = threadIdx.x / kFoldCols;
  const int c = blockIdx.x * kFoldCols + cx;
  const int per = (blocks + kFoldGroups - 1) / kFoldGroups;
  const int lo = min(gy * per, blocks), hi = min(lo + per, blocks);
  float acc = 0.f;
  if (c < d) {
    for (int b0 = lo; b0 < hi; b0 += kFoldBatch) {
      float v[kFoldBatch];
#pragma unroll
      for (int i = 0; i < kFoldBatch; ++i)
        v[i] = b0 + i < hi ? partial[static_cast<int64_t>(b0 + i) * d + c] : 0.f;
#pragma unroll
      for (int i = 0; i < kFoldBatch; ++i)
        if (b0 + i < hi) acc += v[i];
    }
  }
  run[gy][cx] = acc;
  __syncthreads();
  if (gy != 0 || c >= d) return;
  float total = run[0][cx];
#pragma unroll
  for (int g = 1; g < kFoldGroups; ++g) total += run[g][cx];
  dscale[c] = from_f<S>(total);
}

// "regs" route: bf16 x, dy, dx [n, 256 * VPL], 16-byte aligned rows.
// Lane l holds 16-byte vector v of the row at columns (32 v + l) * 8 ...,
// the same columns the smem route's vector path gives it.
//
// 16 bytes through the read-only path.  The load is volatile so that the
// compiler re-reads scale (an L1 hit) for every row instead of hoisting
// 8 * VPL fp32 values of 1 + scale out of the row loop into registers.
__device__ __forceinline__ uint4 ld_nc16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

template <typename S>
__device__ __forceinline__ void load_scale8(const S* p, float (&sp)[8]) {
  if constexpr (sizeof(S) == 2) {
    const uint4 raw = ld_nc16(p);
    const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) sp[i] = 1.f + to_f(e[i]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 raw = ld_nc16(p + 4 * h);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) sp[4 * h + i] = 1.f + e[i];
    }
  }
}

template <typename S, int VPL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_regs_kernel(const __nv_bfloat16* __restrict__ x, const S* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ partial, int n, float eps) {
  constexpr int D = 256 * VPL;
  __shared__ __align__(16) float wsum[kWarps][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[VPL][8];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[v][i] = 0.f;
  const float inv_d = 1.f / static_cast<float>(D);

  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * D);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + static_cast<int64_t>(row) * D);
    uint4 xv[VPL], gv[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      xv[v] = __ldg(xr + v * 32 + lane);
      gv[v] = __ldg(gr + v * 32 + lane);
    }
    float ss = 0.f, sgx = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      float sp[8];
      load_scale8<S>(scale + (v * 32 + lane) * 8, sp);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv[v]);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv[v]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xf = to_f(xe[i]), gf = to_f(ge[i]);
        ss += xf * xf;
        sgx += sp[i] * gf * xf;
      }
    }
    ss = warp_sum(ss);
    sgx = warp_sum(sgx);
    const float r = rsqrtf(ss * inv_d + eps);
    const float cr = sgx * inv_d * (r * r);
    uint4* dr = reinterpret_cast<uint4*>(dx + static_cast<int64_t>(row) * D);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      float sp[8];
      load_scale8<S>(scale + (v * 32 + lane) * 8, sp);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv[v]);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv[v]);
      uint4 raw;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xf = to_f(xe[i]), gf = to_f(ge[i]);
        oe[i] = __float2bfloat16(r * (sp[i] * gf - xf * cr));
        acc[v][i] += gf * (xf * r);
      }
      dr[v * 32 + lane] = raw;
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    float4* dst = reinterpret_cast<float4*>(&wsum[warp][(v * 32 + lane) * 8]);
    dst[0] = make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
    dst[1] = make_float4(acc[v][4], acc[v][5], acc[v][6], acc[v][7]);
  }
  __syncthreads();
  float* prow = partial + static_cast<int64_t>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wsum[w][c];
    prow[c] = a;
  }
}

template <typename S, int VPL>
int launch_regs(const void* x, const void* scale, const void* dy, void* dx, float* partial,
                void* dscale, int n, float eps, int blocks, cudaStream_t stream) {
  rmsnorm_bwd_regs_kernel<S, VPL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const S*>(scale),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), partial, n, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_fold_kernel<S><<<256 * VPL / kFoldCols, kFoldCols * kFoldGroups, 0, stream>>>(
      partial, static_cast<S*>(dscale), blocks, 256 * VPL);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_regs_d(const void* x, const void* scale, const void* dy, void* dx, float* partial,
                  void* dscale, int n, int d, float eps, int blocks, cudaStream_t s) {
  switch (d) {
    case 256: return launch_regs<S, 1>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 512: return launch_regs<S, 2>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 768: return launch_regs<S, 3>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 1024: return launch_regs<S, 4>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 1280: return launch_regs<S, 5>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 1536: return launch_regs<S, 6>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 1792: return launch_regs<S, 7>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    case 2048: return launch_regs<S, 8>(x, scale, dy, dx, partial, dscale, n, eps, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  rmsnorm_bwd_fold_kernel<S><<<(d + kFoldCols - 1) / kFoldCols, kFoldCols * kFoldGroups, 0,
                               stream>>>(partial, static_cast<S*>(dscale), blocks, d);
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

// The "regs" route: x, dy, dx bf16 [n, d] with d a multiple of 256 up to
// 2048 and 16-byte aligned rows; scale and dscale [d] fp32 or bf16;
// partial fp32 [blocks, d].  The caller checks shapes, types, alignment
// and devices.
extern "C" int rmsnorm_bwd_regs_launch(const void* x, const void* scale, const void* dy,
                                       void* dx, void* partial, void* dscale, int n, int d,
                                       float eps, int scale_bf16, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  return scale_bf16 ? launch_regs_d<__nv_bfloat16>(x, scale, dy, dx, part, dscale, n, d, eps,
                                                   blocks, s)
                    : launch_regs_d<float>(x, scale, dy, dx, part, dscale, n, d, eps, blocks, s);
}
