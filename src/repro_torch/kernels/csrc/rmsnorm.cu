// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (`rmsnorm`, body `_rmsnorm_kernel`), and on the model path the jnp
// function src/repro/models/layers.py `rms_norm`.
//
// Bound: bytes.  The work is ~4 operations per element against
// 2*n*d*itemsize bytes of traffic, far below the H100's ~295 op/byte
// balance point, so the floor is 2*n*d*itemsize / 3.35 TB/s.  At decode
// ([4, d]) the floor is a few ns and one launch's latency is the time.
//
// Design: a row goes to a group of L lanes (L = 32, one warp; fewer for a
// row of fewer than 32 vectors), planned by the wrapper (`plan_rmsnorm`:
// L, vectors per lane VPL, rows per block of max(128, L) threads).
//  * The row is held in registers: each lane issues all of its VPL 16-byte
//    loads (8 bf16 or 4 fp32 each; 8 a lane at d = 2048 bf16, 10 at 2560)
//    before it uses any, so a warp keeps the whole row in flight.
//  * The fp32 sum of squares is reduced by warp shuffles within the group:
//    no shared memory and no block barrier.
//  * 1 + scale is loaded once per lane, with vector loads where the
//    pointer allows, issued just after the first row's loads (the row is
//    on the critical path, the scale only at the end: this order measured
//    faster at decode than the scale first), and kept in fp32 registers
//    while the group strides over its rows; the grid is sized to the card
//    (resident blocks a SM x SMs), so a group normalises n / (groups in
//    the grid) rows.
//  * A row too long for one warp's registers, or any row when there are
//    fewer rows than SMs (decode, [4, d]: one warp's serial share of a row
//    is the time), spreads over up to 8 warps (L = 64 to 256; at decode one
//    vector a lane, two at d = 2560, in a block of 256 threads): the warps'
//    sums meet in shared memory, added in warp order, behind one barrier.
//    Each lane loads its share of the row and of the scale in one round
//    trip to device memory.
// A ragged d (not a multiple of the vector width) or an unaligned pointer
// takes a scalar path through the same registers, compiled as its own
// instantiation so that the vector path's code stays short (it runs once a
// layer, from a cold instruction cache).  The registers limit d:
// VPL * (4 + elements a vector) words a lane stay within kRegBudget, which
// the wrapper's plan mirrors (VPL <= 16: d <= 32768 bf16 and 16384 fp32
// across 8 warps).
//
// Triton would serve a reduction like this equally well; it is CUDA C++
// only so the port keeps one build path and one toolchain (nvcc -> one .so
// with a plain C interface, loaded with ctypes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // a block: 4 warps, or one row of L lanes if more
constexpr int kMaxThreads = 256;
constexpr int kRegBudget = 192;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t word(const uint4& p, int i) {
  return i == 0 ? p.x : i == 1 ? p.y : i == 2 ? p.z : p.w;
}

// Element k of 16 packed bytes of T (k a compile-time constant after unrolling).
template <typename T> __device__ __forceinline__ float elem(const uint4& p, int k);
template <> __device__ __forceinline__ float elem<float>(const uint4& p, int k) {
  return __uint_as_float(word(p, k));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& p, int k) {
  const uint32_t w = word(p, k >> 1);
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// 16 bytes of T from E floats, each rounded to nearest even.
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])))
            << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Elements [e0, e0 + E) of a row of T (E = 16 / sizeof(T)), as 16 packed
// bytes: one vector load, or (scalar path) E loads, reading 0 past d.
template <typename T, bool vec>
__device__ __forceinline__ uint4 load_vec(const T* row, int e0, int d) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (vec) return *reinterpret_cast<const uint4*>(row + e0);
  float f[E];
#pragma unroll
  for (int k = 0; k < E; ++k) f[k] = e0 + k < d ? to_f(row[e0 + k]) : 0.f;
  return pack<T>(f);
}

// 1 + scale[e0 + k] for k < E (0 past d), in fp32.
template <typename S, int E>
__device__ __forceinline__ void load_scale(const S* scale, int e0, int d, bool svec,
                                           float* s1) {
  constexpr int kBytes = E * static_cast<int>(sizeof(S));
  if (svec) {
    if constexpr (kBytes >= 16) {
      constexpr int EW = 16 / sizeof(S);  // elements a 16-byte word
#pragma unroll
      for (int w = 0; w < kBytes / 16; ++w) {
        const uint4 p = *reinterpret_cast<const uint4*>(scale + e0 + w * EW);
#pragma unroll
        for (int k = 0; k < EW; ++k) s1[w * EW + k] = 1.f + elem<S>(p, k);
      }
    } else {  // bf16 scale beside fp32 x: 4 elements, 8 bytes
      const uint2 p = *reinterpret_cast<const uint2*>(scale + e0);
      const uint4 q = make_uint4(p.x, p.y, 0u, 0u);
#pragma unroll
      for (int k = 0; k < E; ++k) s1[k] = 1.f + elem<S>(q, k);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) s1[k] = e0 + k < d ? 1.f + to_f(scale[e0 + k]) : 0.f;
}

template <typename T, typename S, int VPL, bool vec>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
               int n, int d, float eps, int lanes_log2, bool svec) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float warp_sums[2][kMaxThreads / 32];  // rows wider than a warp only
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & (L - 1);
  const int nvec = (d + E - 1) / E;
  // this lane's vectors: v * L + lane for v < VPL, those below nvec
  float s1[VPL][E];
  // Rows go to groups of L lanes; a block's groups step together, so every
  // lane reaches every shuffle and barrier (a group past n just idles).
  const int groups = blockDim.x >> lanes_log2;
  const int group = threadIdx.x >> lanes_log2;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * groups;
  int parity = 0;
  for (int64_t base = first; base < n;
       base += static_cast<int64_t>(gridDim.x) * groups, parity ^= 1) {
    const int64_t row = base + group;
    const bool active = row < n;
    const T* xr = x + row * d;
    uint4 xv[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int idx = v * L + lane;
      xv[v] = active && idx < nvec ? load_vec<T, vec>(xr, idx * E, d) : make_uint4(0, 0, 0, 0);
    }
    if (base == first) {  // 1 + scale behind the first row's loads, kept for the rest
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int idx = v * L + lane;
        if (idx < nvec) load_scale<S, E>(scale, idx * E, d, svec, s1[v]);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float f = elem<T>(xv[v], k);
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < L) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (L > 32) {  // the group's warps, in order, through shared memory
      if ((threadIdx.x & 31) == 0) warp_sums[parity][threadIdx.x >> 5] = ss;
      __syncthreads();
      const int w0 = (group << lanes_log2) >> 5;
      ss = 0.f;
      for (int w = 0; w < (L >> 5); ++w) ss += warp_sums[parity][w0 + w];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (!active) continue;
    T* yr = y + row * d;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int idx = v * L + lane;
      if (idx >= nvec) continue;
      float o[E];
#pragma unroll
      for (int k = 0; k < E; ++k) o[k] = (elem<T>(xv[v], k) * r) * s1[v][k];
      if constexpr (vec) {
        *reinterpret_cast<uint4*>(yr + idx * E) = pack<T>(o);
      } else {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if (idx * E + k < d) yr[idx * E + k] = from_f<T>(o[k]);
        }
      }
    }
  }
}

template <typename T, typename S, int VPL>
int launch_vpl(const void* x, const void* scale, void* y, int n, int d, float eps,
               int lanes_log2, int sms, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  static_assert(VPL * (4 + E) <= kRegBudget, "row and 1 + scale exceed a lane's registers");
  const bool vec = d % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  constexpr int kScaleAlign = E * sizeof(S) < 16 ? E * sizeof(S) : 16;
  const bool svec = d % E == 0 && reinterpret_cast<uintptr_t>(scale) % kScaleAlign == 0;
  // resident blocks a SM of the vector path's instantiation at each block
  // size, asked once (a ragged row's scalar path strides over the rows
  // from the same grid)
  const int threads = kThreads > (1 << lanes_log2) ? kThreads : 1 << lanes_log2;
  static int occupancy[2] = {0, 0};
  int& occ = occupancy[threads == kMaxThreads];
  if (occ == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, rmsnorm_kernel<T, S, VPL, true>, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (occ < 1) occ = 1;
  }
  const int rows_per_block = threads >> lanes_log2;
  const int64_t need = (static_cast<int64_t>(n) + rows_per_block - 1) / rows_per_block;
  const int grid = static_cast<int>(need < static_cast<int64_t>(occ) * sms
                                        ? need
                                        : static_cast<int64_t>(occ) * sms);
  if (vec) {
    rmsnorm_kernel<T, S, VPL, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), n, d,
        eps, lanes_log2, svec);
  } else {
    rmsnorm_kernel<T, S, VPL, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), n, d,
        eps, lanes_log2, svec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int n, int d, float eps,
           int lanes_log2, int vpl, int sms, cudaStream_t s) {
  switch (vpl) {
#define RMS_VPL(V) \
  case V: return launch_vpl<T, S, V>(x, scale, y, n, d, eps, lanes_log2, sms, s);
    RMS_VPL(1) RMS_VPL(2) RMS_VPL(4) RMS_VPL(8) RMS_VPL(10) RMS_VPL(16)
#undef RMS_VPL
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [n, d] (fp32 or bf16), scale [d] (fp32 or bf16), y [n, d] in x's type;
// 2^lanes_log2 lanes a row and vpl vectors a lane from the wrapper's plan,
// sms the card's SM count.  The caller checks shapes, contiguity and n > 0.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int n, int d,
                              float eps, int x_bf16, int scale_bf16, int lanes_log2,
                              int vpl, int sms, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (lanes_log2 < 0 || (1 << lanes_log2) > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_bf16) {
    return scale_bf16 ? launch<bf, bf>(x, scale, y, n, d, eps, lanes_log2, vpl, sms, s)
                      : launch<bf, float>(x, scale, y, n, d, eps, lanes_log2, vpl, sms, s);
  }
  return scale_bf16 ? launch<float, bf>(x, scale, y, n, d, eps, lanes_log2, vpl, sms, s)
                    : launch<float, float>(x, scale, y, n, d, eps, lanes_log2, vpl, sms, s);
}
