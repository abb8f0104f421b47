// Flash attention (GQA, causal / local window / kv_valid_len) in fp32 on
// CUDA cores: the "fma" route of kernels/flash_attention/kernel.py.  The
// bf16 routes are flash_attention_mma.cu (prefill, tensor cores) and
// flash_attention_split.cu (decode, split-K); this kernel serves fp32
// inputs only, whose 2e-5 tolerance rules out TF32 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention`, body `_attn_kernel`, GQA wrapper
// ops.py `flash_attention_gqa`), and on the model path the jnp function
// src/repro/models/layers.py `attention` (prefill and contiguous decode).
//
// Layout is the model layer's: q [b, tq, hkv, g, dh], k/v [b, tk, hkv, dh],
// o like q.  Each query head reads KV head h directly; K/V are never
// repeated g times as the Pallas wrapper does.
//
// Bounds on this card:
//  * prefill (tq = tk = T, causal) does about 2 * b * hq * T^2 * dh flops
//    against 67 TFLOP/s fp32 on CUDA cores, and reads q, k, v and writes o
//    once against 3.35 TB/s;
//  * decode (tq = 1 over a cache) is bound by the bytes of the KV cache it
//    reads against 3.35 TB/s.
// The kernel is simple and right, not fast: fp32 FMA on CUDA cores.  What
// the design does:
//  * one block per (q-tile, kv head, batch).  A q-tile is R consecutive
//    (position, group head) rows of one KV head, so the g query heads of a
//    group share every K/V tile the block stages through shared memory;
//  * each query row is owned by TPR threads (dh / TPR <= 32 dims each, dims
//    interleaved so the TPR lanes hit different banks); q, the fp32
//    accumulator and the running max m / sum l stay in registers;
//  * whole K/V tiles outside the tile's causal / window / valid range are
//    never loaded (the Pallas kernel's block skip), and ragged tq / tk are
//    masked per key, so no `T % block` restriction;
//  * when there are fewer rows than row slots (decode: tq = 1, g rows per
//    block) the spare slots split the keys of each tile among themselves and
//    their (m, l, acc) are merged through shared memory at the end, so one
//    block serves all g query heads of the group against the shared cache.
//  * head dims 16 to 256.  At dh = 256 a row is split over TPR = 8 threads
//    of 32 dims each, 16 row slots a block, K/V tiles of 8 keys
//    (2 * 8 * 257 * 4 B ~ 16 KB of static shared memory).
// The training path asks for the rows' log-sum-exp m + log(l) (fp32,
// [b, hkv, g, tq]) for the backward; the serve path passes NULL.
// Numerics follow layers.attention: q is pre-scaled by 1/sqrt(dh) and
// rounded to its own type before the fp32 dot products; the softmax max
// and normaliser are fp32; the output is cast to q's type.  The wrapper
// refuses inputs where a query row has no valid key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
struct Cfg {
  static constexpr int TPR = DH >= 64 ? DH / 32 : 1;  // threads per query row
  static constexpr int DPT = DH / TPR;                // dims per thread
  static constexpr int RS = kThreads / TPR;           // row slots per block
  static constexpr int BK = 2048 / DH;                // keys per smem tile
  static constexpr int LD = DH + 1;                   // padded smem row
  static constexpr int KV_FLOATS = 2 * BK * LD;
  static constexpr int COMB_FLOATS = RS * (DH + 2);
  static constexpr int SMEM_FLOATS = KV_FLOATS > COMB_FLOATS ? KV_FLOATS : COMB_FLOATS;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                  int tq, int tk, int hkv, int g, int causal, int window, int q_offset,
                  int kv_len, int R, int ksplit, float scale) {
  using C = Cfg<DH>;
  constexpr int TPR = C::TPR, DPT = C::DPT, BK = C::BK, LD = C::LD;
  __shared__ float smem[C::SMEM_FLOATS];
  float* Ks = smem;
  float* Vs = smem + BK * LD;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int slot = t / TPR, part = t % TPR;
  const int split = slot / R, r = slot % R;
  const int rows_total = tq * g;
  const int gr = tile * R + r;
  const bool active = split < ksplit && gr < rows_total;
  const int pos = active ? gr / g : 0;
  const int head = active ? gr % g : 0;
  const int qpos = q_offset + pos;
  const int sp = split < ksplit ? split : ksplit - 1;  // keeps smem reads in range

  const int64_t q_base =
      ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * DH + static_cast<int64_t>(head) * DH;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const float qv = active ? to_f(q[q_base + i * TPR + part]) : 0.f;
    qr[i] = to_f(from_f<T>(qv * scale));  // pre-scale, round to q's type
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys this tile of rows can see at all
  const int row_lo = tile * R;
  const int row_hi = min(row_lo + R, rows_total) - 1;
  const int pos_lo = q_offset + row_lo / g, pos_hi = q_offset + row_hi / g;
  int kbeg = window ? max(0, pos_lo - window + 1) : 0;
  const int kend = causal ? min(kv_len, pos_hi + 1) : kv_len;
  kbeg = (kbeg / BK) * BK;

  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = DH / E;        // 16-byte loads per key row
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = t; idx < BK * VPR; idx += kThreads) {
      const int jj = idx / VPR, c = (idx % VPR) * E;
      const int j = k0 + jj;
      float* kd = Ks + jj * LD + c;
      float* vd = Vs + jj * LD + c;
      if (j < kend) {
        const int64_t off = ((static_cast<int64_t>(b) * tk + j) * hkv + h) * DH + c;
        const uint4 kp = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vp = *reinterpret_cast<const uint4*>(v + off);
        const T* ke = reinterpret_cast<const T*>(&kp);
        const T* ve = reinterpret_cast<const T*>(&vp);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kd[e] = to_f(ke[e]);
          vd[e] = to_f(ve[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kd[e] = 0.f;
          vd[e] = 0.f;
        }
      }
    }
    __syncthreads();

    for (int it = 0; it < BK / ksplit; ++it) {
      const int jj = it * ksplit + sp;
      const float* kr = Ks + jj * LD;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) s += qr[i] * kr[i * TPR + part];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int j = k0 + jj;
      const bool ok = active && j < kv_len && (!causal || j <= qpos) &&
                      (!window || qpos - j < window);
      if (ok) {
        if (s > m) {
          const float a = expf(m - s);
          l *= a;
#pragma unroll
          for (int i = 0; i < DPT; ++i) acc[i] *= a;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
        const float* vr = Vs + jj * LD;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * vr[i * TPR + part];
      }
    }
  }

  if (ksplit > 1) {  // merge the key splits of each row (uniform per block)
    __syncthreads();
    float* comb = smem;
    if (split < ksplit) {
      float* c = comb + slot * (DH + 2);
      if (part == 0) {
        c[0] = m;
        c[1] = l;
      }
#pragma unroll
      for (int i = 0; i < DPT; ++i) c[2 + i * TPR + part] = acc[i];
    }
    __syncthreads();
    if (split == 0 && active) {
      float mm = kNegInf;
      for (int s2 = 0; s2 < ksplit; ++s2) mm = fmaxf(mm, comb[(s2 * R + r) * (DH + 2)]);
      float ll = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
      for (int s2 = 0; s2 < ksplit; ++s2) {
        const float* c = comb + (s2 * R + r) * (DH + 2);
        const float w = expf(c[0] - mm);
        ll += c[1] * w;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += c[2 + i * TPR + part] * w;
      }
      l = ll;
      m = mm;
    }
  }

  if (split == 0 && active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[q_base + i * TPR + part] = from_f<T>(acc[i] / denom);
    if (lse != nullptr && part == 0)
      lse[((static_cast<int64_t>(b) * hkv + h) * g + head) * tq + pos] = m + logf(denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int tq,
           int tk, int hkv, int g, int causal, int window, int q_offset,
           int kv_len, float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  const int rows_total = tq * g;
  int R = C::RS, ksplit = 1;
  if (rows_total < C::RS) {
    R = rows_total;
    while (2 * ksplit * R <= C::RS && 2 * ksplit <= C::BK) ksplit *= 2;
  }
  const dim3 grid((rows_total + R - 1) / R, hkv, b);
  flash_attn_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, hkv, g, causal, window, q_offset, kv_len, R,
      ksplit, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int b, int tq,
              int tk, int hkv, int g, int dh, int causal, int window, int q_offset,
              int kv_len, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<float, 16>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 32: return launch<float, 32>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 64: return launch<float, 64>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 128: return launch<float, 128>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 256: return launch<float, 256>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b, tq, hkv, g, dh], k/v [b, tk, hkv, dh], o like q; all contiguous
// fp32, 16-byte aligned; lse fp32 [b, hkv, g, tq] or NULL.  kv_len =
// min(tk, kv_valid_len).  The caller checks shapes, types and that every
// query row sees a key.
extern "C" int flash_fma_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse, int b, int tq, int tk, int hkv, int g, int dh,
                                int causal, int window, int q_offset, int kv_len, float scale,
                                void* stream) {
  return launch_dh(q, k, v, o, static_cast<float*>(lse), b, tq, tk, hkv, g, dh, causal, window,
                   q_offset, kv_len, scale, reinterpret_cast<cudaStream_t>(stream));
}
