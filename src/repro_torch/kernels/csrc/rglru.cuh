// The RG-LRU's coefficient sources and its forward walk over a chunk of
// steps, shared by the scan (rglru.cu) and its backward (rglru_bwd.cu), so
// the backward recomputes exactly the forward's a and b (and a alone,
// `a_only`, where it needs nothing else).  rglru.cu's note
// says what the gate math computes and how it rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rg {

constexpr int kUnroll = 8;
constexpr float kLruC = 8.f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 1 / (1 + e^-z), the reciprocal correctly rounded as IEEE division rounds it.
__device__ __forceinline__ float sigmoid_f(float z) { return __frcp_rn(1.f + expf(-z)); }

// (a, b) read from device memory.
template <typename T>
struct AbSource {
  using Out = T;
  struct Chan {};
  struct Raw { T a, b; };
  const T* __restrict__ a;
  const T* __restrict__ b;
  __device__ __forceinline__ Chan channel(int) const { return {}; }
  __device__ __forceinline__ Raw load(int64_t off) const { return {a[off], b[off]}; }
  __device__ __forceinline__ void coeffs(const Chan&, const Raw& r, float& av,
                                         float& bv) const {
    av = to_f(r.a);
    bv = to_f(r.b);
  }
  __device__ __forceinline__ float a_only(const Chan&, const Raw& r) const { return to_f(r.a); }
};

// The gates of one element from x and its channel's weights.
struct Gates {
  float xf, r, i, a, e2;  // e2 = a * a = exp(2 log_a)
};

// (a, b) computed from x and the channel's gate weights.
template <typename X, typename W>
struct GatedSource {
  using Out = X;
  struct Chan { float wr, br, wi, bi, log_a_base; };
  using Raw = X;
  const X* __restrict__ x;
  const W* wr;
  const W* br;
  const W* wi;
  const W* bi;
  const W* lam;
  __device__ __forceinline__ Chan channel(int c) const {
    // log a_base = -softplus(-lam), softplus(y) = max(y, 0) + log1p(exp(-|y|))
    const float y = -to_f(lam[c]);
    return {to_f(wr[c]), to_f(br[c]), to_f(wi[c]), to_f(bi[c]),
            -(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))))};
  }
  __device__ __forceinline__ Raw load(int64_t off) const { return x[off]; }
  __device__ __forceinline__ Gates gates(const Chan& p, Raw raw) const {
    Gates g;
    g.xf = to_f(raw);
    g.r = sigmoid_f(__fadd_rn(__fmul_rn(g.xf, p.wr), p.br));
    g.i = sigmoid_f(__fadd_rn(__fmul_rn(g.xf, p.wi), p.bi));
    g.a = expf(__fmul_rn(__fmul_rn(kLruC, g.r), p.log_a_base));
    g.e2 = __fmul_rn(g.a, g.a);  // exp(2 * log_a), see rglru.cu's note
    return g;
  }
  // a alone (the recurrence gate, skipping the input gate, the sqrt and b):
  // the operations of gates()' a, so the same bits
  __device__ __forceinline__ float a_only(const Chan& p, Raw raw) const {
    const float r = sigmoid_f(__fadd_rn(__fmul_rn(to_f(raw), p.wr), p.br));
    return expf(__fmul_rn(__fmul_rn(kLruC, r), p.log_a_base));
  }
  __device__ __forceinline__ void coeffs(const Chan& p, Raw raw, float& av,
                                         float& bv) const {
    const Gates g = gates(p, raw);
    av = g.a;
    bv = __fmul_rn(sqrtf(fminf(fmaxf(__fsub_rn(1.f, g.e2), 1e-6f), 1.f)),
                   __fmul_rn(g.i, g.xf));
  }
};

// Steps [t0, t1) of one channel in order: f(raw_t, t, offset of element t),
// each kUnroll steps' loads issued before their calls.
template <class Src, class F>
__device__ __forceinline__ void walk_raw(const Src& src, int64_t base, int t0, int t1, int C,
                                         F&& f) {
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    typename Src::Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = src.load(base + static_cast<int64_t>(t + u) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(raw[u], t + u, base + static_cast<int64_t>(t + u) * C);
  }
  for (; t < t1; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * C;
    f(src.load(off), t, off);
  }
}

// Steps [t0, t1) of one channel: step(a_t, b_t, offset of element t).
template <class Src, class Step>
__device__ __forceinline__ void walk(const Src& src, const typename Src::Chan& ch,
                                     int64_t base, int t0, int t1, int C, Step&& step) {
  walk_raw(src, base, t0, t1, C, [&](const typename Src::Raw& raw, int, int64_t off) {
    float a, b;
    src.coeffs(ch, raw, a, b);
    step(a, b, off);
  });
}

}  // namespace rg
