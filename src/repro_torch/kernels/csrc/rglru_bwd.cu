// RG-LRU backward for Hopper (sm_90a): the gradient of the scan
// h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, for both of rglru.cu's
// coefficient sources.
//
// It is the gradient of the Pallas TPU kernel
// src/repro/kernels/rglru/kernel.py:47 (`rglru`), which has no backward of
// its own, and on the model path the vjp of the functions the reference's
// training path differentiates through XLA: src/repro/models/recurrent.py
// `_rglru_coeffs` followed by the `lax.associative_scan` of `rglru_scan`.
//  * AbSource (the TPU kernel's function): da_t = g_t h_{t-1}, db_t = g_t.
//  * GatedSource (the model's): the chain rule on through the gate math,
//    per element in fp32 with c = 8, L = -softplus(-lam), s = 1 - a^2,
//    m = sqrt(clip(s, 1e-6, 1)), u = i x (rglru.cu's note):
//      d log_a = da a - [1e-6 < s < 1] a^2 db u / m   (the clip's gradient
//                                                      is 0 where it binds)
//      d pre_r = d log_a c L r (1 - r),  d pre_i = db m x i (1 - i)
//      dx = d pre_r wr + d pre_i wi + db m i
//    and per channel dwr, dbr, dwi, dbi = the sums over batch and time of
//    d pre_r x, d pre_r, d pre_i x, d pre_i, and dlam = sigmoid(-lam) c
//    sum(d log_a r).
// with g_t = dh_t + a_{t+1} g_{t+1} (0 past T) and h recomputed in fp32,
// not read back from the bf16 output.
//
// Bound: bytes.  Gated at the train shape x bf16 [2, 2048, 2560]: x and dh
// read, dx written, 62.9 MB, 0.0188 ms at 3.35 TB/s (the chunk starts this
// design reads, 0.66 MB, count against it).  The gate math (~70
// instructions an element, two sigmoids, exp, sqrt) and its chain rule
// (~40 more) make the kernel bound by instruction issue, as the forward is;
// the first version evaluated the full gates three times an element.
//
// Design: the forward's chunks over T (the wrapper's plan, at most
// kMaxChunk steps a chunk so that a chunk's g fits in shared memory), three
// launches, no atomics, bitwise the same from call to call:
//  0. (the forward, rglru.cu, when autograd records it) each chunk's
//     entering h, fp32 starts [B, nchunks, C]: the fold of the chunks'
//     (prod a, h from 0) the first version recomputed here;
//  1. rglru_bwd_summary_kernel, a thread a (batch, chunk, channel): a walk
//     over the chunk computing a alone (the recurrence gate: one sigmoid
//     and an exp, no input gate, sqrt or b) gives (prod a, Q), where
//     Q = sum_t dh_t prod_{s <= t} a_s is the a-weighted gradient the
//     chunk hands to the one before it when nothing flows in from behind;
//  2. rglru_bwd_scan_kernel, a thread a (batch, chunk, channel): folds the
//     later chunks' (prod, Q) into the gradient flowing in from behind, in
//     reverse chunk order; walks the chunk backward from a alone for g_t,
//     kept in shared memory (chunk_len x 128 fp32, 32 KB at 64 steps: the
//     first version's footprint, so as many blocks in flight); then walks
//     it forward from its start h, evaluating the full gates once an
//     element for both the chain rule and the next h.  Keeping more of the
//     gates (r, a) beside g would skip a sigmoid and an exp an element but
//     triple the shared memory and cut the blocks in flight a SM from 7 to
//     2, in a kernel that issue bounds.  The gated form keeps the five
//     weight sums in registers and writes them as one row of fp32
//     partials [5, B * nchunks, C];
//  3. rglru_bwd_fold_kernel (gated), a thread a channel: sums the partials'
//     rows in order and writes the five weight gradients.
// The full gates are evaluated once an element and a alone twice, against
// three full evaluations before.  h, g and dx are the first version's
// operations in its order (the weight sums run over time the other way).
// One chunk skips launch 1 and starts from h = 0.  Consecutive threads take
// consecutive channels, so loads and stores are coalesced; each walk issues
// kUnroll steps' loads before their dependent chain, as the forward does.
#include "rglru.cuh"

namespace {

using rg::from_f;
using rg::kLruC;
using rg::kUnroll;
using rg::to_f;

constexpr int kThreads = 128;
constexpr int kMaxChunk = 64;  // steps: a chunk's fp32 g, 64 x 128 x 4 B = 32 KB
constexpr int kParts = 5;      // dwr, dbr, dwi, dbi, sum(d log_a r)

// The (a, b) form: its input gradients, no weights.
template <typename T>
struct AbBwd {
  using Src = rg::AbSource<T>;
  using Out = T;
  struct Acc {};
  Src src;
  T* __restrict__ da;
  T* __restrict__ db;
  // One step of the forward walk with its g_t and h_{t-1}: the input
  // gradients at off, and the step's (a, b) for h_t.
  __device__ __forceinline__ void step(const typename Src::Chan&, const typename Src::Raw& raw,
                                       float g, float h_prev, int64_t off, Acc&, float& a,
                                       float& b) const {
    da[off] = from_f<T>(g * h_prev);
    db[off] = from_f<T>(g);
    a = to_f(raw.a);
    b = to_f(raw.b);
  }
  __device__ __forceinline__ void store(const Acc&, float*, int64_t, int64_t) const {}
};

// The gated form: dx, and the weight sums in the accumulator.
template <typename X, typename W>
struct GatedBwd {
  using Src = rg::GatedSource<X, W>;
  using Out = X;
  struct Acc { float v[kParts] = {0.f, 0.f, 0.f, 0.f, 0.f}; };
  Src src;
  X* __restrict__ dx;
  // The gates once: the chain rule at off, and (a, b) exactly as
  // GatedSource::coeffs makes them (b = m u, the forward's rounding).
  __device__ __forceinline__ void step(const typename Src::Chan& p, typename Src::Raw raw,
                                       float g, float h_prev, int64_t off, Acc& acc, float& a,
                                       float& b) const {
    const rg::Gates q = src.gates(p, raw);
    const float s = __fsub_rn(1.f, q.e2);
    const float m = sqrtf(fminf(fmaxf(s, 1e-6f), 1.f));
    const float u = __fmul_rn(q.i, q.xf);
    const float dlog_a = g * h_prev * q.a - ((s > 1e-6f && s < 1.f) ? q.e2 * g * u / m : 0.f);
    const float dpre_r = dlog_a * kLruC * p.log_a_base * (q.r * (1.f - q.r));
    const float du = g * m;
    const float dpre_i = du * q.xf * (q.i * (1.f - q.i));
    dx[off] = from_f<X>(dpre_r * p.wr + dpre_i * p.wi + du * q.i);
    acc.v[0] += dpre_r * q.xf;
    acc.v[1] += dpre_r;
    acc.v[2] += dpre_i * q.xf;
    acc.v[3] += dpre_i;
    acc.v[4] += dlog_a * q.r;
    a = q.a;
    b = __fmul_rn(m, u);
  }
  // partials[k, row, c] = acc.v[k]: `plane` = B * nchunks * C, `at` = row * C + c
  __device__ __forceinline__ void store(const Acc& acc, float* partials, int64_t plane,
                                        int64_t at) const {
#pragma unroll
    for (int k = 0; k < kParts; ++k) partials[k * plane + at] = acc.v[k];
  }
};

// 1. summary[bi, k, c] = (prod a, Q from 0) over chunk k, from a alone.
template <class Src>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_summary_kernel(Src src, const typename Src::Out* __restrict__ dh,
                         float2* __restrict__ summary, int steps, int C, int chunk_len) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int t0 = k * chunk_len;
  const int t1 = min(steps, t0 + chunk_len);
  const typename Src::Chan ch = src.channel(c);
  const int64_t base = bi * steps * C + c;
  float prod = 1.f, q = 0.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    typename Src::Raw raw[kUnroll];
    float dhv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t + u) * C;
      raw[u] = src.load(off);
      dhv[u] = to_f(dh[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      prod *= src.a_only(ch, raw[u]);
      q = fmaf(dhv[u], prod, q);
    }
  }
  for (; t < t1; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * C;
    prod *= src.a_only(ch, src.load(off));
    q = fmaf(to_f(dh[off]), prod, q);
  }
  summary[(bi * gridDim.y + k) * C + c] = make_float2(prod, q);
}

// 2. the chunk's backward walk (g_t into shared memory, from a alone) and
// forward walk (the gates once: the chain rule and h).
template <class Bwd>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_scan_kernel(Bwd bwd, const typename Bwd::Out* __restrict__ dh,
                      const float2* __restrict__ summary, const float* __restrict__ starts,
                      float* __restrict__ partials, int steps, int C, int chunk_len) {
  extern __shared__ float g_s[];  // [chunk_len][kThreads]
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;  // each thread reads only its own column of g_s: no barrier
  const int k = blockIdx.y, nchunks = gridDim.y;
  const int64_t bi = blockIdx.z;
  const int t0 = k * chunk_len;
  const int t1 = min(steps, t0 + chunk_len);
  const auto& src = bwd.src;
  const auto ch = src.channel(c);
  float q = 0.f;  // a_{t1} g_{t1}: the gradient entering from the chunk behind
  for (int j = nchunks - 1; j > k; --j) {
    const float2 sj = summary[(bi * nchunks + j) * C + c];
    q = fmaf(sj.x, q, sj.y);
  }
  const int64_t base = bi * steps * C + c;
  float* gp = g_s + threadIdx.x;
  int t = t1;
  for (; t - kUnroll >= t0; t -= kUnroll) {
    typename Bwd::Src::Raw raw[kUnroll];
    float dhv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t - 1 - u) * C;
      raw[u] = src.load(off);
      dhv[u] = to_f(dh[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float g = dhv[u] + q;
      gp[(t - 1 - u - t0) * kThreads] = g;
      q = src.a_only(ch, raw[u]) * g;
    }
  }
  for (; t > t0; --t) {
    const int64_t off = base + static_cast<int64_t>(t - 1) * C;
    const float g = to_f(dh[off]) + q;
    gp[(t - 1 - t0) * kThreads] = g;
    q = src.a_only(ch, src.load(off)) * g;
  }
  float h = starts != nullptr ? starts[(bi * nchunks + k) * C + c] : 0.f;  // h entering
  typename Bwd::Acc acc;
  rg::walk_raw(src, base, t0, t1, C, [&](const typename Bwd::Src::Raw& raw, int tt, int64_t off) {
    float a, b;
    bwd.step(ch, raw, gp[(tt - t0) * kThreads], h, off, acc, a, b);
    h = fmaf(a, h, b);
  });
  bwd.store(acc, partials, static_cast<int64_t>(gridDim.z) * nchunks * C,
            (bi * nchunks + k) * C + c);
}

// 3. the five weight gradients of a channel: the partials' rows summed in order.
template <typename W>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_fold_kernel(const float* __restrict__ partials, int rows, int C,
                      const W* __restrict__ lam, W* __restrict__ dwr, W* __restrict__ dbr,
                      W* __restrict__ dwi, W* __restrict__ dbi, W* __restrict__ dlam) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float sum[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const float* p = partials + static_cast<int64_t>(k) * rows * C + c;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += p[static_cast<int64_t>(r) * C];
    sum[k] = acc;
  }
  dwr[c] = from_f<W>(sum[0]);
  dbr[c] = from_f<W>(sum[1]);
  dwi[c] = from_f<W>(sum[2]);
  dbi[c] = from_f<W>(sum[3]);
  // d lam = sigmoid(-lam) * c * sum(d log_a r)
  dlam[c] = from_f<W>(rg::sigmoid_f(-to_f(lam[c])) * (kLruC * sum[4]));
}

template <class Bwd>
int run(const Bwd& bwd, const void* dh, const void* starts, void* summary, void* partials, int B,
        int steps, int C, int nchunks, int chunk_len, cudaStream_t s) {
  if (chunk_len < 1 || chunk_len > kMaxChunk || (nchunks > 1 && starts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kThreads - 1) / kThreads, nchunks, B);
  const auto* d = static_cast<const typename Bwd::Out*>(dh);
  float2* sum = static_cast<float2*>(summary);
  if (nchunks > 1) {
    rglru_bwd_summary_kernel<typename Bwd::Src><<<grid, kThreads, 0, s>>>(bwd.src, d, sum, steps,
                                                                           C, chunk_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(chunk_len) * kThreads * sizeof(float);  // <= 32 KB
  rglru_bwd_scan_kernel<Bwd><<<grid, kThreads, smem, s>>>(
      bwd, d, sum, static_cast<const float*>(starts), static_cast<float*>(partials), steps, C,
      chunk_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename W>
int run_gated(const void* x, const void* const* w, const void* dh, void* dx, void* partials,
              const void* starts, void* summary, void* const* dw, int B, int steps, int C,
              int nchunks, int chunk_len, cudaStream_t s) {
  GatedBwd<X, W> bwd;
  bwd.src = {static_cast<const X*>(x), static_cast<const W*>(w[0]), static_cast<const W*>(w[1]),
             static_cast<const W*>(w[2]), static_cast<const W*>(w[3]),
             static_cast<const W*>(w[4])};
  bwd.dx = static_cast<X*>(dx);
  int err = run(bwd, dh, starts, summary, partials, B, steps, C, nchunks, chunk_len, s);
  if (err != 0) return err;
  rglru_bwd_fold_kernel<W><<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partials), B * nchunks, C, static_cast<const W*>(w[4]),
      static_cast<W*>(dw[0]), static_cast<W*>(dw[1]), static_cast<W*>(dw[2]),
      static_cast<W*>(dw[3]), static_cast<W*>(dw[4]));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller checks shapes, types, contiguity and B, T, C > 0, and gives
// summary as fp32 [B, nchunks, C, 2] and starts (the forward's chunk
// starts) as fp32 [B, nchunks, C] when nchunks > 1 (else null for both),
// with (nchunks - 1) * chunk_len < T <= nchunks * chunk_len and
// chunk_len <= 64.

// a, b, dh, da, db [B, T, C] one type (fp32 or bf16); h_{-1} = 0.
extern "C" int rglru_bwd_launch(const void* a, const void* b, const void* dh, void* da,
                                void* db, const void* starts, void* summary, int B, int steps,
                                int C, int nchunks, int chunk_len, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    AbBwd<T> bwd{{static_cast<const T*>(a), static_cast<const T*>(b)}, static_cast<T*>(da),
                 static_cast<T*>(db)};
    return run(bwd, dh, starts, summary, nullptr, B, steps, C, nchunks, chunk_len, s);
  }
  AbBwd<float> bwd{{static_cast<const float*>(a), static_cast<const float*>(b)},
                   static_cast<float*>(da), static_cast<float*>(db)};
  return run(bwd, dh, starts, summary, nullptr, B, steps, C, nchunks, chunk_len, s);
}

// x, dh, dx [B, T, C] one type (fp32 or bf16); wr, br, wi, bi, lam and their
// gradients dwr .. dlam [C] one type (fp32 or bf16); partials fp32
// [5, B * nchunks, C]; h_{-1} = 0.
extern "C" int rglru_gated_bwd_launch(const void* x, const void* wr, const void* br,
                                      const void* wi, const void* bi, const void* lam,
                                      const void* dh, void* dx, void* partials,
                                      const void* starts, void* summary, void* dwr, void* dbr,
                                      void* dwi, void* dbi, void* dlam, int B, int steps, int C,
                                      int nchunks, int chunk_len, int x_bf16, int w_bf16,
                                      void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const void* w[5] = {wr, br, wi, bi, lam};
  void* dw[5] = {dwr, dbr, dwi, dbi, dlam};
#define RGLRU_BWD_ARGS \
  x, w, dh, dx, partials, starts, summary, dw, B, steps, C, nchunks, chunk_len, s
  if (x_bf16) {
    return w_bf16 ? run_gated<bf, bf>(RGLRU_BWD_ARGS) : run_gated<bf, float>(RGLRU_BWD_ARGS);
  }
  return w_bf16 ? run_gated<float, bf>(RGLRU_BWD_ARGS) : run_gated<float, float>(RGLRU_BWD_ARGS);
#undef RGLRU_BWD_ARGS
}
