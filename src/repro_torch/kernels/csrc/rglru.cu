// RG-LRU scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t per channel,
// with (a, b) either read from device memory or computed in the kernel from
// x and the per-channel gate weights.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru/kernel.py
// (`rglru`, body `_rglru_kernel`, wrapper ops.py `rglru_scan`), and on the
// model path the functions of src/repro/models/recurrent.py that run the
// recurrence in its place: `_rglru_coeffs` followed by the
// `lax.associative_scan` of `rglru_scan` (prefill, h_{-1} = 0), and
// `rglru_step` (decode, T = 1 from the cached fp32 state, passed as h0).
//
// Two coefficient sources share one scan (template parameter Src):
//  * AbSource: a, b [B, T, C] fp32 or bf16 (one type), h in that type;
//    the TPU kernel's own function.
//  * GatedSource: x [B, T, C] fp32 or bf16 and wr, br, wi, bi, lam [C]
//    fp32 or bf16 (one type; loaded as scalars, their alignment is not
//    guaranteed); per element, in fp32, exactly `_rglru_coeffs`:
//      r = sigmoid(x*wr + br), i = sigmoid(x*wi + bi),
//      log_a = 8 * r * (-softplus(-lam)), softplus exact (logaddexp form,
//      no threshold) and hoisted per channel,
//      a = exp(log_a), b = sqrt(clamp(1 - exp(2*log_a), 1e-6, 1)) * (i*x).
//    exp(2*log_a) is computed as a*a: one precise expf fewer an element,
//    in a scan whose time the gate math bounds, at about twice the
//    relative rounding error in 1 - a^2, well inside the fp32 check of
//    1e-4 of max |h| (chip_smoke.py, tests/test_torch_kernels.py).  The
//    products and sums that the reference rounds one by one are not
//    contracted to FMAs.  Precise expf / log1pf / sqrtf and IEEE division
//    (the sigmoid's reciprocal as __frcp_rn, which rounds 1/x as division
//    does); no fast math.  a and b never reach device memory; h is written
//    in x's type and the fp32 last state h[:, T-1] into h_last.
//
// Bound: bytes.  Gated at the serve path's prefill shape, x bf16
// [4, 2560, 2560]: 52.4 MB read + 52.4 MB written, 0.031 ms at 3.35 TB/s.
// The gate math costs ~6 special-function operations an element (two
// sigmoids' exp and reciprocal, exp(log_a), a sqrt), ~0.038 ms a pass on
// 132 SMs x 16 a clock, and ~70 instructions an element in all, so each
// pass is bound by instruction issue, not by bytes.  (a, b) form at
// [4, 2560, 2560] fp32: 314.6 MB, 0.094 ms.
//
// Design: a chunked two-pass scan over T, planned by the wrapper
// (`plan_scan_chunks`: nchunks chunks of chunk_len steps, the last cut
// short).  With only B * C = 10,240 channels on the path, one thread per
// channel left most of the card idle and the loop latency-bound; chunks put
// T across threads too (36 chunks of 72 steps at [4, 2560, 2560]: two waves
// of 12 blocks of 128 threads on each of 132 SMs).
//  * pass 1 (rglru_summary_kernel), one thread per (batch, chunk, channel):
//    the chunk's (prod a, h from 0) into fp32 scratch [B, nchunks, C, 2];
//  * pass 2 (rglru_scan_kernel), one thread per (batch, chunk, channel):
//    fold h0 and the earlier chunks' summaries into the chunk's carry, in
//    chunk order, then rescan the chunk sequentially from it, recomputing
//    the coefficients, and write h; the last chunk writes h_last.  When the
//    caller asks (a call autograd records, on the backward's chunk plan),
//    it also writes each chunk's carry, the h entering it, into fp32
//    starts [B, nchunks, C]: the backward (rglru_bwd.cu) starts its chunks
//    from them instead of folding the summaries again -- the same fold in
//    the same order, so the same bits.
// The scan inside a chunk is sequential, so the only reassociation is the
// carry fold; there are no atomics and the output is bitwise the same from
// call to call.  nchunks = 1 runs pass 2 alone, without scratch (decode,
// short T).  Consecutive threads take consecutive channels, so every step's
// loads and stores are coalesced; the time loop is unrolled by kUnroll and
// those steps' loads are issued before the dependent FMA chain (they do not
// depend on h).  Any T and C (threads past C return).
//
// h0 may be the same tensor as h_last (the decode step's state, updated in
// place): each thread reads its own channel of h0 before it writes that
// channel of h_last, which is safe with one chunk only; the wrapper refuses
// the alias when the plan has more.  Neither pointer is __restrict__.
#include "rglru.cuh"

namespace {

using rg::AbSource;
using rg::from_f;
using rg::GatedSource;
using rg::walk;

constexpr int kThreads = 128;
constexpr int kMinBlocks = 12;  // resident blocks a SM; the wrapper's plan fills one wave

// Pass 1: summary[bi, k, c] = (prod of the chunk's a, h over the chunk from 0).
template <class Src>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rglru_summary_kernel(Src src, float2* __restrict__ summary, int steps, int C,
                     int chunk_len) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int t0 = k * chunk_len;
  const int t1 = min(steps, t0 + chunk_len);
  const typename Src::Chan ch = src.channel(c);
  float prod = 1.f, hl = 0.f;
  walk(src, ch, bi * steps * C + c, t0, t1, C, [&](float a, float b, int64_t) {
    prod *= a;
    hl = fmaf(a, hl, b);
  });
  summary[(bi * gridDim.y + k) * C + c] = make_float2(prod, hl);
}

// Pass 2: fold h0 and chunks 0..k-1 into the carry, rescan chunk k, write h.
// Its blocks run in the reverse of pass 1's order, so the first ones find
// in L2 what pass 1 read last.
template <class Src>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rglru_scan_kernel(Src src, const float2* __restrict__ summary, const float* h0,
                  typename Src::Out* __restrict__ h, float* h_last,
                  float* __restrict__ starts, int steps, int C, int chunk_len) {
  const int c = (gridDim.x - 1 - blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = gridDim.y - 1 - blockIdx.y;
  const int64_t bi = gridDim.z - 1 - blockIdx.z;
  const int t0 = k * chunk_len;
  const int t1 = min(steps, t0 + chunk_len);
  const typename Src::Chan ch = src.channel(c);
  float carry = h0 ? h0[bi * C + c] : 0.f;
  const float2* s = summary + bi * gridDim.y * C + c;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float2 aj = s[static_cast<int64_t>(j) * C];
    carry = fmaf(aj.x, carry, aj.y);
  }
  if (starts != nullptr) starts[(bi * gridDim.y + k) * C + c] = carry;
  walk(src, ch, bi * steps * C + c, t0, t1, C, [&](float a, float b, int64_t off) {
    carry = fmaf(a, carry, b);
    h[off] = from_f<typename Src::Out>(carry);
  });
  if (h_last != nullptr && k == static_cast<int>(gridDim.y) - 1) h_last[bi * C + c] = carry;
}

template <class Src>
int run(const Src& src, const void* h0, void* h, void* h_last, void* starts, void* summary,
        int B, int steps, int C, int nchunks, int chunk_len, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((C + kThreads - 1) / kThreads, nchunks, B);
  float2* sum = static_cast<float2*>(summary);
  if (nchunks > 1) {
    rglru_summary_kernel<Src><<<grid, kThreads, 0, s>>>(src, sum, steps, C, chunk_len);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_scan_kernel<Src><<<grid, kThreads, 0, s>>>(
      src, sum, static_cast<const float*>(h0), static_cast<typename Src::Out*>(h),
      static_cast<float*>(h_last), static_cast<float*>(starts), steps, C, chunk_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename W>
int run_gated(const void* x, const void* wr, const void* br, const void* wi,
              const void* bi, const void* lam, const void* h0, void* h, void* h_last,
              void* starts, void* summary, int B, int steps, int C, int nchunks,
              int chunk_len, void* stream) {
  const GatedSource<X, W> src{static_cast<const X*>(x), static_cast<const W*>(wr),
                              static_cast<const W*>(br), static_cast<const W*>(wi),
                              static_cast<const W*>(bi), static_cast<const W*>(lam)};
  return run(src, h0, h, h_last, starts, summary, B, steps, C, nchunks, chunk_len, stream);
}

}  // namespace

// The caller checks shapes, types, contiguity and B, T, C > 0, and gives
// summary as fp32 [B, nchunks, C, 2] when nchunks > 1 (else null), with
// (nchunks - 1) * chunk_len < T <= nchunks * chunk_len; starts fp32
// [B, nchunks, C] or null.

// a, b, h [B, T, C] one type (fp32 or bf16); h0 [B, C] fp32 or null (0);
// h_last [B, C] fp32 or null.
extern "C" int rglru_launch(const void* a, const void* b, const void* h0, void* h,
                            void* h_last, void* starts, void* summary, int B, int steps,
                            int C, int nchunks, int chunk_len, int is_bf16, void* stream) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    const AbSource<T> src{static_cast<const T*>(a), static_cast<const T*>(b)};
    return run(src, h0, h, h_last, starts, summary, B, steps, C, nchunks, chunk_len, stream);
  }
  const AbSource<float> src{static_cast<const float*>(a), static_cast<const float*>(b)};
  return run(src, h0, h, h_last, starts, summary, B, steps, C, nchunks, chunk_len, stream);
}

// x, h [B, T, C] one type (fp32 or bf16); wr, br, wi, bi, lam [C] one type
// (fp32 or bf16); h0 [B, C] fp32 or null (0); h_last [B, C] fp32, may be h0.
extern "C" int rglru_gated_launch(const void* x, const void* wr, const void* br,
                                  const void* wi, const void* bi, const void* lam,
                                  const void* h0, void* h, void* h_last, void* starts,
                                  void* summary, int B, int steps, int C, int nchunks,
                                  int chunk_len, int x_bf16, int w_bf16, void* stream) {
  using bf = __nv_bfloat16;
#define RGLRU_GATED_ARGS \
  x, wr, br, wi, bi, lam, h0, h, h_last, starts, summary, B, steps, C, nchunks, chunk_len, stream
  if (x_bf16)
    return w_bf16 ? run_gated<bf, bf>(RGLRU_GATED_ARGS) : run_gated<bf, float>(RGLRU_GATED_ARGS);
  return w_bf16 ? run_gated<float, bf>(RGLRU_GATED_ARGS) : run_gated<float, float>(RGLRU_GATED_ARGS);
#undef RGLRU_GATED_ARGS
}
