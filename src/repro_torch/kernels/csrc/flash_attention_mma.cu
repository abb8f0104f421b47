// Flash attention, bf16, many query rows (prefill): the "mma" route.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:86
// (`flash_attention`, body `_attn_kernel`, GQA wrapper ops.py
// `flash_attention_gqa`) and, on the model path, the jnp function
// src/repro/models/layers.py `attention` at prefill.
//
// Layout is the model layer's: q [b, tq, hkv, g, dh], k/v [b, tk, hkv, dh],
// o like q.  A block owns an M-tile of 64 consecutive packed rows
// (position, group head) of one KV head of one batch row, so the g query
// heads of a group share every K/V tile; 4 warps, 16 rows each.
//
// Bound on this card: operations.  A causal prefill does about
// 2 * b * hq * T^2 * dh flops (4 per allowed (query, key) pair and head
// dim) against 989 TFLOP/s bf16, and reads q, k, v and writes o once
// against 3.35 TB/s; at recurrentgemma's T 2560, dh 256 the flops floor is
// 20x the bytes floor.  What the design does about it:
//  * both products on the tensor cores: S = Q K^T and O += P V with
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands by ldmatrix
//    (V's by ldmatrix.trans); the online softmax runs on the S fragments in
//    registers (row max and sum over the quad by __shfl_xor_sync), P goes
//    to bf16 in registers and straight in as the A operand of the PV mma;
//  * K/V tiles of BC keys through a 2-stage ring in dynamic shared memory,
//    filled by 16-byte cp.async.cg: tile i+1 is in flight while tile i's
//    mmas run.  Q is staged once (pre-scaled by 1/sqrt(dh), rounded to
//    bf16) and its fragments are reloaded per k-step, which keeps the
//    dh 256 O accumulator (128 fp32 registers a thread) clear of spills;
//  * key tiles outside the M-tile's [kbeg, kend) (causal, window,
//    kv_valid_len) are never loaded, the Pallas kernel's `pl.when` skip; a
//    warp skips tiles none of its rows sees, and masks per element only on
//    tiles that cross one of its rows' bounds;
//  * M-tiles with the most keys first (reversed tile index along the grid's
//    slowest axis), so the grid's tail under causal is short.
// BC: 64 keys at dh <= 128, 32 at dh 256, 2 stages: other tile widths and
// 3 stages ran slower on the card at the serve shapes (PERF.md §6);
// registers and spills are in the build log's -Xptxas -v lines beside the
// .so.  No wgmma or TMA yet.
// The training path asks for the rows' log-sum-exp m + log(l) (fp32,
// [b, hkv, g, tq]) for the backward (flash_attention_bwd.cu); the serve
// path passes NULL and the kernel writes none.
#include "flash_mma.cuh"

namespace {

using fa::bf16;

template <int DH>
struct MmaCfg {
  static constexpr int BM = 64;               // packed rows per block
  static constexpr int BC = DH <= 128 ? 64 : 32;  // keys per tile
  static constexpr int STAGES = 2;
  static constexpr int LDS = DH + 8;
  static constexpr int SMEM_BYTES = (BM + 2 * STAGES * BC) * LDS * 2;
};

template <int DH>
__global__ void __launch_bounds__(fa::kThreads)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int tq, int tk, int hkv, int g, int causal, int window, int q_offset,
                 int kv_len, float scale) {
  using C = MmaCfg<DH>;
  constexpr int BM = C::BM, BC = C::BC, STAGES = C::STAGES, LDS = C::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LDS;
  bf16* Vs = Ks + STAGES * BC * LDS;

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int tile = gridDim.y - 1 - blockIdx.y;  // most keys first
  const int rows_total = tq * g;
  const int row0 = tile * BM;
  const int nrows = min(BM, rows_total - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  fa::stage_q<DH>(Qs, q, b, h, tq, hkv, g, row0, nrows, BM, scale);

  // Keys this M-tile sees at all; rows past nrows take the last row's position.
  auto pos_of = [&](int r) { return q_offset + (row0 + min(r, nrows - 1)) / g; };
  const fa::KeyRange first = fa::key_range(pos_of(0), causal, window, 0, kv_len);
  const fa::KeyRange last = fa::key_range(pos_of(nrows - 1), causal, window, 0, kv_len);
  const int kbeg = first.lo, kend = last.hi;
  const int t0 = kbeg / BC;
  const int ntiles = kend > kbeg ? (kend - 1) / BC - t0 + 1 : 0;

  // This warp's rows: the key ranges of its first and last row bound the
  // tiles it needs and those it may take unmasked.
  const int wr = warp * 16;
  const bool warp_live = wr < nrows;
  const fa::KeyRange wfirst = fa::key_range(pos_of(wr), causal, window, 0, kv_len);
  const fa::KeyRange wlast = fa::key_range(pos_of(wr + 15), causal, window, 0, kv_len);
  const fa::KeyRange kr[2] = {
      fa::key_range(pos_of(wr + (lane >> 2)), causal, window, 0, kv_len),
      fa::key_range(pos_of(wr + (lane >> 2) + 8), causal, window, 0, kv_len)};

  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {fa::kNegInf, fa::kNegInf}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles)
      fa::load_kv_tile<DH, BC>(Ks + i * BC * LDS, Vs + i * BC * LDS, k, v, b, h, tk, hkv,
                               (t0 + i) * BC, kend);
    fa::cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < ntiles) {
      const int st = nx % STAGES;
      fa::load_kv_tile<DH, BC>(Ks + st * BC * LDS, Vs + st * BC * LDS, k, v, b, h, tk, hkv,
                               (t0 + nx) * BC, kend);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int k0 = (t0 + i) * BC;
    if (warp_live && k0 < wlast.hi && k0 + BC > wfirst.lo) {
      const bool masked = !(k0 >= wlast.lo && k0 + BC <= wfirst.hi);
      const int st = i % STAGES;
      fa::attend_tile<DH, BC, DH>(Qs + wr * LDS, Ks + st * BC * LDS, Vs + st * BC * LDS, 0, k0,
                                  masked, kr, acc, m, l);
    }
    __syncthreads();
  }

  // o = acc / max(l, 1e-30), bf16; this thread holds rows lane/4 and
  // lane/4 + 8, two adjacent columns of each 8-wide column block.
  const int tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lsum = fmaxf(fa::quad_sum(l[half]), 1e-30f);
    const float inv = 1.f / lsum;
    const int r = wr + (lane >> 2) + 8 * half;
    if (r >= nrows) continue;
    const int gr = row0 + r, pos = gr / g, head = gr % g;
    if (lse != nullptr && tig == 0)
      lse[((static_cast<int64_t>(b) * hkv + h) * g + head) * tq + pos] = m[half] + logf(lsum);
    bf16* dst = o + ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * DH +
                static_cast<int64_t>(head) * DH + tig * 2;
#pragma unroll
    for (int db = 0; db < DH / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(acc[db][2 * half] * inv, acc[db][2 * half + 1] * inv);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int tq,
           int tk, int hkv, int g, int causal, int window, int q_offset, int kv_len,
           float scale, cudaStream_t stream) {
  using C = MmaCfg<DH>;
  const int ntiles = (tq * g + C::BM - 1) / C::BM;
  if (ntiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if constexpr (C::SMEM_BYTES > 48 * 1024) {  // above 48 KB only when asked for
    static unsigned done = 0;
    const cudaError_t e = fa::smem_opt_in(flash_mma_kernel<DH>, C::SMEM_BYTES, done);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b * hkv, ntiles);
  flash_mma_kernel<DH><<<grid, fa::kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, tq, hkv, g, dh], k/v [b, tk, hkv, dh], o like q; all contiguous
// bf16, 16-byte aligned; lse fp32 [b, hkv, g, tq] or NULL.  kv_len =
// min(tk, kv_valid_len).  The caller checks shapes, types and that every
// query row sees a key.
extern "C" int flash_mma_launch(const void* q, const void* k, const void* v, void* o,
                                void* lse_out, int b, int tq, int tk, int hkv, int g, int dh,
                                int causal, int window, int q_offset, int kv_len, float scale,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 32: return launch<32>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
