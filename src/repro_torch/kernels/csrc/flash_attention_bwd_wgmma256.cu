// Flash-attention backward on Hopper's warpgroup tensor cores (sm_90a) at
// head dim 256: the "wgmma256" route, bf16 with one KV head (any group size
// g) or a g that divides 64 -- every backward call of the recurrentgemma-2b
// train path (b 2, T 2048, hkv 1, g 10, dh 256, causal, window 2048).  It
// computes what flash_attention_bwd.cu's "mma" kernels compute, with the
// same masks (causal, window, q_offset, kv_valid_len, ragged T, GQA) and the
// same roundings, so both are held to the one plain version (kernel.py
// `flash_attention_bwd_plain`).
//
// It is the gradient of the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:86 (`flash_attention`),
// which has no backward of its own, and on the model path the vjp of the
// jnp function src/repro/models/layers.py:145 `attention`.  With qs =
// q / sqrt(dh) rounded to bf16, P = exp(qs k^T - lse) (0 where masked),
// delta = rowsum(dO o):  dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
// dK = dS^T qs,  dQ = (dS K) / sqrt(dh).
//
// Bound on this card: operations.  10 dh flops an allowed (query, key) pair
// and head against 989 TFLOP/s bf16: 1.07e11 flops, 0.109 ms at the train
// shape.  The dQ launch recomputes S and dP (1.5x the dQ product's flops),
// which the bound does not count.
//
// What held the "mma" route back at dh 256 (PERF.md): 64 keys x 256 columns
// of dK and dV in fp32 do not fit one warp's registers, so each block owned
// 128 columns and computed S^T and dP^T for each half (1.5x the products);
// mma.sync runs well under wgmma's rate; and the causal triangle gave key
// tile 0's block 320 row tiles and the last 10, at one block a SM.  The
// design here (flash_attention_bwd_wgmma.cu's pieces, from hopper.cuh):
//  * Launch 1 (flash_attention_bwd.cu): delta, qs and the packed rows'
//    (lse, delta), as for the "wgmma" route.
//  * Launch 2, dK / dV, split by output: a block holds 64 keys of K and V in
//    shared memory and two warpgroups.  Warpgroup 0 owns dV: it computes
//    S^T = K qs^T, makes P^T and runs dV += P^T dO; warpgroup 1 owns dK: it
//    computes dP^T = V dO^T, takes P^T from warpgroup 0 through shared
//    memory (fp32, 16 KB a tile, two buffers, named barriers: full / empty),
//    makes dS^T and runs dK += dS^T qs.  S and dP are computed once a tile,
//    both warpgroups run the same instruction stream for them (their
//    operands differ), and each holds one 64 x 256 fp32 output: 128
//    registers a thread.  Shared memory: K and V (64 KB), a 2-stage TMA
//    ring of (qs, dO) tiles of 64 packed rows (128 KB) and their (lse,
//    delta), P^T's two buffers (32 KB): 226 KB, one block a SM.
//  * Balance: a block is a piece of a key tile's row range, not the whole
//    range.  kernel.py `plan_dkdv_pieces` cuts each key tile's row tiles
//    into pieces of about equal work (about two waves of pieces on the
//    card), longest first; each piece writes fp32 partial dK and dV to its
//    slot of a scratch buffer, and
//  * Launch 3, the fold, sums a key tile's partials in slot (row) order and
//    writes bf16 dK and dV: no atomics, bitwise repeatable.  Key tiles no
//    row sees (past kv_len) get 0.
//  * Launch 4, dQ: one block a (batch, KV head, 128 packed rows), two
//    warpgroups of 64 rows at full width (a 64 x 256 fp32 accumulator
//    each), a 3-stage ring of K and V tiles of 32 keys.  S = qs K^T and
//    dP = dO V^T on wgmma from shared memory (m64n32), dQ += dS K with dS
//    from registers (m64n256).  It recomputes S and dP so that every row of
//    dQ is owned by one block.
//  * Loads: q, qs and dO rows by TMA.  At one KV head the packed
//    (position, head) rows are simply rows [b, T g, dh]: a 3-D map
//    {dh, T g, b} boxes any 64 rows, whatever g is; otherwise the "wgmma"
//    route's 5-D map (g divides 64).  Four 64-column boxes make a row
//    under the 128-byte swizzle.  TMA fills with zero past T; the masks
//    stay as in the "mma" kernels.  Ring refills as in the "wgmma" route:
//    the warpgroup that finishes a stage second issues its next tile.
//  * Roundings as the "mma" kernels (and the plain version): dP to bf16
//    before delta is subtracted, P (fp32 in dS, bf16 as an operand) and dS
//    to bf16 as operands, dQ to bf16 before and after 1/sqrt(dh).
#include "hopper.cuh"

namespace {

using namespace hopper;
using fa::allowed;
using fa::bf16;
using fa::round_bf16;

constexpr int D = 256;
constexpr int kThreads = 256;  // two warpgroups a block
constexpr int kTR = 64;        // packed rows a dK/dV row tile
constexpr int kKeys = 64;      // keys a dK/dV block
constexpr int kStagesKV = 2;
constexpr int kQRows = 128;    // packed rows a dQ block (64 a warpgroup)
constexpr int kTK = 32;        // keys a dQ ring tile
constexpr int kStagesQ = 3;
// Named barriers (0 is __syncthreads): 1 + wg a warpgroup's own; P^T's
// buffers kFull + buf (warpgroup 0 arrives, 1 waits) and kEmpty + buf.
constexpr int kFull = 3, kEmpty = 5;
constexpr int kPartial = kKeys * D / 2;  // float2 an output (dK or dV) of a piece

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 64 (or 2 x 64) packed rows from row0 of (b, h) into a tile of `rows`
// rows at dst (its 64-column halves rows x 128 bytes apart).
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* m, uint64_t* bar,
                                          int rows, int row0, int b, int h, int g, int one_head) {
#pragma unroll
  for (int hf = 0; hf < D / kHalf; ++hf)
    for (int w = 0; w < rows / 64; ++w) {
      unsigned char* p = dst + hf * rows * 128 + w * 64 * 128;
      if (one_head)
        tma_3d(p, m, bar, hf * kHalf, row0 + w * 64, b);
      else
        tma_5d(p, m, bar, hf * kHalf, 0, h, (row0 + w * 64) / g, b);
    }
}

// ---------------------------------------------------------------------------
// 2. dK, dV by pieces
// ---------------------------------------------------------------------------
struct KvSmem {
  static constexpr int KTILE = kKeys * D * 2;  // K (or V): 64 keys
  static constexpr int RTILE = kTR * D * 2;    // a qs (or dO) row tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KTILE;
  static constexpr int Q_OFF = V_OFF + KTILE;
  static constexpr int DO_OFF = Q_OFF + kStagesKV * RTILE;
  static constexpr int ST_OFF = DO_OFF + kStagesKV * RTILE;  // float2 [stages][kTR]
  static constexpr int P_OFF = ST_OFF + kStagesKV * kTR * 8;  // fp32 [2][32][128]
  static constexpr int BAR_OFF = P_OFF + 2 * kKeys * kTR * 4;  // full[stages], kv, done[stages]
  static constexpr int BYTES = BAR_OFF + (kStagesKV + 1) * 8 + kStagesKV * 4 + 1024;
  static constexpr uint32_t TILE_TX = 2 * RTILE + kTR * 8;
};
static_assert(KvSmem::BYTES <= 232448, "dK/dV shared memory");

// piece = (key tile id = (b hkv + h) ktiles + kt, first row, end row, slot):
// rows [first, end) of the packed rows that key tile's keys see.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_qs,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_st,
                               const int4* __restrict__ pieces, float2* __restrict__ partials,
                               int hkv, int g, int ktiles, int one_head, int causal, int window,
                               int q_offset, int kv_len) {
  using L = KvSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_bar = full + kStagesKV;
  int* done = reinterpret_cast<int*>(kv_bar + 1);  // as flash_attention_bwd_wgmma.cu's

  const int4 pc = pieces[blockIdx.x];
  const int bh = pc.x / ktiles, b = bh / hkv, h = bh % hkv;
  const int k0 = pc.x % ktiles * kKeys;
  const int rbeg = pc.y, rend = pc.z;
  const int ntiles = (rend - rbeg + kTR - 1) / kTR;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesKV; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue_tile = [&](int i) {
    const int s = i % kStagesKV, row0 = rbeg + i * kTR;
    mbar_expect_tx(&full[s], L::TILE_TX);
    load_rows(smem + L::Q_OFF + s * L::RTILE, &tm_qs, &full[s], kTR, row0, b, h, g, one_head);
    load_rows(smem + L::DO_OFF + s * L::RTILE, &tm_do, &full[s], kTR, row0, b, h, g, one_head);
    tma_2d(smem + L::ST_OFF + s * kTR * 8, &tm_st, &full[s], 2 * row0, bh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * L::KTILE);
#pragma unroll
    for (int hf = 0; hf < D / kHalf; ++hf) {
      tma_4d(smem + L::K_OFF + hf * kKeys * 128, &tm_k, kv_bar, hf * kHalf, h, k0, b);
      tma_4d(smem + L::V_OFF + hf * kKeys * 128, &tm_v, kv_bar, hf * kHalf, h, k0, b);
    }
    for (int i = 0; i < min(kStagesKV, ntiles); ++i) issue_tile(i);
  }
  // warp-uniform for the compiler, as in flash_attention_bwd_wgmma.cu
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int wl = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32 % 4, 0);
  const int lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // S^T from (K, qs) for warpgroup 0, dP^T from (V, dO) for warpgroup 1
  const unsigned char* At = smem + (wg == 0 ? L::K_OFF : L::V_OFF);
  float* pbuf = reinterpret_cast<float*>(smem + L::P_OFF);
  const int key0 = k0 + 16 * wl + (lane >> 2);  // this thread's first key
  mbar_wait(kv_bar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStagesKV;
    mbar_wait(&full[s], (i / kStagesKV) & 1);
    const int row0 = rbeg + i * kTR, nrows = min(kTR, rend - row0);
    const unsigned char* Qt = smem + L::Q_OFF + s * L::RTILE;
    const unsigned char* Dt = smem + L::DO_OFF + s * L::RTILE;
    const float2* stat = reinterpret_cast<const float2*>(smem + L::ST_OFF + s * kTR * 8);
    float* pb = pbuf + (i & 1) * (kKeys * kTR);
    float st[kTR / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<kTR>(st, desc_k(At, kKeys, 0, ks), desc_k(wg == 0 ? Qt : Dt, kTR, 0, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    // element 4 j + e: key key0 (+ 8 for e >= 2), packed row
    // 8 j + 2 (lane % 4) + (e & 1) of the tile
    if (wg == 0) {
      const int pfirst = q_offset + row0 / g, plast = q_offset + (row0 + nrows - 1) / g;
      const bool all = nrows == kTR && k0 + kKeys <= kv_len && (!causal || k0 + kKeys - 1 <= pfirst) &&
                       (!window || plast - k0 < window);
      if (all) {
#pragma unroll
        for (int j = 0; j < kTR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * j + 2 * (lane & 3) + (e & 1);
            st[4 * j + e] = fa::exp2_approx(fmaf(st[4 * j + e], fa::kLog2e, -stat[r].x));
          }
      } else {
#pragma unroll
        for (int j = 0; j < kTR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * j + 2 * (lane & 3) + (e & 1);
            const float pv = fa::exp2_approx(fmaf(st[4 * j + e], fa::kLog2e, -stat[r].x));
            const bool ok = (r < nrows) & allowed(key0 + 8 * (e >> 1), q_offset + (row0 + r) / g,
                                                  causal, window, kv_len);
            st[4 * j + e] = ok ? pv : 0.f;
          }
      }
      if (i >= 2) bar_sync(kEmpty + (i & 1), 256);  // warpgroup 1 has read tile i - 2's P^T
#pragma unroll
      for (int j = 0; j < kTR / 2; ++j) pb[j * 128 + tid] = st[j];
      bar_arrive(kFull + (i & 1), 256);
    } else {
      bar_sync(kFull + (i & 1), 256);
      // dS^T; a masked pair (P 0) stays 0 whatever the padded rows' stats hold
#pragma unroll
      for (int j = 0; j < kTR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e, r = 8 * j + 2 * (lane & 3) + (e & 1);
          const float pv = pb[idx * 128 + tid];
          st[idx] = pv == 0.f ? 0.f : pv * (round_bf16(st[idx]) - stat[r].y);
        }
      if (i + 2 < ntiles) bar_arrive(kEmpty + (i & 1), 256);
    }
    // outside the branch, so ptxas sees one wgmma stream: dV += P^T dO
    // (warpgroup 0), dK += dS^T qs (warpgroup 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTR / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(st, kk, a);
      wgmma_rs_mn<D>(acc, a, desc_mn(wg == 0 ? Dt : Qt, kTR, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    // the warpgroup is done with stage s: the later of the two refills it
    bar_sync(1 + wg, 128);
    if (tid == 0 && (atomicAdd(&done[s], 1) & 1) && i + kStagesKV < ntiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_tile(i + kStagesKV);
    }
  }
  fence_regs(acc);
  // partials[slot][dK 0 / dV 1][m][tid] = (acc[2 m], acc[2 m + 1]): coalesced
  float2* dst = partials + (static_cast<int64_t>(pc.w) * 2 + (1 - wg)) * kPartial + tid;
#pragma unroll
  for (int m = 0; m < D / 4; ++m) dst[m * 128] = make_float2(acc[2 * m], acc[2 * m + 1]);
}

// ---------------------------------------------------------------------------
// 3. the fold: a key tile's partials in slot order, to bf16 dK and dV
// ---------------------------------------------------------------------------
// tiles[key tile id] = (first slot, pieces); a thread an output float2.
__global__ void __launch_bounds__(256)
flash_bwd_fold_wgmma256_kernel(const float2* __restrict__ partials, const int2* __restrict__ tiles,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int tk, int hkv,
                               int ktiles, int nkt) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= static_cast<int64_t>(nkt) * 2 * kPartial) return;
  const int tid = idx & 127, m = (idx >> 7) & (D / 4 - 1), which = (idx >> 13) & 1;
  const int kid = static_cast<int>(idx >> 14);
  const int2 tl = tiles[kid];
  float2 sum = make_float2(0.f, 0.f);
  for (int p = 0; p < tl.y; ++p) {
    const float2 v = partials[(static_cast<int64_t>(tl.x + p) * 2 + which) * kPartial + m * 128 + tid];
    sum.x += v.x;
    sum.y += v.y;
  }
  // (m, tid) -> key 16 wl + lane / 4 + 8 (m & 1), dims 8 (m / 2) + 2 (lane % 4) (+ 1)
  const int lane = tid & 31;
  const int key = kid % ktiles * kKeys + 16 * (tid >> 5) + (lane >> 2) + 8 * (m & 1);
  if (key >= tk) return;
  const int bh = kid / ktiles, b = bh / hkv, h = bh % hkv;
  const int64_t off = ((static_cast<int64_t>(b) * tk + key) * hkv + h) * D + 8 * (m >> 1) +
                      2 * (lane & 3);
  *reinterpret_cast<__nv_bfloat162*>((which ? dv : dk) + off) = __floats2bfloat162_rn(sum.x, sum.y);
}

// ---------------------------------------------------------------------------
// 4. dQ at full width
// ---------------------------------------------------------------------------
struct QSmem {
  static constexpr int QTILE = kQRows * D * 2;  // 128 rows of qs (or dO)
  static constexpr int KTILE = kTK * D * 2;     // a tile of K (or V)
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + QTILE;
  static constexpr int K_OFF = DO_OFF + QTILE;
  static constexpr int V_OFF = K_OFF + kStagesQ * KTILE;
  static constexpr int BAR_OFF = V_OFF + kStagesQ * KTILE;  // full[stages], q, done[stages]
  static constexpr int BYTES = BAR_OFF + (kStagesQ + 1) * 8 + kStagesQ * 4 + 1024;
};
static_assert(QSmem::BYTES <= 232448, "dQ shared memory");

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma256_kernel(const __grid_constant__ CUtensorMap tm_qs,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float2* __restrict__ rowstat, bf16* __restrict__ dq, int tq,
                             int hkv, int g, int rs_rows, int one_head, int causal, int window,
                             int q_offset, int kv_len, float scale) {
  using L = QSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_bar = full + kStagesQ;
  int* done = reinterpret_cast<int*>(q_bar + 1);

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int rows_total = tq * g;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kQRows;  // the most keys first
  const int nrows = min(kQRows, rows_total - row0);
  auto pos_of = [&](int r) { return q_offset + (row0 + min(r, nrows - 1)) / g; };
  const int kbeg = fa::key_range(pos_of(0), causal, window, 0, kv_len).lo;
  const int kend = fa::key_range(pos_of(nrows - 1), causal, window, 0, kv_len).hi;
  const int t0 = kbeg / kTK;
  const int ntiles = kend > kbeg ? (kend - 1) / kTK - t0 + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue_tile = [&](int i) {
    const int s = i % kStagesQ;
    mbar_expect_tx(&full[s], 2 * L::KTILE);
#pragma unroll
    for (int hf = 0; hf < D / kHalf; ++hf) {
      tma_4d(smem + L::K_OFF + s * L::KTILE + hf * kTK * 128, &tm_k, &full[s], hf * kHalf, h,
             (t0 + i) * kTK, b);
      tma_4d(smem + L::V_OFF + s * L::KTILE + hf * kTK * 128, &tm_v, &full[s], hf * kHalf, h,
             (t0 + i) * kTK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, 2 * L::QTILE);
    load_rows(smem + L::Q_OFF, &tm_qs, q_bar, kQRows, row0, b, h, g, one_head);
    load_rows(smem + L::DO_OFF, &tm_do, q_bar, kQRows, row0, b, h, g, one_head);
    for (int i = 0; i < min(kStagesQ, ntiles); ++i) issue_tile(i);
  }

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int wl = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32 % 4, 0);
  const int lane = threadIdx.x & 31;
  const int wr0 = wg * 64;                            // the warpgroup's rows in the block
  const int wn = max(0, min(64, nrows - wr0));        // of which exist
  const fa::KeyRange wfirst = fa::key_range(pos_of(wr0), causal, window, 0, kv_len);
  const fa::KeyRange wlast = fa::key_range(pos_of(wr0 + wn - 1), causal, window, 0, kv_len);
  fa::KeyRange kr[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr0 + 16 * wl + (lane >> 2) + 8 * half;
    kr[half] = fa::key_range(pos_of(r), causal, window, 0, kv_len);
    const float2 ld = r < nrows ? rowstat[(static_cast<int64_t>(b) * hkv + h) * rs_rows + row0 + r]
                                : make_float2(0.f, 0.f);
    lse2[half] = ld.x;  // lse log2(e)
    delta[half] = ld.y;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const unsigned char* Qw = smem + L::Q_OFF;
  const unsigned char* Dw = smem + L::DO_OFF;
  mbar_wait(q_bar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStagesQ;
    mbar_wait(&full[s], (i / kStagesQ) & 1);
    const int kt0 = (t0 + i) * kTK;
    if (wn > 0 && kt0 < wlast.hi && kt0 + kTK > wfirst.lo) {
      const bool masked = !(kt0 >= wlast.lo && kt0 + kTK <= wfirst.hi);
      const unsigned char* Kt = smem + L::K_OFF + s * L::KTILE;
      const unsigned char* Vt = smem + L::V_OFF + s * L::KTILE;
      float sc[kTK / 2], dp[kTK / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // S = qs K^T
        wgmma_ss<kTK>(sc, desc_k(Qw, kQRows, wr0, ks), desc_k(Kt, kTK, 0, ks), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)  // dP = dO V^T
        wgmma_ss<kTK>(dp, desc_k(Dw, kQRows, wr0, ks), desc_k(Vt, kTK, 0, ks), ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      // element 4 j + e: row 16 wl + lane / 4 (+ 8 for e >= 2) of the
      // warpgroup's 64, key kt0 + 8 j + 2 (lane % 4) + (e & 1)
      if (masked) {
#pragma unroll
        for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            const float pv = fa::exp2_approx(fmaf(sc[4 * j + e], fa::kLog2e, -lse2[half]));
            const int key = kt0 + 8 * j + 2 * (lane & 3) + (e & 1);
            sc[4 * j + e] = (key < kr[half].lo) | (key >= kr[half].hi) ? 0.f : pv;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = fa::exp2_approx(fmaf(sc[4 * j + e], fa::kLog2e, -lse2[e >> 1]));
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          const float pv = sc[idx];
          dp[idx] = pv == 0.f ? 0.f : pv * (round_bf16(dp[idx]) - delta[e >> 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(dp, kk, a);
        wgmma_rs_mn<D>(acc, a, desc_mn(Kt, kTK, kk));  // dQs += dS K
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0 && (atomicAdd(&done[s], 1) & 1) && i + kStagesQ < ntiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_tile(i + kStagesQ);
    }
  }
  fence_regs(acc);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr0 + 16 * wl + (lane >> 2) + 8 * half;
    if (r >= nrows) continue;
    const int gr = row0 + r, pos = gr / g, head = gr % g;
    bf16* dst = dq + ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * D +
                static_cast<int64_t>(head) * D + 2 * (lane & 3);
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb) =
          __floats2bfloat162_rn(round_bf16(acc[4 * jb + 2 * half]) * scale,
                                round_bf16(acc[4 * jb + 2 * half + 1]) * scale);
  }
}

}  // namespace

// qs (q scaled and rounded), dO, dq [b, tq, hkv, g, 256]; k, v, dk, dv
// [b, tk, hkv, 256]; rowstat fp32 [b, hkv, rs_rows, 2] as
// flash_bwd_delta_launch wrote them (rs_rows even); bf16, contiguous,
// 16-byte aligned; hkv 1 or g dividing 64.  pieces int4 [npieces] in
// launch order and tiles int2 [b * hkv * ktiles] as kernel.py
// `plan_dkdv_pieces` gives them, on the device; partials fp32 [npieces, 2,
// 64 x 256] scratch.  kv_len = min(tk, kv_valid_len).  The caller checks
// shapes, types and that every query row sees a key.
extern "C" int flash_bwd_wgmma256_launch(const void* qs, const void* k, const void* v,
                                         const void* dO, const void* rowstat, const void* pieces,
                                         int npieces, const void* tiles, void* partials, void* dq,
                                         void* dk, void* dv, int b, int tq, int tk, int hkv, int g,
                                         int rs_rows, int causal, int window, int q_offset,
                                         int kv_len, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int one_head = hkv == 1;
  const int qtiles = (tq * g + kQRows - 1) / kQRows;
  const int ktiles = (tk + kKeys - 1) / kKeys;
  const int nkt = b * hkv * ktiles;
  if (qtiles > 65535 || rs_rows % 2 || !(one_head || 64 % g == 0))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  static unsigned done_kv = 0, done_q = 0;
  cudaError_t e = fa::smem_opt_in(flash_bwd_dkdv_wgmma256_kernel, KvSmem::BYTES, done_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fa::smem_opt_in(flash_bwd_dq_wgmma256_kernel, QSmem::BYTES, done_q);
  if (e != cudaSuccess) return static_cast<int>(e);

  // q and dO rows as 64-row boxes (both kernels); K and V as 64-key boxes
  // (dK/dV) and kTK-key boxes (dQ); (lse, delta) as kTR-pair boxes
  CUtensorMap tm_qs, tm_do, tm_k, tm_v, tm_kq, tm_vq, tm_st;
  int err = one_head ? map_rows_3d(&tm_qs, qs, b, tq, g, D, 64)
                     : map_rows(&tm_qs, qs, b, tq, hkv, g, D, 64);
  if (!err) err = one_head ? map_rows_3d(&tm_do, dO, b, tq, g, D, 64)
                           : map_rows(&tm_do, dO, b, tq, hkv, g, D, 64);
  if (!err) err = map_keys(&tm_k, k, b, tk, hkv, D, kKeys);
  if (!err) err = map_keys(&tm_v, v, b, tk, hkv, D, kKeys);
  if (!err) err = map_keys(&tm_kq, k, b, tk, hkv, D, kTK);
  if (!err) err = map_keys(&tm_vq, v, b, tk, hkv, D, kTK);
  if (!err) err = map_rowstat(&tm_st, rowstat, b * hkv, rs_rows, kTR);
  if (err) return err;

  float2* part = static_cast<float2*>(partials);
  if (npieces > 0) {
    flash_bwd_dkdv_wgmma256_kernel<<<npieces, kThreads, KvSmem::BYTES, s>>>(
        tm_qs, tm_do, tm_k, tm_v, tm_st, static_cast<const int4*>(pieces), part, hkv, g, ktiles,
        one_head, causal, window, q_offset, kv_len);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t fold_threads = static_cast<int64_t>(nkt) * 2 * kPartial;
  flash_bwd_fold_wgmma256_kernel<<<static_cast<unsigned>((fold_threads + 255) / 256), 256, 0, s>>>(
      part, static_cast<const int2*>(tiles), static_cast<bf16*>(dk), static_cast<bf16*>(dv), tk,
      hkv, ktiles, nkt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma256_kernel<<<dim3(b * hkv, qtiles), kThreads, QSmem::BYTES, s>>>(
      tm_qs, tm_do, tm_kq, tm_vq, static_cast<const float2*>(rowstat), static_cast<bf16*>(dq), tq,
      hkv, g, rs_rows, one_head, causal, window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}
