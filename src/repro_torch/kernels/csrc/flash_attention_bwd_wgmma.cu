// Flash-attention backward on Hopper's warpgroup tensor cores (sm_90a):
// the "wgmma" route, bf16 with head dim 64 or 128 and a group size g that
// divides 64 -- every backward call of the llama3.2-1b train path (dh 64,
// g 4).  It computes what flash_attention_bwd.cu's "mma" kernels compute,
// with the same masks (causal, window, q_offset, kv_valid_len, ragged T,
// GQA) and the same roundings, so both are held to the one plain version
// (kernel.py `flash_attention_bwd_plain`).
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
// and head (S, dP, dV, dK, dQ) against 989 TFLOP/s bf16; at the llama train
// shape (b 4, T 2048, 32 heads of 64, causal) 1.72e11 flops, 0.174 ms.  The
// dQ launch recomputes S and dP (2.41e11 flops in all), which the bound does
// not count.
//
// What held the "mma" kernels back (PERF.md): mma.sync reaches the
// tensor cores well under wgmma's rate; its dK/dV block of 64 keys staged
// each (qs, dO) row tile for 64 keys only and each warp re-read the whole
// tile four times through ldmatrix; 239 registers left 2 blocks (8 warps)
// a SM.  The design here:
//  * Launch 1 (flash_attention_bwd.cu): delta, qs = bf16(q scale), and
//    each packed (position, group head) row's (lse, delta) side by side,
//    the row count padded to even so the TMA stride is a multiple of 16
//    bytes.
//  * Launch 2, dK / dV: one block a (batch, KV head, 128 keys), two
//    warpgroups of 64 keys each.  The K and V rows stay in shared memory
//    for the block.  A ring of (qs, dO) row tiles of TR packed rows (128
//    at dh 64, 64 at dh 128), and their (lse, delta) pairs, arrives by TMA
//    on full mbarriers.  A warpgroup computes S^T = K qs^T and
//    dP^T = V dO^T as wgmma m64nTR with both operands in shared memory,
//    makes P^T while dP^T is still on the tensor cores, issues
//    dV += P^T dO, makes dS^T while that runs, then issues dK += dS^T qs:
//    P^T and dS^T go in as bf16 register A operands, and B is the ring's
//    tile read MN-major through the descriptor.  dK and dV stay in
//    registers (dh / 2 fp32 a thread each).  A 128-key block stages each
//    row tile once for 128 keys, twice as many as the "mma" block.
//  * Launch 3, dQ: one block a (batch, KV head, 128 packed rows), two
//    warpgroups of 64 rows, a ring of K and V tiles of TK keys (128 at
//    dh 64, 64 at dh 128).  S = qs K^T and dP = dO V^T on wgmma from shared
//    memory, dQ += dS K with dS from registers and K MN-major.  It
//    recomputes S and dP so that every output is owned by one block: no
//    atomics on any result, and the result is bitwise repeatable.
//  * Who refills the ring: no producer warp (see Registers).  Thread 0
//    issues the first STAGES tiles; tile i + STAGES is then issued by the
//    leader of whichever warpgroup finishes tile i second, the moment its
//    stage is free: after a named barrier of its 128 threads, each leader
//    adds one to a shared-memory count of finishers for the stage, and the
//    one that makes it even issues.  The count only schedules copies.  So
//    neither warpgroup waits for a single issuer that is busy with its
//    own tile.
//  * Tile sizes: 128-row (dK/dV) and 128-key (dQ) tiles, m64n128 products,
//    halve the waits and instructions a product against 64.
//  * Masks: a tile that every pair of a warpgroup passes skips them; the
//    others select, in a loop of their own, so the loop has no branch that
//    would keep the exponentials from overlapping.  g divides 64, so it is
//    a power of two and positions come by shifts, not divisions.
//  * Tiles and layouts: q, dO [b, T, hkv, g, dh] load as packed rows
//    through a 5-D tensor map {dh, g, hkv, T, b} with box {64, g, 1,
//    rows / g, 1}, which is why g must divide 64 (kernel.py `bwd_route`
//    sends other g to "mma"); K, V [b, T, hkv, dh] through {dh, hkv, T, b}.
//    Each box is 64 bf16 = 128 bytes wide, the 128-byte swizzle span, so
//    dh 128 loads as two 64-column halves.  TMA fills with zero past T, and
//    the masks stay as in the "mma" kernels.
//  * Causal imbalance: key tile 0 sees every packed row and the last tile
//    the fewest, so the dK/dV grid runs key tiles in blockIdx.y order (the
//    longest first, as blocks are dispatched in linear order) and the dQ
//    grid runs its row tiles last first (the most keys first).
//  * Registers: 8 warps a block, one block a SM, so each thread may use 255
//    (dK/dV takes 250 at dh 64, dQ 187).  A ninth, producer warp makes
//    ptxas budget 168 a thread (a SM quarter's 16384 over its 3 warps), and
//    setmaxnreg (a producer warpgroup at 24 or 40, consumers at 232 or 240)
//    did not lift the consumers' compiled budget above 168: both spilled.
//    Register A fragments of K and V for S^T and dP^T were tried too: no
//    faster, and wrong dK and dV from builds in which the same source with
//    one more branch was right, so the S and dP products read both
//    operands from shared memory; only P and dS, made in registers just
//    before, feed wgmma from registers.  A warp-uniform warpgroup index
//    (a shuffle from lane 0) keeps ptxas from serializing wgmma behind
//    branches it would take for divergent.  An mbarrier wait that never
//    completes traps instead of hanging.
//  * Roundings as the "mma" kernels (and the plain version): dP to bf16
//    before delta is subtracted, P and dS to bf16 as operands, dQ to bf16
//    before and after 1/sqrt(dh).
// The mbarrier, TMA and wgmma helpers live in hopper.cuh, shared with the
// head-dim-256 route (flash_attention_bwd_wgmma256.cu).
#include "hopper.cuh"

namespace {

using namespace hopper;
using fa::bf16;

constexpr int kRows = 64;                   // packed query rows a tile (a warpgroup's)
constexpr int kKeysKV = 128;                // keys a dK/dV block (64 a warpgroup)
constexpr int kThreads = 256;               // two warpgroups a block

using fa::allowed;
using fa::round_bf16;
using fa::rows_seeing;

// ---------------------------------------------------------------------------
// 2. dK, dV
// ---------------------------------------------------------------------------
// TR packed rows a row tile: 128 at dh 64, 64 at dh 128 (where S^T and dP^T
// of 128 rows would not fit beside dK and dV in registers).
template <int D, int STAGES, int TR>
struct KvSmem {
  static constexpr int KTILE = kKeysKV * D * 2;  // K (or V): 128 keys
  static constexpr int RTILE = TR * D * 2;       // a qs (or dO) row tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KTILE;
  static constexpr int Q_OFF = V_OFF + KTILE;
  static constexpr int DO_OFF = Q_OFF + STAGES * RTILE;
  static constexpr int ST_OFF = DO_OFF + STAGES * RTILE;  // float2 [STAGES][TR]
  static constexpr int BAR_OFF = ST_OFF + STAGES * TR * 8;  // full[STAGES], kv, done[STAGES]
  static constexpr int BYTES = BAR_OFF + (STAGES + 1) * 8 + STAGES * 4 + 1024;  // + alignment
  static constexpr uint32_t TILE_TX = 2 * RTILE + TR * 8;
};

// Per tile a warpgroup runs S^T and dP^T (two commit groups), makes P^T
// while dP^T is still on the tensor cores, issues dV += P^T dO, makes dS^T
// while that runs, then issues dK += dS^T qs.
template <int D, int STAGES, int TR>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qs,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_st, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int tq, int tk, int hkv, int g, int causal,
                            int window, int q_offset, int kv_len) {
  using L = KvSmem<D, STAGES, TR>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_bar = full + STAGES;
  // done[s]: warpgroups that have finished with stage s, counted up for
  // ever; the one that makes it even finished second and refills the stage.
  int* done = reinterpret_cast<int*>(kv_bar + 1);

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int gs = __ffs(g) - 1;  // g divides 64: a power of two, so / g is a shift
  const int k0 = blockIdx.y * kKeysKV;
  const int kend = min(k0 + kKeysKV, kv_len);
  int rlo, rhi;
  rows_seeing(k0, kend, tq, g, causal, window, q_offset, rlo, rhi);
  const int ntiles = (rhi - rlo + TR - 1) / TR;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every copy is issued by one thread: K and V and the first STAGES row
  // tiles by thread 0, then tile i + STAGES by the leader of whichever
  // warpgroup finishes tile i second, the moment its stage is free.
  auto issue_tile = [&](int i) {
    const int s = i % STAGES, row0 = rlo + i * TR;
    mbar_expect_tx(&full[s], L::TILE_TX);
#pragma unroll
    for (int hf = 0; hf < D / kHalf; ++hf) {
      tma_5d(smem + L::Q_OFF + s * L::RTILE + hf * TR * 128, &tm_qs, &full[s], hf * kHalf, 0,
             h, row0 >> gs, b);
      tma_5d(smem + L::DO_OFF + s * L::RTILE + hf * TR * 128, &tm_do, &full[s], hf * kHalf, 0,
             h, row0 >> gs, b);
    }
    tma_2d(smem + L::ST_OFF + s * TR * 8, &tm_st, &full[s], 2 * row0, b * hkv + h);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * L::KTILE);
#pragma unroll
    for (int hf = 0; hf < D / kHalf; ++hf) {
      tma_4d(smem + L::K_OFF + hf * kKeysKV * 128, &tm_k, kv_bar, hf * kHalf, h, k0, b);
      tma_4d(smem + L::V_OFF + hf * kKeysKV * 128, &tm_v, kv_bar, hf * kHalf, h, k0, b);
    }
    for (int i = 0; i < min(STAGES, ntiles); ++i) issue_tile(i);
  }
  // The warpgroup's index and the warp's in it, made warp-uniform for the
  // compiler by a shuffle from lane 0, so that it sees the warpgroup's
  // branches as uniform (it serializes wgmma behind a branch it takes for
  // divergent).
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  {
    const int wl = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32 % 4, 0);
    const int lane = threadIdx.x & 31;
    const int kw = k0 + wg * 64;  // the warpgroup's first key
    const bool live = kw < kend;
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    const unsigned char* Ks = smem + L::K_OFF;
    const unsigned char* Vs = smem + L::V_OFF;
    mbar_wait(kv_bar, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const int row0 = rlo + i * TR, nrows = min(TR, rhi - row0);
      const int pfirst = q_offset + (row0 >> gs), plast = q_offset + ((row0 + nrows - 1) >> gs);
      // Does the warpgroup see any pair of the tile, and does it see all?
      const bool sees = live && (!causal || plast >= kw) && (!window || pfirst - (kw + 63) < window);
      if (sees) {
        const bool all = nrows == TR && kw + 64 <= kv_len && (!causal || kw + 63 <= pfirst) &&
                         (!window || plast - kw < window);
        const unsigned char* Qt = smem + L::Q_OFF + s * L::RTILE;
        const unsigned char* Dt = smem + L::DO_OFF + s * L::RTILE;
        const float2* stat = reinterpret_cast<const float2*>(smem + L::ST_OFF + s * TR * 8);
        float st[TR / 2], dpt[TR / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<TR>(st, desc_k(Ks, kKeysKV, wg * 64, ks), desc_k(Qt, TR, 0, ks), ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<TR>(dpt, desc_k(Vs, kKeysKV, wg * 64, ks), desc_k(Dt, TR, 0, ks), ks > 0);
        wgmma_commit();
        wgmma_wait<1>();  // S^T
        fence_regs(st);
        // element 4 j + e: key 16 wl + lane / 4 (+ 8 for e >= 2) of the
        // warpgroup's 64, packed row 8 j + 2 (lane % 4) + (e & 1) of the
        // tile.  The mask is a select in a loop of its own, taken only by
        // tiles that need it: a branch an element kept the loop from
        // overlapping its exponentials (2.3k of the 5k cycles a tile took).
        if (all) {
#pragma unroll
          for (int j = 0; j < TR / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 8 * j + 2 * (lane & 3) + (e & 1);
              st[4 * j + e] =
                  fa::exp2_approx(fmaf(st[4 * j + e], fa::kLog2e, -stat[r].x));
            }
        } else {
          const int key0 = kw + 16 * wl + (lane >> 2);
#pragma unroll
          for (int j = 0; j < TR / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 8 * j + 2 * (lane & 3) + (e & 1);
              const float pv =
                  fa::exp2_approx(fmaf(st[4 * j + e], fa::kLog2e, -stat[r].x));
              const bool ok =
                  (r < nrows) & allowed(key0 + 8 * (e >> 1), q_offset + ((row0 + r) >> gs), causal,
                                            window, kv_len);
              st[4 * j + e] = ok ? pv : 0.f;
            }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(st, kk, a);
          wgmma_rs_mn<D>(acc_v, a, desc_mn(Dt, TR, kk));  // dV += P^T dO
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
        fence_regs(dpt);
        // dS^T; a masked pair (P 0) stays 0 whatever the padded rows' stats hold
#pragma unroll
        for (int j = 0; j < TR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e, r = 8 * j + 2 * (lane & 3) + (e & 1);
            const float pv = st[idx];
            dpt[idx] = pv == 0.f ? 0.f : pv * (round_bf16(dpt[idx]) - stat[r].y);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TR / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(dpt, kk, a);
          wgmma_rs_mn<D>(acc_k, a, desc_mn(Qt, TR, kk));  // dK += dS^T qs
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      // The warpgroup is done with stage s (its wgmma waited on, its stats
      // read): the later of the two refills it with tile i + STAGES.
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if ((threadIdx.x & 127) == 0 && (atomicAdd(&done[s], 1) & 1) && i + STAGES < ntiles) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_tile(i + STAGES);
      }
    }
    fence_regs(acc_k);
    fence_regs(acc_v);

    // This thread holds keys 16 wl + lane / 4 (+ 8) of the warpgroup's 64,
    // dims 8 jb + 2 (lane % 4) (+ 1).  Keys past kv_len (never seen) get 0.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = kw + 16 * wl + (lane >> 2) + 8 * half;
      if (j >= tk) continue;
      const int64_t off = ((static_cast<int64_t>(b) * tk + j) * hkv + h) * D + 2 * (lane & 3);
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jb) =
            __floats2bfloat162_rn(acc_k[4 * jb + 2 * half], acc_k[4 * jb + 2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jb) =
            __floats2bfloat162_rn(acc_v[4 * jb + 2 * half], acc_v[4 * jb + 2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------
// TK keys a K / V ring tile: 128 at dh 64, 64 at dh 128 (register room, as
// the dK/dV kernel's TR).
template <int D, int STAGES, int TK>
struct QSmem {
  static constexpr int QTILE = 2 * kRows * D * 2;  // 128 rows of qs (or dO)
  static constexpr int KTILE = TK * D * 2;         // a tile of K (or V)
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + QTILE;
  static constexpr int K_OFF = DO_OFF + QTILE;
  static constexpr int V_OFF = K_OFF + STAGES * KTILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KTILE;  // full[STAGES], q, done[STAGES]
  static constexpr int BYTES = BAR_OFF + (STAGES + 1) * 8 + STAGES * 4 + 1024;
};

// Per key tile a warpgroup runs S and dP (two commit groups), makes P while
// dP is still on the tensor cores, then dS, then dQ += dS K.
template <int D, int STAGES, int TK, int RB>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qs,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float2* __restrict__ rowstat, bf16* __restrict__ dq, int tq,
                          int hkv, int g, int rs_rows, int causal, int window, int q_offset,
                          int kv_len, float scale) {
  using L = QSmem<D, STAGES, TK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_bar = full + STAGES;
  int* done = reinterpret_cast<int*>(q_bar + 1);  // as the dK/dV kernel's

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int gs = __ffs(g) - 1;  // g divides 64: a power of two, so / g is a shift
  const int rows_total = tq * g;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;  // the most keys first
  const int nrows = min(2 * kRows, rows_total - row0);
  auto pos_of = [&](int r) { return q_offset + ((row0 + min(r, nrows - 1)) >> gs); };
  const int kbeg = fa::key_range(pos_of(0), causal, window, 0, kv_len).lo;
  const int kend = fa::key_range(pos_of(nrows - 1), causal, window, 0, kv_len).hi;
  const int t0 = kbeg / TK;
  const int ntiles = kend > kbeg ? (kend - 1) / TK - t0 + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every copy is issued by one thread, as in the dK/dV kernel: the block's
  // qs and dO rows and the first STAGES K / V tiles by thread 0, then tile
  // i + STAGES by the warpgroup that finishes tile i second.
  auto issue_tile = [&](int i) {
    const int s = i % STAGES;
    mbar_expect_tx(&full[s], 2 * L::KTILE);
#pragma unroll
    for (int hf = 0; hf < D / kHalf; ++hf) {
      tma_4d(smem + L::K_OFF + s * L::KTILE + hf * TK * 128, &tm_k, &full[s], hf * kHalf, h,
             (t0 + i) * TK, b);
      tma_4d(smem + L::V_OFF + s * L::KTILE + hf * TK * 128, &tm_v, &full[s], hf * kHalf, h,
             (t0 + i) * TK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, 2 * L::QTILE);
#pragma unroll
    for (int w = 0; w < 2 * kRows / RB; ++w)  // the maps' boxes hold RB rows
#pragma unroll
      for (int hf = 0; hf < D / kHalf; ++hf) {
        const int off = hf * 2 * kRows * 128 + w * RB * 128;
        tma_5d(smem + L::Q_OFF + off, &tm_qs, q_bar, hf * kHalf, 0, h, (row0 + w * RB) >> gs, b);
        tma_5d(smem + L::DO_OFF + off, &tm_do, q_bar, hf * kHalf, 0, h, (row0 + w * RB) >> gs,
               b);
      }
    for (int i = 0; i < min(STAGES, ntiles); ++i) issue_tile(i);
  }

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  {
    const int wl = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32 % 4, 0);
    const int lane = threadIdx.x & 31;
    const int wr0 = wg * kRows;                          // the warpgroup's rows in the block
    const int wn = max(0, min(kRows, nrows - wr0));      // of which exist
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
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const int kt0 = (t0 + i) * TK;
      if (wn > 0 && kt0 < wlast.hi && kt0 + TK > wfirst.lo) {
        const bool masked = !(kt0 >= wlast.lo && kt0 + TK <= wfirst.hi);
        const unsigned char* Kt = smem + L::K_OFF + s * L::KTILE;
        const unsigned char* Vt = smem + L::V_OFF + s * L::KTILE;
        float sc[TK / 2], dp[TK / 2];
        wgmma_fence();
        // Qw / Dw: the warpgroup's 64 rows of 128-row tiles (halves 128 rows apart)
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)  // S = qs K^T
          wgmma_ss<TK>(sc, desc_k(Qw, 2 * kRows, wr0, ks), desc_k(Kt, TK, 0, ks), ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)  // dP = dO V^T
          wgmma_ss<TK>(dp, desc_k(Dw, 2 * kRows, wr0, ks), desc_k(Vt, TK, 0, ks), ks > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        // element 4 j + e: row 16 wl + lane / 4 (+ 8 for e >= 2) of the
        // warpgroup's 64, key kt0 + 8 j + 2 (lane % 4) + (e & 1)
        if (masked) {
#pragma unroll
          for (int j = 0; j < TK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int half = e >> 1;
              const float pv = fa::exp2_approx(fmaf(sc[4 * j + e], fa::kLog2e, -lse2[half]));
              const int key = kt0 + 8 * j + 2 * (lane & 3) + (e & 1);
              sc[4 * j + e] = (key < kr[half].lo) | (key >= kr[half].hi) ? 0.f : pv;
            }
        } else {
#pragma unroll
          for (int j = 0; j < TK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = fa::exp2_approx(fmaf(sc[4 * j + e], fa::kLog2e, -lse2[e >> 1]));
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * j + e;
            const float pv = sc[idx];
            dp[idx] = pv == 0.f ? 0.f : pv * (round_bf16(dp[idx]) - delta[e >> 1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(dp, kk, a);
          wgmma_rs_mn<D>(acc, a, desc_mn(Kt, TK, kk));  // dQs += dS K
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if ((threadIdx.x & 127) == 0 && (atomicAdd(&done[s], 1) & 1) && i + STAGES < ntiles) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_tile(i + STAGES);
      }
    }
    fence_regs(acc);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr0 + 16 * wl + (lane >> 2) + 8 * half;
      if (r >= nrows) continue;
      const int gr = row0 + r, pos = gr >> gs, head = gr & (g - 1);
      bf16* dst = dq + ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * D +
                  static_cast<int64_t>(head) * D + 2 * (lane & 3);
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jb) =
            __floats2bfloat162_rn(round_bf16(acc[4 * jb + 2 * half]) * scale,
                                  round_bf16(acc[4 * jb + 2 * half + 1]) * scale);
    }
  }
}

template <int D, int STAGES_KV, int TR, int STAGES_Q, int TK>
int launch_wgmma(const void* qs, const void* k, const void* v, const void* dO,
                 const void* rowstat, void* dq, void* dk, void* dv, int b, int tq, int tk,
                 int hkv, int g, int rs_rows, int causal, int window, int q_offset, int kv_len,
                 float scale, cudaStream_t stream) {
  using LK = KvSmem<D, STAGES_KV, TR>;
  using LQ = QSmem<D, STAGES_Q, TK>;
  const int qtiles = (tq * g + 2 * kRows - 1) / (2 * kRows);
  const int ktiles = (tk + kKeysKV - 1) / kKeysKV;
  if (qtiles > 65535 || ktiles > 65535 || kRows % g || rs_rows % 2)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  static unsigned done_kv = 0, done_q = 0;
  cudaError_t e = fa::smem_opt_in(flash_bwd_dkdv_wgmma_kernel<D, STAGES_KV, TR>, LK::BYTES, done_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fa::smem_opt_in(flash_bwd_dq_wgmma_kernel<D, STAGES_Q, TK, TR>, LQ::BYTES, done_q);
  if (e != cudaSuccess) return static_cast<int>(e);

  // One map a tensor where the two kernels' boxes agree (all but K and V
  // at dh 128): each encode is a driver call on the host.
  CUtensorMap tm_qs, tm_do, tm_k, tm_v, tm_kq, tm_vq, tm_st;
  int err = map_rows(&tm_qs, qs, b, tq, hkv, g, D, TR);
  if (!err) err = map_rows(&tm_do, dO, b, tq, hkv, g, D, TR);
  if (!err) err = map_keys(&tm_k, k, b, tk, hkv, D, kKeysKV);
  if (!err) err = map_keys(&tm_v, v, b, tk, hkv, D, kKeysKV);
  if (TK != kKeysKV) {
    if (!err) err = map_keys(&tm_kq, k, b, tk, hkv, D, TK);
    if (!err) err = map_keys(&tm_vq, v, b, tk, hkv, D, TK);
  }
  if (!err) err = map_rowstat(&tm_st, rowstat, b * hkv, rs_rows, TR);  // TR pairs a box
  if (err) return err;

  flash_bwd_dkdv_wgmma_kernel<D, STAGES_KV, TR><<<dim3(b * hkv, ktiles), kThreads, LK::BYTES,
                                             stream>>>(
      tm_qs, tm_do, tm_k, tm_v, tm_st, static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk,
      hkv, g, causal, window, q_offset, kv_len);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_wgmma_kernel<D, STAGES_Q, TK, TR><<<dim3(b * hkv, qtiles), kThreads, LQ::BYTES,
                                              stream>>>(
      tm_qs, tm_do, TK != kKeysKV ? tm_kq : tm_k, TK != kKeysKV ? tm_vq : tm_v,
      static_cast<const float2*>(rowstat), static_cast<bf16*>(dq),
      tq, hkv, g, rs_rows, causal, window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qs (q scaled and rounded), dO, dq [b, tq, hkv, g, dh]; k, v, dk, dv
// [b, tk, hkv, dh]; rowstat fp32 [b, hkv, rs_rows, 2] as
// flash_bwd_delta_launch wrote them (rs_rows even); bf16, contiguous,
// 16-byte aligned.  dh 64 or 128, g dividing 64.  kv_len = min(tk,
// kv_valid_len).  The caller checks shapes, types and that every query row
// sees a key.
extern "C" int flash_bwd_wgmma_launch(const void* qs, const void* k, const void* v,
                                      const void* dO, const void* rowstat, void* dq, void* dk,
                                      void* dv, int b, int tq, int tk, int hkv, int g, int dh,
                                      int rs_rows, int causal, int window, int q_offset,
                                      int kv_len, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch_wgmma<64, 3, 128, 3, 128>(qs, k, v, dO, rowstat, dq, dk, dv, b, tq, tk, hkv, g, rs_rows,
                                    causal, window, q_offset, kv_len, scale, s);
    case 128:
      return launch_wgmma<128, 2, 64, 2, 64>(qs, k, v, dO, rowstat, dq, dk, dv, b, tq, tk, hkv, g,
                                     rs_rows, causal, window, q_offset, kv_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
