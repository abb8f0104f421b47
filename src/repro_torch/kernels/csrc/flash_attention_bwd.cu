// Flash-attention backward (FlashAttention-2) for Hopper (sm_90a), GQA,
// causal / local window / q_offset / kv_valid_len, as the forward masks.
//
// It is the gradient of the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:86 (`flash_attention`),
// which has no backward of its own, and on the model path the vjp of the
// jnp function src/repro/models/layers.py `attention` (the reference's
// training path differentiates that through XLA).  Inputs: q, k, v, the
// forward's output o and its rows' log-sum-exp lse (fp32 [b, hkv, g, tq],
// written by flash_attention_mma.cu / flash_attention.cu), and dO.
// With qs = q / sqrt(dh) rounded to q's type (as the forward),
// P = exp(qs k^T - lse) (0 where masked), delta = rowsum(dO o):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
//   dK = dS^T qs, dQ = (dS K) / sqrt(dh).
// Routes (kernel.py `bwd_route`): bf16 at head dim 64 or 128 with a group
// size dividing 64 -- llama's train path -- takes
// flash_attention_bwd_wgmma.cu after this file's delta launch, and bf16 at
// head dim 256 with one KV head or such a group -- recurrentgemma's train
// path -- flash_attention_bwd_wgmma256.cu; the other dh-256 shapes take the
// "mma" kernels here with their output columns split over blocks (below),
// the other bf16 shapes the "mma" kernels whole, fp32 the "fma" ones.
// Three launches, no atomics, bitwise repeatable:
//  1. delta, one warp a row (bf16: dh / 8 lanes a row, 16-byte accesses);
//     for bf16 also qs (q scaled and rounded once) and each packed row's
//     (lse, delta) side by side, so launch 2 stages a tile with nothing but
//     asynchronous copies;
//  2. dK and dV: one block a (batch, KV head, 64-key tile); it loops over
//     the packed (position, group head) query rows that its keys can see
//     under the masks, 64 at a time, so the sum over the g heads of the
//     group stays inside the block; the next tile's qs, dO and stats are
//     in flight (a 2-stage cp.async ring) while this one's products run;
//  3. dQ: one block a (batch, KV head, 64 packed query rows), over the
//     key tiles those rows see (the forward's grid and skips).
//
// Bound on this card: operations.  10 * dh flops an allowed (query, key)
// pair and head (S recomputed, dP, dV, dK, dQ; dQ's kernel recomputes S
// and dP once more, which the bound does not count) against 989 TFLOP/s
// bf16: at the llama train shape (b 4, T 2048, 32 heads of 64, causal)
// 1.72e11 flops, 0.174 ms; at recurrentgemma's (b 2, T 2048, hkv 1, g 10,
// dh 256, causal, window 2048) 1.07e11 flops, 0.109 ms.
//
// bf16 ("mma" kernels): every product on the tensor cores with the
// forward's pieces (flash_mma.cuh: mma.sync m16n8k16, ldmatrix, cp.async).
// In the dK/dV kernel each warp owns 16 keys and computes S^T and dP^T as
// [16 keys x 64 rows] tiles (K or V rows as the A operand, Q or dO rows as
// B), so P^T and dS^T come out in the accumulator layout that is the A
// operand of dV += P^T dO and dK += dS^T qs.  The dQ kernel is the
// forward's loop with dP = dO V^T beside S and dQ += dS K in place of
// O += P V.  Roundings, chosen to follow the reference's autodiff: dP to
// bf16 (the cotangent of its bf16 probabilities), P and dS to bf16 as the
// tensor cores' operands, dQ to bf16 before and after the 1/sqrt(dh).
// Head dims 16 to 128 whole: each warp's dK and dV (or dQ) rows live in
// registers.  Head dim 256: 256 columns of both would not fit,
// so a block owns DW = 128 of them (grid dim z picks the half); it still
// stages q, k, v and dO rows whole in shared memory (about 200 KB, one
// block a SM) and computes S and dP over all 256 dims, so S and dP are
// computed once for each half: 1.5x the products of one pass.
// fp32 ("fma" kernels): the same three launches on CUDA cores in fp32, all
// head dims of the forward, a key (dK/dV) or a query row (dQ) split over
// dh / 32 lanes as the forward's fma kernel splits a row.
// The ring keeps the dK/dV kernel from waiting on synchronous per-tile
// loads (PERF.md).
#include "flash_mma.cuh"

namespace {

using fa::bf16;

// 8-byte async copy; `valid` false zero-fills the destination.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(fa::smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

using fa::allowed;
using fa::round_bf16;
using fa::rows_seeing;

__device__ __forceinline__ int64_t stat_index(int b, int h, int hkv, int g, int tq, int gr) {
  return ((static_cast<int64_t>(b) * hkv + h) * g + gr % g) * tq + gr / g;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), fp32 [b, hkv, g, tq].
//    fp32 (the "fma" route): one warp a packed row, delta alone.
// ---------------------------------------------------------------------------
__global__ void flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                                       float* __restrict__ delta, int rows, int tq, int hkv,
                                       int g, int dh) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t base = static_cast<int64_t>(row) * dh;
  float s = 0.f;
  for (int i = lane; i < dh; i += 32) s += o[base + i] * dO[base + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  // row = ((b * tq + pos) * hkv + h) * g + head
  const int head = row % g, h = (row / g) % hkv, pos = (row / (g * hkv)) % tq,
            b = row / (g * hkv * tq);
  if (lane == 0) delta[((static_cast<int64_t>(b) * hkv + h) * g + head) * tq + pos] = s;
}

//    bf16 (the "mma" and "wgmma" routes): LPR = dh / 8 lanes a row, 16-byte
//    loads and stores, 32 / LPR rows a warp; also qs = bf16(q * scale) in
//    q's layout and rowstat[b, hkv, rs_rows] = (lse log2(e), delta) in
//    packed-row order (rs_rows >= tq * g: the wgmma routes pad it to even so
//    its TMA stride is 16 bytes); lse comes pre-scaled for the kernels'
//    exp2.
template <int LPR>
__global__ void flash_bwd_delta_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ o,
                                            const bf16* __restrict__ dO,
                                            const float* __restrict__ lse,
                                            float* __restrict__ delta, bf16* __restrict__ qs,
                                            float2* __restrict__ rowstat, int rows, int tq,
                                            int hkv, int g, int rs_rows, float scale) {
  const int lane = threadIdx.x & 31, part = lane % LPR;
  const int row = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (32 / LPR) + lane / LPR;
  const bool valid = row < rows;  // the same for a row's LPR lanes: the shuffles stay in it
  const int64_t off = (static_cast<int64_t>(valid ? row : 0) * LPR + part) * 8;
  float s = 0.f;
  uint4 qv = make_uint4(0, 0, 0, 0);
  if (valid) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    const uint4 dv = *reinterpret_cast<const uint4*>(dO + off);
    qv = *reinterpret_cast<const uint4*>(q + off);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(oe[i]) * __bfloat162float(de[i]);
  }
#pragma unroll
  for (int o2 = LPR / 2; o2 > 0; o2 >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o2);
  if (!valid) return;
  bf16* qe = reinterpret_cast<bf16*>(&qv);
#pragma unroll
  for (int i = 0; i < 8; ++i) qe[i] = __float2bfloat16(__bfloat162float(qe[i]) * scale);
  *reinterpret_cast<uint4*>(qs + off) = qv;
  if (part != 0) return;
  // row = ((b * tq + pos) * hkv + h) * g + head
  const int head = row % g, h = (row / g) % hkv, pos = (row / (g * hkv)) % tq,
            b = row / (g * hkv * tq);
  const int64_t stat = ((static_cast<int64_t>(b) * hkv + h) * g + head) * tq + pos;
  delta[stat] = s;
  rowstat[(static_cast<int64_t>(b) * hkv + h) * rs_rows + pos * g + head] =
      make_float2(lse[stat] * fa::kLog2e, s);
}

template <int LPR>
int launch_delta_bf16(const void* q, const void* o, const void* dO, const float* lse,
                      float* delta, void* qs, float2* rowstat, int rows, int tq, int hkv, int g,
                      int rs_rows, float scale, cudaStream_t s) {
  constexpr int kRowsPerBlock = 4 * (32 / LPR);  // 4 warps
  flash_bwd_delta_bf16_kernel<LPR><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 128, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
      lse, delta, static_cast<bf16*>(qs), rowstat, rows, tq, hkv, g, rs_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------
constexpr int kBM = 64;  // packed query rows a tile
constexpr int kBC = 64;  // keys a tile

template <int DH>
struct BwdCfg {
  static constexpr int LDS = DH + 8;
  // output columns a block owns (dK and dV, or dQ), and the blocks a tile
  static constexpr int DW = DH > 128 ? 128 : DH;
  static constexpr int NCOL = DH / DW;
  // dK/dV kernel: K, V tiles + a 2-stage ring of (qs, dO) tiles and their
  // rows' (lse, delta)
  static constexpr int RING = 2;
  static constexpr int KV_SMEM = (2 * kBC + RING * 2 * kBM) * LDS * 2 + RING * kBM * 8;
  // dQ kernel: Qs, dO tiles + a 2-stage ring of K/V tiles
  static constexpr int STAGES = 2;
  static constexpr int Q_SMEM = (2 * kBM + 2 * STAGES * kBC) * LDS * 2;
};

// S^T-like product for one warp: c[16 rows of A][64 rows of B] over DH,
// A rows at A (16 of them), B rows at Bm (64 of them), both [.][LDS] bf16.
template <int DH>
__device__ __forceinline__ void mma_rows_x_rows(const bf16* A, const bf16* Bm,
                                                float (&c)[kBM / 8][4]) {
  constexpr int LDS = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kBM / 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    fa::ldsm_x4(a, A + (lane & 15) * LDS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < kBM / 16; ++nb) {
      uint32_t bk[4];
      fa::ldsm_x4(bk, Bm + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      fa::mma16816(c[2 * nb], a, bk[0], bk[1]);
      fa::mma16816(c[2 * nb + 1], a, bk[2], bk[3]);
    }
  }
}

// acc[16 x DW] += P (the accumulator-layout [16 x 64] tile p, as bf16) times
// columns [0, DW) of the 64 rows of Bm [64][DH + 8] (ldmatrix.trans: Bm's
// rows are the k index; Bm may point at a column offset).
template <int DH, int DW>
__device__ __forceinline__ void mma_acc_p_rows(const float (&p)[kBM / 8][4], const bf16* Bm,
                                               float (&acc)[DW / 8][4]) {
  constexpr int LDS = DH + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kBM / 16; ++kk) {
    const uint32_t pa[4] = {fa::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            fa::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            fa::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            fa::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int db = 0; db < DW / 16; ++db) {
      uint32_t vb[4];
      fa::ldsm_x4_t(vb, Bm + (kk * 16 + (lane & 15)) * LDS + db * 16 + (lane >> 4) * 8);
      fa::mma16816(acc[2 * db], pa, vb[0], vb[1]);
      fa::mma16816(acc[2 * db + 1], pa, vb[2], vb[3]);
    }
  }
}

// Issue the async copies of packed rows [row0, row0 + nrows) of (b, h): qs
// and dO rows into Qs / Ds ([64][LDS]) and their (lse, delta) into St;
// rows from nrows on are zero-filled.
template <int DH>
__device__ __forceinline__ void load_row_tile(bf16* Qs, bf16* Ds, float2* St,
                                              const bf16* __restrict__ qs,
                                              const bf16* __restrict__ dO,
                                              const float2* __restrict__ rowstat, int b, int h,
                                              int tq, int hkv, int g, int row0, int nrows) {
  constexpr int LDS = DH + 8, VPR = DH / 8;
  for (int idx = threadIdx.x; idx < kBM * VPR; idx += fa::kThreads) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const int gr = row0 + min(r, nrows - 1);  // an address inside the tensor
    const int64_t off = ((static_cast<int64_t>(b) * tq + gr / g) * hkv + h) * g * DH +
                        static_cast<int64_t>(gr % g) * DH + c;
    fa::cp_async16(Qs + r * LDS + c, qs + off, r < nrows);
    fa::cp_async16(Ds + r * LDS + c, dO + off, r < nrows);
  }
  for (int r = threadIdx.x; r < kBM; r += fa::kThreads)
    cp_async8(St + r,
              rowstat + (static_cast<int64_t>(b) * hkv + h) * tq * g + row0 + min(r, nrows - 1),
              r < nrows);
}

// 2. dK, dV.  Block (b * hkv, key tile, column block); warp w owns keys
// k0 + 16w ..., columns [d0, d0 + DW).
template <int DH>
__global__ void __launch_bounds__(fa::kThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dO,
                          const float2* __restrict__ rowstat, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int tq, int tk, int hkv, int g, int causal,
                          int window, int q_offset, int kv_len) {
  using C = BwdCfg<DH>;
  constexpr int LDS = C::LDS, RING = C::RING, DW = C::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBC * LDS;
  bf16* Qring = Vs + kBC * LDS;                 // RING x [qs tile, dO tile]
  float2* Sring = reinterpret_cast<float2*>(Qring + RING * 2 * kBM * LDS);

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int k0 = blockIdx.y * kBC;
  const int kend = min(k0 + kBC, kv_len);
  const int d0 = blockIdx.z * DW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;

  fa::load_kv_tile<DH, kBC>(Ks, Vs, k, v, b, h, tk, hkv, k0, kend);
  fa::cp_async_commit();

  float acc_k[DW / 8][4], acc_v[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  int rlo, rhi;
  rows_seeing(k0, kend, tq, g, causal, window, q_offset, rlo, rhi);
  const int ntiles = (rhi - rlo + kBM - 1) / kBM;
  auto issue = [&](int i) {
    const int row0 = rlo + i * kBM, st = i % RING;
    load_row_tile<DH>(Qring + st * 2 * kBM * LDS, Qring + (st * 2 + 1) * kBM * LDS,
                      Sring + st * kBM, qs, dO, rowstat, b, h, tq, hkv, g, row0,
                      min(kBM, rhi - row0));
  };
  if (ntiles > 0) issue(0);
  fa::cp_async_commit();

  const int kw = k0 + warp * 16;  // this warp's first key
  const bool warp_live = kw < kend;
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) issue(i + 1);  // into the stage tile i - 1 used
    fa::cp_async_commit();
    fa::cp_async_wait<1>();            // K / V and tile i have landed
    __syncthreads();
    const int row0 = rlo + i * kBM, nrows = min(kBM, rhi - row0), st = i % RING;
    const bf16* Qs = Qring + st * 2 * kBM * LDS;
    const bf16* Ds = Qs + kBM * LDS;
    const float2* stat = Sring + st * kBM;
    if (warp_live) {
      // Does every (row, key) pair of this warp's 16 keys and the tile's
      // rows pass the masks?  The first row sees the fewest keys below, the
      // last the fewest above.
      const int pfirst = q_offset + row0 / g, plast = q_offset + (row0 + nrows - 1) / g;
      const bool full = nrows == kBM && kw + 16 <= kv_len &&
                        (!causal || kw + 15 <= pfirst) && (!window || plast - kw < window);

      float p[kBM / 8][4], ds[kBM / 8][4];
      mma_rows_x_rows<DH>(Ks + warp * 16 * LDS, Qs, p);   // S^T
      mma_rows_x_rows<DH>(Vs + warp * 16 * LDS, Ds, ds);  // dP^T
#pragma unroll
      for (int nb = 0; nb < kBM / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = nb * 8 + tig * 2 + (e & 1);          // query row in the tile
          const int j = kw + (lane >> 2) + 8 * (e >> 1);      // key
          const float2 lse_delta = stat[r];
          float pv = fa::exp2_approx(fmaf(p[nb][e], fa::kLog2e, -lse_delta.x));
          if (!full && (r >= nrows ||
                        !allowed(j, q_offset + (row0 + r) / g, causal, window, kv_len)))
            pv = 0.f;
          p[nb][e] = pv;
          ds[nb][e] = pv * (round_bf16(ds[nb][e]) - lse_delta.y);
        }
      mma_acc_p_rows<DH, DW>(p, Ds + d0, acc_v);   // dV += P^T dO
      mma_acc_p_rows<DH, DW>(ds, Qs + d0, acc_k);  // dK += dS^T qs
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  fa::cp_async_wait<0>();

  // This thread holds keys lane/4 and lane/4 + 8 of the warp's 16, two
  // adjacent dims of each 8-wide block.  Keys past kv_len (never seen) get 0.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = kw + (lane >> 2) + 8 * half;
    if (j >= tk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * tk + j) * hkv + h) * DH + d0 + tig * 2;
#pragma unroll
    for (int db = 0; db < DW / 8; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + db * 8) =
          __floats2bfloat162_rn(acc_k[db][2 * half], acc_k[db][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + db * 8) =
          __floats2bfloat162_rn(acc_v[db][2 * half], acc_v[db][2 * half + 1]);
    }
  }
}

// 3. dQ.  Block (b * hkv, packed row tile, most keys first, column block);
// warp w owns rows 16w ... of the tile, columns [d0, d0 + DW).
template <int DH>
__global__ void __launch_bounds__(fa::kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int tq, int tk, int hkv, int g, int causal,
                        int window, int q_offset, int kv_len, float scale) {
  using C = BwdCfg<DH>;
  constexpr int LDS = C::LDS, STAGES = C::STAGES, DW = C::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + kBM * LDS;
  bf16* Ks = Ds + kBM * LDS;
  bf16* Vs = Ks + STAGES * kBC * LDS;

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int tile = gridDim.y - 1 - blockIdx.y;
  const int rows_total = tq * g;
  const int row0 = tile * kBM;
  const int nrows = min(kBM, rows_total - row0);
  const int d0 = blockIdx.z * DW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;

  fa::stage_q<DH>(Qs, q, b, h, tq, hkv, g, row0, nrows, kBM, scale);
  fa::stage_q<DH>(Ds, dO, b, h, tq, hkv, g, row0, nrows, kBM, 1.f);

  auto pos_of = [&](int r) { return q_offset + (row0 + min(r, nrows - 1)) / g; };
  const fa::KeyRange first = fa::key_range(pos_of(0), causal, window, 0, kv_len);
  const fa::KeyRange last = fa::key_range(pos_of(nrows - 1), causal, window, 0, kv_len);
  const int kbeg = first.lo, kend = last.hi;
  const int t0 = kbeg / kBC;
  const int ntiles = kend > kbeg ? (kend - 1) / kBC - t0 + 1 : 0;

  const int wr = warp * 16;
  const bool warp_live = wr < nrows;
  const fa::KeyRange wfirst = fa::key_range(pos_of(wr), causal, window, 0, kv_len);
  const fa::KeyRange wlast = fa::key_range(pos_of(wr + 15), causal, window, 0, kv_len);
  const fa::KeyRange kr[2] = {
      fa::key_range(pos_of(wr + (lane >> 2)), causal, window, 0, kv_len),
      fa::key_range(pos_of(wr + (lane >> 2) + 8), causal, window, 0, kv_len)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + (lane >> 2) + 8 * half;
    const bool ok = r < nrows;
    lse_r[half] = ok ? lse[stat_index(b, h, hkv, g, tq, row0 + r)] * fa::kLog2e : 0.f;
    delta_r[half] = ok ? delta[stat_index(b, h, hkv, g, tq, row0 + r)] : 0.f;
  }

  float acc[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles)
      fa::load_kv_tile<DH, kBC>(Ks + i * kBC * LDS, Vs + i * kBC * LDS, k, v, b, h, tk, hkv,
                                (t0 + i) * kBC, kend);
    fa::cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < ntiles) {
      const int st = nx % STAGES;
      fa::load_kv_tile<DH, kBC>(Ks + st * kBC * LDS, Vs + st * kBC * LDS, k, v, b, h, tk, hkv,
                                (t0 + nx) * kBC, kend);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int kt0 = (t0 + i) * kBC;
    if (warp_live && kt0 < wlast.hi && kt0 + kBC > wfirst.lo) {
      const bool masked = !(kt0 >= wlast.lo && kt0 + kBC <= wfirst.hi);
      const int st = i % STAGES;
      const bf16* Kt = Ks + st * kBC * LDS;
      const bf16* Vt = Vs + st * kBC * LDS;
      float p[kBC / 8][4], ds[kBC / 8][4];
      mma_rows_x_rows<DH>(Qs + wr * LDS, Kt, p);   // S
      mma_rows_x_rows<DH>(Ds + wr * LDS, Vt, ds);  // dP
#pragma unroll
      for (int nb = 0; nb < kBC / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          float pv = fa::exp2_approx(fmaf(p[nb][e], fa::kLog2e, -lse_r[half]));
          if (masked) {
            const int j = kt0 + nb * 8 + tig * 2 + (e & 1);
            if (j < kr[half].lo || j >= kr[half].hi) pv = 0.f;
          }
          ds[nb][e] = pv * (round_bf16(ds[nb][e]) - delta_r[half]);
        }
      mma_acc_p_rows<DH, DW>(ds, Kt + d0, acc);  // dQs += dS K
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + (lane >> 2) + 8 * half;
    if (r >= nrows) continue;
    const int gr = row0 + r, pos = gr / g, head = gr % g;
    bf16* dst = dq + ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * DH +
                static_cast<int64_t>(head) * DH + d0 + tig * 2;
#pragma unroll
    for (int db = 0; db < DW / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) = __floats2bfloat162_rn(
          round_bf16(acc[db][2 * half]) * scale, round_bf16(acc[db][2 * half + 1]) * scale);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dO, const float* lse,
               const float* delta, const void* qs, const void* rowstat, void* dq, void* dk,
               void* dv, int b, int tq, int tk, int hkv, int g, int causal, int window,
               int q_offset, int kv_len, float scale, cudaStream_t stream) {
  using C = BwdCfg<DH>;
  const int qtiles = (tq * g + kBM - 1) / kBM, ktiles = (tk + kBC - 1) / kBC;
  if (qtiles > 65535 || ktiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  static unsigned done_kv = 0, done_q = 0;
  if constexpr (C::KV_SMEM > 48 * 1024) {
    const cudaError_t e = fa::smem_opt_in(flash_bwd_dkdv_mma_kernel<DH>, C::KV_SMEM, done_kv);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if constexpr (C::Q_SMEM > 48 * 1024) {
    const cudaError_t e = fa::smem_opt_in(flash_bwd_dq_mma_kernel<DH>, C::Q_SMEM, done_q);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dO);
  flash_bwd_dkdv_mma_kernel<DH><<<dim3(b * hkv, ktiles, C::NCOL), fa::kThreads, C::KV_SMEM,
                                  stream>>>(
      static_cast<const bf16*>(qs), kb, vb, db, static_cast<const float2*>(rowstat),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, hkv, g, causal, window, q_offset,
      kv_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_mma_kernel<DH><<<dim3(b * hkv, qtiles, C::NCOL), fa::kThreads, C::Q_SMEM,
                                stream>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), tq, tk, hkv, g, causal, window,
      q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32, CUDA cores
// ---------------------------------------------------------------------------
template <int DH>
struct FmaCfg {
  static constexpr int TPR = DH >= 64 ? DH / 32 : 1;  // lanes a key or a query row
  static constexpr int DPT = DH / TPR;                // dims a lane
  static constexpr int SLOTS = fa::kThreads / TPR;    // keys (dK/dV) or rows (dQ) a block
  static constexpr int TILE = 2048 / DH;              // rows or keys staged a step
  static constexpr int LD = DH + 1;
};

template <int TPR>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// 2. dK, dV: block (b * hkv, key tile of SLOTS keys).
template <int DH>
__global__ void __launch_bounds__(fa::kThreads)
flash_bwd_dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int tq, int tk,
                          int hkv, int g, int causal, int window, int q_offset, int kv_len,
                          float scale) {
  using C = FmaCfg<DH>;
  constexpr int TPR = C::TPR, DPT = C::DPT, TILE = C::TILE, LD = C::LD;
  __shared__ float Qs[TILE * LD], Ds[TILE * LD], stat[2 * TILE];
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int k0 = blockIdx.y * C::SLOTS;
  const int kend = min(k0 + C::SLOTS, kv_len);
  const int slot = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int j = k0 + slot;
  const bool live = j < kend;
  const int64_t kv_off = ((static_cast<int64_t>(b) * tk + min(j, tk - 1)) * hkv + h) * DH;
  float kr[DPT], vr[DPT], ak[DPT], av[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = live ? k[kv_off + i * TPR + part] : 0.f;
    vr[i] = live ? v[kv_off + i * TPR + part] : 0.f;
    ak[i] = av[i] = 0.f;
  }
  int rlo, rhi;
  rows_seeing(k0, kend, tq, g, causal, window, q_offset, rlo, rhi);
  for (int row0 = rlo; row0 < rhi; row0 += TILE) {
    const int nrows = min(TILE, rhi - row0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nrows * DH; idx += fa::kThreads) {
      const int r = idx / DH, c = idx % DH, gr = row0 + r;
      const int64_t off = ((static_cast<int64_t>(b) * tq + gr / g) * hkv + h) * g * DH +
                          static_cast<int64_t>(gr % g) * DH + c;
      Qs[r * LD + c] = q[off] * scale;
      Ds[r * LD + c] = dO[off];
    }
    for (int r = threadIdx.x; r < nrows; r += fa::kThreads) {
      stat[r] = lse[stat_index(b, h, hkv, g, tq, row0 + r)];
      stat[TILE + r] = delta[stat_index(b, h, hkv, g, tq, row0 + r)];
    }
    __syncthreads();
    for (int r = 0; r < nrows; ++r) {
      const float* qr = Qs + r * LD;
      const float* dr = Ds + r * LD;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s += qr[i * TPR + part] * kr[i];
        dp += dr[i * TPR + part] * vr[i];
      }
      s = group_sum<TPR>(s);
      dp = group_sum<TPR>(dp);
      const int pos = q_offset + (row0 + r) / g;
      if (live && allowed(j, pos, causal, window, kv_len)) {
        const float p = expf(s - stat[r]);
        const float ds = p * (dp - stat[TILE + r]);
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          av[i] += p * dr[i * TPR + part];
          ak[i] += ds * qr[i * TPR + part];
        }
      }
    }
  }
  if (j < tk) {
    const int64_t off = ((static_cast<int64_t>(b) * tk + j) * hkv + h) * DH;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[off + i * TPR + part] = ak[i];
      dv[off + i * TPR + part] = av[i];
    }
  }
}

// 3. dQ: block (b * hkv, SLOTS packed rows).
template <int DH>
__global__ void __launch_bounds__(fa::kThreads)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int tq, int tk, int hkv, int g, int causal,
                        int window, int q_offset, int kv_len, float scale) {
  using C = FmaCfg<DH>;
  constexpr int TPR = C::TPR, DPT = C::DPT, TILE = C::TILE, LD = C::LD;
  __shared__ float Ks[TILE * LD], Vs[TILE * LD];
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int row0 = blockIdx.y * C::SLOTS;
  const int rows_total = tq * g;
  const int slot = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int gr = row0 + slot;
  const bool live = gr < rows_total;
  const int grc = min(gr, rows_total - 1);
  const int pos = q_offset + grc / g;
  const int64_t q_off = ((static_cast<int64_t>(b) * tq + grc / g) * hkv + h) * g * DH +
                        static_cast<int64_t>(grc % g) * DH;
  float qr[DPT], dr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = q[q_off + i * TPR + part] * scale;
    dr[i] = dO[q_off + i * TPR + part];
    acc[i] = 0.f;
  }
  const float lse_r = lse[stat_index(b, h, hkv, g, tq, grc)];
  const float delta_r = delta[stat_index(b, h, hkv, g, tq, grc)];
  // keys the block's rows see at all
  const int last = min(row0 + C::SLOTS, rows_total) - 1;
  const int plo = q_offset + row0 / g, phi = q_offset + last / g;
  const int kbeg = window ? max(0, plo - window + 1) : 0;
  const int kend = causal ? min(kv_len, phi + 1) : kv_len;
  for (int t0 = kbeg; t0 < kend; t0 += TILE) {
    const int nk = min(TILE, kend - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * DH; idx += fa::kThreads) {
      const int jj = idx / DH, c = idx % DH;
      const int64_t off = ((static_cast<int64_t>(b) * tk + t0 + jj) * hkv + h) * DH + c;
      Ks[jj * LD + c] = k[off];
      Vs[jj * LD + c] = v[off];
    }
    __syncthreads();
    for (int jj = 0; jj < nk; ++jj) {
      const float* kk = Ks + jj * LD;
      const float* vv = Vs + jj * LD;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        s += qr[i] * kk[i * TPR + part];
        dp += dr[i] * vv[i * TPR + part];
      }
      s = group_sum<TPR>(s);
      dp = group_sum<TPR>(dp);
      if (live && allowed(t0 + jj, pos, causal, window, kv_len)) {
        const float ds = expf(s - lse_r) * (dp - delta_r);
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += ds * kk[i * TPR + part];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq[q_off + i * TPR + part] = acc[i] * scale;
  }
}

template <int DH>
int launch_fma(const void* q, const void* k, const void* v, const void* dO, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int b, int tq, int tk,
               int hkv, int g, int causal, int window, int q_offset, int kv_len, float scale,
               cudaStream_t stream) {
  using C = FmaCfg<DH>;
  const int qtiles = (tq * g + C::SLOTS - 1) / C::SLOTS, ktiles = (tk + C::SLOTS - 1) / C::SLOTS;
  if (qtiles > 65535 || ktiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dO);
  flash_bwd_dkdv_fma_kernel<DH><<<dim3(b * hkv, ktiles), fa::kThreads, 0, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), tq, tk,
      hkv, g, causal, window, q_offset, kv_len, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_fma_kernel<DH><<<dim3(b * hkv, qtiles), fa::kThreads, 0, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), tq, tk, hkv, g, causal, window,
      q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dO [b, tq, hkv, g, dh] (rows = b * tq * hkv * g), lse and delta fp32
// [b, hkv, g, tq]; bf16 or fp32, contiguous.  bf16 (dh 16 to 256) also
// writes qs (like q) and rowstat (fp32 [b, hkv, rs_rows, 2], rs_rows >= tq *
// g); fp32 reads only o and dO and writes only delta.
extern "C" int flash_bwd_delta_launch(const void* q, const void* o, const void* dO,
                                      const void* lse, void* delta, void* qs, void* rowstat,
                                      int rows, int tq, int hkv, int g, int dh, int rs_rows,
                                      float scale, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float2* st = static_cast<float2*>(rowstat);
  if (!is_bf16) {
    flash_bwd_delta_kernel<<<(rows + 3) / 4, 128, 0, s>>>(  // 4 warps a block, a warp a row
        static_cast<const float*>(o), static_cast<const float*>(dO), d, rows, tq, hkv, g, dh);
    return static_cast<int>(cudaGetLastError());
  }
  switch (dh) {
    case 16: return launch_delta_bf16<2>(q, o, dO, l, d, qs, st, rows, tq, hkv, g, rs_rows, scale, s);
    case 32: return launch_delta_bf16<4>(q, o, dO, l, d, qs, st, rows, tq, hkv, g, rs_rows, scale, s);
    case 64: return launch_delta_bf16<8>(q, o, dO, l, d, qs, st, rows, tq, hkv, g, rs_rows, scale, s);
    case 128: return launch_delta_bf16<16>(q, o, dO, l, d, qs, st, rows, tq, hkv, g, rs_rows, scale, s);
    case 256: return launch_delta_bf16<32>(q, o, dO, l, d, qs, st, rows, tq, hkv, g, rs_rows, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define FLASH_BWD_ARGS                                                                     \
  q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk, dv, \
      b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s
#define FLASH_BWD_MMA_ARGS                                                                     \
  q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta), qs, rowstat, \
      dq, dk, dv, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, scale, s

// q, dO, dq [b, tq, hkv, g, dh]; k, v, dk, dv [b, tk, hkv, dh]; lse, delta
// fp32 [b, hkv, g, tq]; qs and rowstat as flash_bwd_delta_launch wrote
// them; contiguous, 16-byte aligned.  kv_len = min(tk, kv_valid_len).  The
// caller checks shapes, types, head dims and that every query row sees a
// key.  bf16: "mma" kernels, dh 16 to 128 whole and 256 by column halves.
extern "C" int flash_bwd_mma_launch(const void* q, const void* k, const void* v, const void* dO,
                                    const void* lse, const void* delta, const void* qs,
                                    const void* rowstat, void* dq, void* dk, void* dv, int b,
                                    int tq, int tk, int hkv, int g, int dh, int causal,
                                    int window, int q_offset, int kv_len, float scale,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_mma<16>(FLASH_BWD_MMA_ARGS);
    case 32: return launch_mma<32>(FLASH_BWD_MMA_ARGS);
    case 64: return launch_mma<64>(FLASH_BWD_MMA_ARGS);
    case 128: return launch_mma<128>(FLASH_BWD_MMA_ARGS);
    case 256: return launch_mma<256>(FLASH_BWD_MMA_ARGS);  // by column halves
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q .. dv and the rest as flash_bwd_mma_launch's, in fp32 (no qs or
// rowstat): "fma" kernels, dh 16 to 256.
extern "C" int flash_bwd_fma_launch(const void* q, const void* k, const void* v, const void* dO,
                                    const void* lse, const void* delta, void* dq, void* dk,
                                    void* dv, int b, int tq, int tk, int hkv, int g, int dh,
                                    int causal, int window, int q_offset, int kv_len,
                                    float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_fma<16>(FLASH_BWD_ARGS);
    case 32: return launch_fma<32>(FLASH_BWD_ARGS);
    case 64: return launch_fma<64>(FLASH_BWD_ARGS);
    case 128: return launch_fma<128>(FLASH_BWD_ARGS);
    case 256: return launch_fma<256>(FLASH_BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
