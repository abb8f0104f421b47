// Flash attention over a paged KV pool: the "paged" route, a split-K kernel
// and the merge of its partials; bf16 queries over bf16 or int8 pages
// (the wgmma and mma bodies), bf16 or fp32 queries over fp32 pages (the fma
// body, fp32 out).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:86
// (`flash_attention`) at the continuous-batching engine's call site
// (src/repro/models/blocks.py `self_attention`, :183-186: `L.attention`
// over the block-table view `_paged_kv_read` with per-row valid lengths),
// and under the contiguous vector-position reference step.
//
// Bound on this card: the bytes of the live keys and values (each request's
// keys below its live rows' valid lengths), q and the output, against 3.35
// TB/s; the flops are 4 dh a (live row, key) pair, far below the tensor
// cores' floor.  The engine runs every tick at its chunk width (64 tokens a
// slot), so at a decode-only tick 63 of a slot's 64 rows are padding.  Rows
// of valid length 0 are *dead*: their output is exactly zero.  The design:
//  * split-K over the capacity max_blocks * block_size: the plan (nsplit,
//    chunk) depends on (b, hkv, capacity) only (kernel.py
//    `plan_paged_splits`), never on the tables or the lengths, and is sized
//    so that one live row block a (batch row, KV head) fills the card;
//  * one block a (split, 64 packed rows, batch row, KV head): one warpgroup,
//    each warp owning 16 of the rows, so a K/V tile reaches shared memory
//    once for 64 rows (16 positions x g 4 at llama) and no warp computes
//    another's scores;
//  * a block reads keys only up to the largest valid length among its live
//    rows; a block whose rows are all dead, or see no key of its chunk,
//    returns before any load and writes nothing: the merge reads a row's
//    partials only for the splits its keys reach, and writes zeros for a
//    dead row without reading any.  Both read the engine's int64 lengths
//    as they are (no cast launch);
//  * "wgmma" body, head dims 64 and 128 (llama): S = Q K^T as wgmma
//    m64n64k16 with Q and the K tile in shared memory, P V as wgmma with P
//    from registers and the V tile read MN-major.  Key tiles of 64 keys
//    arrive by TMA through the block table (key j is row j % bs of block
//    tables[b, j / bs]): a 4-D tensor map over the pages [n_blocks, bs, hkv,
//    dh], boxes of gcd(bs, 64) rows (64 for a one-block table), one per page
//    piece and 64-column half, issued by the 32 lanes of warp 0 into a
//    3-stage ring on mbarriers, 128-byte swizzled as the descriptors read
//    them.  A piece past the block's last live key is asked at block
//    n_blocks, out of bounds: TMA writes its zeros without reading memory.
//    int8 pages come the same way (unswizzled int8 rows), with their fp32
//    scales by 4-byte cp.async, and are dequantized from shared memory into
//    the bf16 tile as bf16(float(q) * s), the plain version's
//    `dequantize_plain` rounding bit for bit;
//  * "mma" body, head dims 16, 32 and 256: the same blocks and skips on
//    mma.sync (flash_mma.cuh `attend_tile`, each warp its 16 rows at the
//    full head dim), keys by 16-byte cp.async through the table into a
//    2-stage ring, int8 pages dequantized in the load;
//  * key tiles start at the chunk's first key whatever the page boundaries
//    or rows are, and a masked lane's p is 0 by select, so the keys a row
//    does not see (and whole tiles of them) leave its (m, l, acc) bit for
//    bit as they were: a row's result does not depend on the other rows of
//    its block, its batch, or where a prompt's chunk boundaries fall, and
//    the contiguous form (one block a request) is bitwise the paged one;
//  * the merge sums a row's partials in the fixed order 0, 1, ..., so the
//    output is bitwise repeatable.
//  * "fma" body, fp32 pages (the exact, slow pool: Hopper has no fp32
//    wgmma, and TF32 would miss fp32's tolerance): flash_attention.cu's
//    arithmetic on CUDA cores through the table, the same blocks, skips,
//    partials and merge; its bound is the same bytes at 4 bytes a value.
// Partials: fp32 [b, hkv, nsplit, tq * g, dh + 2], (m, l, acc) per row,
// written only for (live row, split) pairs with keys.
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using fa::bf16;
using hopper::kHalf;

constexpr int kRows = 64;    // packed query rows a block: the warpgroup's M
constexpr int kKeys = 64;    // keys a wgmma tile (and the plan's chunk multiple)
constexpr int kStages = 3;   // the wgmma body's K / V ring

// 4-byte async copy; `valid` false zero-fills the destination.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(fa::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Per-row valid length i of the int64 [b, tq] lengths (the engine's type),
// read as int (past INT_MAX as INT_MAX).
__device__ __forceinline__ int length_at(const long long* __restrict__ kvl, int64_t i) {
  return static_cast<int>(min(kvl[i], static_cast<long long>(INT_MAX)));
}

// What every block computes first.  This thread's two rows are 16 w + lane
// / 4 (+ 8) of the block's 64 (the mma.sync and wgmma accumulator layout);
// hi[half] is the end of the row's keys in this chunk [c0, c1), c0 when the
// row is dead, past the last packed row or sees no key of the chunk (such a
// row is *idle*: its partial is never written or read).  kend: the block's
// largest hi; wmin: the smallest hi of the warp's rows that are not idle
// (INT_MAX if none), below which a tile needs no mask.
struct Rows {
  int hi[2], kend, wmin;
};

__device__ __forceinline__ Rows block_rows(const long long* kvl, int64_t base, int row0,
                                           int rows, int g, int c0, int c1, int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Rows out;
  int lo = INT_MAX;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = row0 + 16 * warp + (lane >> 2) + 8 * half;
    const int hi = gr < rows ? max(c0, min(c1, length_at(kvl, base + gr / g))) : c0;
    out.hi[half] = hi;
    if (hi > c0) lo = min(lo, hi);
  }
  out.wmin = __reduce_min_sync(0xffffffffu, lo);
  const int wmax = __reduce_max_sync(0xffffffffu, max(out.hi[0], out.hi[1]));
  if (lane == 0) red[warp] = wmax;
  __syncthreads();
  out.kend = max(max(red[0], red[1]), max(red[2], red[3]));
  return out;
}

// Write this thread's rows' partials (m, l, acc) where the row has keys in
// the chunk; acc[jb] holds columns 8 jb + 2 (lane % 4) (+ 1) of row half.
template <int D, typename Acc>
__device__ __forceinline__ void write_partials(float* __restrict__ out, const Rows& rw,
                                               int c0, const float (&m)[2], const float (&l)[2],
                                               Acc acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lsum = fa::quad_sum(l[half]);
    if (rw.hi[half] <= c0) continue;
    float* dst = out + static_cast<int64_t>(16 * warp + (lane >> 2) + 8 * half) * (D + 2);
    if (tig == 0) {
      dst[0] = m[half];
      dst[1] = lsum;
    }
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const float2 v = acc(jb, half);
      *reinterpret_cast<float2*>(dst + 2 + 8 * jb + 2 * tig) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// the wgmma body: head dims 64 and 128
// ---------------------------------------------------------------------------
template <int D, bool INT8>
struct WgSmem {
  static constexpr int QTILE = kRows * D * 2;           // D / 64 swizzled halves of 64 rows
  static constexpr int KTILE = kKeys * D * 2;           // a bf16 K (or V) tile, the same way
  static constexpr int RAW = INT8 ? kKeys * D : KTILE;  // what TMA brings a tile: int8 rows or bf16
  static constexpr int Q_OFF = 0;
  static constexpr int DQ_OFF = Q_OFF + QTILE;          // int8: the dequantized K, V tiles
  static constexpr int RING_OFF = DQ_OFF + (INT8 ? 2 * KTILE : 0);  // stage s: K, then V
  static constexpr int SC_OFF = RING_OFF + kStages * 2 * RAW;       // int8: fp32 [stage][k|v][key]
  static constexpr int BAR_OFF = SC_OFF + (INT8 ? kStages * 2 * kKeys * 4 : 0);
  static constexpr int BYTES = BAR_OFF + kStages * 8 + 16 + 1024;  // + red[4] + alignment
};

// Byte offset of bf16 element (row r, column c) in a tile of `rows` rows
// stored as 128-byte swizzled 64-column halves (TMA's SWIZZLE_128B).
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c / kHalf) * rows * 128 + r * 128 + ((((c % kHalf) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

template <int D, bool INT8>
__global__ void __launch_bounds__(fa::kThreads)
flash_paged_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
                         const float* __restrict__ ks, const float* __restrict__ vs,
                         const int* __restrict__ tables, const long long* __restrict__ kvl,
                         float* __restrict__ part, int tq, int hkv, int g, int bs, int box,
                         int n_blocks, int max_blocks, int chunk, float scale) {
  using L = WgSmem<D, INT8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  int* red = reinterpret_cast<int*>(full + kStages);

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.z, b = bh / hkv, h = bh % hkv;
  const int rows = tq * g, row0 = blockIdx.y * kRows;
  const int c0 = split * chunk, c1 = min(c0 + chunk, max_blocks * bs);
  // warp-uniform for the compiler (a shuffle from lane 0), so that it sees
  // the loop's branches as uniform and does not serialize wgmma behind them
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int64_t lbase = static_cast<int64_t>(b) * tq;
  const int* table = tables + static_cast<int64_t>(b) * max_blocks;

  const Rows rw = block_rows(kvl, lbase, row0, rows, g, c0, c1, red);
  const int kend = __shfl_sync(0xffffffffu, rw.kend, 0);
  if (kend <= c0) return;  // every row dead or past this chunk: no load, no write

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float* scs = reinterpret_cast<float*>(smem + L::SC_OFF);
  // Tile i (keys c0 + 64 i ...) into stage i % kStages, by every thread:
  // warp 0's lanes issue the page pieces' TMA copies; with int8 pages each
  // thread also copies one key row's K or V scale and commits a group.
  auto issue = [&](int i) {
    const int s = i % kStages, k0 = c0 + i * kKeys;
    unsigned char* kdst = smem + L::RING_OFF + s * 2 * L::RAW;
    unsigned char* vdst = kdst + L::RAW;
    if (warp == 0) {
      if (lane == 0) hopper::mbar_expect_tx(&full[s], 2 * L::RAW);
      __syncwarp();
      for (int p = lane; p < kKeys / box; p += 32) {
        const int j = k0 + p * box;
        const bool live = j < kend;  // j < kend <= capacity: a table entry
        const int blk = live ? table[j / bs] : n_blocks, r = live ? j % bs : 0;
        if constexpr (INT8) {
          hopper::tma_4d(kdst + p * box * D, &tm_k, &full[s], 0, h, r, blk);
          hopper::tma_4d(vdst + p * box * D, &tm_v, &full[s], 0, h, r, blk);
        } else {
#pragma unroll
          for (int hf = 0; hf < D / kHalf; ++hf) {
            hopper::tma_4d(kdst + hf * kKeys * 128 + p * box * 128, &tm_k, &full[s], hf * kHalf,
                           h, r, blk);
            hopper::tma_4d(vdst + hf * kKeys * 128 + p * box * 128, &tm_v, &full[s], hf * kHalf,
                           h, r, blk);
          }
        }
      }
    }
    if constexpr (INT8) {
      const int kv = threadIdx.x / kKeys, jj = threadIdx.x % kKeys, j = k0 + jj;
      const bool live = j < kend;
      const int64_t row =
          live ? (static_cast<int64_t>(table[j / bs]) * bs + j % bs) * hkv + h : 0;
      cp_async4(scs + (s * 2 + kv) * kKeys + jj, (kv ? vs : ks) + row, live);
      fa::cp_async_commit();
    }
  };

  const int ntiles = (kend - c0 + kKeys - 1) / kKeys;
  for (int i = 0; i < kStages; ++i) {
    if (i < ntiles)
      issue(i);
    else if constexpr (INT8)
      fa::cp_async_commit();  // one group a tile slot, so the waits count tiles
  }
  // Q, while the first tiles are in flight: the block's rows scaled by
  // 1/sqrt(dh) and rounded to bf16 (as layers.attention does), swizzled as
  // TMA would; dead rows and rows past the last stay zero.
  unsigned char* Qs = smem + L::Q_OFF;
  for (int idx = threadIdx.x; idx < kRows * (D / 8); idx += fa::kThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8, gr = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < rows && length_at(kvl, lbase + gr / g) > 0) {
      const int pos = gr / g, head = gr % g;
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * D +
          static_cast<int64_t>(head) * D + c);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + swz(kRows, r, c)) = val;
  }
  fence_async_shared();  // the generic writes, before wgmma reads them
  __syncthreads();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {fa::kNegInf, fa::kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages, k0 = c0 + i * kKeys;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* Kt = smem + L::RING_OFF + s * 2 * L::RAW;
    const unsigned char* Vt = Kt + L::RAW;
    if constexpr (INT8) {
      // dequantize the stage's int8 rows into the bf16 tiles (the previous
      // tile's wgmma are done with them: every warp waited before the
      // barrier that ended it)
      fa::cp_async_wait<kStages - 1>();
      __syncthreads();
      unsigned char* dq = smem + L::DQ_OFF;
      for (int idx = threadIdx.x; idx < 2 * kKeys * (D / 16); idx += fa::kThreads) {
        const int kv = idx / (kKeys * (D / 16)), rem = idx % (kKeys * (D / 16));
        const int jj = rem / (D / 16), c = (rem % (D / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>((kv ? Vt : Kt) + jj * D + c);
        const float sc = scs[(s * 2 + kv) * kKeys + jj];
        const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
        uint4 o[2];
        bf16* ob = reinterpret_cast<bf16*>(o);
#pragma unroll
        for (int e = 0; e < 16; ++e) ob[e] = __float2bfloat16(static_cast<float>(qv[e]) * sc);
        unsigned char* tile = dq + kv * L::KTILE;
        *reinterpret_cast<uint4*>(tile + swz(kKeys, jj, c)) = o[0];
        *reinterpret_cast<uint4*>(tile + swz(kKeys, jj, c + 8)) = o[1];
      }
      fence_async_shared();
      __syncthreads();
      Kt = dq;
      Vt = dq + L::KTILE;
    }

    // S = Q K^T; element 4 j + e: row 16 warp + lane / 4 (+ 8 for e >= 2),
    // key k0 + 8 j + 2 (lane % 4) + (e & 1)
    float sc[kKeys / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<kKeys>(sc, hopper::desc_k(Qs, kRows, 0, kk),
                              hopper::desc_k(Kt, kKeys, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // the online softmax of flash_mma.cuh `attend_tile`, on this layout
    const bool masked = k0 + kKeys > rw.wmin;  // some row of the warp misses a key
    if (masked) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= rw.hi[e >> 1]) sc[4 * j + e] = fa::kNegInf;
    }
    float mlog[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mlog[r] = mx * fa::kLog2e;
      const float alpha = fa::exp2_approx((m[r] - mx) * fa::kLog2e);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        acc[4 * jb + 2 * r] *= alpha;
        acc[4 * jb + 2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fa::exp2_approx(fmaf(sc[4 * j + e], fa::kLog2e, -mlog[r]));
        if (masked && k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= rw.hi[r]) p = 0.f;
        sc[4 * j + e] = p;
        l[r] += p;
      }

    // acc += P V: P (rounded to bf16) from registers, V MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      hopper::acc_to_a(sc, kk, a);
      hopper::wgmma_rs_mn<D>(acc, a, hopper::desc_mn(Vt, kKeys, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __syncthreads();  // every warp is done with stage s: refill it
    if (i + kStages < ntiles) {
      if (warp == 0) fence_async_shared();  // int8: the dequantize read the stage
      issue(i + kStages);
    } else if constexpr (INT8) {
      fa::cp_async_commit();
    }
  }

  float* out = part + ((static_cast<int64_t>(bh) * nsplit + split) * rows + row0) * (D + 2);
  write_partials<D>(out, rw, c0, m, l, [&](int jb, int half) {
    return make_float2(acc[4 * jb + 2 * half], acc[4 * jb + 2 * half + 1]);
  });
}

// Pages [n_blocks, bs, hkv, dh] of one KV head as boxes of `box` key rows:
// bf16 in 64-column swizzled halves, int8 as whole unswizzled rows.
int map_pages(CUtensorMap* m, const void* p, bool int8, int n_blocks, int bs, int hkv, int dh,
              int box) {
  const cuuint64_t es = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(bs), static_cast<cuuint64_t>(n_blocks)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * es;
  const cuuint64_t strides[3] = {row, row * hkv, row * hkv * bs};
  const cuuint32_t boxd[4] = {static_cast<cuuint32_t>(int8 ? dh : kHalf), 1,
                              static_cast<cuuint32_t>(box), 1};
  return hopper::make_map(
      m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims,
      strides, boxd, int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// the mma body: head dims 16, 32 and 256
// ---------------------------------------------------------------------------
template <int DH>
struct MmaCfg {
  static constexpr int BC = DH <= 128 ? 64 : 32;  // keys per tile
  static constexpr int STAGES = 2;
  static constexpr int LDS = DH + 8;
  static constexpr int SMEM_BYTES = (kRows + 2 * STAGES * BC) * LDS * 2;
};

// Keys [k0, k0 + BC) of KV head h through the request's block table into
// Ks / Vs by async copies; keys at or past `kend` are zero-filled.
template <int DH, int BC>
__device__ __forceinline__ void load_tile_bf16(bf16* Ks, bf16* Vs, const bf16* __restrict__ k,
                                               const bf16* __restrict__ v,
                                               const int* __restrict__ table, int bs, int hkv,
                                               int h, int k0, int kend) {
  constexpr int LDS = DH + 8, VPR = DH / 8;
  for (int idx = threadIdx.x; idx < BC * VPR; idx += fa::kThreads) {
    const int jj = idx / VPR, c = (idx % VPR) * 8;
    const int j = k0 + jj;
    const bool ok = j < kend;
    int64_t off = 0;
    if (ok) {
      const int64_t row = static_cast<int64_t>(table[j / bs]) * bs + j % bs;
      off = (row * hkv + h) * DH + c;
    }
    fa::cp_async16(Ks + jj * LDS + c, k + off, ok);
    fa::cp_async16(Vs + jj * LDS + c, v + off, ok);
  }
}

// 16 int8 values times their block's scale, each product rounded to bf16.
__device__ __forceinline__ void dequant16(const uint4& raw, float s, uint4 (&out)[2]) {
  const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
  bf16* o = reinterpret_cast<bf16*>(out);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = __float2bfloat16(static_cast<float>(qv[i]) * s);
}

// As load_tile_bf16 for int8 pages with fp32 scale pages [.., hkv, NSC]
// (one scale a 128 values of a row): loaded, dequantized and stored.
template <int DH, int BC>
__device__ __forceinline__ void load_tile_int8(bf16* Ks, bf16* Vs, const int8_t* __restrict__ k,
                                               const int8_t* __restrict__ v,
                                               const float* __restrict__ ks,
                                               const float* __restrict__ vs,
                                               const int* __restrict__ table, int bs, int hkv,
                                               int h, int k0, int kend) {
  constexpr int LDS = DH + 8, VPR = DH / 16, NSC = (DH + 127) / 128;
  for (int idx = threadIdx.x; idx < BC * VPR; idx += fa::kThreads) {
    const int jj = idx / VPR, c = (idx % VPR) * 16;
    const int j = k0 + jj;
    uint4 ko[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    uint4 vo[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (j < kend) {
      const int64_t row = (static_cast<int64_t>(table[j / bs]) * bs + j % bs) * hkv + h;
      const uint4 kr = *reinterpret_cast<const uint4*>(k + row * DH + c);
      const uint4 vr = *reinterpret_cast<const uint4*>(v + row * DH + c);
      dequant16(kr, ks[row * NSC + c / 128], ko);
      dequant16(vr, vs[row * NSC + c / 128], vo);
    }
    *reinterpret_cast<uint4*>(Ks + jj * LDS + c) = ko[0];
    *reinterpret_cast<uint4*>(Ks + jj * LDS + c + 8) = ko[1];
    *reinterpret_cast<uint4*>(Vs + jj * LDS + c) = vo[0];
    *reinterpret_cast<uint4*>(Vs + jj * LDS + c + 8) = vo[1];
  }
}

template <int DH, bool INT8>
__global__ void __launch_bounds__(fa::kThreads)
flash_paged_mma_kernel(const bf16* __restrict__ q, const void* __restrict__ kp,
                       const void* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ tables,
                       const long long* __restrict__ kvl, float* __restrict__ part, int tq,
                       int hkv, int g, int bs, int max_blocks, int chunk, float scale) {
  using C = MmaCfg<DH>;
  constexpr int BC = C::BC, STAGES = C::STAGES, LDS = C::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int red[4];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * LDS;
  bf16* Vs = Ks + STAGES * BC * LDS;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.z, b = bh / hkv, h = bh % hkv;
  const int rows = tq * g, row0 = blockIdx.y * kRows, nrows = min(kRows, rows - row0);
  const int c0 = split * chunk, c1 = min(c0 + chunk, max_blocks * bs);
  const int warp = threadIdx.x >> 5;
  const int* table = tables + static_cast<int64_t>(b) * max_blocks;

  const Rows rw = block_rows(kvl, static_cast<int64_t>(b) * tq, row0, rows, g, c0, c1, red);
  const int kend = rw.kend;
  if (kend <= c0) return;  // every row dead or past this chunk: no load, no write
  // the warp's last key: tiles past it leave its rows as they are, so it skips them
  const int wend = __reduce_max_sync(0xffffffffu, max(rw.hi[0], rw.hi[1]));

  const fa::KeyRange kr[2] = {{c0, rw.hi[0]}, {c0, rw.hi[1]}};
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {fa::kNegInf, fa::kNegInf}, l[2] = {0.f, 0.f};

  auto load = [&](int st, int k0) {
    if constexpr (INT8)
      load_tile_int8<DH, BC>(Ks + st * BC * LDS, Vs + st * BC * LDS,
                             static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp), ks,
                             vs, table, bs, hkv, h, k0, kend);
    else
      load_tile_bf16<DH, BC>(Ks + st * BC * LDS, Vs + st * BC * LDS,
                             static_cast<const bf16*>(kp), static_cast<const bf16*>(vp), table,
                             bs, hkv, h, k0, kend);
  };

  const int ntiles = (kend - c0 + BC - 1) / BC;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load(i, c0 + i * BC);
    fa::cp_async_commit();
  }
  // Q while the first tile is in flight (the loop's barrier publishes it)
  fa::stage_q<DH>(Qs, q, b, h, tq, hkv, g, row0, nrows, kRows, scale);
  for (int i = 0; i < ntiles; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < ntiles) load(nx % STAGES, c0 + nx * BC);
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int k0 = c0 + i * BC;
    if (k0 < wend) {
      const int st = i % STAGES;
      fa::attend_tile<DH, BC, DH>(Qs + warp * 16 * LDS, Ks + st * BC * LDS, Vs + st * BC * LDS,
                                  0, k0, k0 + BC > rw.wmin, kr, acc, m, l);
    }
    __syncthreads();
  }

  float* out = part + ((static_cast<int64_t>(bh) * nsplit + split) * rows + row0) * (DH + 2);
  write_partials<DH>(out, rw, c0, m, l, [&](int jb, int half) {
    return make_float2(acc[jb][2 * half], acc[jb][2 * half + 1]);
  });
}

// ---------------------------------------------------------------------------
// the fma body: fp32 pages, bf16 or fp32 queries, any head dim
// ---------------------------------------------------------------------------
// The "fma" route's arithmetic (flash_attention.cu) through the block table:
// a row is owned by TPR threads of DPT dims each (dh / TPR <= 32), q
// pre-scaled and rounded to its own type, fp32 dot products, the online
// softmax in expf; K and V tiles of BK keys staged in shared memory as fp32
// rows padded by one float (no bank conflicts across a row's threads).  The
// blocks, skips and partials are the other bodies': a block a (split, FR
// packed rows, batch row, KV head), idle rows write nothing.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

template <int DH>
struct FmaCfg {
  static constexpr int TPR = DH >= 64 ? DH / 32 : 1;  // threads a query row
  static constexpr int DPT = DH / TPR;                // dims a thread
  static constexpr int FR = fa::kThreads / TPR;       // packed rows a block
  static constexpr int BK = 2048 / DH;                // keys a shared-memory tile
  static constexpr int LD = DH + 1;
};

template <int DH, typename TQ>
__global__ void __launch_bounds__(fa::kThreads)
flash_paged_fma_kernel(const TQ* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ tables,
                       const long long* __restrict__ kvl, float* __restrict__ part, int tq,
                       int hkv, int g, int bs, int max_blocks, int chunk, float scale) {
  using C = FmaCfg<DH>;
  constexpr int TPR = C::TPR, DPT = C::DPT, BK = C::BK, LD = C::LD;
  __shared__ float Ks[BK * LD], Vs[BK * LD];
  __shared__ int red[fa::kThreads / 32];

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.z, b = bh / hkv, h = bh % hkv;
  const int rows = tq * g;
  const int c0 = split * chunk, c1 = min(c0 + chunk, max_blocks * bs);
  const int t = threadIdx.x, part_i = t % TPR;
  const int gr = blockIdx.y * C::FR + t / TPR;
  const bool in = gr < rows;
  const int pos = in ? gr / g : 0, head = in ? gr % g : 0;
  const int hi = in ? max(c0, min(c1, length_at(kvl, static_cast<int64_t>(b) * tq + pos))) : c0;
  const int wmax = __reduce_max_sync(0xffffffffu, hi);
  if ((t & 31) == 0) red[t >> 5] = wmax;
  __syncthreads();
  int kend = red[0];
#pragma unroll
  for (int w = 1; w < fa::kThreads / 32; ++w) kend = max(kend, red[w]);
  if (kend <= c0) return;  // every row dead or past this chunk: no load, no write

  const int* table = tables + static_cast<int64_t>(b) * max_blocks;
  const int64_t q_base =
      ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * DH + static_cast<int64_t>(head) * DH;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const float qv = in ? to_f(q[q_base + i * TPR + part_i]) : 0.f;
    qr[i] = to_f(from_f<TQ>(qv * scale));  // pre-scale, round to q's type
    acc[i] = 0.f;
  }
  float m = fa::kNegInf, l = 0.f;

  constexpr int VPR = DH / 4;  // float4 loads a key row
  for (int k0 = c0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = t; idx < BK * VPR; idx += fa::kThreads) {
      const int jj = idx / VPR, c = (idx % VPR) * 4;
      const int j = k0 + jj;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (j < kend) {
        const int64_t row = static_cast<int64_t>(table[j / bs]) * bs + j % bs;
        const int64_t off = (row * hkv + h) * DH + c;
        kv4 = *reinterpret_cast<const float4*>(k + off);
        vv4 = *reinterpret_cast<const float4*>(v + off);
      }
      float* kd = Ks + jj * LD + c;
      float* vd = Vs + jj * LD + c;
      kd[0] = kv4.x, kd[1] = kv4.y, kd[2] = kv4.z, kd[3] = kv4.w;
      vd[0] = vv4.x, vd[1] = vv4.y, vd[2] = vv4.z, vd[3] = vv4.w;
    }
    __syncthreads();
    for (int jj = 0; jj < BK; ++jj) {
      const float* kr = Ks + jj * LD;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) s += qr[i] * kr[i * TPR + part_i];
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (k0 + jj < hi) {  // the row's keys in this chunk: [c0, hi)
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
        for (int i = 0; i < DPT; ++i) acc[i] += p * vr[i * TPR + part_i];
      }
    }
  }
  if (hi <= c0) return;  // an idle row: its partial is never read
  float* dst = part + ((static_cast<int64_t>(bh) * nsplit + split) * rows + gr) * (DH + 2);
  if (part_i == 0) {
    dst[0] = m;
    dst[1] = l;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) dst[2 + i * TPR + part_i] = acc[i];
}

// ---------------------------------------------------------------------------
// the merge
// ---------------------------------------------------------------------------
constexpr int kMergeRows = 8;  // a warp a packed row

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Row r of request b combines the partials of the splits its keys reach
// (s chunk < its valid length, cut to the capacity) in the fixed order 0,
// 1, ...: o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s -
// max m).  A dead row writes zeros and reads no partial.  A lane owns
// columns 2 lane + 64 i (+ 1).
template <typename TO>
__global__ void __launch_bounds__(32 * kMergeRows)
flash_paged_merge_kernel(const float* __restrict__ part, const long long* __restrict__ kvl,
                         TO* __restrict__ o, int tq, int hkv, int g, int dh, int nsplit,
                         int chunk, int capacity) {
  const int lane = threadIdx.x & 31;
  const int rows = tq * g, r = blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (r >= rows) return;
  const int pos = r / g, head = r % g;
  const int l = min(length_at(kvl, static_cast<int64_t>(b) * tq + pos), capacity);
  const int ns = l > 0 ? min(nsplit, (l + chunk - 1) / chunk) : 0;
  const int64_t stride = static_cast<int64_t>(rows) * (dh + 2);  // split to split
  const float* base = part + (static_cast<int64_t>(b) * hkv + h) * nsplit * stride +
                      static_cast<int64_t>(r) * (dh + 2);
  TO* dst = o + ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * dh +
            static_cast<int64_t>(head) * dh;
  float mx = fa::kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, base[s * stride]);
  for (int c = 2 * lane; c < dh; c += 64) {
    float lsum = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < ns; ++s) {  // fixed order: bitwise repeatable
      const float* p = base + s * stride;
      const float ms = p[0];
      const float w = ms == fa::kNegInf ? 0.f : fa::exp2_approx((ms - mx) * fa::kLog2e);
      const float2 av = *reinterpret_cast<const float2*>(p + 2 + c);
      lsum += w * p[1];
      a0 += w * av.x;
      a1 += w * av.y;
    }
    const float den = fmaxf(lsum, 1e-30f);
    store2(dst + c, ns ? a0 / den : 0.f, ns ? a1 / den : 0.f);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
struct Launch {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* tables;
  const long long* kvl;
  float* part;
  int b, tq, hkv, g, bs, max_blocks, n_blocks, nsplit, chunk;
  float scale;
  cudaStream_t stream;
};

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <int D, bool INT8>
int launch_wgmma(const Launch& a) {
  using L = WgSmem<D, INT8>;
  // rows a TMA box: a piece of one page, a 128-byte multiple of int8 rows
  const int box = a.max_blocks == 1 ? kKeys : gcd(a.bs, kKeys);
  if (INT8 && box * D % 128) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned done = 0;
  cudaError_t e = fa::smem_opt_in(flash_paged_wgmma_kernel<D, INT8>, L::BYTES, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_k, tm_v;
  int err = map_pages(&tm_k, a.k, INT8, a.n_blocks, a.bs, a.hkv, D, box);
  if (!err) err = map_pages(&tm_v, a.v, INT8, a.n_blocks, a.bs, a.hkv, D, box);
  if (err) return err;
  const dim3 grid(a.nsplit, (a.tq * a.g + kRows - 1) / kRows, a.b * a.hkv);
  flash_paged_wgmma_kernel<D, INT8><<<grid, fa::kThreads, L::BYTES, a.stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(a.q), a.ks, a.vs, a.tables, a.kvl, a.part, a.tq,
      a.hkv, a.g, a.bs, box, a.n_blocks, a.max_blocks, a.chunk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool INT8>
int launch_mma(const Launch& a) {
  using C = MmaCfg<DH>;
  if constexpr (C::SMEM_BYTES > 48 * 1024) {  // above 48 KB only when asked for
    static unsigned done = 0;
    const cudaError_t e = fa::smem_opt_in(flash_paged_mma_kernel<DH, INT8>, C::SMEM_BYTES, done);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.nsplit, (a.tq * a.g + kRows - 1) / kRows, a.b * a.hkv);
  flash_paged_mma_kernel<DH, INT8><<<grid, fa::kThreads, C::SMEM_BYTES, a.stream>>>(
      static_cast<const bf16*>(a.q), a.k, a.v, a.ks, a.vs, a.tables, a.kvl, a.part, a.tq, a.hkv,
      a.g, a.bs, a.max_blocks, a.chunk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename TQ>
int launch_fma(const Launch& a) {
  const dim3 grid(a.nsplit, (a.tq * a.g + FmaCfg<DH>::FR - 1) / FmaCfg<DH>::FR, a.b * a.hkv);
  flash_paged_fma_kernel<DH, TQ><<<grid, fa::kThreads, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.tables, a.kvl, a.part, a.tq, a.hkv, a.g, a.bs,
      a.max_blocks, a.chunk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_fma_dh(int dh, const Launch& a) {
  switch (dh) {
    case 16: return launch_fma<16, TQ>(a);
    case 32: return launch_fma<32, TQ>(a);
    case 64: return launch_fma<64, TQ>(a);
    case 128: return launch_fma<128, TQ>(a);
    case 256: return launch_fma<256, TQ>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool INT8>
int launch_body(int dh, int wgmma, const Launch& a) {
  if (wgmma) {
    switch (dh) {
      case 64: return launch_wgmma<64, INT8>(a);
      case 128: return launch_wgmma<128, INT8>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (dh) {
    case 16: return launch_mma<16, INT8>(a);
    case 32: return launch_mma<32, INT8>(a);
    case 256: return launch_mma<256, INT8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o [b, tq, hkv, g, dh]: q [b, tq, hkv, g, dh] against the pages k / v
// [n_blocks, bs, hkv, dh] through tables [b, max_blocks] int32; row i of
// request b sees keys j < kvl[b, i] (int64 [b, tq]; 0: a dead row, whose o
// is zero).  `body`: 0 the mma body (dh 16, 32, 256) and 1 the wgmma body
// (dh 64, 128), both over bf16 pages, or int8 ones with fp32 scale pages ks /
// vs [n_blocks, bs, hkv, ceil(dh / 128)] (`kv_int8`; NULL otherwise), bf16 q
// and o; 2 the fma body over fp32 pages, q bf16 or fp32 (`q_fp32`), o fp32.
// part: fp32 scratch [b, hkv, nsplit, tq * g, dh + 2].  nsplit * chunk
// covers max_blocks * bs, chunk a multiple of 64.  Then the merge.  All
// contiguous and 16-byte aligned.
extern "C" int flash_paged_launch(const void* q, const void* k, const void* v, const void* ks,
                                  const void* vs, const void* tables, const void* kvl,
                                  void* part, void* o, int b, int tq, int hkv, int g, int dh,
                                  int bs, int max_blocks, int n_blocks, int kv_int8, int body,
                                  int q_fp32, int nsplit, int chunk, float scale, void* stream) {
  // packed rows a block: kRows, or the fma body's FmaCfg<dh>::FR
  const int fr = body != 2 ? kRows : dh >= 64 ? fa::kThreads * 32 / dh : fa::kThreads;
  const int row_blocks = (tq * g + fr - 1) / fr;
  if (b > 65535 || hkv > 65535 || static_cast<int64_t>(b) * hkv > 65535 ||
      row_blocks > 65535 || nsplit < 1 || chunk % kKeys || (body == 2 && kv_int8))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Launch a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(tables), static_cast<const long long*>(kvl),
                 static_cast<float*>(part), b, tq, hkv, g,
                 bs, max_blocks, n_blocks, nsplit, chunk, scale,
                 reinterpret_cast<cudaStream_t>(stream)};
  int err;
  if (body == 2)
    err = q_fp32 ? launch_fma_dh<float>(dh, a) : launch_fma_dh<bf16>(dh, a);
  else
    err = kv_int8 ? launch_body<true>(dh, body, a) : launch_body<false>(dh, body, a);
  if (err) return err;
  const dim3 grid((tq * g + kMergeRows - 1) / kMergeRows, hkv, b);
  if (body == 2)
    flash_paged_merge_kernel<float><<<grid, 32 * kMergeRows, 0, a.stream>>>(
        a.part, a.kvl, static_cast<float*>(o), tq, hkv, g, dh, nsplit, chunk, max_blocks * bs);
  else
    flash_paged_merge_kernel<bf16><<<grid, 32 * kMergeRows, 0, a.stream>>>(
        a.part, a.kvl, static_cast<bf16*>(o), tq, hkv, g, dh, nsplit, chunk, max_blocks * bs);
  return static_cast<int>(cudaGetLastError());
}
