// Flash attention over a paged KV pool, bf16 queries: the "paged" route,
// a split-K kernel whose partials the split route's merge kernel
// (flash_attention_split.cu) combines.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:86
// (`flash_attention`) at the continuous-batching engine's call site
// (src/repro/models/blocks.py `self_attention`, :183-186: `L.attention`
// over the block-table view `_paged_kv_read` with per-row valid lengths
// `absp + 1`), and under the contiguous vector-position reference step.
//
// Bound on this card: the bytes of the live keys and values (each request's
// keys below its rows' valid lengths), q and the output, against 3.35 TB/s;
// the flops are g * 4 * dh a key and query position, far below the tensor
// cores' floor at decode.  What the design does about it:
//  * split-K over the capacity max_blocks * block_size: the plan (nsplit,
//    chunk) depends on (b, hkv, capacity) only (kernel.py
//    `plan_decode_splits`), never on the tables or the lengths; grid
//    (nsplit, row tiles, b * hkv);
//  * a block takes 16 packed rows (position, group head) of its (batch
//    row, KV head) against its chunk; a block whose rows see no key of the
//    chunk writes the empty partial (m = -1e30, l = 0, acc = 0) and loads
//    nothing, so a request's keys past its rows' valid lengths are never
//    read: the kernel reads each request's live bytes, not the capacity;
//  * key j of request b is row j % block_size of block
//    tables[b, j / block_size]; bf16 pages stream through the split route's
//    2-stage cp.async ring; int8 pages are read 16 values a thread,
//    dequantized to bf16(float(q) * scale) (the plain version's
//    `dequantize_plain(..., bfloat16)` rounding, so the tile is a
//    dequantized view bit for bit) and stored to the same ring stage;
//  * key tiles start at the chunk's first key whatever the rows are, and a
//    masked lane's p is 0 by select, so the keys a row does not see (and
//    whole tiles of them) leave its (m, l, acc) bit for bit as they were: a
//    row's result does not depend on the other rows of its tile, its
//    batch, or where a prompt's chunk boundaries fall;
//  * as in the split route, the 4 warps compute the same S = Q K^T tile and
//    split the head dim of P V; the merge sums a row's partials in the
//    fixed order 0 .. nsplit-1, so the output is bitwise repeatable.
// Partials: fp32 [b, hkv, nsplit, tq * g, dh + 2], (m, l, acc) per row.
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using fa::bf16;

constexpr int kRows = 16;  // one mma tile of packed query rows

template <int DH>
struct PagedCfg {
  static constexpr int BC = DH <= 128 ? 64 : 32;  // keys per tile
  static constexpr int STAGES = 2;
  static constexpr int LDS = DH + 8;
  static constexpr int DW = DH / 4 >= 16 ? DH / 4 : 16;  // head-dim columns per warp
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
flash_paged_kernel(const bf16* __restrict__ q, const void* __restrict__ kp,
                   const void* __restrict__ vp, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ tables,
                   const int* __restrict__ kvl, float* __restrict__ part, int tq, int hkv, int g,
                   int bs, int max_blocks, int capacity, int chunk, float scale) {
  using C = PagedCfg<DH>;
  constexpr int BC = C::BC, STAGES = C::STAGES, LDS = C::LDS, DW = C::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * LDS;
  bf16* Vs = Ks + STAGES * BC * LDS;

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.z, b = bh / hkv, h = bh % hkv;
  const int rows = tq * g, row0 = blockIdx.y * kRows, nrows = min(kRows, rows - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  float* out = part + ((static_cast<int64_t>(bh) * nsplit + split) * rows + row0) * (DH + 2);
  const int* table = tables + static_cast<int64_t>(b) * max_blocks;
  const int* vlen = kvl + static_cast<int64_t>(b) * tq;

  // Row r of the tile sees keys [c0, hi(r)) of this chunk; rows past the
  // last real one take its range (their output is not written).
  const int c0 = split * chunk, c1 = min(c0 + chunk, capacity);
  auto hi_of = [&](int r) { return min(c1, vlen[(row0 + min(r, nrows - 1)) / g]); };
  int hmin = c1, hmax = c0;
  for (int r = 0; r < nrows; ++r) {
    const int hr = hi_of(r);
    hmin = min(hmin, hr);
    hmax = max(hmax, hr);
  }
  const int kend = hmax;
  if (kend <= c0) {  // no row sees a key of this chunk
    for (int idx = threadIdx.x; idx < nrows * (DH + 2); idx += fa::kThreads)
      out[idx] = idx % (DH + 2) == 0 ? fa::kNegInf : 0.f;
    return;
  }

  fa::stage_q<DH>(Qs, q, b, h, tq, hkv, g, row0, nrows, kRows, scale);
  const fa::KeyRange kr[2] = {{c0, hi_of(lane >> 2)}, {c0, hi_of((lane >> 2) + 8)}};
  const int d0 = warp * DW;
  const bool warp_live = d0 < DH;  // at dh 16 / 32 fewer than 4 warps hold columns

  float acc[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
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
  for (int i = 0; i < ntiles; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < ntiles) load(nx % STAGES, c0 + nx * BC);
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int k0 = c0 + i * BC;
    if (warp_live) {
      const bool masked = k0 + BC > hmin;  // some row misses a key of the tile
      const int st = i % STAGES;
      fa::attend_tile<DH, BC, DW>(Qs, Ks + st * BC * LDS, Vs + st * BC * LDS, d0, k0, masked,
                                  kr, acc, m, l);
    }
    __syncthreads();
  }

  if (!warp_live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lsum = fa::quad_sum(l[half]);
    const int r = (lane >> 2) + 8 * half;
    if (r >= nrows) continue;
    float* dst = out + r * (DH + 2);
    if (warp == 0 && tig == 0) {
      dst[0] = m[half];
      dst[1] = lsum;
    }
#pragma unroll
    for (int db = 0; db < DW / 8; ++db)
      *reinterpret_cast<float2*>(dst + 2 + d0 + db * 8 + tig * 2) =
          make_float2(acc[db][2 * half], acc[db][2 * half + 1]);
  }
}

template <int DH, bool INT8>
int launch_paged(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 const int* tables, const int* kvl, float* part, int b, int tq, int hkv, int g,
                 int bs, int max_blocks, int nsplit, int chunk, float scale,
                 cudaStream_t stream) {
  using C = PagedCfg<DH>;
  const int tiles = (tq * g + kRows - 1) / kRows;
  if (static_cast<int64_t>(b) * hkv > 65535 || tiles > 65535 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if constexpr (C::SMEM_BYTES > 48 * 1024) {  // above 48 KB only when asked for
    static unsigned done = 0;
    const cudaError_t e = fa::smem_opt_in(flash_paged_kernel<DH, INT8>, C::SMEM_BYTES, done);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(nsplit, tiles, b * hkv);
  flash_paged_kernel<DH, INT8><<<grid, fa::kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), k, v, ks, vs, tables, kvl, part, tq, hkv, g, bs, max_blocks,
      max_blocks * bs, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8>
int launch_dh(int dh, const void* q, const void* k, const void* v, const float* ks,
              const float* vs, const int* tables, const int* kvl, float* part, int b, int tq,
              int hkv, int g, int bs, int max_blocks, int nsplit, int chunk, float scale,
              cudaStream_t s) {
  switch (dh) {
    case 16: return launch_paged<16, INT8>(q, k, v, ks, vs, tables, kvl, part, b, tq, hkv, g, bs, max_blocks, nsplit, chunk, scale, s);
    case 32: return launch_paged<32, INT8>(q, k, v, ks, vs, tables, kvl, part, b, tq, hkv, g, bs, max_blocks, nsplit, chunk, scale, s);
    case 64: return launch_paged<64, INT8>(q, k, v, ks, vs, tables, kvl, part, b, tq, hkv, g, bs, max_blocks, nsplit, chunk, scale, s);
    case 128: return launch_paged<128, INT8>(q, k, v, ks, vs, tables, kvl, part, b, tq, hkv, g, bs, max_blocks, nsplit, chunk, scale, s);
    case 256: return launch_paged<256, INT8>(q, k, v, ks, vs, tables, kvl, part, b, tq, hkv, g, bs, max_blocks, nsplit, chunk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Partials of q [b, tq, hkv, g, dh] bf16 against the pages k / v
// [n_blocks, bs, hkv, dh] (bf16, or int8 with fp32 scale pages ks / vs
// [n_blocks, bs, hkv, ceil(dh / 128)]; NULL for bf16) through tables
// [b, max_blocks] int32; row i of request b sees keys j < kvl[b, i] (int32
// [b, tq]).  part fp32 [b, hkv, nsplit, tq * g, dh + 2]; nsplit * chunk
// covers max_blocks * bs.  All contiguous and 16-byte aligned.
extern "C" int flash_paged_partials_launch(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, const void* tables,
                                           const void* kvl, void* part, int b, int tq, int hkv,
                                           int g, int dh, int bs, int max_blocks, int kv_int8,
                                           int nsplit, int chunk, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* t = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(kvl);
  float* p = static_cast<float*>(part);
  if (kv_int8)
    return launch_dh<true>(dh, q, k, v, ksf, vsf, t, len, p, b, tq, hkv, g, bs, max_blocks,
                           nsplit, chunk, scale, s);
  return launch_dh<false>(dh, q, k, v, ksf, vsf, t, len, p, b, tq, hkv, g, bs, max_blocks,
                          nsplit, chunk, scale, s);
}
