// Flash attention, bf16, few query rows (decode): the "split" route, a
// split-K ("flash-decoding") kernel and a merge kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:86
// (`flash_attention`) and, on the model path, the jnp function
// src/repro/models/layers.py `attention` at decode (tq = 1 over the KV
// cache) and for short chunks (tq * g <= 16).
//
// Bound on this card: the bytes of the cache, read once against 3.35 TB/s
// (8.4 MB at recurrentgemma's batch 4 x 2048 keys x dh 256 is 2.5 us); the
// flops are g * 4 * dh a key, far below the tensor cores' floor.  A decode
// has b * hkv (batch row, KV head) pairs, 4 under MQA at batch 4, so one
// block per pair leaves the card idle.  What the design does about it:
//  * the keys [0, kv_len) are cut into nsplit chunks of `chunk` keys
//    (kernel.py `plan_decode_splits`: about two blocks per SM); grid
//    (nsplit, hkv, b).  A block takes all rows = tq * g <= 16 query rows of
//    its (batch row, KV head), padded to one 16-row mma tile, against its
//    chunk, streamed through the same 2-stage cp.async ring as the prefill
//    route, with the same per-row causal / window / kv_valid_len masks;
//  * the 4 warps compute the same S = Q K^T tile (cheap here) and split
//    the head dim of P V among themselves, so no warp holds more than
//    dh / 4 accumulator columns and nothing is merged across warps;
//  * each block writes an fp32 partial (m, l, acc[dh]) per row; a chunk
//    with no allowed key writes m = -1e30, l = 0, acc = 0 without loading;
//  * the merge kernel combines a row's partials in the fixed order
//    0 .. nsplit-1 (no atomics), so the output is bitwise repeatable.
// Partials: fp32 [b, hkv, nsplit, rows, dh + 2], (m, l, acc) per row.
#include "flash_mma.cuh"

namespace {

using fa::bf16;

constexpr int kRows = 16;  // one mma tile of query rows

template <int DH>
struct SplitCfg {
  static constexpr int BC = DH <= 128 ? 64 : 32;  // keys per tile
  static constexpr int STAGES = 2;
  static constexpr int LDS = DH + 8;
  static constexpr int DW = DH / 4 >= 16 ? DH / 4 : 16;  // head-dim columns per warp
  static constexpr int SMEM_BYTES = (kRows + 2 * STAGES * BC) * LDS * 2;
};

template <int DH>
__global__ void __launch_bounds__(fa::kThreads)
flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, float* __restrict__ part, int tq, int tk,
                   int hkv, int g, int causal, int window, int q_offset, int kv_len, int chunk,
                   float scale) {
  using C = SplitCfg<DH>;
  constexpr int BC = C::BC, STAGES = C::STAGES, LDS = C::LDS, DW = C::DW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * LDS;
  bf16* Vs = Ks + STAGES * BC * LDS;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int rows = tq * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  float* out = part + ((static_cast<int64_t>(b) * hkv + h) * nsplit + split) * rows * (DH + 2);

  const int c0 = split * chunk, c1 = min(c0 + chunk, kv_len);
  auto pos_of = [&](int r) { return q_offset + min(r, rows - 1) / g; };
  const fa::KeyRange first = fa::key_range(pos_of(0), causal, window, c0, c1);
  const fa::KeyRange last = fa::key_range(pos_of(rows - 1), causal, window, c0, c1);
  const int kbeg = first.lo, kend = last.hi;
  if (kend <= kbeg) {  // no row sees a key of this chunk
    for (int idx = threadIdx.x; idx < rows * (DH + 2); idx += fa::kThreads) {
      const int c = idx % (DH + 2);
      out[idx] = c == 0 ? fa::kNegInf : 0.f;
    }
    return;
  }

  fa::stage_q<DH>(Qs, q, b, h, tq, hkv, g, 0, rows, kRows, scale);
  const fa::KeyRange kr[2] = {
      fa::key_range(pos_of(lane >> 2), causal, window, c0, c1),
      fa::key_range(pos_of((lane >> 2) + 8), causal, window, c0, c1)};
  const int d0 = warp * DW;
  const bool warp_live = d0 < DH;  // at dh 16 / 32 fewer than 4 warps hold columns

  float acc[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {fa::kNegInf, fa::kNegInf}, l[2] = {0.f, 0.f};

  const int ntiles = (kend - kbeg + BC - 1) / BC;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles)
      fa::load_kv_tile<DH, BC>(Ks + i * BC * LDS, Vs + i * BC * LDS, k, v, b, h, tk, hkv,
                               kbeg + i * BC, kend);
    fa::cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int nx = i + STAGES - 1;
    if (nx < ntiles) {
      const int st = nx % STAGES;
      fa::load_kv_tile<DH, BC>(Ks + st * BC * LDS, Vs + st * BC * LDS, k, v, b, h, tk, hkv,
                               kbeg + nx * BC, kend);
    }
    fa::cp_async_commit();
    fa::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int k0 = kbeg + i * BC;
    if (warp_live) {
      const bool masked = !(k0 >= last.lo && k0 + BC <= first.hi);
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
    if (r >= rows) continue;
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

// One block per (row, KV head, batch row), one thread per head-dim column.
__global__ void flash_merge_kernel(const float* __restrict__ part, bf16* __restrict__ o,
                                   int tq, int hkv, int g, int dh, int nsplit) {
  extern __shared__ float sm[];  // m, l and the merge weight w of each split
  float* ms = sm;
  float* ls = sm + nsplit;
  float* ws = sm + 2 * nsplit;
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rows = tq * g;
  const int64_t stride = static_cast<int64_t>(rows) * (dh + 2);  // split to split
  const float* base = part + (static_cast<int64_t>(b) * hkv + h) * nsplit * stride +
                      static_cast<int64_t>(r) * (dh + 2);
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x) {
    ms[s] = base[s * stride];
    ls[s] = base[s * stride + 1];
  }
  __syncthreads();
  float mx = fa::kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ms[s]);
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x)
    ws[s] = ms[s] == fa::kNegInf ? 0.f : fa::exp2_approx((ms[s] - mx) * fa::kLog2e);  // empty: weight 0
  __syncthreads();
  const int d = threadIdx.x;
  float lsum = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {  // fixed order: bitwise repeatable
    lsum += ws[s] * ls[s];
    acc += ws[s] * base[s * stride + 2 + d];
  }
  const int pos = r / g, head = r % g;
  o[((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * dh + static_cast<int64_t>(head) * dh +
    d] = __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
}

template <int DH>
int launch_partials(const void* q, const void* k, const void* v, float* part, int b, int tq,
                    int tk, int hkv, int g, int causal, int window, int q_offset, int kv_len,
                    int nsplit, int chunk, float scale, cudaStream_t stream) {
  using C = SplitCfg<DH>;
  if (tq * g > kRows || hkv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if constexpr (C::SMEM_BYTES > 48 * 1024) {  // above 48 KB only when asked for
    static unsigned done = 0;
    const cudaError_t e = fa::smem_opt_in(flash_split_kernel<DH>, C::SMEM_BYTES, done);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(nsplit, hkv, b);
  flash_split_kernel<DH><<<grid, fa::kThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      part, tq, tk, hkv, g, causal, window, q_offset, kv_len, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Partials of q [b, tq, hkv, g, dh] (tq * g <= 16) against the chunks of
// k/v [b, tk, hkv, dh]: part fp32 [b, hkv, nsplit, tq * g, dh + 2].  All
// contiguous, bf16 inputs 16-byte aligned; kv_len = min(tk, kv_valid_len);
// chunk a multiple of 16 with nsplit * chunk >= kv_len.
extern "C" int flash_split_partials_launch(const void* q, const void* k, const void* v,
                                           void* part, int b, int tq, int tk, int hkv, int g,
                                           int dh, int causal, int window, int q_offset,
                                           int kv_len, int nsplit, int chunk, float scale,
                                           void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dh) {
    case 16: return launch_partials<16>(q, k, v, p, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, nsplit, chunk, scale, s);
    case 32: return launch_partials<32>(q, k, v, p, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, nsplit, chunk, scale, s);
    case 64: return launch_partials<64>(q, k, v, p, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, nsplit, chunk, scale, s);
    case 128: return launch_partials<128>(q, k, v, p, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, nsplit, chunk, scale, s);
    case 256: return launch_partials<256>(q, k, v, p, b, tq, tk, hkv, g, causal, window, q_offset, kv_len, nsplit, chunk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o [b, tq, hkv, g, dh] bf16 from the partials above.
extern "C" int flash_split_merge_launch(const void* part, void* o, int b, int tq, int hkv,
                                        int g, int dh, int nsplit, void* stream) {
  const size_t smem = 3 * static_cast<size_t>(nsplit) * sizeof(float);
  if (smem > 48 * 1024 || hkv > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(tq * g, hkv, b);
  flash_merge_kernel<<<grid, dh, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<bf16*>(o), tq, hkv, g, dh, nsplit);
  return static_cast<int>(cudaGetLastError());
}
