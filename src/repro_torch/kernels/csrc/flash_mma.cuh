// Tensor-core building blocks shared by the bf16 flash-attention routes
// (flash_attention_mma.cu: prefill; flash_attention_split.cu: decode; the
// backward's flash_attention_bwd.cu and, through hopper.cuh,
// flash_attention_bwd_wgmma.cu and flash_attention_bwd_wgmma256.cu).
//
// Products are `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` with
// operands from `ldmatrix`; K/V tiles reach shared memory by 16-byte
// `cp.async.cg`.  Shared-memory rows are padded to DH + 8 bf16 (16 bytes),
// so the 8 row addresses of one `ldmatrix` phase fall on 8 distinct 16-byte
// bank groups.
//
// `attend_tile` is one key tile for one warp's 16 query rows: S = Q K^T,
// the online softmax on S in registers, and acc += P V on the d-range
// [d0, d0 + DW).  Numerics: fp32 scores, running max m and sum l; P is
// rounded to bf16 before the PV product (it is the A operand of that mma);
// a masked score's p is 0 by select, never by exp(-1e30 - m).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `valid` false zero-fills the destination (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (denormal results flush to 0, which a
// softmax weight below 1e-38 can spare).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Allow `kernel` `bytes` of dynamic shared memory (above 48 KB it must
// ask), once per device: bit d of the caller's `done` marks device d.
template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;  // a race only sets it twice
  return e;
}

// Keys a query at absolute position `pos` may see: [lo, hi), cut to the
// caller's key range [klo, khi).
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange key_range(int pos, int causal, int window, int klo,
                                              int khi) {
  KeyRange r;
  r.lo = window ? max(klo, pos - window + 1) : klo;
  r.hi = causal ? min(khi, pos + 1) : khi;
  return r;
}

// Stage query rows into Qs [pad_rows][DH + 8], pre-scaled by `scale` and
// rounded to bf16 (as layers.attention does).  Row r < nrows is packed row
// row0 + r = (position, group head) of KV head h of batch row b; rows from
// nrows to pad_rows are zero.
template <int DH>
__device__ __forceinline__ void stage_q(bf16* Qs, const bf16* __restrict__ q, int b, int h,
                                        int tq, int hkv, int g, int row0, int nrows,
                                        int pad_rows, float scale) {
  constexpr int LDS = DH + 8, VPR = DH / 8;
  for (int idx = threadIdx.x; idx < pad_rows * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nrows) {
      const int gr = row0 + r, pos = gr / g, head = gr % g;
      const int64_t off =
          ((static_cast<int64_t>(b) * tq + pos) * hkv + h) * g * DH + static_cast<int64_t>(head) * DH + c;
      val = *reinterpret_cast<const uint4*>(q + off);
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDS + c) = val;
  }
}

// Issue the async copy of keys [k0, k0 + BC) of (b, h) into Ks / Vs;
// keys at or past `kend` are zero-filled.
template <int DH, int BC>
__device__ __forceinline__ void load_kv_tile(bf16* Ks, bf16* Vs, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, int b, int h, int tk,
                                             int hkv, int k0, int kend) {
  constexpr int LDS = DH + 8, VPR = DH / 8;
  for (int idx = threadIdx.x; idx < BC * VPR; idx += kThreads) {
    const int jj = idx / VPR, c = (idx % VPR) * 8;
    const int j = k0 + jj;
    const bool ok = j < kend;
    const int64_t off = ok ? ((static_cast<int64_t>(b) * tk + j) * hkv + h) * DH + c : 0;
    cp_async16(Ks + jj * LDS + c, k + off, ok);
    cp_async16(Vs + jj * LDS + c, v + off, ok);
  }
}

// One key tile [k0, k0 + BC) for the 16 rows at Qw (this thread's rows are
// lane / 4 and lane / 4 + 8, with key ranges kr[0], kr[1]).  `masked` is
// false when every key of the tile is allowed for all 16 rows.
template <int DH, int BC, int DW>
__device__ __forceinline__ void attend_tile(const bf16* Qw, const bf16* Ks, const bf16* Vs,
                                            int d0, int k0, bool masked,
                                            const KeyRange (&kr)[2], float (&acc)[DW / 8][4],
                                            float (&m)[2], float (&l)[2]) {
  constexpr int LDS = DH + 8;
  const int lane = threadIdx.x & 31, tig = lane & 3;

  float s[BC / 8][4];
#pragma unroll
  for (int i = 0; i < BC / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, Qw + (lane & 15) * LDS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < BC / 16; ++nb) {
      uint32_t bk[4];
      ldsm_x4(bk, Ks + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                      ((lane >> 3) & 1) * 8);
      mma16816(s[2 * nb], a, bk[0], bk[1]);
      mma16816(s[2 * nb + 1], a, bk[2], bk[3]);
    }
  }

  if (masked) {
#pragma unroll
    for (int nb = 0; nb < BC / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nb * 8 + tig * 2 + (e & 1);
        const KeyRange& r = kr[e >> 1];
        if (j < r.lo || j >= r.hi) s[nb][e] = kNegInf;
      }
  }

  float mlog[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int nb = 0; nb < BC / 8; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mlog[r] = mx * kLog2e;
    const float alpha = exp2_approx((m[r] - mx) * kLog2e);
    m[r] = mx;
    l[r] *= alpha;
#pragma unroll
    for (int db = 0; db < DW / 8; ++db) {
      acc[db][2 * r] *= alpha;
      acc[db][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int nb = 0; nb < BC / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2_approx(fmaf(s[nb][e], kLog2e, -mlog[r]));
      if (masked) {
        const int j = k0 + nb * 8 + tig * 2 + (e & 1);
        if (j < kr[r].lo || j >= kr[r].hi) p = 0.f;
      }
      s[nb][e] = p;
      l[r] += p;
    }

#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int db = 0; db < DW / 16; ++db) {
      uint32_t vb[4];
      ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 15)) * LDS + d0 + db * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * db], pa, vb[0], vb[1]);
      mma16816(acc[2 * db + 1], pa, vb[2], vb[3]);
    }
  }
}

// The backward kernels' (flash_attention_bwd.cu, flash_attention_bwd_wgmma.cu)
// shared pieces.  x rounded to bf16 and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Whether key j is allowed for a query at absolute position pos (written
// without branches, so an unrolled loop of them stays one basic block).
__device__ __forceinline__ bool allowed(int j, int pos, int causal, int window, int kv_len) {
  return (j < kv_len) & (!causal | (j <= pos)) & (!window | (pos - j < window));
}

// Packed query rows [lo, hi) whose positions see some key of [k0, kend).
__device__ __forceinline__ void rows_seeing(int k0, int kend, int tq, int g, int causal,
                                            int window, int q_offset, int& lo, int& hi) {
  int plo = causal ? k0 - q_offset : 0;
  int phi = window ? kend - 1 + window - 1 - q_offset : tq - 1;
  plo = max(plo, 0);
  phi = min(phi, tq - 1);
  lo = plo * g;
  hi = kend > k0 && phi >= plo ? (phi + 1) * g : lo;
}

// The four lanes of a quad hold one row's partial sums: add them.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace fa
