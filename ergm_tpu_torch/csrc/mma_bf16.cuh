// Tensor-core building blocks for bf16 (sm_80 and later, used on sm_90a),
// shared by the attention kernels K1 and K7 (its wide:: kernels) and the
// cross-entropy GEMM K6, and, for pack, ex2, zero and store_rows, by the
// wgmma kernels of K5 and K7: ldmatrix loads of 8 x 8 b16 matrices from
// shared memory (plain and transposed), the mma.sync m16n8k16 product (bf16
// in, f32 accumulate), and the attention kernels' 16-row warp products over
// head tiles DH wide (a multiple of 16; K1 and the defaults: 64; K7's wide
// heads: slices of 128).
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane (g, t) = (lane / 4,
// lane % 4) holds the accumulator's c[0..1] at row g, columns 2t, 2t + 1
// and c[2..3] at row g + 8; the A operand's a[0..3] are the 8 x 8 blocks
// (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15,
// k 8-15), each lane holding two values of a row; so an accumulator tile
// 16 x 16, rounded and packed in pairs, is the A operand of the next
// product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace ergm_mma {

using bf16 = __nv_bfloat16;

constexpr int kDh = 64;        // head dim of the attention kernels (K1; K5's default)
// A head tile's row stride: DH + 8 elements (144-byte rows at DH = 64; 80,
// 208 and 272 at 32, 96 and 128), so that ldmatrix's 8 rows hit 8 distinct
// bank groups and every row starts on a 16-byte boundary for cp.async
template <int DH>
__host__ __device__ constexpr int ld_of() {
  return DH + 8;
}
constexpr int kLd = ld_of<kDh>();

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the rows of matrix i. No
// memory clobber: the barriers order them, and other loads may pass them.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Stage N rows (DH bf16 each, row stride sl) into a [N][ld_of<DH>()] tile
// by cp.async with kThreads threads; the caller commits.
template <int N, int kThreads, int DH = kDh>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long sl) {
  constexpr int kChunks = DH / 8;  // 16-byte copies a row
  constexpr int kLdT = ld_of<DH>();
  static_assert((N * kChunks) % kThreads == 0, "whole rows per pass");
#pragma unroll
  for (int i = 0; i < N * kChunks / kThreads; ++i) {
    const unsigned idx = threadIdx.x + i * kThreads;  // unsigned: a shift where kChunks is 8
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    ergm_async::copy16(dst + r * kLdT + c, src + r * sl + c);
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// c[j] += A . B^T over DH for A = rows [ar, ar + 16) of tile ta and B = the
// 32 rows at c0 of tile tb (8 columns per j; both DH-contiguous). Each
// k16 step loads its fragments first, then issues its 4 independent products.
template <int DH = kDh>
__device__ __forceinline__ void prod_nt_acc(float (&c)[4][4], const bf16* ta, int ar,
                                            const bf16* tb, int c0) {
  constexpr int kLd = ld_of<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned af[4], bf[2][4];
    ldsm4(af, saddr(ta + (ar + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp)
      ldsm4(bf[jp], saddr(tb + (c0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                          ((lane >> 3) & 1) * 8));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      mma(c[2 * jp], af, bf[jp][0], bf[jp][1]);
      mma(c[2 * jp + 1], af, bf[jp][2], bf[jp][3]);
    }
  }
}

// c[j] = A . B^T, as prod_nt_acc from zero.
template <int DH = kDh>
__device__ __forceinline__ void prod_nt(float (&c)[4][4], const bf16* ta, int ar, const bf16* tb,
                                        int c0) {
  zero(c);
  prod_nt_acc<DH>(c, ta, ar, tb, c0);
}

// acc[j] (j < DH / 8: DH in groups of 8) += P . B, for P the warp's 16 x
// 32 block x (accumulator layout, rounded to bf16 here: the A operand
// straight from registers) and B = the 32 rows at r0 of tile tb
// (DH-contiguous). The B fragments come in groups of up to 64 columns (4
// x4 loads, then their 8 products), so that a wide head holds no more of
// them in registers at once than a 64-wide one.
template <int DH = kDh>
__device__ __forceinline__ void prod_nn(float (&acc)[DH / 8][4], const float (&x)[4][4],
                                        const bf16* tb, int r0) {
  constexpr int kLd = ld_of<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    const unsigned pf[4] = {pack(x[2 * kc][0], x[2 * kc][1]), pack(x[2 * kc][2], x[2 * kc][3]),
                            pack(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                            pack(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int d0 = 0; d0 < DH / 16; d0 += 4) {
      constexpr int kAll = DH / 16;
      unsigned bf[4][4];
#pragma unroll
      for (int dp = 0; dp < 4; ++dp)
        if (d0 + dp < kAll)
          ldsm4t(bf[dp], saddr(tb + (r0 + kc * 16 + (lane & 15)) * kLd + (d0 + dp) * 16 +
                               (lane >> 4) * 8));
#pragma unroll
      for (int dp = 0; dp < 4; ++dp)
        if (d0 + dp < kAll) {
          mma(acc[2 * (d0 + dp)], pf, bf[dp][0], bf[dp][1]);
          mma(acc[2 * (d0 + dp) + 1], pf, bf[dp][2], bf[dp][3]);
        }
    }
  }
}

// The lane's rows r, r + 8 of the warp's 16 x DH f32 block, times mul,
// rounded to bf16, to rows of one head.
template <int DH = kDh>
__device__ __forceinline__ void store_rows(bf16* dst, long long sl, int r,
                                           const float (&acc)[DH / 8][4], float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = dst + static_cast<long long>(r + 8 * i) * sl;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
  }
}

}  // namespace ergm_mma
