// Prefill attention for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces ergm_tpu/ops/prefill_attention.py::_call (body _kernel), the
// Pallas kernel behind prefill_mha. It computes attention over
// merged-layout operands, q [B, L, H*64] and k/v [B, Lk, H*64], in two
// forms: causal (the prompt's self-attention prefill) and rectangular
// non-causal (cross-attention over the caption). The math and its
// rounding points are JAX's:
//   s = (q . k) * scale in f32;
//   causal form: s = where(kpos <= qpos, s, -1e9);
//   s += (1 - mask) * -1e9;
//   p = exp(s - m) / z with m and z taken over the whole row;
//   p rounded to v's dtype, out = sum_k p * v accumulated in f32,
//   rounded to the input dtype.
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s bf16 dense,
// 3.35 TB/s HBM). At the slice's self form, B=256, L=Lk=128, D=768, one
// layer's causal products are 2*2*B*H*L*(L+1)/2*64 = 6.5 GFLOP, 7 us on the
// tensor cores, and its q/k/v/out traffic is 4*B*L*D*2 bytes = 201 MB,
// 60 us at the HBM rate; the cross form (Lk=32) moves 126 MB, 37 us: bytes
// bind both. The design reads each operand once and keeps every
// intermediate on chip:
//   - one CTA of 8 warps per (batch row, head, block of 128 query rows),
//     a warp per 16 rows; q, k and v arrive by cp.async, 16 bytes a copy,
//     at head stride straight from the merged tensors or their strided
//     views (the fused qkv slices), no split or merge copies;
//   - both products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with operands from shared memory by ldmatrix (.trans for
//     V), the fragment helpers of mma_bf16.cuh shared with K5;
//   - Lk <= 128 (the self form, which the model gates at L <= 128, and
//     captions up to 128): the whole key set is staged (K, then V in a
//     second copy group that lands while QK^T and the softmax run), and a
//     row's scores stay in the product's accumulator registers: exact m
//     and z, then p normalised, rounded and packed as the A operand of PV.
//     Nothing of the scores is stored;
//   - 128 < Lk <= 512: keys stream in 64-key tiles through a two-stage
//     ring and are walked twice, as in K5: pass 1 takes m and z, pass 2
//     recomputes s and accumulates the rounded p . V (an online softmax
//     would round p before normalising it, which JAX does not);
//   - causal: a warp skips the 32-key blocks above its rows' diagonal (a
//     real row sees its own real key under left padding, so the skipped
//     keys' exp(-1e9 - m) is 0 for every real row);
//   - the output goes through shared memory so that the merged rows are
//     written 16 bytes a copy.
//
// f32 operands (the fp32 bars only) keep the first design: one CTA of 128
// threads per (batch row, head), query rows in tiles of 32, K and V
// streamed in 64-key chunks as f32, products as f32 FMAs on the CUDA cores
// and the scores in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace ergm_prefill {

constexpr int kDh = 64;             // head dim (the GPT-2 family)
constexpr float kNegInf = -1e9f;    // the large-negative fill of JAX's math
constexpr int kMaxKeys = 512;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [B, Lk] 1 = real key, or null
  void* out;          // [B, L, H*64], contiguous
  int B, L, Lk, H;
  int q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // batch and row strides, in elements
  float scale;
  int causal;
  int score_stride;  // f32 row stride of the score tile (f32 kernel)
};

// ---------------------------------------------------------------------------
// f32: CUDA-core products, scores in shared memory.
namespace f32 {

constexpr int kQT = 32;             // query rows per tile
constexpr int kCK = 64;             // keys per staged K/V chunk
constexpr int kThreads = 128;
constexpr int kRowPad = kDh + 1;    // f32 row stride of the q and k/v tiles

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

// Stage rows [row0, row0 + n) of one head of a merged operand into an f32
// tile with row stride kRowPad; rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row_stride,
                                      int row0, int n, int tile_rows) {
  for (int i = threadIdx.x; i < tile_rows * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh;
    dst[r * kRowPad + d] =
        r < n ? Cvt<T>::load(src + static_cast<long long>(row0 + r) * row_stride + d)
              : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) prefill_mha_kernel(Args a) {
  extern __shared__ float smem[];
  const int ss = a.score_stride;
  float* qs = smem;                 // [kQT][kRowPad] query tile
  float* kvs = qs + kQT * kRowPad;  // [kCK][kRowPad] K or V chunk
  float* sc = kvs + kCK * kRowPad;  // [kQT][ss] scores, then probabilities
  float* kb = sc + kQT * ss;        // [Lk] additive key bias

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 4, tc = tid & 15;
  const T* q = static_cast<const T*>(a.q) + static_cast<long long>(b) * a.q_sb + h * kDh;
  const T* k = static_cast<const T*>(a.k) + static_cast<long long>(b) * a.k_sb + h * kDh;
  const T* v = static_cast<const T*>(a.v) + static_cast<long long>(b) * a.v_sb + h * kDh;
  const int out_sl = a.H * kDh;
  T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * a.L * out_sl + h * kDh;

  for (int j = tid; j < a.Lk; j += kThreads)
    kb[j] = a.mask ? (1.0f - a.mask[static_cast<long long>(b) * a.Lk + j]) * kNegInf : 0.0f;

  for (int r0 = 0; r0 < a.L; r0 += kQT) {
    const int rows = min(kQT, a.L - r0);
    // Keys past the tile's last row are causally masked for every row of
    // the tile. A row with a visible real key has exp(-1e9 - m) == 0 in
    // f32 for them, so skipping them changes no real row's result.
    const int kend = a.causal ? min(a.Lk, r0 + rows) : a.Lk;
    __syncthreads();  // the previous tile is done with qs, kvs and sc
    stage(qs, q, a.q_sl, r0, rows, kQT);

    // pass 1a: scores for the tile, chunk by chunk
    for (int c0 = 0; c0 < kend; c0 += kCK) {
      const int n = min(kCK, kend - c0);
      __syncthreads();  // qs is written; kvs is free
      stage(kvs, k, a.k_sl, c0, n, kCK);
      __syncthreads();
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < kDh; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(tr + 8 * i) * kRowPad + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kvs[(tc + 16 * j) * kRowPad + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = c0 + tc + 16 * j;
          if (tc + 16 * j < n) {
            float s = acc[i][j] * a.scale;
            if (a.causal && key > r0 + r) s = kNegInf;
            sc[r * ss + key] = s + kb[key];
          }
        }
      }
    }
    __syncthreads();

    // pass 1b and 2a: row max and sum in f32, then p rounded to v's dtype
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* srow = sc + r * ss;
      float m = -INFINITY;
      for (int j = lane; j < kend; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float z = 0.0f;
      for (int j = lane; j < kend; j += 32) z += expf(srow[j] - m);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
      for (int j = lane; j < kend; j += 32) srow[j] = Cvt<T>::round(expf(srow[j] - m) / z);
    }

    // pass 2b: out = p . v with f32 accumulation
    float acc[4][4] = {};
    for (int c0 = 0; c0 < kend; c0 += kCK) {
      const int n = min(kCK, kend - c0);
      __syncthreads();  // probabilities are written; kvs is free
      stage(kvs, v, a.v_sl, c0, n, kCK);
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        float p[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sc[(tr + 8 * i) * ss + c0 + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = kvs[j * kRowPad + tc + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p[i], vv[e], acc[i][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 8 * i;
      if (r < rows) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Cvt<T>::store(out + static_cast<long long>(r0 + r) * out_sl + tc + 16 * e, acc[i][e]);
      }
    }
  }
}

cudaError_t launch(Args a, cudaStream_t stream) {
  // Score rows padded to 16 mod 32 floats: the two rows a warp touches
  // fall in opposite halves of the 32 banks.
  a.score_stride = (a.Lk + 31) / 32 * 32 + 16;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQT + kCK) * kRowPad +
                       static_cast<size_t>(kQT) * a.score_stride + a.Lk);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mha_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  prefill_mha_kernel<float><<<a.B * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync), scores in registers.
namespace tc {

using bf16 = __nv_bfloat16;
using ergm_mma::kLd;  // 144-byte tile rows: ldmatrix's 8 rows hit 8 bank groups
using ergm_mma::ldsm4t;
using ergm_mma::mma;
using ergm_mma::pack;
using ergm_mma::prod_nt;
using ergm_mma::saddr;

constexpr int kThreads = 256;  // 8 warps of 16 query rows
constexpr int kRows = 128;     // query rows per CTA
constexpr int kResident = 128; // the most keys staged whole
constexpr int kTile = 64;      // keys per ring stage beyond that
constexpr int kSub = 32;       // keys per warp product
constexpr float kLog2e = 1.4426950408889634f;
// q, k and v tiles of 128 rows (k and v: the whole key set, or the ring's
// two 64-key stages), then the additive key bias of up to 512 keys
constexpr size_t kTileBytes = sizeof(bf16) * kRows * kLd;
constexpr size_t kSmem = 3 * kTileBytes + sizeof(float) * kMaxKeys;

// rows [row0, row0 + n) of one head (row stride sl, rows past `last`
// clamped to it: their scores are masked or their rows not written) into a
// [n][kLd] tile by cp.async; the caller commits
template <int N>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long sl, int row0,
                                      int last) {
  static_assert((N * 8) % kThreads == 0, "whole rows per pass");
#pragma unroll
  for (int i = 0; i < N * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = (idx & 7) * 8;
    ergm_async::copy16(dst + r * kLd + c, src + min(row0 + r, last) * sl + c);
  }
}

// JAX's mask on the warp's 16 x 32 score block at keys c0.. (accumulator
// layout, rows from r0): s * scale, the causal where, the additive key
// bias; keys past Lk are -inf (exp gives exactly 0).
__device__ __forceinline__ void mask_scores(const Args& a, const float* kb, float (&sc)[4][4],
                                            int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c0 + 8 * j + 2 * t + (e & 1), row = r0 + g + 8 * (e >> 1);
      float x = sc[j][e] * a.scale;
      if (key >= a.Lk) {
        x = -INFINITY;
      } else {
        if (a.causal && key > row) x = kNegInf;
        x += kb[key];
      }
      sc[j][e] = x;
    }
}

// The lane's two rows' maxima and sums of exp(s - max) over a 16 x 32 block
__device__ __forceinline__ void row_stats(const float (&sc)[4][4], float (&mt)[2], float (&lt)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = mt[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sum += ergm_mma::ex2((sc[j][2 * i] - mx) * kLog2e) +
             ergm_mma::ex2((sc[j][2 * i + 1] - mx) * kLog2e);
    lt[i] = lt[i] * ergm_mma::ex2((mt[i] - mx) * kLog2e) + sum;
    mt[i] = mx;
  }
}

// The row's m and 1/z from the four lanes that hold it
__device__ __forceinline__ void reduce_rows(const float (&mt)[2], const float (&lt)[2],
                                            float (&m)[2], float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float l = lt[i] * ergm_mma::ex2((mt[i] - mx) * kLog2e);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    m[i] = mx;
    inv[i] = 1.0f / l;
  }
}

// p = exp(s - m) / z, rounded to bf16 and packed as the A operand of PV
// (two k16 halves of the 32 keys)
__device__ __forceinline__ void probs(const float (&sc)[4][4], const float (&m)[2],
                                      const float (&inv)[2], unsigned (&pf)[2][4]) {
  float p[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[j][e] = ergm_mma::ex2((sc[j][e] - m[e >> 1]) * kLog2e) * inv[e >> 1];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    pf[kc][0] = pack(p[2 * kc][0], p[2 * kc][1]);
    pf[kc][1] = pack(p[2 * kc][2], p[2 * kc][3]);
    pf[kc][2] = pack(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pf[kc][3] = pack(p[2 * kc + 1][2], p[2 * kc + 1][3]);
  }
}

// o (16 x 64) += P (16 x 32, packed) . V rows [r0, r0 + 32) of tile vt
__device__ __forceinline__ void pv(float (&o)[8][4], const unsigned (&pf)[2][4], const bf16* vt,
                                   int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    unsigned bf[4][4];
#pragma unroll
    for (int dp = 0; dp < 4; ++dp)
      ldsm4t(bf[dp], saddr(vt + (r0 + kc * 16 + (lane & 15)) * kLd + dp * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      mma(o[2 * dp], pf[kc], bf[dp][0], bf[dp][1]);
      mma(o[2 * dp + 1], pf[kc], bf[dp][2], bf[dp][3]);
    }
  }
}

template <bool kWhole>
__global__ void __launch_bounds__(kThreads, 2) kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [128][kLd]
  bf16* ks = qs + kRows * kLd;               // [128][kLd], or [2][64][kLd]
  bf16* vs = ks + kRows * kLd;               // the same
  float* kb = reinterpret_cast<float*>(vs + kRows * kLd);  // [Lk]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const bf16* q = static_cast<const bf16*>(a.q) + static_cast<long long>(b) * a.q_sb + h * kDh;
  const bf16* k = static_cast<const bf16*>(a.k) + static_cast<long long>(b) * a.k_sb + h * kDh;
  const bf16* v = static_cast<const bf16*>(a.v) + static_cast<long long>(b) * a.v_sb + h * kDh;
  // keys the CTA and the warp walk: up to the diagonal when causal
  const int kend = a.causal ? min(a.Lk, q0 + kRows) : a.Lk;
  const int wend = a.causal ? min(a.Lk, r0 + 16) : a.Lk;

  for (int j = threadIdx.x; j < a.Lk; j += kThreads)
    kb[j] = a.mask ? (1.0f - a.mask[static_cast<long long>(b) * a.Lk + j]) * kNegInf : 0.0f;
  stage<kRows>(qs, q, a.q_sl, q0, a.L - 1);

  float o[8][4];
  ergm_mma::zero(o);
  float mt[2] = {-INFINITY, -INFINITY}, lt[2] = {0.0f, 0.0f}, m[2], inv[2];
  if constexpr (kWhole) {
    // K (with q) and V in two copy groups; 32-key blocks past kend unread
#pragma unroll
    for (int u = 0; u < kResident / kSub; ++u)
      if (u * kSub < kend) stage<kSub>(ks + u * kSub * kLd, k, a.k_sl, u * kSub, a.Lk - 1);
    ergm_async::commit();
#pragma unroll
    for (int u = 0; u < kResident / kSub; ++u)
      if (u * kSub < kend) stage<kSub>(vs + u * kSub * kLd, v, a.v_sl, u * kSub, a.Lk - 1);
    ergm_async::commit();
    ergm_async::wait<1>();
    __syncthreads();
    float sc[kResident / kSub][4][4];
#pragma unroll
    for (int u = 0; u < kResident / kSub; ++u)
      if (u * kSub < wend) {
        prod_nt(sc[u], qs, warp * 16, ks, u * kSub);
        mask_scores(a, kb, sc[u], r0, u * kSub);
        row_stats(sc[u], mt, lt);
      }
    reduce_rows(mt, lt, m, inv);
    ergm_async::wait<0>();
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kResident / kSub; ++u)
      if (u * kSub < wend) {
        unsigned pf[2][4];
        probs(sc[u], m, inv, pf);
        pv(o, pf, vs, u * kSub);
      }
  } else {
    // steps 0..n-1: pass 1 over the 64-key tiles (K); n..2n-1: pass 2 (K, V)
    const int n = (kend + kTile - 1) / kTile;
    auto issue = [&](int s) {
      if (s < 2 * n) {
        const int k0 = (s < n ? s : s - n) * kTile;
        stage<kTile>(ks + (s & 1) * kTile * kLd, k, a.k_sl, k0, a.Lk - 1);
        if (s >= n) stage<kTile>(vs + (s & 1) * kTile * kLd, v, a.v_sl, k0, a.Lk - 1);
      }
      ergm_async::commit();
    };
    issue(0);
    for (int s = 0; s < 2 * n; ++s) {
      const int k0 = (s < n ? s : s - n) * kTile;
      issue(s + 1);
      ergm_async::wait<1>();
      __syncthreads();
      if (s == n) reduce_rows(mt, lt, m, inv);
      const bf16* kt = ks + (s & 1) * kTile * kLd;
      const bf16* vt = vs + (s & 1) * kTile * kLd;
#pragma unroll
      for (int u = 0; u < kTile / kSub; ++u) {
        const int c0 = k0 + u * kSub;
        if (c0 < wend) {
          float sc[4][4];
          prod_nt(sc, qs, warp * 16, kt, u * kSub);
          mask_scores(a, kb, sc, r0, c0);
          if (s < n) {
            row_stats(sc, mt, lt);
          } else {
            unsigned pf[2][4];
            probs(sc, m, inv, pf);
            pv(o, pf, vt, u * kSub);
          }
        }
      }
      __syncthreads();
    }
  }

  // the warp's 16 output rows, rounded, through its own q rows (only this
  // warp read them) so that each row leaves as eight 16-byte copies
  __syncwarp();
  bf16* os = qs + warp * 16 * kLd;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * i) * kLd + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * i], o[j][2 * i + 1]);
  __syncwarp();
  const int out_sl = a.H * kDh;
  bf16* out = static_cast<bf16*>(a.out) + static_cast<long long>(b) * a.L * out_sl + h * kDh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 4 + (lane >> 3), c = (lane & 7) * 8;
    if (r0 + r < a.L)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(r0 + r) * out_sl + c) =
          *reinterpret_cast<const uint4*>(os + r * kLd + c);
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto fn = a.Lk <= kResident ? kernel<true> : kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  fn<<<dim3((a.L + kRows - 1) / kRows, a.H, a.B), kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace ergm_prefill

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int ergm_prefill_mha(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int dtype, int B,
                                int L, int Lk, int H, int q_sb, int q_sl,
                                int k_sb, int k_sl, int v_sb, int v_sl,
                                float scale, int causal, void* stream) {
  using namespace ergm_prefill;
  Args a{q, k, v, static_cast<const float*>(mask), out, B, L, Lk, H,
         q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, causal, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lk < 1 || Lk > kMaxKeys || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(f32::launch(a, s));
  if (dtype == 1) return static_cast<int>(tc::launch(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
