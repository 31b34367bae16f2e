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
// bind both. The design (namespace hop) reads each operand once, keeps
// every intermediate on chip, and overlaps an item's loads and stores
// with another item's products:
//   - a persistent grid, one CTA an SM (the host passes the grid,
//     ops/prefill_attention.py::grid), walks the items (batch row, head,
//     block of 128 query rows), the last query block first when causal;
//   - a CTA is a producer warp and two consumer warpgroups of 64 query
//     rows each. The producer keeps the Q tiles and key-bias rows of two
//     items and a ring of four K / V tiles in flight by TMA on mbarriers,
//     straight from the merged tensors or their strided views (one 4-D
//     tensor map [B, rows, H, 64] an operand, at the caller's batch and
//     row strides, multiples of 16 bytes; the fused qkv slices), so there
//     are no split or merge copies; rows past L or Lk are TMA's zeros;
//   - both products on wgmma: S = Q K^T from shared memory (128-byte
//     swizzle), then p, rounded to bf16, as the A operand from registers
//     of P V with V read MN-major (wgmma_rs);
//   - Lk <= 128 (the self form, which the model gates at L <= 128, and
//     captions up to 128): every key tile's scores stay in registers, so
//     m and z are the exact row max and sum, and p is normalised before
//     it is rounded, as JAX does. 128 < Lk <= 512: two passes over the key
//     tiles, as K5's blk:: walks them: pass 1 takes m and z, pass 2 forms
//     S again and accumulates the rounded p . V (an online softmax would
//     round p before normalising it, which JAX does not);
//   - keys past Lk give -inf (exp is exactly 0); causal: a warpgroup skips
//     the key tiles wholly above its rows (a real row sees its own real
//     key under left padding, so the skipped keys' exp(-1e9 - m) is 0 for
//     every real row). The mask and the scale are applied in log2 units
//     in JAX's order: the causal where (-1e9), then the additive key bias;
//   - the output leaves through a swizzled staging tile by TMA store
//     (rows past L are clipped by the map), which runs while the consumers
//     start the next item.
//
// f32 operands (the fp32 bars only) keep the first design: one CTA of 128
// threads per (batch row, head), query rows in tiles of 32, K and V
// streamed in 64-key chunks as f32, products as f32 FMAs on the CUDA cores
// and the scores in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
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
// bf16: wgmma products, operands by TMA (the note at the top).
namespace hop {

using bf16 = __nv_bfloat16;
using ergm_hopper::bar_sync;
using ergm_hopper::bulk_commit;
using ergm_hopper::bulk_wait;
using ergm_hopper::bulk_wait_read;
using ergm_hopper::fence_async_shared;
using ergm_hopper::mbar_arrive;
using ergm_hopper::mbar_expect;
using ergm_hopper::mbar_fence_init;
using ergm_hopper::mbar_init;
using ergm_hopper::mbar_wait;
using ergm_hopper::pin;
using ergm_hopper::sm_desc;
using ergm_hopper::tma_load_4d;
using ergm_hopper::tma_store_4d;
using ergm_hopper::wg_commit;
using ergm_hopper::wg_fence;
using ergm_hopper::wg_wait;
using ergm_hopper::wgmma_rs;
using ergm_hopper::wgmma_ss;
using ergm_mma::ex2;
using ergm_mma::pack;
using ergm_mma::zero;

constexpr int kThreads = 384;   // a producer warpgroup, two consumer warpgroups
constexpr int kRows = 128;      // query rows an item
constexpr int kOwn = 64;        // query rows a consumer warpgroup owns
constexpr int kQBufs = 2;       // items whose Q tile and key bias are in flight
constexpr int kStages = 4;      // the ring of K / V tiles
constexpr int kResident = 128;  // the most keys whose scores stay in registers
constexpr size_t kAlign = 1024;  // the 128-byte swizzle's pattern
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskL2 = kNegInf * kLog2e;  // JAX's -1e9, in log2 units

// KT: keys a streamed tile (32 where Lk <= 32, else 64); RES tiles of
// them (the keys up to kResident) keep their scores for one pass; smem
// bytes: Q [kQBufs][128][64], the ring of K and V [KT][64] tiles, the
// output's staging [2 warpgroups][2][64][64], the key bias [kQBufs][512]
// f32 and the barriers
template <int KT_>
struct Shape {
  static constexpr int KT = KT_, RES = kResident / KT > 2 ? 1 : kResident / KT;
  static constexpr int kQ = kRows * kDh, kTile = KT * kDh, kOut = kOwn * kDh;  // elements
  static constexpr size_t kSmem = kAlign + 2 * (kQBufs * kQ + kStages * 2 * kTile + 4 * kOut) +
                                  sizeof(float) * kQBufs * kMaxKeys + 8 * (2 * kQBufs + 2 * kStages);
};
using K32 = Shape<32>;
using K64 = Shape<64>;

// The tensor maps: q, k, v [B, rows, H, 64] over the callers' strides
// (boxes of 64 columns by 128 query rows or KT key rows), out [B, L, H,
// 64] (boxes of 64 rows); 128-byte swizzle
struct Maps {
  CUtensorMap q, k, v, out;
};

// An item: query rows [q0, q0 + 128) of head h of batch row b. Items run
// in rank order over every (b, h), the last query block first when causal
// (the longest walks)
struct Item {
  int b, h, q0;
  __device__ Item(const Args& a, int idx, int nqb) {
    const int bh = idx % (a.B * a.H), rank = idx / (a.B * a.H);
    q0 = (a.causal ? nqb - 1 - rank : rank) * kRows;
    b = bh / a.H;
    h = bh % a.H;
  }
};

// The keys query rows [r0, r0 + rows) see: up to the diagonal when causal
__device__ __forceinline__ int key_end(const Args& a, int r0, int rows) {
  return a.causal ? min(a.Lk, r0 + rows) : a.Lk;
}

// k16 step kk of a K-major tile [rows][64] from row0 (the 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int row0, int kk) {
  return sm_desc(t + row0 * kDh + kk * 16, 16, 1024);
}

// k16 step kk of an X-row tile [X][64] read MN-major (V: its rows the depth)
template <int X>
__device__ __forceinline__ uint64_t desc_mn(const bf16* t, int kk) {
  return sm_desc(t + kk * 16 * kDh, X * kDh * 2, 1024);
}

// s = Q . K^T for the warpgroup's 64 rows (from row0 of the Q tile) over a
// KT-key tile; issued and committed, not waited for
template <int KT>
__device__ __forceinline__ void scores(float (&s)[KT / 8][4], const bf16* qt, int row0,
                                       const bf16* kt) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_ss<KT>(s, desc_k(qt, row0, kk), desc_k(kt, 0, kk), kk);
  wg_commit();
}

// JAX's mask on the warp's 16 rows (from rw) of a KT-key score block at k0,
// in log2 units: s * scale, the causal where (-1e9), the additive key bias
// kb (log2 units); keys past Lk give -inf (exp is exactly 0)
template <int KT>
__device__ __forceinline__ void mask_tile(const Args& a, const float* kb, float (&s)[KT / 8][4],
                                          int rw, int k0, float sl2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const int key = k0 + 8 * j + 2 * t;
    const float2 bias = key < a.Lk ? *reinterpret_cast<const float2*>(kb + key)
                                   : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = key + (e & 1), row = rw + g + 8 * (e >> 1);
      float x = s[j][e] * sl2;
      if (a.causal && c > row) x = kMaskL2;
      x += (e & 1) ? bias.y : bias.x;
      s[j][e] = c < a.Lk ? x : -INFINITY;
    }
  }
}

// o += p . V over a KT-key tile: p the warpgroup's 64 x KT block, rounded
// to bf16 as wgmma's A operand in registers; committed, not waited for
template <int KT>
__device__ __forceinline__ void accumulate(float (&o)[kDh / 8][4], const float (&p)[KT / 8][4],
                                           const bf16* vt) {
  unsigned a[KT / 16][4];
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    a[kk][0] = pack(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs<kDh>(o, a[kk], desc_mn<KT>(vt, kk));
  wg_commit();
}

// The row's max and 1/sum from the four lanes that hold it, given each
// lane's max mt and its sum lt of 2^(x - mt)
__device__ __forceinline__ void row_stats(float (&mt)[2], const float (&lt)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float l = lt[r] * ex2(mt[r] - mx);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    mt[r] = mx;
    inv[r] = 1.0f / l;
  }
}

// One CTA an SM walks the items. The producer warp keeps the Q tile and
// key-bias row of kQBufs items and kStages K / V tiles in flight; each
// consumer warpgroup owns 64 query rows of an item. Up to kResident keys
// (RES tiles) the scores stay in registers: S once, the exact row max and
// sum, p rounded, o += p . V. Past that, two passes over the key tiles as
// blk:: walks them: pass 1 streams K and keeps each lane's running max and
// sum, pass 2 streams K and V, forms S again and accumulates the rounded p
// . V. The output leaves through a swizzled staging tile by TMA store,
// which overlaps the next item.
template <class S>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int KT = S::KT, RES = S::RES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kAlign - (ergm_mma::saddr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  bf16* qs = reinterpret_cast<bf16*>(base);  // [kQBufs][128][64]
  bf16* ring = qs + kQBufs * S::kQ;           // [kStages]: K [KT][64], V [KT][64]
  bf16* outs = ring + kStages * 2 * S::kTile;  // [2][2][64][64]
  float* kbias = reinterpret_cast<float*>(outs + 4 * S::kOut);  // [kQBufs][kMaxKeys]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(kbias + kQBufs * kMaxKeys);
  uint64_t* res_free = res_full + kQBufs;
  uint64_t* full = res_free + kQBufs;
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(res_full + i, 33);  // the Q tile's expect_tx and the bias row's 32 lanes
      mbar_init(res_free + i, 8);   // the consumers' eight warps
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nqb = (a.L + kRows - 1) / kRows, items = nqb * a.B * a.H;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 128) {  // the producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    int it = 0;  // ring steps so far
    for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
      const Item m(a, idx, nqb);
      const int buf = w % kQBufs;
      const int n = (key_end(a, m.q0, kRows) + KT - 1) / KT, steps = n > RES ? 2 * n : n;
      mbar_wait(res_free + buf, ((w / kQBufs) + 1) & 1);
      if (lane == 0) {
        mbar_expect(res_full + buf, 2 * S::kQ);
        tma_load_4d(&maps.q, qs + buf * S::kQ, res_full + buf, 0, m.q0, m.h, m.b);
      }
      float* kb = kbias + buf * kMaxKeys;
      const float* mrow = a.mask ? a.mask + static_cast<long long>(m.b) * a.Lk : nullptr;
      for (int j = lane; j < a.Lk; j += 32) kb[j] = mrow ? (1.0f - mrow[j]) * kMaskL2 : 0.0f;
      mbar_arrive(res_full + buf);
      if (lane == 0) {
        for (int i = 0; i < steps; ++i) {  // two passes: 0..n-1 K, n..2n-1 K and V
          const int s = (it + i) % kStages, k0 = (i % n) * KT;
          const bool with_v = steps == n || i >= n;
          bf16* kt = ring + s * 2 * S::kTile;
          mbar_wait(empty + s, (((it + i) / kStages) + 1) & 1);
          mbar_expect(full + s, (with_v ? 2 : 1) * 2 * S::kTile);
          tma_load_4d(&maps.k, kt, full + s, 0, k0, m.h, m.b);
          if (with_v) tma_load_4d(&maps.v, kt + S::kTile, full + s, 0, k0, m.h, m.b);
        }
      }
      it += steps;
      __syncwarp();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1, g = lane >> 2, t = lane & 3;
  const int wi = (threadIdx.x >> 5) & 3;  // the warp in its warpgroup
  const float sl2 = a.scale * kLog2e;
  int it = 0, stores = 0;
  for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
    const Item m(a, idx, nqb);
    const int buf = w % kQBufs;
    const int n = (key_end(a, m.q0, kRows) + KT - 1) / KT;
    const int r0 = m.q0 + kOwn * c, rw = r0 + 16 * wi;  // the warpgroup's and the warp's rows
    const bool active = r0 < a.L;
    const int wend = key_end(a, r0, kOwn);  // the keys the warpgroup's rows see
    const bf16* qt = qs + buf * S::kQ;
    const float* kb = kbias + buf * kMaxKeys;
    float o[kDh / 8][4];
    zero(o);
    mbar_wait(res_full + buf, (w / kQBufs) & 1);
    if (n <= RES) {
      // one pass: every tile's scores, the exact row statistics, p . V
      float sc[RES][KT / 8][4];
#pragma unroll
      for (int i = 0; i < RES; ++i)
        if (i < n) {
          const int s = (it + i) % kStages;
          mbar_wait(full + s, ((it + i) / kStages) & 1);
          if (active && i * KT < wend) scores<KT>(sc[i], qt, kOwn * c, ring + s * 2 * S::kTile);
        }
      wg_wait<0>();
      float mx[2] = {-INFINITY, -INFINITY}, lt[2] = {0.0f, 0.0f}, inv[2];
#pragma unroll
      for (int i = 0; i < RES; ++i)
        if (i < n && active && i * KT < wend) {
          pin(sc[i]);
          mask_tile<KT>(a, kb, sc[i], rw, i * KT, sl2);
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][j][e]);
        }
      if (lane == 0) mbar_arrive(res_free + buf);  // Q and the key bias are read
      if (active) {
        // the row's max over the four lanes that hold it, p = 2^(x - max),
        // the row's sum, then p / sum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
#pragma unroll
        for (int i = 0; i < RES; ++i)
          if (i < n && i * KT < wend)
#pragma unroll
            for (int j = 0; j < KT / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                sc[i][j][e] = ex2(sc[i][j][e] - mx[e >> 1]);
                lt[e >> 1] += sc[i][j][e];
              }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 1);
          lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 2);
          inv[r] = 1.0f / lt[r];
        }
#pragma unroll
        for (int i = 0; i < RES; ++i)
          if (i < n && i * KT < wend) {
#pragma unroll
            for (int j = 0; j < KT / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[i][j][e] *= inv[e >> 1];
            accumulate<KT>(o, sc[i], ring + ((it + i) % kStages) * 2 * S::kTile + S::kTile);
          }
        wg_wait<0>();
        pin(o);
      }
#pragma unroll
      for (int i = 0; i < RES; ++i)
        if (i < n && lane == 0) mbar_arrive(empty + (it + i) % kStages);
      it += n;
    } else {
      // two passes over the key tiles
      float mt[2] = {-INFINITY, -INFINITY}, lt[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
      for (int i = 0; i < 2 * n; ++i, ++it) {
        const int s = it % kStages, k0 = (i < n ? i : i - n) * KT;
        const bf16* kt = ring + s * 2 * S::kTile;
        if (i == n) row_stats(mt, lt, inv);
        mbar_wait(full + s, (it / kStages) & 1);
        if (active && k0 < wend) {
          float sc[KT / 8][4];
          scores<KT>(sc, qt, kOwn * c, kt);
          wg_wait<0>();
          pin(sc);
          mask_tile<KT>(a, kb, sc, rw, k0, sl2);
          if (i < n) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float mx = mt[r];
#pragma unroll
              for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
              float sum = 0.0f;
#pragma unroll
              for (int j = 0; j < KT / 8; ++j)
                sum += ex2(sc[j][2 * r] - mx) + ex2(sc[j][2 * r + 1] - mx);
              lt[r] = lt[r] * ex2(mt[r] - mx) + sum;
              mt[r] = mx;
            }
          } else {
#pragma unroll
            for (int j = 0; j < KT / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][e] = ex2(sc[j][e] - mt[e >> 1]) * inv[e >> 1];
            accumulate<KT>(o, sc, kt + S::kTile);
            wg_wait<0>();
            pin(o);
          }
        }
        if (i == 2 * n - 1 && lane == 0) mbar_arrive(res_free + buf);
        if (lane == 0) mbar_arrive(empty + s);
      }
    }
    if (!active) continue;
    // the warpgroup's 64 rows, rounded, into its staging tile (the
    // 128-byte swizzle: row r's 16-byte chunk j at chunk j ^ (r % 8)),
    // then out by TMA store; rows past L are not written
    bf16* ot = outs + (2 * c + (stores & 1)) * S::kOut;
    if (threadIdx.x % 128 == 0) bulk_wait_read<1>();  // this tile's store of two items ago
    bar_sync(1 + c, 128);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * wi + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < kDh / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ot + row * kDh + ((j ^ g) << 3) + 2 * t) =
            __floats2bfloat162_rn(o[j][2 * hf], o[j][2 * hf + 1]);
    }
    fence_async_shared();
    bar_sync(1 + c, 128);
    if (threadIdx.x % 128 == 0) {
      tma_store_4d(&maps.out, ot, 0, r0, m.h, m.b);
      bulk_commit();
    }
    ++stores;
  }
  if (threadIdx.x % 128 == 0) bulk_wait<0>();
}

// The tensor map of one merged-layout operand, [B, rows, H, 64] over the
// (batch, row) element strides, boxes of 64 columns by box_rows rows
inline bool head_map(CUtensorMap* map, const void* p, long long sb, long long sl, int B,
                     int rows, int H, int box_rows) {
  ergm_hopper::MapArgs m{};
  m.ptr = p;
  m.rank = 4;
  m.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kDh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(kDh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kDh), static_cast<cuuint32_t>(box_rows), 1,
                             1};
  for (int i = 0; i < 4; ++i) {
    m.dims[i] = dims[i];
    m.box[i] = box[i];
    if (i < 3) m.strides[i] = strides[i];
  }
  return ergm_hopper::encode_cached(map, m);
}

template <class S>
cudaError_t run(const Args& a, int grid, cudaStream_t stream, int* info) {
  Maps m;
  const int hd = a.H * kDh;
  if (!head_map(&m.q, a.q, a.q_sb, a.q_sl, a.B, a.L, a.H, kRows) ||
      !head_map(&m.k, a.k, a.k_sb, a.k_sl, a.B, a.Lk, a.H, S::KT) ||
      !head_map(&m.v, a.v, a.v_sb, a.v_sl, a.B, a.Lk, a.H, S::KT) ||
      !head_map(&m.out, a.out, static_cast<long long>(a.L) * hd, hd, a.B, a.L, a.H, kOwn))
    return cudaErrorInvalidValue;
  cudaError_t err = ergm_hopper::smem_limit(kernel<S>, S::kSmem);
  if (err != cudaSuccess) return err;
  kernel<S><<<grid, kThreads, S::kSmem, stream>>>(m, a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    info[0] = grid;
    info[1] = (a.L + kRows - 1) / kRows * a.B * a.H;
    info[2] = S::KT;
  }
  return err;
}

// TMA reads the operands at their own strides: every stride and base
// address must be a multiple of 16 bytes (8 elements). info receives the
// grid the kernel started with, the items it walks and its key tile.
cudaError_t launch(const Args& a, int grid, cudaStream_t stream, int* info) {
  const long long st[6] = {a.q_sb, a.q_sl, a.k_sb, a.k_sl, a.v_sb, a.v_sl};
  for (long long x : st)
    if (x % 8) return cudaErrorInvalidValue;
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  const int items = (a.L + kRows - 1) / kRows * a.B * a.H;
  if (grid < 1 || grid > items) return cudaErrorInvalidValue;
  return a.Lk <= 32 ? run<K32>(a, grid, stream, info) : run<K64>(a, grid, stream, info);
}

}  // namespace hop

}  // namespace ergm_prefill

// dtype: 0 = float32, 1 = bfloat16. grid: the bf16 kernel's CTAs (the
// host's plan, ops/prefill_attention.py::grid); info (three ints) receives
// the grid a bf16 launch started with, the items it walks and its key tile
// (zeros in fp32). Returns a cudaError_t (0 on success).
extern "C" int ergm_prefill_mha(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int dtype, int B,
                                int L, int Lk, int H, int q_sb, int q_sl,
                                int k_sb, int k_sl, int v_sb, int v_sl,
                                float scale, int causal, int grid, int* info,
                                void* stream) {
  using namespace ergm_prefill;
  info[0] = info[1] = info[2] = 0;
  Args a{q, k, v, static_cast<const float*>(mask), out, B, L, Lk, H,
         q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, causal, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lk < 1 || Lk > kMaxKeys || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(f32::launch(a, s));
  if (dtype == 1) return static_cast<int>(hop::launch(a, grid, s, info));
  return static_cast<int>(cudaErrorInvalidValue);
}
