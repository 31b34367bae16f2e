// Softmax cross-entropy over the tied vocab projection, forward and
// backward, for Hopper (sm_90a): kernel K6 of the port.
//
// Replaces ergm_tpu/ops/fused_ce.py::_fwd_impl and ::_vjp_bwd, the Pallas
// kernels behind fused_softmax_xent (bodies _fwd_kernel, _bwd_dh_kernel,
// _bwd_dw_kernel and _padj). For hidden h [N, D], the vocab table W [V, D]
// and labels [N], the loss needs two numbers per token, logZ = logsumexp_v
// (h . W_v) and the gold logit, and the gradient is
//   padj[n, v] = (v < V ? exp(s[n, v] - logZ[n]) : 0) * g[n] - [v == label[n]] g[n],
//   dh = padj . W, dW = padj^T . h,
// with padj rounded to h's type before both products (JAX's _padj). The
// [N, V] logits never reach device memory. Labels < 0 get zero gradient
// (their g is taken as 0) and the NLL logZ.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).
// At the training slice, N = 48*512 = 24,576 tokens, V = 50,271, D = 768,
// the forward is one product of 2NVD = 1.9 TFLOP (1.92 ms on the tensor
// cores) and the backward three (the logits again, dh and dW: 5.76 ms),
// while h is 38 MB and W 77 MB: operations bind, by far. So they do at
// gpt2-large's N = 6,144, D = 1,280 (bounds 0.80 / 2.40 ms) and gpt2-xl's
// N = 2,048, D = 1,600 (0.33 / 1.00 ms), where chip_smoke.py measured
// 1.257 / 4.735 and 0.583 / 2.399 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// bf16 design (gemm::): every product is one hand-written GEMM with CTA
// tiles of 128 rows by 256 columns (192 where the output is D = 768 wide)
// and 64 deep, and three epilogues:
//   forward: S = h W^T; each tile reduces its 256 vocab columns to a
//     (max, sum of exp, gold logit) partial per token, and a second kernel
//     combines a token's partials in a fixed order into logZ and the NLL;
//   backward, per vocab chunk of C columns (C = 8192 by default), in order
//     on the stream: (1) S_c = h W_c^T with an epilogue that writes padj_c,
//     rounded to bf16, into a [N, C] scratch (403 MB at the slice);
//     (2) dh += padj_c W_c, the epilogue adding into one [N, D] f32 buffer
//     (75 MB; the last chunk rounds it to bf16); (3) dW_c = padj_c^T h over
//     all N, rounded once.
// The backward forms 3 products where recomputing the logits for dh and dW
// separately takes 4; no kernel uses atomics, so the result does not depend
// on scheduling. The mainloop (wg_kernel) is Hopper's: a producer
// warpgroup whose one thread keeps a four-stage ring of TMA loads in flight
// (128-byte swizzle, mbarriers counting the bytes), and two consumer
// warpgroups of 64 rows each issuing wgmma m64nNk16 straight from shared
// memory, operands stored MN-major (W_c in (2), padj_c and h in (3)) read
// with wgmma's transpose flag, so no operand is transposed in memory. The
// kernel is persistent, one CTA per SM over the output tiles, so the
// producer loads the next tile while the consumers run this one's
// epilogue. An mma.sync m16n8k16 mainloop fed by a cp.async ring ran the
// same products 1.8-2.1x slower on the card (PERF.md) and was not kept.
//
// f32 operands (the fp32 bars only; f32::) keep the first design: one CTA
// per 16-row resident tile, streaming the other table in 32-row tiles,
// f32 FMAs on the CUDA cores in order (the backward's long sums tile by
// tile). Both operands come in slices of 256 columns, the resident rows
// restaged for every streamed tile (twice in the backward: once for the
// logits, once for the product with padj), so shared memory does not grow
// with D (54 KB). The backward's [16, D] sum lives in registers, each
// thread's share at most 8 columns by 16 rows: a grid axis splits D into
// column groups of kGroup = 2048, each CTA recomputing its tile's logits
// over the whole width for its own group (3 groups at D = 5,120).
//
// Widths: D any multiple of 64 (JAX's kernel takes any D; the wrapper,
// ops/fused_ce.py, pads h and W with zero columns to the next multiple of
// 64 and slices dh and dW back, which is exact). The bf16 products stream
// D in whole 64-deep stages: a last stage partly past D (its out-of-bounds
// columns zero-filled by the TMA) made the products 1.3-1.5x slower at
// D = 776 than the same products padded to 832 on an H100 (chip_smoke.py's
// K6 rows; PERF.md). The dh and dW products tile D in 192-column tiles,
// the last one partly past D at widths that 192 does not divide (1,280
// runs 7 tiles, 1,600 9, 2,560 14, 4,096 22, 5,120 27, 64 one): the
// overhang is computed on zero-filled loads and not written. dh's sum over
// the vocab chunks is one [N, D] f32 buffer (42 MB at N = 2,048, D =
// 5,120). The f32 route streams D in 256-column slices, the last one
// ragged.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace ergm_xent {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// D: a multiple of 64, the bf16 mainloop's stage depth
inline bool width_ok(int D) { return D % 64 == 0 && D >= 64; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products in order.
namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int R = 16;         // resident rows per CTA
constexpr int M = 32;         // streamed rows per tile
constexpr int KS = kThreads;  // columns of a streamed slice: one per thread
constexpr int kPer = R * M / kThreads;  // logits of a tile per thread
constexpr int kCols = 8;                // backward: output slices per thread
constexpr int kGroup = kCols * KS;      // backward: columns of a CTA's group

enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

struct Args {
  const float* h;     // [N, D]
  const float* w;     // [V, D]
  const int* labels;  // [N]
  const float* logz;  // [N] (backward)
  const float* g;     // [N] cotangent of the NLL (backward)
  float* nll;         // [N] (forward)
  float* logz_out;    // [N] (forward)
  float* out;         // dh [N, D] or dW [V, D]
  int N, V, D;
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// One slice of KS columns of the resident rows and of the streamed tile
// (stride KS + 1: conflict-free column reads), the logit and padj tiles and
// the streamed tokens' label, logZ and cotangent: 54 KB whatever D is.
struct Layout {
  static constexpr int ldt = KS + 1, lds = M + 1;
  static constexpr size_t res = 0;
  static constexpr size_t str = align128(res + sizeof(float) * R * ldt);
  static constexpr size_t s = align128(str + sizeof(float) * M * ldt);
  static constexpr size_t p = align128(s + sizeof(float) * R * lds);
  static constexpr size_t vec = align128(p + sizeof(float) * R * lds);
  static constexpr size_t total = vec + 3 * sizeof(float) * M;
};

// Columns [c0, c0 + width) of rows [row0, row0 + rows) of a [limit, D] table
// into a tile of stride ld, 16 bytes at a time through registers; rows past
// the table are zero.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int row0,
                                           int limit, int rows, int D, int c0, int width) {
  const int per = width / 4;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i % per) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < limit)
      val = *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * D + c0 + c);
    dst[r * ld + c] = val.x;
    dst[r * ld + c + 1] = val.y;
    dst[r * ld + c + 2] = val.z;
    dst[r * ld + c + 3] = val.w;
  }
}

// Per-token label, logZ and cotangent of tokens [n0, n0 + rows): padded
// tokens and negative labels get cotangent 0.
__device__ __forceinline__ void stage_tokens(const Args& a, int n0, int rows, int* lbl,
                                             float* lz, float* g, bool backward) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int n = n0 + i;
    const bool real = n < a.N;
    lbl[i] = real ? a.labels[n] : -1;
    if (backward) {
      lz[i] = real ? a.logz[n] : 0.0f;
      g[i] = (real && lbl[i] >= 0) ? a.g[n] : 0.0f;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) xent_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout;
  const int D = a.D;
  float* res = reinterpret_cast<float*>(smem + L::res);
  float* str = reinterpret_cast<float*>(smem + L::str);
  float* s = reinterpret_cast<float*>(smem + L::s);
  float* p = reinterpret_cast<float*>(smem + L::p);
  int* lbl = reinterpret_cast<int*>(smem + L::vec);
  float* lz = reinterpret_cast<float*>(lbl + M);
  float* gg = lz + M;

  const int r0 = blockIdx.x * R;
  const int g0 = blockIdx.y * kGroup;  // backward: this CTA's column group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr bool vocab_rows = MODE == kDw;
  const float* resident = vocab_rows ? a.w : a.h;
  const int res_limit = vocab_rows ? a.V : a.N;
  const float* streamed = vocab_rows ? a.h : a.w;
  if (!vocab_rows) stage_tokens(a, r0, R, lbl, lz, gg, MODE == kDh);

  // forward: online max, sum and gold logit of this warp's token rows
  constexpr int kRows = R / kWarps;
  float m[kRows], l[kRows], gold[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
    gold[i] = 0.0f;
  }
  // backward: the group's [R, kGroup] f32 sum, thread t holding columns
  // g0 + t + KS c
  float facc[R][kCols];
  if constexpr (MODE != kFwd) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) facc[r][c] = 0.0f;
  }

  const int limit = vocab_rows ? a.N : a.V;
  for (int t0 = 0; t0 < limit; t0 += M) {
    // s[R x M] = res[R x D] . str[M x D]^T, the depth in slices of KS
    // columns: each logit's slice summed in column order on its own, then
    // added to the slices before it (one serial f32 sum over D = 4,096 put
    // dW 3e-5 from the plain version, past its fp32 bar)
    float sacc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) sacc[q] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += KS) {
      const int width = min(KS, D - k0);
      __syncthreads();  // the previous slice (or tile) is done with res, str, s and p
      stage_rows(res, L::ldt, resident, r0, res_limit, R, D, k0, width);
      stage_rows(str, L::ldt, streamed, t0, limit, M, D, k0, width);
      if (vocab_rows && k0 == 0) stage_tokens(a, t0, M, lbl, lz, gg, true);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int idx = threadIdx.x + kThreads * q, i = idx / M, j = idx % M;
        const float* rr = res + i * L::ldt;
        const float* ss = str + j * L::ldt;
        float acc = 0.0f;
        for (int k = 0; k < width; ++k) acc = fmaf(rr[k], ss[k], acc);
        sacc[q] += acc;
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int idx = threadIdx.x + kThreads * q;
      s[(idx / M) * L::lds + idx % M] = sacc[q];
    }
    __syncthreads();
    if constexpr (MODE == kFwd) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = warp * kRows + i;
        float sv[M / 32], tmax = kNeg, gsum = 0.0f;
#pragma unroll
        for (int e = 0; e < M / 32; ++e) {
          const int col = lane + 32 * e, v = t0 + col;
          sv[e] = v < a.V ? s[row * L::lds + col] : kNeg;
          if (v == lbl[row]) gsum += sv[e];
          tmax = fmaxf(tmax, sv[e]);
        }
        const float m_next = fmaxf(m[i], warp_max(tmax));
        float esum = 0.0f;
#pragma unroll
        for (int e = 0; e < M / 32; ++e) esum += expf(sv[e] - m_next);
        l[i] = l[i] * expf(m[i] - m_next) + warp_sum(esum);
        m[i] = m_next;
        gold[i] += warp_sum(gsum);
      }
    } else {
      // p[R x M] = padj of the logit tile. Token-resident tiles (dh) index
      // tokens by row; vocab-resident ones (dW) by column.
      for (int idx = threadIdx.x; idx < R * M; idx += kThreads) {
        const int i = idx / M, j = idx % M;
        const int t = vocab_rows ? j : i;             // token slot
        const int v = vocab_rows ? r0 + i : t0 + j;   // vocab row
        float x = v < a.V ? expf(s[i * L::lds + j] - lz[t]) * gg[t] : 0.0f;
        if (v == lbl[t]) x -= gg[t];
        p[i * L::lds + j] = x;
      }
      // acc[R x group] += p[R x M] . str[M x group], a slice of the streamed
      // tile at a time (staged again: the logits took it in the same
      // slices). Each tile's M products are summed on their own, in order,
      // and the tile's sum then joins the running one: a row of dh sums ~V
      // terms, and one serial f32 sum of them misses the fp32 bar at D = 32
      // (its rounding errors reach 1e-5 where dh cancels); tile by tile
      // they are ~10x smaller
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int k0 = g0 + c * KS;
        if (k0 >= D) break;
        __syncthreads();  // p is written; the last slice is read
        stage_rows(str, L::ldt, streamed, t0, limit, M, D, k0, min(KS, D - k0));
        __syncthreads();
        if (k0 + threadIdx.x < D) {
          float b[M];
#pragma unroll
          for (int k = 0; k < M; ++k) b[k] = str[k * L::ldt + threadIdx.x];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float t = 0.0f;
#pragma unroll
            for (int k = 0; k < M; ++k) t = fmaf(p[r * L::lds + k], b[k], t);
            facc[r][c] += t;
          }
        }
      }
    }
  }

  if constexpr (MODE == kFwd) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int n = r0 + warp * kRows + i;
        if (n < a.N) {
          const float lzv = m[i] + logf(fmaxf(l[i], 1e-30f));
          a.logz_out[n] = lzv;
          a.nll[n] = lzv - gold[i];
        }
      }
    }
  } else {
    const int rows_total = vocab_rows ? a.V : a.N;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = g0 + threadIdx.x + KS * c;
        if (col < D && r0 + r < rows_total)
          a.out[static_cast<long long>(r0 + r) * D + col] = facc[r][c];
      }
  }
}

// The forward: one CTA per R resident rows; the backward also one per
// column group of kGroup.
template <int MODE>
int launch(const Args& a, cudaStream_t stream) {
  if (!width_ok(a.D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(xent_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Layout::total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = MODE == kDw ? a.V : a.N;
  const int groups = MODE == kFwd ? 1 : (a.D + kGroup - 1) / kGroup;
  xent_kernel<MODE><<<dim3((rows + R - 1) / R, groups), kThreads, Layout::total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: one tensor-core GEMM mainloop, three epilogues.
namespace gemm {

using ergm_mma::saddr;

constexpr int BM = 128;        // rows of a CTA tile
constexpr int BK = 64;         // depth of a stage: 128-byte K-major rows
constexpr int kStages = 4;
constexpr int kTileV = 256;    // vocab columns of a forward (and padj) CTA

enum Epi { kLogits = 0, kPadj = 1, kDh = 2, kDw = 3 };

// An operand: element (row x, depth k) at p[x * ld + k] when K-major, at
// p[k * ld + x] when MN-major; storage rows (x when K-major, k when
// MN-major) at or past `rows` read as zero.
struct Operand {
  const bf16* p;
  long long ld;
  int rows;
};

struct Params {
  Operand a, b;
  int M, N, K;        // the product's extent; M and N in whole tiles by the grid
  const int* labels;  // [N_tok]
  const float* logz;  // [N_tok]
  const float* g;     // [N_tok] cotangent of the NLL
  int n_tok, V, v0;   // tokens, vocab size, the chunk's first vocab row
  float* part;        // forward: [3][vocab tiles][m_pad] (max, sum, gold) partials
  int m_pad;
  bf16* out;          // padj scratch [m_pad, ld_out], dh [n_tok, D] or dW [V, D]
  long long ld_out;
  float* acc;         // dh's f32 sum [n_tok, D]
  int first, last;    // dh: the first and last vocab chunk
};

// Row partials of a 16-row tile of logits (accumulator layout: rows r16 +
// g + 8hf, columns c0 + 8j + 2t + e) over its valid vocab columns, reduced
// across the quad that holds each row: max, sum of exp(s - max), gold.
template <int NJ>
__device__ __forceinline__ void row_partials(const Params& p, const float (&acc)[NJ][4], int r16,
                                             int c0, float (&mx)[2], float (&sum)[2],
                                             float (&gold)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r16 + g + 8 * hf;
    const int lbl = row < p.n_tok ? p.labels[row] : -1;
    float m = -INFINITY, gl = 0.0f, l = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = c0 + 8 * j + 2 * t + e;
        if (v < p.V) m = fmaxf(m, acc[j][2 * hf + e]);
        if (v == lbl) gl += acc[j][2 * hf + e];
      }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c0 + 8 * j + 2 * t + e < p.V) l += ergm_mma::ex2((acc[j][2 * hf + e] - m) * kLog2e);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    gl += __shfl_xor_sync(0xffffffffu, gl, 1);
    gl += __shfl_xor_sync(0xffffffffu, gl, 2);
    mx[hf] = m;
    sum[hf] = l;
    gold[hf] = gl;
  }
}

// The padj, dh and dW epilogues of a 16-row tile (layout as above):
//   padj: the chunk's columns into the scratch, rounded to bf16;
//   dh (rows: tokens): added to the f32 sum, or rounded out on the last chunk;
//   dW (rows: the chunk's vocab rows): rounded out;
// columns at or past N (= D) are not written.
template <int EPI, int NJ>
__device__ __forceinline__ void store_tile(const Params& p, const float (&acc)[NJ][4], int r16,
                                           int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r16 + g + 8 * hf;
    if constexpr (EPI == kPadj) {
      const bool real = row < p.n_tok;
      const int lbl = real ? p.labels[row] : -1;
      const float gw = (real && lbl >= 0) ? p.g[row] : 0.0f;
      const float lz = real ? p.logz[row] : 0.0f;
      bf16* orow = p.out + static_cast<long long>(row) * p.ld_out;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = p.v0 + c + e;
          x[e] = v < p.V ? ergm_mma::ex2((acc[j][2 * hf + e] - lz) * kLog2e) * gw : 0.0f;
          if (v == lbl) x[e] -= gw;
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x[0], x[1]);
      }
    } else {
      const long long orow = EPI == kDh ? row : static_cast<long long>(p.v0) + row;
      if (orow >= (EPI == kDh ? p.n_tok : p.V)) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (c0 + 8 * j >= p.N) break;  // a tile wider than what is left of D
        const long long at = orow * p.ld_out + c0 + 8 * j + 2 * t;
        float2 x = make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        if constexpr (EPI == kDh) {
          if (!p.first) {
            const float2 y = *reinterpret_cast<const float2*>(p.acc + at);
            x.x += y.x;
            x.y += y.y;
          }
          if (!p.last) {
            *reinterpret_cast<float2*>(p.acc + at) = x;
            continue;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + at) = __floats2bfloat162_rn(x.x, x.y);
      }
    }
  }
}

template <int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * kStages * (BM + BN) * BK;
}

// --- the mainloop: wgmma, loads by TMA -------------------------------------
// A producer warpgroup (one thread) keeps the four-stage ring full by TMA,
// each stage's arrival counted by an mbarrier; two consumer warpgroups of
// 64 rows each issue wgmma m64nBNk16 on the stage's tiles straight from
// shared memory (128-byte swizzle: the TMA writes it, the descriptors read
// it) and release the stage through a second mbarrier when its products
// are done. Operands stored MN-major are loaded in 64-wide column blocks
// and read with wgmma's transpose flag.

constexpr int kWgThreads = 384;

using ergm_hopper::mbar_arrive;
using ergm_hopper::mbar_expect;
using ergm_hopper::mbar_fence_init;
using ergm_hopper::mbar_init;
using ergm_hopper::mbar_wait;
using ergm_hopper::sm_desc;
using ergm_hopper::tma_load_2d;
using ergm_hopper::wg_commit;
using ergm_hopper::wg_fence;
using ergm_hopper::wg_wait;

// d (64 x 256, f32, the warpgroup's accumulator) += A . B over k16, operands
// from shared memory by descriptor; kTA / kTB: the operand is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n256(float (&d)[32][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// d (64 x 192, f32, the warpgroup's accumulator) += A . B over k16, operands
// from shared memory by descriptor; kTA / kTB: the operand is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n192(float (&d)[24][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// The descriptor of stage tile t (X rows by BK deep) at the 64 rows from x
// (A: a consumer's rows; B: x = 0, all X), k16 step kk. K-major: [X][64]
// with 1024-byte groups of 8 rows, a step is 32 bytes into the swizzled
// rows. MN-major: 64-wide column blocks of [64 k][64], 8 KB apart; a step
// is 16 rows.
template <bool kKMajor>
__device__ __forceinline__ uint64_t operand_desc(const bf16* t, int x, int kk) {
  if constexpr (kKMajor) return sm_desc(t + x * BK + kk * 16, 16, 1024);
  return sm_desc(t + (x / 64) * 64 * BK + kk * 16 * 64, 64 * BK * 2, 1024);
}

template <int X, bool kKMajor>
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, bf16* dst, uint64_t* bar, int x0,
                                         int k0) {
  if constexpr (kKMajor) {
    tma_load_2d(map, dst, bar, k0, x0);
  } else {
#pragma unroll
    for (int b = 0; b < X / 64; ++b) tma_load_2d(map, dst + b * 64 * BK, bar, x0 + 64 * b, k0);
  }
}

template <int BN>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return smem_bytes<BN>() + 2 * kStages * sizeof(uint64_t) + 1024;
}

// Persistent: one CTA per SM walks the output tiles (tile, tile + grid,
// ...; kNFast: along N first, else along M), and the ring runs on across
// them, so that the producer loads the next tile while the consumers finish
// this one's epilogue.
template <int BN, bool kAK, bool kBK, int EPI, bool kNFast>
__global__ void __launch_bounds__(kWgThreads, 1)
    wg_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
              const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  bf16* as = reinterpret_cast<bf16*>(smem);  // [kStages][BM * BK]
  bf16* bs = as + kStages * BM * BK;         // [kStages][BN * BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kStages * BN * BK);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31, t = lane & 3;
  const int kt_n = p.K / BK;
  const int tiles_m = p.M / BM, tiles_n = (p.N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  auto tile_mn = [&](int tile, int& mi, int& ni) {
    mi = kNFast ? tile / tiles_n : tile % tiles_m;
    ni = kNFast ? tile % tiles_n : tile / tiles_m;
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // the consumers' eight warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // k steps issued, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mi, ni;
        tile_mn(tile, mi, ni);
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + s, ((it / kStages) + 1) & 1);
          mbar_expect(full + s, static_cast<unsigned>(smem_bytes<BN>() / kStages));
          tma_tile<BM, kAK>(&ta, as + s * BM * BK, full + s, mi * BM, kt * BK);
          tma_tile<BN, kBK>(&tb, bs + s * BN * BK, full + s, ni * BN, kt * BK);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;  // this consumer's 64 rows of a tile
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mi, ni;
    tile_mn(tile, mi, ni);
    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int kt = 0; kt < kt_n; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = operand_desc<kAK>(as + s * BM * BK, 64 * c, kk);
        const uint64_t db = operand_desc<kBK>(bs + s * BN * BK, 0, kk);
        if constexpr (BN == 256)
          wgmma_n256<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
        else
          wgmma_n192<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
      }
      wg_commit();
      wg_wait<1>();  // the previous step's products are done: release its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % kStages);
    }
    wg_wait<0>();
    if (lane == 0) mbar_arrive(empty + (it - 1) % kStages);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");

    const int r16 = mi * BM + 64 * c + 16 * ((threadIdx.x >> 5) & 3);
    if constexpr (EPI == kLogits) {
      float mx[2], sum[2], gold[2];
      row_partials(p, acc, r16, ni * BN, mx, sum, gold);
      if (t == 0) {
        const long long plane = static_cast<long long>(tiles_n) * p.m_pad;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long at =
              static_cast<long long>(ni) * p.m_pad + r16 + (lane >> 2) + 8 * hf;
          p.part[at] = mx[hf];
          p.part[plane + at] = sum[hf];
          p.part[2 * plane + at] = gold[hf];
        }
      }
    } else {
      store_tile<EPI>(p, acc, r16, ni * BN);
    }
  }
}

// logZ and the NLL of each token from its partials, in vocab-tile order
__global__ void combine_kernel(const float* part, int tiles, int m_pad, int n_tok, float* nll,
                               float* logz) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_tok) return;
  const long long plane = static_cast<long long>(tiles) * m_pad;
  float mx = -INFINITY, sum = 0.0f, gold = 0.0f;
  for (int i = 0; i < tiles; ++i) mx = fmaxf(mx, part[static_cast<long long>(i) * m_pad + n]);
  for (int i = 0; i < tiles; ++i) {
    const long long at = static_cast<long long>(i) * m_pad + n;
    const float l = part[plane + at];
    if (l > 0.0f) sum += l * expf(part[at] - mx);
    gold += part[2 * plane + at];
  }
  const float lz = mx + logf(fmaxf(sum, 1e-30f));
  logz[n] = lz;
  nll[n] = lz - gold;
}

// The tensor map of an operand whose tiles are X rows (K-major: a [X][64]
// box) or 64-wide column blocks (MN-major: [64][64] boxes), 128-byte
// swizzle, out-of-bounds rows read as zero.
inline bool operand_map(CUtensorMap* map, const Operand& op, bool kmajor, int x) {
  const ergm_hopper::EncodeTiled encode = ergm_hopper::encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(op.ld), static_cast<cuuint64_t>(op.rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(op.ld) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(kmajor ? x : BK)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(op.p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product with its epilogue, tiles 128 x BN, one persistent CTA per SM
// (or per tile, where there are fewer).
template <int BN, bool kAK, bool kBK, int EPI, bool kNFast>
cudaError_t run(const Params& p, cudaStream_t stream) {
  const int mt = p.M / BM, nt = (p.N + BN - 1) / BN;
  CUtensorMap ta, tb;
  if (!operand_map(&ta, p.a, kAK, BM) || !operand_map(&tb, p.b, kBK, BN))
    return cudaErrorInvalidValue;
  const auto kernel = wg_kernel<BN, kAK, kBK, EPI, kNFast>;
  constexpr size_t smem = wg_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  kernel<<<std::min(mt * nt, sms), kWgThreads, smem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

}  // namespace gemm

}  // namespace ergm_xent

using ergm_xent::gemm::Operand;
using ergm_xent::gemm::Params;

// dtype: 0 = float32, 1 = bfloat16; h [N, D] and W [V, D] contiguous, D a
// multiple of 64. part: the bf16 route's [3, ceil(V / 256),
// m_pad] f32 partials, m_pad = N rounded up to 128 (unused in f32).
// Returns a cudaError_t (0 on success).
extern "C" int ergm_xent_fwd(const void* h, const void* w, const void* labels, void* nll,
                             void* logz, void* part, int dtype, int N, int V, int D,
                             void* stream) {
  using namespace ergm_xent;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!width_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    f32::Args a{static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const int*>(labels), nullptr, nullptr, static_cast<float*>(nll),
                static_cast<float*>(logz), nullptr, N, V, D};
    return f32::launch<f32::kFwd>(a, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  const int m_pad = (N + gemm::BM - 1) / gemm::BM * gemm::BM;
  p.a = Operand{static_cast<const bf16*>(h), D, N};
  p.b = Operand{static_cast<const bf16*>(w), D, V};
  p.M = m_pad;
  p.N = V;
  p.K = D;
  p.labels = static_cast<const int*>(labels);
  p.n_tok = N;
  p.V = V;
  p.part = static_cast<float*>(part);
  p.m_pad = m_pad;
  cudaError_t err = gemm::run<gemm::kTileV, true, true, gemm::kLogits, false>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (V + gemm::kTileV - 1) / gemm::kTileV;
  gemm::combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), tiles, m_pad, N, static_cast<float*>(nll),
      static_cast<float*>(logz));
  return static_cast<int>(cudaGetLastError());
}

// The f32 route's backward: dh (which = 0) or dW (which = 1) in one kernel.
extern "C" int ergm_xent_bwd_f32(const void* h, const void* w, const void* labels,
                                 const void* logz, const void* g, void* out, int which, int N,
                                 int V, int D, void* stream) {
  using namespace ergm_xent;
  f32::Args a{static_cast<const float*>(h), static_cast<const float*>(w),
              static_cast<const int*>(labels), static_cast<const float*>(logz),
              static_cast<const float*>(g), nullptr, nullptr, static_cast<float*>(out), N, V, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return which == 0 ? f32::launch<f32::kDh>(a, s) : f32::launch<f32::kDw>(a, s);
}

// One vocab chunk [v0, v0 + width) of the bf16 backward, three products in
// order on the stream: padj (into the [m_pad, chunk] scratch), dh += padj . W_c
// (into the f32 sum dh_acc, or rounded into dh on the last chunk; the first
// chunk does not read dh_acc) and dW_c = padj^T . h. width <= chunk, chunk a
// multiple of 256, and width too unless the chunk ends at V.
extern "C" int ergm_xent_bwd_chunk(const void* h, const void* w, const void* labels,
                                   const void* logz, const void* g, void* padj, void* dh_acc,
                                   void* dh, void* dw, int N, int V, int D, int v0,
                                   int width, int chunk, int first, int last, void* stream) {
  using namespace ergm_xent;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a chunk that ends before V must be whole tiles: the padj kernel writes
  // its tiles' columns past `width`, which the next chunk would count again
  if (!width_ok(D) || chunk % gemm::kTileV || width < 1 || width > chunk ||
      (v0 + width != V && width % gemm::kTileV))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_pad = (N + gemm::BM - 1) / gemm::BM * gemm::BM;
  const int k_chunk = (width + gemm::BK - 1) / gemm::BK * gemm::BK;
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* wc = static_cast<const bf16*>(w) + static_cast<long long>(v0) * D;
  bf16* pj = static_cast<bf16*>(padj);
  Params p{};
  p.labels = static_cast<const int*>(labels);
  p.logz = static_cast<const float*>(logz);
  p.g = static_cast<const float*>(g);
  p.n_tok = N;
  p.V = V;
  p.v0 = v0;
  p.m_pad = m_pad;
  p.first = first;
  p.last = last;

  // (1) padj_c = padj(h . W_c^T): [m_pad, width] of the scratch
  Params p1 = p;
  p1.a = Operand{hb, D, N};
  p1.b = Operand{wc, D, V - v0};
  p1.M = m_pad;
  p1.N = width;
  p1.K = D;
  p1.out = pj;
  p1.ld_out = chunk;
  cudaError_t err = gemm::run<gemm::kTileV, true, true, gemm::kPadj, false>(p1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // (2) dh (+)= padj_c . W_c: A K-major over the chunk, B = W_c MN-major
  Params p2 = p;
  p2.a = Operand{pj, chunk, m_pad};
  p2.b = Operand{wc, D, V - v0};
  p2.M = m_pad;
  p2.N = D;
  p2.K = k_chunk;
  p2.out = static_cast<bf16*>(dh);
  p2.ld_out = D;
  p2.acc = static_cast<float*>(dh_acc);
  err = gemm::run<192, true, false, gemm::kDh, true>(p2, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // (3) dW_c = padj_c^T . h: A = the scratch MN-major, B = h MN-major, over
  // all tokens (padded rows of the scratch are 0)
  Params p3 = p;
  p3.a = Operand{pj, chunk, m_pad};
  p3.b = Operand{hb, D, N};
  p3.M = (width + gemm::BM - 1) / gemm::BM * gemm::BM;
  p3.N = D;
  p3.K = m_pad;
  p3.out = static_cast<bf16*>(dw);
  p3.ld_out = D;
  err = gemm::run<192, false, false, gemm::kDw, true>(p3, s);
  return static_cast<int>(err);
}
