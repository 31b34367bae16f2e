// Dense layer of the single-token decode kernel K3 for Hopper (sm_90a),
// and of K4's fp32 route (its bf16 route runs dense_hopper.cuh's TMA and
// wgmma product).
//
// out = epilogue(round(A' @ W + bias)) for A [M, K] (row stride lda), W
// [K, N] row-major ([in, out], GPT-2's Conv1D orientation) and bias [N],
// all in the compute dtype T (float or bf16). A' is A itself, or the
// LayerNorm of A's rows when ln_scale is given: f32 statistics (mean, then
// the mean of centred squares), ((x - mean) * rsqrt(var + eps)) * scale +
// bias, rounded to T, as the port's layer_norm and JAX's kernels round it
// (in bf16 formed as x * rstd - mean * rstd: equal up to f32 rounding).
// The product accumulates in f32, the bias joins in f32 and the sum is
// rounded once to T, as cuBLAS's addmm epilogue does in the plain path.
// Epilogues, each rounding where the plain path rounds:
//   kEpiNone      y
//   kEpiGeluTanh  round(gelu_tanh(y))   (PyTorch's tanh-approximate formula)
//   kEpiGeluErf   round(gelu_erf(y))
//   kEpiResidual  round(res + round(y * gate[row])), gate 1 unless the row's
//                 caption mask sums to 0 (the capless-row gate of K3)
//   kEpiPartial   the f32 accumulator as it is, into an f32 [M, N] output:
//                 no bias, no rounding, no gate, no residual. The
//                 tensor-parallel forms of K3 and K4 take it for their
//                 row-parallel c_proj, whose partial products the caller
//                 sums over the model group before it adds the bias, the
//                 gate and the residual in the order kEpiResidual uses.
//
// bf16 (dense_tc_kernel): the products run on the tensor cores, mma.sync
// m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from shared memory.
// mma.sync rather than wgmma: at decode M = B <= 256 rows, and a layer is
// bound by bytes, not operations (a 768 x 3072 bf16 matrix is 4.7 MB, 1.4
// us at 3.35 TB/s, against 1.2 GFLOP, 1.2 us at 989 TFLOP/s), so what
// matters is reading W once and filling the SMs; mma.sync's fragments also
// take the LayerNorm'd A tile that threads write into padded shared memory,
// where wgmma wants TMA's swizzled layout. A bf16 x bf16 product is exact
// in f32, so the tensor cores change only the summation order.
//
// Grid: a CTA (256 threads, 8 warps of 32 rows) covers up to 256 rows, all
// of B at decode, times 64 columns, so each W tile leaves device memory
// once; K is split S ways (S <= 8, the largest that keeps one CTA an SM),
// and the S CTAs of a column tile form a thread-block cluster. Each CTA
// streams its share of K in 64-deep chunks through a four-stage cp.async
// ring (A and W; rows past M are zero-filled, never read). The split
// partials are reduced without a workspace in device memory and without a
// second launch: each CTA leaves its f32 tile in its own shared memory,
// and after a cluster barrier the CTA with share k adds the S tiles of rows
// k, k + S, ... through distributed shared memory in K order, then applies
// bias and epilogue: one launch a product, no atomics, and a repeat is
// bitwise equal. With a LayerNorm prologue the cluster also spans Cn column
// tiles (S * Cn <= 8); its CTAs split the rows, bring each once into
// shared memory by cp.async, form the f32 mean and then the mean of
// centred squares (8 lanes a row), and read the statistics from each
// other's shared memory, so a row's statistics are formed once a cluster
// and not once a column tile. Each warp applies the LayerNorm to its A fragments in registers
// and rounds them to bf16 just before their products. At the slice's
// shape: K3's two projections (768 x 768) S = 6 (72 CTAs).
//
// A product launched after another of the same call (K3's c_proj) uses
// programmatic dependent launch: it starts
// while the other finishes, requests its W chunks, and waits for the other
// before it reads A.
//
// What binds it (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py): A is read
// from L2 once per column tile, so each product moves ~24 MB through L2,
// ~250 KB an SM; around that sits a serial chain of short steps (the
// statistics and the cluster barrier that shares them, the partial-tile
// barrier, the distributed shared-memory sums and the epilogue). Device
// durations of one K3 call: 15.2 us q, 10.4 us c_proj (K4 on this kernel
// took 23.2 us up and 17.9 us down; PERF.md's K4 rows hold both designs).

#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace ergm_decode {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Cvt<bf16> {
  static __device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
};

constexpr float kNegInf = -1e9f;  // the large-negative fill of JAX's math

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

enum Epilogue { kEpiNone = 0, kEpiGeluTanh = 1, kEpiGeluErf = 2, kEpiResidual = 3, kEpiPartial = 4 };

struct DenseArgs {
  const void* a;          // [M, K], row stride lda
  const void* w;          // [K, N] row-major
  const void* bias;       // [N] (unread by kEpiPartial)
  const void* ln_scale;   // [K], or null: no LayerNorm prologue
  const void* ln_bias;    // [K]
  const void* res;        // [M, N] residual (kEpiResidual), row stride ldr
  const float* gate_mask; // [M, gate_len] caption mask of the row gate, or null (gate 1)
  void* out;              // [M, N], row stride ldo (f32 under kEpiPartial)
  int gate_len;
  int lda, ldr, ldo;
  int M, N, K;
  int epi;
  float eps;
};

// The capless-row gate: 0 where the row's caption mask sums to 0.
__device__ __forceinline__ float row_gate(const DenseArgs& g, int row) {
  if (!g.gate_mask) return 1.0f;
  const float* m = g.gate_mask + static_cast<long long>(row) * g.gate_len;
  float n = 0.0f;
  for (int t = 0; t < g.gate_len; ++t) n += m[t];
  return n > 0.0f ? 1.0f : 0.0f;
}

// Rounding and epilogue of one output element: acc is its f32 sum, b its
// bias, r its residual (kEpiResidual).
template <typename T>
__device__ __forceinline__ float dense_epi(const DenseArgs& g, float acc, float b, float r,
                                           float gate) {
  float y = Cvt<T>::round(acc + b);
  if (g.epi == kEpiGeluTanh) {
    const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
    y = Cvt<T>::round(0.5f * y * (1.0f + tanhf(inner)));
  } else if (g.epi == kEpiGeluErf) {
    y = Cvt<T>::round(y * 0.5f * (1.0f + erff(y * 0.7071067811865476f)));
  } else if (g.epi == kEpiResidual) {
    y = r + Cvt<T>::round(y * gate);
  }
  return y;
}

template <typename T>
__device__ __forceinline__ void dense_store(const DenseArgs& g, int row, int col, float acc,
                                            float gate) {
  if (g.epi == kEpiPartial) {
    static_cast<float*>(g.out)[static_cast<long long>(row) * g.ldo + col] = acc;
    return;
  }
  const float r = g.epi == kEpiResidual
                      ? Cvt<T>::load(static_cast<const T*>(g.res) +
                                     static_cast<long long>(row) * g.ldr + col)
                      : 0.0f;
  const float y = dense_epi<T>(g, acc, Cvt<T>::load(static_cast<const T*>(g.bias) + col), r, gate);
  Cvt<T>::store(static_cast<T*>(g.out) + static_cast<long long>(row) * g.ldo + col, y);
}

// ---------------------------------------------------------------------------
// f32: the fp32 bars (JAX's 2e-5 for K4) rule out TF32, so float products
// stay on the CUDA cores: 16 rows x 64 columns a CTA of 128 threads, a 2 x
// 4 register tile a thread, all of K in 32-deep chunks, one launch. Each
// chunk is summed on its own, then added to the chunks before it: one
// serial f32 sum over K = 10,240 (K4's down projection at
// Cerebras-GPT-2.7B's width) missed the 2e-5 bar.

constexpr int kBM = 16, kBN = 64, kBK = 32, kF32Threads = 128;

static __global__ void __launch_bounds__(kF32Threads) dense_f32_kernel(const DenseArgs g) {
  __shared__ float as[kBK][kBM + 1];  // A chunk, k-major; +1 spreads the staging writes
  __shared__ __align__(16) float ws[kBK][kBN];
  __shared__ float mean_s[kBM], rstd_s[kBM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float* A = static_cast<const float*>(g.a);
  const float* W = static_cast<const float*>(g.w);
  const float* lns = static_cast<const float*>(g.ln_scale);
  const float* lnb = static_cast<const float*>(g.ln_bias);
  const bool vec_w = reinterpret_cast<uintptr_t>(W) % 16 == 0;

  if (lns) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < kBM; r += kF32Threads / 32) {
      const int row = m0 + r;
      float mean = 0.0f, rstd = 0.0f;
      if (row < g.M) {
        const float* x = A + static_cast<long long>(row) * g.lda;
        float s = 0.0f;
        for (int k = lane; k < g.K; k += 32) s += x[k];
        mean = warp_sum(s) / g.K;
        float v = 0.0f;
        for (int k = lane; k < g.K; k += 32) {
          const float d = x[k] - mean;
          v = fmaf(d, d, v);
        }
        rstd = rsqrtf(warp_sum(v) / g.K + g.eps);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
  }

  const int tr = tid >> 4, tc = tid & 15;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    __syncthreads();  // the previous chunk is consumed; the statistics are written
    for (int i = tid; i < kBM * kBK; i += kF32Threads) {
      const int r = i / kBK, k = i % kBK, row = m0 + r;
      float x = 0.0f;
      if (row < g.M) {
        x = A[static_cast<long long>(row) * g.lda + k0 + k];
        if (lns) x = ((x - mean_s[r]) * rstd_s[r]) * lns[k0 + k] + lnb[k0 + k];
      }
      as[k][r] = x;
    }
    for (int i = tid; i < kBK * kBN / 4; i += kF32Threads) {
      const int k = i / (kBN / 4), n = (i % (kBN / 4)) * 4;
      const float* src = W + static_cast<long long>(k0 + k) * g.N + n0 + n;
      if (vec_w) {
        *reinterpret_cast<float4*>(&ws[k][n]) = *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) ws[k][n + j] = src[j];
      }
    }
    __syncthreads();
    float part[2][4] = {};
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float a0 = as[k][tr], a1 = as[k][tr + 8];
      const float4 w = *reinterpret_cast<const float4*>(&ws[k][4 * tc]);
      part[0][0] = fmaf(a0, w.x, part[0][0]);
      part[0][1] = fmaf(a0, w.y, part[0][1]);
      part[0][2] = fmaf(a0, w.z, part[0][2]);
      part[0][3] = fmaf(a0, w.w, part[0][3]);
      part[1][0] = fmaf(a1, w.x, part[1][0]);
      part[1][1] = fmaf(a1, w.y, part[1][1]);
      part[1][2] = fmaf(a1, w.z, part[1][2]);
      part[1][3] = fmaf(a1, w.w, part[1][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + tr + 8 * i;
    if (row >= g.M) continue;
    const float gate = g.epi == kEpiResidual ? row_gate(g, row) : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dense_store<float>(g, row, n0 + 4 * tc + j, acc[i][j], gate);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, split K reduced across a cluster.

constexpr int kTcThreads = 256, kTcBM = 256, kTcBN = 64, kTcBK = 64;
constexpr int kTcLd = ergm_mma::kLd;  // 72 elements: 144-byte rows, conflict-free ldmatrix
constexpr int kRedLd = kTcBN + 8;     // f32 partial tile row: 72 words, conflict-free float2 stores
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kStages = 4;            // chunks in flight: A and W by cp.async
constexpr int kAStage = kTcBM * kTcLd, kWStage = kTcBK * kTcLd;
// shared memory besides the LayerNorm parameters of the CTA's K share
constexpr size_t kTcSmem =
    sizeof(bf16) * kStages * (kAStage + kWStage) + sizeof(float) * 5 * kTcBM;
constexpr int kTcSmemMax = 232448;  // what a CTA may take on sm_90
static_assert(sizeof(float) * kTcBM * kRedLd <= sizeof(bf16) * kStages * kAStage,
              "the partial tile reuses the A stages");


__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 bytes from device to shared memory by cp.async; zeros, and no read,
// where !valid.
__device__ __forceinline__ void copy16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Programmatic dependent launch: a kernel launched after another of the
// same call starts early, waits here before it reads the other's output,
// and lets the next one start once its own reads are done. Both are no-ops
// in a kernel launched without the attribute.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// grid (N / 64 * S, ceil(M / 256)), clusters of S * Cn CTAs along x: the
// cluster covers Cn column tiles of 64, and K split S ways for each; the
// CTA with K share k of a column tile is cluster rank base + k.
static __global__ void __launch_bounds__(kTcThreads, 1) dense_tc_kernel(const DenseArgs g,
                                                                        const int splits,
                                                                        const int csize) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [kStages][kTcBM][kTcLd]
  bf16* ws = as + kStages * kAStage;         // [kStages][kTcBK][kTcLd]
  float* mean_s = reinterpret_cast<float*>(ws + kStages * kWStage);
  float* rstd_s = mean_s + kTcBM;
  float* own_mean = rstd_s + kTcBM;  // the statistics of the rows this rank owns
  float* own_rstd = own_mean + kTcBM;
  float* gate_s = own_rstd + kTcBM;
  bf16* lnp = reinterpret_cast<bf16*>(gate_s + kTcBM);  // [2][K / S]: LayerNorm scale, bias
  float* red = reinterpret_cast<float*>(smem);  // [kTcBM][kRedLd] after the mainloop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int kidx = rank % splits, base = rank - kidx;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = (blockIdx.x / splits) * kTcBN, m0 = blockIdx.y * kTcBM;
  const int rows = min(kTcBM, g.M - m0);
  const int klen = g.K / splits, kbeg = kidx * klen, nk = klen / kTcBK;
  const bf16* A = static_cast<const bf16*>(g.a) + static_cast<long long>(m0) * g.lda;
  const bf16* W = static_cast<const bf16*>(g.w);
  const bf16* lns = static_cast<const bf16*>(g.ln_scale);
  const bf16* lnb = static_cast<const bf16*>(g.ln_bias);

  // chunk c (A: 256 rows x 64, W: 64 x 64) into stage c % kStages; one
  // cp.async group per chunk (issue_a commits), empty past the last
  auto issue_w = [&](int c) {
    if (c >= nk) return;
    bf16* wd = ws + (c % kStages) * kWStage;
    const bf16* wsrc = W + static_cast<long long>(kbeg + c * kTcBK) * g.N + n0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kTcThreads, r = idx >> 3, col = (idx & 7) * 8;
      ergm_async::copy16(wd + r * kTcLd + col, wsrc + static_cast<long long>(r) * g.N + col);
    }
  };
  auto issue_a = [&](int c) {
    if (c < nk) {
      bf16* ad = as + (c % kStages) * kAStage;
      const int k0 = kbeg + c * kTcBK;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (tid >> 3) + 32 * i, col = (tid & 7) * 8;
        copy16_zfill(ad + r * kTcLd + col,
                     A + static_cast<long long>(min(r, rows - 1)) * g.lda + k0 + col, r < rows);
      }
    }
    ergm_async::commit();
  };
  // the first chunks: W before the wait for the kernel that writes A
  auto prologue = [&]() {
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) issue_w(c);
    griddep_wait();
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) issue_a(c);
  };
  // this CTA's share of the LayerNorm parameters joins chunk 0's group
  if (lns) {
    for (int i = tid; i < klen / 8; i += kTcThreads) {
      ergm_async::copy16(lnp + 8 * i, lns + kbeg + 8 * i);
      ergm_async::copy16(lnp + klen + 8 * i, lnb + kbeg + 8 * i);
    }
  }
  // (a LayerNorm product is never launched early: its statistics read A
  // before the prologue's wait)
  if (!lns) prologue();

  // the row gates of the rows this CTA finishes (kidx, kidx + S, ...), a
  // warp a row
  const int mine = (rows - kidx + splits - 1) / splits;
  if (g.epi == kEpiResidual) {
    for (int j = warp; j < mine; j += kTcThreads / 32) {
      float n = 1.0f;
      if (g.gate_mask) {
        const float* m =
            g.gate_mask + static_cast<long long>(m0 + kidx + j * splits) * g.gate_len;
        n = 0.0f;
        for (int t = lane; t < g.gate_len; t += 32) n += m[t];
        n = warp_sum(n);
      }
      if (lane == 0) gate_s[j] = n > 0.0f ? 1.0f : 0.0f;
    }
  }

  // LayerNorm statistics, before the first chunks are requested: cluster
  // rank r owns rows r, r + csize, ...; they come by cp.async into the A
  // stages (free until the prologue), as many a batch as fit, and 8 lanes a
  // row form the mean, then the mean of centred squares, from shared
  // memory. The cluster then reads each row's statistics from its owner.
  if (lns) {
    const int per = kStages * kAStage / g.K, owned = (rows - rank + csize - 1) / csize;
    const int sub = lane & 7, grp = warp * 4 + (lane >> 3);
    for (int b0 = 0; b0 < owned; b0 += per) {
      const int nb = min(per, owned - b0);
      for (int i = tid; i < nb * (g.K / 8); i += kTcThreads) {
        const int j = i / (g.K / 8), c = i % (g.K / 8);
        ergm_async::copy16(as + j * g.K + c * 8,
                           A + static_cast<long long>((b0 + j) * csize + rank) * g.lda + c * 8);
      }
      ergm_async::commit();
      ergm_async::wait<0>();
      __syncthreads();
      for (int j0 = 0; j0 < nb; j0 += 32) {  // the whole warp shuffles
        const int j = j0 + grp;
        const bf16* x = as + min(j, nb - 1) * g.K;
        float p8[8] = {}, e8[8];
        for (int k = sub * 8; k < g.K; k += 64) {
          unpack8(*reinterpret_cast<const uint4*>(x + k), e8);
#pragma unroll
          for (int e = 0; e < 8; ++e) p8[e] += e8[e];
        }
        float sum = ((p8[0] + p8[1]) + (p8[2] + p8[3])) + ((p8[4] + p8[5]) + (p8[6] + p8[7]));
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        const float mean = sum / g.K;
#pragma unroll
        for (int e = 0; e < 8; ++e) p8[e] = 0.0f;
        for (int k = sub * 8; k < g.K; k += 64) {
          unpack8(*reinterpret_cast<const uint4*>(x + k), e8);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = e8[e] - mean;
            p8[e] = fmaf(d, d, p8[e]);
          }
        }
        float sq = ((p8[0] + p8[1]) + (p8[2] + p8[3])) + ((p8[4] + p8[5]) + (p8[6] + p8[7]));
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        sq += __shfl_xor_sync(0xffffffffu, sq, 4);
        if (sub == 0 && j < nb) {
          const int r = (b0 + j) * csize + rank;
          own_mean[r] = mean;
          own_rstd[r] = rsqrtf(sq / g.K + g.eps);
        }
      }
      __syncthreads();  // the row buffer is consumed
    }
    prologue();
    cluster.sync();  // the owners' statistics are visible to the cluster
    for (int r = tid; r < rows; r += kTcThreads) {
      mean_s[r] = *cluster.map_shared_rank(own_mean + r, r % csize);
      rstd_s[r] = *cluster.map_shared_rank(own_rstd + r, r % csize);
    }
  }

  // LayerNorm constants of the lane's four fragment rows (rows past M: 0)
  const int gr = lane >> 2, t4 = lane & 3;
  float lrstd[2][2] = {}, lshift[2][2] = {};  // y = (x * rstd - mean * rstd) * sc + bi
  if (lns) {
    __syncthreads();  // mean_s / rstd_s
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 32 + i * 16 + gr + 8 * hf;
        if (r < rows) {
          lrstd[i][hf] = rstd_s[r];
          lshift[i][hf] = -mean_s[r] * rstd_s[r];
        }
      }
  }
  // LayerNorm and round two values of a fragment register in place
  auto ln2 = [](unsigned u, float rstd, float shift, float2 sc, float2 bi) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    const __nv_bfloat162 y = __floats2bfloat162_rn(fmaf(fmaf(x.x, rstd, shift), sc.x, bi.x),
                                                   fmaf(fmaf(x.y, rstd, shift), sc.y, bi.y));
    return *reinterpret_cast<const unsigned*>(&y);
  };

  float acc[2][8][4] = {};
  const bool active = warp * 32 < rows;  // warps past the last row skip the products
  for (int c = 0; c < nk; ++c) {
    const int s = c % kStages;
    ergm_async::wait<kStages - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1 is consumed
    issue_w(c + kStages - 1);  // into the stage chunk c - 1 held
    issue_a(c + kStages - 1);
    if (active) {
      const bf16* at = as + s * kAStage;
      const bf16* wt = ws + s * kWStage;
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        unsigned af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ergm_mma::ldsm4(af[i], ergm_mma::saddr(at + (warp * 32 + i * 16 + (lane & 15)) * kTcLd +
                                                 kk * 16 + (lane >> 4) * 8));
        if (lns) {  // fragment registers: (row g, k 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
          const int k = c * kTcBK + kk * 16 + 2 * t4;
          const float2 s0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lnp + k));
          const float2 s8 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lnp + k + 8));
          const float2 b0 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lnp + klen + k));
          const float2 b8 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lnp + klen + k + 8));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            af[i][0] = ln2(af[i][0], lrstd[i][0], lshift[i][0], s0, b0);
            af[i][1] = ln2(af[i][1], lrstd[i][1], lshift[i][1], s0, b0);
            af[i][2] = ln2(af[i][2], lrstd[i][0], lshift[i][0], s8, b8);
            af[i][3] = ln2(af[i][3], lrstd[i][1], lshift[i][1], s8, b8);
          }
        }
#pragma unroll
        for (int dp = 0; dp < kTcBN / 16; ++dp) {
          unsigned bfr[4];
          ergm_mma::ldsm4t(bfr, ergm_mma::saddr(wt + (kk * 16 + (lane & 15)) * kTcLd + dp * 16 +
                                                (lane >> 4) * 8));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ergm_mma::mma(acc[i][2 * dp], af[i], bfr[0], bfr[1]);
            ergm_mma::mma(acc[i][2 * dp + 1], af[i], bfr[2], bfr[3]);
          }
        }
      }
    }
  }
  ergm_async::wait<0>();
  __syncthreads();  // every chunk is consumed: the stages take the partial tile
  griddep_launch();  // this CTA has read its inputs

  // this CTA's f32 partial tile into its own shared memory
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(red + (warp * 32 + i * 16 + gr + 8 * hf) * kRedLd + 8 * j +
                                     2 * t4) =
              make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
  }
  const bf16* bias = static_cast<const bf16*>(g.bias);
  const bf16* res = static_cast<const bf16*>(g.res);
  bf16* out = static_cast<bf16*>(g.out);
  cluster.sync();  // every partial tile is written
  // K share k finishes rows k, k + S, ...: the S partials in K order. A
  // thread takes kU output quads a round and loads all their partials at
  // once, so that the remote loads overlap: 4 quads where S <= 2, 2 beyond.
  constexpr int kQuads = kTcBN / 4;
  auto finish = [&](auto u_const, auto q_const) {
    constexpr int kU = decltype(u_const)::value, kQ = decltype(q_const)::value;
    for (int idx0 = tid; idx0 < mine * kQuads; idx0 += kU * kTcThreads) {
      float4 p[kU][kQ];
      uint2 braw[kU], rraw[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {  // bias and residual, then the partials
        const int idx = idx0 + u * kTcThreads;
        if (idx >= mine * kQuads) continue;
        const int r = kidx + (idx / kQuads) * splits, c4 = (idx % kQuads) * 4;
        if (g.epi != kEpiPartial) braw[u] = *reinterpret_cast<const uint2*>(bias + n0 + c4);
        if (g.epi == kEpiResidual)
          rraw[u] = *reinterpret_cast<const uint2*>(res + static_cast<long long>(m0 + r) * g.ldr +
                                                    n0 + c4);
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          if (q < splits)
            p[u][q] = *cluster.map_shared_rank(reinterpret_cast<float4*>(red + r * kRedLd + c4),
                                               base + q);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int idx = idx0 + u * kTcThreads;
        if (idx >= mine * kQuads) continue;
        const int j = idx / kQuads, c4 = (idx % kQuads) * 4;
        const int row = m0 + kidx + j * splits, col = n0 + c4;
        float acc4[4] = {p[u][0].x, p[u][0].y, p[u][0].z, p[u][0].w};
#pragma unroll
        for (int q = 1; q < kQ; ++q) {
          if (q >= splits) continue;
          acc4[0] += p[u][q].x;
          acc4[1] += p[u][q].y;
          acc4[2] += p[u][q].z;
          acc4[3] += p[u][q].w;
        }
        if (g.epi == kEpiPartial) {
          *reinterpret_cast<float4*>(static_cast<float*>(g.out) +
                                     static_cast<long long>(row) * g.ldo + col) =
              make_float4(acc4[0], acc4[1], acc4[2], acc4[3]);
          continue;
        }
        const float gate = g.epi == kEpiResidual ? gate_s[j] : 1.0f;
        float b4[4], r4[4] = {}, y[4];
        const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&braw[u]);
        b4[0] = __low2float(bh[0]);
        b4[1] = __high2float(bh[0]);
        b4[2] = __low2float(bh[1]);
        b4[3] = __high2float(bh[1]);
        if (g.epi == kEpiResidual) {
          const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&rraw[u]);
          r4[0] = __low2float(rh[0]);
          r4[1] = __high2float(rh[0]);
          r4[2] = __low2float(rh[1]);
          r4[3] = __high2float(rh[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = dense_epi<bf16>(g, acc4[e], b4[e], r4[e], gate);
        uint2 o;
        __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
        oh[0] = __floats2bfloat162_rn(y[0], y[1]);
        oh[1] = __floats2bfloat162_rn(y[2], y[3]);
        *reinterpret_cast<uint2*>(out + static_cast<long long>(row) * g.ldo + col) = o;
      }
    }
  };
  if (splits <= 2) {
    finish(std::integral_constant<int, 4>{}, std::integral_constant<int, 2>{});
  } else {
    finish(std::integral_constant<int, 2>{}, std::integral_constant<int, kMaxCluster>{});
  }
  cluster.sync();  // no CTA leaves while another still reads its tile
}

// The split of K (S) and the column tiles a cluster spans (Cn): S is the
// largest S <= 8 that divides K into 64-deep chunks and keeps the grid
// within one wave of CTAs (one an SM). With a LayerNorm prologue, Cn is the
// largest that keeps S * Cn <= 8 and divides the column tiles: the cluster's
// CTAs share the statistics, so each row is read for them once a cluster.
inline void tc_shape(const DenseArgs& g, int sms, int* splits, int* cn) {
  const int ntiles = g.N / kTcBN, tiles = ntiles * ((g.M + kTcBM - 1) / kTcBM);
  const int nk = g.K / kTcBK;
  *splits = 1;
  for (int s = 2; s <= kMaxCluster; ++s)
    if (nk % s == 0 && tiles * s <= sms) *splits = s;
  *cn = 1;
  if (g.ln_scale)
    for (int c = 2; c * *splits <= kMaxCluster; ++c)
      if (ntiles % c == 0) *cn = c;
}

// One launch on `stream`; N % 64 == 0 and K % 64 == 0 are the caller's
// checks, and in bf16 16-byte aligned A, W, LayerNorm, bias and residual
// rows (row strides a multiple of 8 elements; an f32 kEpiPartial output
// row a multiple of 4). `launches` counts the
// kernels started; `after_kernel`: A is the output of the kernel launched
// just before on the stream, and this one may start while it finishes.
template <typename T>
cudaError_t launch_dense(const DenseArgs& g, cudaStream_t stream, int* launches,
                        bool after_kernel = false) {
  if constexpr (sizeof(T) == 4) {
    const dim3 grid(g.N / kBN, (g.M + kBM - 1) / kBM);
    dense_f32_kernel<<<grid, kF32Threads, 0, stream>>>(g);
  } else {
    // once a process: the SM count, and the shared-memory limit of the
    // kernel this instantiation launches (each source that includes this
    // header has its own copy of the kernel)
    static int sms = 0;
    if (!sms) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaError_t err = cudaFuncSetAttribute(
          dense_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemMax);
      if (err != cudaSuccess) {
        sms = 0;
        return err;
      }
    }
    int splits = 1, cn = 1;
    tc_shape(g, sms, &splits, &cn);
    const size_t smem = kTcSmem + (g.ln_scale ? sizeof(bf16) * 2 * (g.K / splits) : 0);
    if (smem > kTcSmemMax) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g.N / kTcBN * splits, (g.M + kTcBM - 1) / kTcBM);
    cfg.blockDim = dim3(kTcThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits * cn;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = after_kernel ? 2 : 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, dense_tc_kernel, g, splits, splits * cn);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace ergm_decode
