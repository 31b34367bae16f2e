// Row-tiled dense layer for the single-token decode kernels K3 and K4.
//
// out = epilogue(round(A' @ W + bias)) for A [M, K] (row stride lda), W
// [K, N] row-major ([in, out], GPT-2's Conv1D orientation) and bias [N],
// all in the compute dtype T (float or bf16). A' is A itself, or the
// LayerNorm of A's rows when ln_scale is given: f32 statistics (mean, then
// the mean of centred squares), ((x - mean) * rsqrt(var + eps)) * scale +
// bias, rounded to T, as the port's layer_norm and JAX's kernels round it.
// The product accumulates in f32, the bias joins in f32 and the sum is
// rounded once to T, as cuBLAS's addmm epilogue does in the plain path.
// Epilogues, each rounding where the plain path rounds:
//   kEpiNone      y
//   kEpiGeluTanh  round(gelu_tanh(y))   (PyTorch's tanh-approximate formula)
//   kEpiGeluErf   round(gelu_erf(y))
//   kEpiResidual  round(res + round(y * gate[row]))  (gate 1 when null)
//
// Tiling: a CTA of 128 threads owns 16 rows x 64 columns and walks its
// share of K in chunks of 32, staging the A chunk (after LayerNorm) and
// the W chunk in shared memory as f32; W is read with 16-byte loads where
// it is aligned. Each thread keeps a 2 x 4 register tile (rows tr and
// tr + 8, columns 4 tc .. 4 tc + 3, read as one float4). At decode's
// M = 256 a W tile is read from device memory once and from L2 by the 16
// row tiles. Where the tiles alone would not fill the card (N = 768 gives
// 192 CTAs for 132 SMs), K is split over up to kMaxSplits CTAs: each
// writes its f32 partial sums to a workspace, and a second launch adds the
// partials in a fixed order and applies bias and epilogue, so no value is
// rounded before the end and the result does not depend on scheduling.
// The products run on the CUDA cores in f32; moving them to the tensor
// cores is later work.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ergm_decode {

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
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

enum Epilogue { kEpiNone = 0, kEpiGeluTanh = 1, kEpiGeluErf = 2, kEpiResidual = 3 };

struct DenseArgs {
  const void* a;         // [M, K], row stride lda
  const void* w;         // [K, N] row-major
  const void* bias;      // [N]
  const void* ln_scale;  // [K], or null: no LayerNorm prologue
  const void* ln_bias;   // [K]
  const void* res;       // [M, N] residual (kEpiResidual), row stride ldr
  const float* gate;     // [M] row gate (kEpiResidual), or null
  void* out;             // [M, N], row stride ldo
  float* partial;        // [splits, M, N] f32 workspace when splits > 1, or null
  long long partial_cap; // floats the workspace holds
  int lda, ldr, ldo;
  int M, N, K;
  int epi;
  float eps;
  int splits;            // set by launch_dense
  int vec_w;             // W is 16-byte aligned: stage it with vector loads
};

constexpr int kBM = 16, kBN = 64, kBK = 32, kGemmThreads = 128;
constexpr int kMaxSplits = 4;

// 16 bytes of W as f32: 8 bf16 or 4 floats.
template <typename T>
struct WVec;

template <>
struct WVec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

template <>
struct WVec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Bias, rounding and epilogue of one output element whose f32 sum is acc.
template <typename T>
__device__ __forceinline__ void dense_store(const DenseArgs& g, int row, int col, float acc) {
  float y = Cvt<T>::round(acc + Cvt<T>::load(static_cast<const T*>(g.bias) + col));
  if (g.epi == kEpiGeluTanh) {
    const float inner = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
    y = Cvt<T>::round(0.5f * y * (1.0f + tanhf(inner)));
  } else if (g.epi == kEpiGeluErf) {
    y = Cvt<T>::round(y * 0.5f * (1.0f + erff(y * 0.7071067811865476f)));
  } else if (g.epi == kEpiResidual) {
    const float gate = g.gate ? g.gate[row] : 1.0f;
    y = Cvt<T>::load(static_cast<const T*>(g.res) + static_cast<long long>(row) * g.ldr + col) +
        Cvt<T>::round(y * gate);
  }
  Cvt<T>::store(static_cast<T*>(g.out) + static_cast<long long>(row) * g.ldo + col, y);
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) dense_kernel(DenseArgs g) {
  __shared__ float as[kBK][kBM + 1];  // A chunk, k-major; +1 spreads the staging writes
  __shared__ __align__(16) float ws[kBK][kBN];
  __shared__ float mean_s[kBM], rstd_s[kBM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int klen = g.K / g.splits, kbeg = blockIdx.z * klen;
  const T* A = static_cast<const T*>(g.a);
  const T* W = static_cast<const T*>(g.w);
  const T* lns = static_cast<const T*>(g.ln_scale);
  const T* lnb = static_cast<const T*>(g.ln_bias);

  if (lns) {  // statistics over the whole row, whatever share of K this CTA takes
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const int row = m0 + r;
      float mean = 0.0f, rstd = 0.0f;
      if (row < g.M) {
        const T* x = A + static_cast<long long>(row) * g.lda;
        float s = 0.0f;
        for (int k = lane; k < g.K; k += 32) s += Cvt<T>::load(x + k);
        mean = warp_sum(s) / g.K;
        float v = 0.0f;
        for (int k = lane; k < g.K; k += 32) {
          const float d = Cvt<T>::load(x + k) - mean;
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
  for (int k0 = kbeg; k0 < kbeg + klen; k0 += kBK) {
    __syncthreads();  // the previous chunk is consumed; the statistics are written
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int r = i / kBK, k = i % kBK, row = m0 + r;
      float x = 0.0f;
      if (row < g.M) {
        x = Cvt<T>::load(A + static_cast<long long>(row) * g.lda + k0 + k);
        if (lns) {
          const float y = (x - mean_s[r]) * rstd_s[r];
          x = Cvt<T>::round(y * Cvt<T>::load(lns + k0 + k) + Cvt<T>::load(lnb + k0 + k));
        }
      }
      as[k][r] = x;
    }
    if (g.vec_w) {
      constexpr int kV = WVec<T>::kN;
      for (int i = tid; i < kBK * kBN / kV; i += kGemmThreads) {
        const int k = i / (kBN / kV), n = (i % (kBN / kV)) * kV;
        WVec<T>::load(W + static_cast<long long>(k0 + k) * g.N + n0 + n, &ws[k][n]);
      }
    } else {
      for (int i = tid; i < kBK * kBN; i += kGemmThreads) {
        const int k = i / kBN, n = i % kBN;
        ws[k][n] = Cvt<T>::load(W + static_cast<long long>(k0 + k) * g.N + n0 + n);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float a0 = as[k][tr], a1 = as[k][tr + 8];
      const float4 w = *reinterpret_cast<const float4*>(&ws[k][4 * tc]);
      acc[0][0] = fmaf(a0, w.x, acc[0][0]);
      acc[0][1] = fmaf(a0, w.y, acc[0][1]);
      acc[0][2] = fmaf(a0, w.z, acc[0][2]);
      acc[0][3] = fmaf(a0, w.w, acc[0][3]);
      acc[1][0] = fmaf(a1, w.x, acc[1][0]);
      acc[1][1] = fmaf(a1, w.y, acc[1][1]);
      acc[1][2] = fmaf(a1, w.z, acc[1][2]);
      acc[1][3] = fmaf(a1, w.w, acc[1][3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + tr + 8 * i;
    if (row >= g.M) continue;
    const int col = n0 + 4 * tc;
    if (g.splits > 1) {
      float4* p = reinterpret_cast<float4*>(
          g.partial + (static_cast<long long>(blockIdx.z) * g.M + row) * g.N + col);
      *p = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dense_store<T>(g, row, col + j, acc[i][j]);
    }
  }
}

// Second launch of a split product: the partials in split order, then bias
// and epilogue. One thread per output element.
template <typename T>
__global__ void __launch_bounds__(256) dense_reduce_kernel(DenseArgs g) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long mn = static_cast<long long>(g.M) * g.N;
  if (i >= mn) return;
  float acc = 0.0f;
  for (int z = 0; z < g.splits; ++z) acc += g.partial[z * mn + i];
  dense_store<T>(g, static_cast<int>(i / g.N), static_cast<int>(i % g.N), acc);
}

// Launch on `stream`; N % 64 == 0 and K % 32 == 0 are the caller's checks.
// K is split while the tiles fill fewer than four CTAs per SM of an H100,
// each share keeps at least four chunks and the workspace holds the
// partials.
template <typename T>
cudaError_t launch_dense(DenseArgs g, cudaStream_t stream) {
  const int tiles = (g.N / kBN) * ((g.M + kBM - 1) / kBM);
  const long long mn = static_cast<long long>(g.M) * g.N;
  g.splits = 1;
  while (g.partial && g.splits < kMaxSplits && tiles * g.splits < 4 * 132 &&
         (g.K / (2 * g.splits)) % kBK == 0 && g.K / (2 * g.splits) >= 4 * kBK &&
         2 * g.splits * mn <= g.partial_cap)
    g.splits *= 2;
  g.vec_w = reinterpret_cast<uintptr_t>(g.w) % 16 == 0;
  const dim3 grid(g.N / kBN, (g.M + kBM - 1) / kBM, g.splits);
  dense_kernel<T><<<grid, kGemmThreads, 0, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  dense_reduce_kernel<T><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace ergm_decode
