// Softmax cross-entropy over the tied vocab projection, forward and
// backward, for Hopper (sm_90a): kernel K6 of the port.
//
// Replaces ergm_tpu/ops/fused_ce.py::_fwd_impl and ::_vjp_bwd, the Pallas
// kernels behind fused_softmax_xent (bodies _fwd_kernel, _bwd_dh_kernel and
// _bwd_dw_kernel). For hidden h [N, D], the vocab table W [V, D] and
// labels [N], the loss needs two numbers per token, logZ = logsumexp_v
// (h . W_v) and the gold logit, and the gradient is
//   padj[n, v] = (v < V ? exp(s[n, v] - logZ[n]) : 0) * g[n] - [v == label[n]] g[n],
//   dh = padj . W, dW = padj^T . h,
// with padj rounded to h's type before both products (JAX's _padj). No
// [N, V] logits or gradient ever reach device memory. Labels < 0 get zero
// gradient (their g is taken as 0) and the NLL logZ.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).
// At the training slice, N = 48*512 = 24,576 tokens, V = 50,271, D = 768,
// the forward is 2NVD = 1.9 TFLOP (1.9 ms on the tensor cores) and each
// backward kernel recomputes those logits and forms one more product of the
// same size (3.8 TFLOP for the two required products, 3.8 ms), while h is
// 38 MB and W 77 MB: operations bind, by far. The design keeps every
// product on the tensor cores (nvcuda::wmma, 16x16x16 bf16, f32
// accumulate) and every intermediate on chip, with no atomics, so the
// result does not depend on scheduling:
//   forward and dh: one CTA per 32-token block; its h rows stay in shared
//     memory while it walks the vocab in 64-row tiles of W (the TPU's
//     sequential vocab grid becomes this loop). The forward keeps an online
//     max and sum per token in registers; dh accumulates padj . W_tile into
//     a [32, D] f32 sum held in the warps' wmma accumulators.
//   dW: the mirror, one CTA per 32-row vocab tile holding its W rows,
//     walking the tokens in 64-row tiles of h and accumulating padj^T . h.
// Each W (or h) tile is read from L2 once per CTA, so W is re-read N/32
// times; the tiles arrive by cp.async, all of a tile's 16-byte copies in
// flight at once. A pipelined wgmma version with larger tiles and TMA is
// later work. f32 operands (the parity tests) use f32 FMAs on the CUDA
// cores with 16-row resident and 32-row streamed tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "cp_async.cuh"

namespace ergm_xent {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 1024;
constexpr float kNeg = -1e30f;

enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

template <typename T>
struct Tr;

template <>
struct Tr<float> {
  static constexpr int R = 16;   // resident rows per CTA
  static constexpr int M = 32;   // streamed rows per tile
  static constexpr int kPad = 1;   // operand tile stride D + 1: conflict-free column reads
  static constexpr int kPadS = 1;
  static __device__ __forceinline__ float cvt(float x) { return x; }
};

template <>
struct Tr<bf16> {
  static constexpr int R = 32;
  static constexpr int M = 64;
  static constexpr int kPad = 8;   // wmma: stride a multiple of 8, rows 16 B aligned
  static constexpr int kPadS = 4;  // wmma: f32 stride a multiple of 4
  static __device__ __forceinline__ bf16 cvt(float x) { return __float2bfloat16_rn(x); }
};

struct Args {
  const void* h;      // [N, D]
  const void* w;      // [V, D]
  const int* labels;  // [N]
  const float* logz;  // [N] (backward)
  const float* g;     // [N] cotangent of the NLL (backward)
  float* nll;         // [N] (forward)
  float* logz_out;    // [N] (forward)
  void* out;          // dh [N, D] or dW [V, D]
  int N, V, D;
};

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

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
struct Layout {
  int ld, lds, ldp;
  size_t res, str, s, p, vec, total;
  __host__ __device__ explicit Layout(int D) {
    ld = D + Tr<T>::kPad;
    lds = Tr<T>::M + Tr<T>::kPadS;
    ldp = Tr<T>::M + Tr<T>::kPad;
    res = 0;
    str = align128(res + sizeof(T) * Tr<T>::R * ld);
    s = align128(str + sizeof(T) * Tr<T>::M * ld);
    p = align128(s + sizeof(float) * Tr<T>::R * lds);
    vec = align128(p + sizeof(T) * Tr<T>::R * ldp);
    total = vec + 3 * sizeof(float) * Tr<T>::M;
  }
};

// Rows [row0, row0 + rows) of a [limit, D] table into a tile of stride ld;
// rows past the table are zero. 16 bytes at a time: bf16 rows by cp.async
// (complete after ergm_async::wait_all()), f32 rows, whose odd tile stride
// is not 16-byte aligned, through registers.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int row0, int limit,
                                           int rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int per = D / kVec;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i % per) * kVec;
    const bool real = row0 + r < limit;
    const T* from = src + static_cast<long long>(row0 + r) * D + c;
    if constexpr (sizeof(T) == 2) {
      if (real) {
        ergm_async::copy16(dst + r * ld + c, from);
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (real) val = *reinterpret_cast<const uint4*>(from);
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[r * ld + c + e] = f[e];
    }
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

// s[R x M] (f32, stride lds) = res[R x D] . str[M x D]^T.
template <typename T>
__device__ __forceinline__ void logit_tile(float* s, const T* res, const T* str,
                                           const Layout<T>& L, int D) {
  constexpr int R = Tr<T>::R, M = Tr<T>::M;
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert((R / 16) * (M / 16) == kWarps, "one logit fragment per warp");
    const int w = threadIdx.x >> 5, fi = w / (M / 16), fj = w % (M / 16);
    // two accumulators over alternate 16-wide steps of D halve the chain of
    // dependent products; D is a multiple of 128, so the steps pair up
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
    wmma::fill_fragment(c[0], 0.0f);
    wmma::fill_fragment(c[1], 0.0f);
    for (int k = 0; k < D; k += 32) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, res + fi * 16 * L.ld + k + 16 * e, L.ld);
        wmma::load_matrix_sync(bfr, str + fj * 16 * L.ld + k + 16 * e, L.ld);
        wmma::mma_sync(c[e], af, bfr, c[e]);
      }
    }
#pragma unroll
    for (int i = 0; i < c[0].num_elements; ++i) c[0].x[i] += c[1].x[i];
    wmma::store_matrix_sync(s + fi * 16 * L.lds + fj * 16, c[0], L.lds, wmma::mem_row_major);
  } else {
    for (int idx = threadIdx.x; idx < R * M; idx += kThreads) {
      const int i = idx / M, j = idx % M;
      float acc = 0.0f;
      for (int k = 0; k < D; ++k) acc = fmaf(res[i * L.ld + k], str[j * L.ld + k], acc);
      s[i * L.lds + j] = acc;
    }
  }
}

// p[R x M] = padj of the logit tile, rounded to T. Token-resident tiles
// (dh) index tokens by row; vocab-resident ones (dW) by column.
template <typename T, bool kVocabRows>
__device__ __forceinline__ void padj_tile(T* p, const float* s, const Layout<T>& L,
                                          const Args& a, int row0, int col0, const int* lbl,
                                          const float* lz, const float* g) {
  constexpr int R = Tr<T>::R, M = Tr<T>::M;
  for (int idx = threadIdx.x; idx < R * M; idx += kThreads) {
    const int i = idx / M, j = idx % M;
    const int t = kVocabRows ? j : i;            // token slot
    const int v = kVocabRows ? row0 + i : col0 + j;  // vocab row
    float x = v < a.V ? expf(s[i * L.lds + j] - lz[t]) * g[t] : 0.0f;
    if (v == lbl[t]) x -= g[t];
    p[i * L.ldp + j] = Tr<T>::cvt(x);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) xent_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = Tr<T>::R, M = Tr<T>::M;
  const int D = a.D;
  const Layout<T> L(D);
  T* res = reinterpret_cast<T*>(smem + L.res);
  T* str = reinterpret_cast<T*>(smem + L.str);
  float* s = reinterpret_cast<float*>(smem + L.s);
  T* p = reinterpret_cast<T*>(smem + L.p);
  int* lbl = reinterpret_cast<int*>(smem + L.vec);
  float* lz = reinterpret_cast<float*>(lbl + M);
  float* gg = lz + M;

  const int r0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  constexpr bool vocab_rows = MODE == kDw;
  stage_rows(res, L.ld, vocab_rows ? w : h, r0, vocab_rows ? a.V : a.N, R, D);
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

  // backward: the [R, D] f32 sum, in wmma accumulators (bf16: warp w holds
  // columns [w D/8, (w+1) D/8)) or in registers (f32: thread t holds
  // columns t + 256 c)
  constexpr int kColFrags = kMaxD / (16 * kWarps);
  constexpr int kCols = kMaxD / kThreads;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[R / 16][kColFrags];
  float facc[std::is_same<T, float>::value ? R : 1][kCols];
  const int ncf = D / (16 * kWarps);
  if constexpr (MODE != kFwd) {
    if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
      for (int r = 0; r < R / 16; ++r)
#pragma unroll
        for (int c = 0; c < kColFrags; ++c) wmma::fill_fragment(acc[r][c], 0.0f);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) facc[r][c] = 0.0f;
    }
  }

  const int limit = vocab_rows ? a.N : a.V;
  for (int t0 = 0; t0 < limit; t0 += M) {
    __syncthreads();  // the previous tile is done with str, s and p
    stage_rows(str, L.ld, vocab_rows ? h : w, t0, limit, M, D);
    if (vocab_rows) stage_tokens(a, t0, M, lbl, lz, gg, true);
    ergm_async::wait_all();  // the resident rows too, on the first tile
    __syncthreads();
    logit_tile<T>(s, res, str, L, D);
    __syncthreads();
    if constexpr (MODE == kFwd) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = warp * kRows + i;
        float sv[M / 32], tmax = kNeg, gsum = 0.0f;
#pragma unroll
        for (int e = 0; e < M / 32; ++e) {
          const int col = lane + 32 * e, v = t0 + col;
          sv[e] = v < a.V ? s[row * L.lds + col] : kNeg;
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
      padj_tile<T, vocab_rows>(p, s, L, a, r0, t0, lbl, lz, gg);
      __syncthreads();
      // acc[R x D] += p[R x M] . str[M x D]
      if constexpr (std::is_same<T, bf16>::value) {
        const int col0 = warp * (D / kWarps);
#pragma unroll
        for (int kf = 0; kf < M / 16; ++kf) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[R / 16];
#pragma unroll
          for (int r = 0; r < R / 16; ++r)
            wmma::load_matrix_sync(af[r], p + r * 16 * L.ldp + kf * 16, L.ldp);
#pragma unroll
          for (int c = 0; c < kColFrags; ++c) {
            if (c < ncf) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(bfr, str + kf * 16 * L.ld + col0 + c * 16, L.ld);
#pragma unroll
              for (int r = 0; r < R / 16; ++r) wmma::mma_sync(acc[r][c], af[r], bfr, acc[r][c]);
            }
          }
        }
      } else {
        for (int k = 0; k < M; ++k) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int col = threadIdx.x + kThreads * c;
            if (col < D) {
              const float b = str[k * L.ld + col];
#pragma unroll
              for (int r = 0; r < R; ++r) facc[r][c] = fmaf(p[r * L.ldp + k], b, facc[r][c]);
            }
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
    T* out = static_cast<T*>(a.out);
    const int rows_total = vocab_rows ? a.V : a.N;
    if constexpr (std::is_same<T, bf16>::value) {
      __syncthreads();  // str is free: stage the f32 sums there
      float* stage = reinterpret_cast<float*>(str);
      const int lda = D + 4;
      const int col0 = warp * (D / kWarps);
#pragma unroll
      for (int r = 0; r < R / 16; ++r)
#pragma unroll
        for (int c = 0; c < kColFrags; ++c)
          if (c < ncf)
            wmma::store_matrix_sync(stage + r * 16 * lda + col0 + c * 16, acc[r][c], lda,
                                    wmma::mem_row_major);
      __syncthreads();
      for (int i = threadIdx.x; i < R * D; i += kThreads) {
        const int r = i / D, c = i % D;
        if (r0 + r < rows_total)
          out[static_cast<long long>(r0 + r) * D + c] = Tr<T>::cvt(stage[r * lda + c]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = threadIdx.x + kThreads * c;
          if (col < D && r0 + r < rows_total)
            out[static_cast<long long>(r0 + r) * D + col] = facc[r][c];
        }
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.D % 128 || a.D > kMaxD) return cudaErrorInvalidValue;
  const Layout<T> L(a.D);
  cudaError_t err = cudaFuncSetAttribute(xent_kernel<T, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const int rows = MODE == kDw ? a.V : a.N;
  const int grid = (rows + Tr<T>::R - 1) / Tr<T>::R;
  xent_kernel<T, MODE><<<grid, kThreads, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
int dispatch(const Args& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float, MODE>(a, s));
  if (dtype == 1) return static_cast<int>(launch<bf16, MODE>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ergm_xent

// dtype: 0 = float32, 1 = bfloat16; h [N, D] and W [V, D] contiguous, D a
// multiple of 128 up to 1024. Each returns a cudaError_t (0 on success).
extern "C" int ergm_xent_fwd(const void* h, const void* w, const void* labels, void* nll,
                             void* logz, int dtype, int N, int V, int D, void* stream) {
  ergm_xent::Args a{h, w, static_cast<const int*>(labels), nullptr, nullptr,
                    static_cast<float*>(nll), static_cast<float*>(logz), nullptr, N, V, D};
  return ergm_xent::dispatch<ergm_xent::kFwd>(a, dtype, stream);
}

extern "C" int ergm_xent_bwd_dh(const void* h, const void* w, const void* labels,
                                const void* logz, const void* g, void* dh, int dtype, int N,
                                int V, int D, void* stream) {
  ergm_xent::Args a{h, w, static_cast<const int*>(labels), static_cast<const float*>(logz),
                    static_cast<const float*>(g), nullptr, nullptr, dh, N, V, D};
  return ergm_xent::dispatch<ergm_xent::kDh>(a, dtype, stream);
}

extern "C" int ergm_xent_bwd_dw(const void* h, const void* w, const void* labels,
                                const void* logz, const void* g, void* dw, int dtype, int N,
                                int V, int D, void* stream) {
  ergm_xent::Args a{h, w, static_cast<const int*>(labels), static_cast<const float*>(logz),
                    static_cast<const float*>(g), nullptr, nullptr, dw, N, V, D};
  return ergm_xent::dispatch<ergm_xent::kDw>(a, dtype, stream);
}
