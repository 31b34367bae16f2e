// Fused cross-attention sublayer of a decode step for Hopper (sm_90a):
// kernel K3 of the port.
//
// Replaces ergm_tpu/ops/cross_decode.py::_call (the Pallas kernel behind
// fused_cross_decode). For h [B, D] (one token per row) and layer li of the
// int8 cross cache it computes
//   q   = round(ln_cross(h) @ Wq + bq)                           [B, D]
//   s   = (sum_{d in head} ck[t, d] * q[d]) * scale * ck_scale[t, h]
//   s  += (1 - mask[t]) * -1e9;  p = softmax_t(s) * cv_scale[t, h]
//   a   = round(sum_t cv[t, d] * p[t, head(d)])                  [B, D]
//   out = round(h + round(round(a @ Wp + bp) * has_caption))
// with the rounding points of JAX's kernel (cross_decode.py:65-106) and of
// the port's plain int8 cross decode branch: f32 LN statistics, f32 products
// of the raw int8 codes, f32 softmax over the caption, the per-(token, head)
// scales factored out of both reductions.
//
// Three stages, split where JAX rounds to the compute dtype: (1) LN
// prologue + q projection (decode_gemm.cuh), (2) the attention below, (3)
// c_proj + bias + capless-row gate + residual (decode_gemm.cuh). At the
// slice's shape each projection has only 192 tiles of 16 x 64 for 132 SMs,
// so it splits K four ways and adds the f32 partials in a second launch:
// five launches in all, and no value is rounded at the extra boundaries. The cache
// and its scales are read in place at layer li's offset into the stacked
// [L, B, Lc, D] / [L, B, Lc, H] buffers: no per-layer slice is copied. The
// scales keep the port's unpadded [.., H] layout (JAX's 128-lane padding is
// a TPU workaround).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 CUDA cores).
// At the slice's shape, B = 256, Lc = 32, D = 768, one layer reads 12.6 MB of
// int8 cache (3.8 us at the HBM rate) and does 2 * 2 * B * D * D = 0.6 GFLOP
// in its two projections (9 us at the f32 peak): on the CUDA cores the
// projections bound it. The attention is one CTA of 128 threads per batch
// row: q is staged in shared memory, one thread per (head, caption token)
// forms a score from 8-byte loads of the int8 row (threads of a warp share
// the head, so q reads are broadcasts), one warp per head runs the softmax,
// and one thread per output column accumulates p * v over the caption with
// consecutive threads on consecutive bytes. Measured on an NVIDIA H100 80GB
// HBM3 at its 700 W limit: 0.083 ms per call in bf16, against 0.415 ms for
// the plain version.

#include <cstdint>

#include "decode_gemm.cuh"

namespace ergm_decode {

constexpr int kAttnThreads = 128;

struct AttnArgs {
  const void* q;       // [B, D]
  const int8_t* ck;    // layer li: [B, Lc, D]
  const int8_t* cv;
  const float* ks;     // layer li: [B, Lc, H]
  const float* vs;
  const float* mask;   // [B, Lc] 1 = real caption token, or null (all real)
  void* out;           // [B, D]
  float* has;          // [B] 1 if the row has a real caption token
  float* partial;      // the projections' split workspace (decode_gemm.cuh)
  long long partial_cap;
  int Lc, H, Dh;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kAttnThreads) cross_attn_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int D = a.H * a.Dh;
  float* qs = smem;      // [D] q in f32
  float* sc = qs + D;    // [H][Lc] scores, then p * v_scale
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long row = static_cast<long long>(b) * a.Lc;
  const T* q = static_cast<const T*>(a.q) + static_cast<long long>(b) * D;
  for (int d = tid; d < D; d += kAttnThreads) qs[d] = Cvt<T>::load(q + d);
  __syncthreads();

  const int8_t* ck = a.ck + row * D;
  for (int i = tid; i < a.H * a.Lc; i += kAttnThreads) {
    const int h = i / a.Lc, t = i % a.Lc;
    const int8_t* kr = ck + static_cast<long long>(t) * D + h * a.Dh;
    const float* qh = qs + h * a.Dh;
    float s = 0.0f;
    for (int d = 0; d < a.Dh; d += 8) {
      const int2 raw = *reinterpret_cast<const int2*>(kr + d);
      const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(static_cast<float>(c[e]), qh[d + e], s);
    }
    s = s * a.scale * a.ks[(row + t) * a.H + h];
    if (a.mask) s += (1.0f - a.mask[row + t]) * kNegInf;
    sc[i] = s;
  }
  __syncthreads();

  for (int h = warp; h < a.H; h += kAttnThreads / 32) {
    float* srow = sc + h * a.Lc;
    float m = -INFINITY;
    for (int t = lane; t < a.Lc; t += 32) m = fmaxf(m, srow[t]);
    m = warp_max(m);
    float z = 0.0f;
    for (int t = lane; t < a.Lc; t += 32) z += expf(srow[t] - m);
    z = warp_sum(z);
    for (int t = lane; t < a.Lc; t += 32)
      srow[t] = expf(srow[t] - m) / z * a.vs[(row + t) * a.H + h];
  }
  if (tid == 0) {
    float n = 1.0f;
    if (a.mask) {
      n = 0.0f;
      for (int t = 0; t < a.Lc; ++t) n += a.mask[row + t];
    }
    a.has[b] = n > 0.0f ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int8_t* cv = a.cv + row * D;
  T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * D;
  for (int d = tid; d < D; d += kAttnThreads) {
    const float* w = sc + (d / a.Dh) * a.Lc;
    float acc = 0.0f;
    for (int t = 0; t < a.Lc; ++t)
      acc = fmaf(static_cast<float>(cv[static_cast<long long>(t) * D + d]), w[t], acc);
    Cvt<T>::store(out + d, acc);
  }
}

template <typename T>
cudaError_t launch_cross(const void* h, int ldh, const void* ln_s, const void* ln_b, float eps,
                         const void* wq, const void* bq, const void* wp, const void* bp,
                         const AttnArgs& attn, int B, cudaStream_t stream) {
  const int D = attn.H * attn.Dh;
  DenseArgs qa{};
  qa.a = h;
  qa.lda = ldh;
  qa.w = wq;
  qa.bias = bq;
  qa.ln_scale = ln_s;
  qa.ln_bias = ln_b;
  qa.eps = eps;
  qa.out = const_cast<void*>(attn.q);
  qa.ldo = D;
  qa.M = B;
  qa.N = D;
  qa.K = D;
  qa.epi = kEpiNone;
  qa.partial = attn.partial;
  qa.partial_cap = attn.partial_cap;
  cudaError_t err = launch_dense<T>(qa, stream);
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) * (static_cast<size_t>(D) + attn.H * attn.Lc);
  err = cudaFuncSetAttribute(cross_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cross_attn_kernel<T><<<B, kAttnThreads, smem, stream>>>(attn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  DenseArgs pa{};
  pa.a = attn.out;
  pa.lda = D;
  pa.w = wp;
  pa.bias = bp;
  pa.res = h;
  pa.ldr = ldh;
  pa.gate = attn.has;
  pa.out = const_cast<void*>(attn.q);  // q is consumed; its buffer takes the result
  pa.ldo = D;
  pa.M = B;
  pa.N = D;
  pa.K = D;
  pa.epi = kEpiResidual;
  pa.partial = attn.partial;
  pa.partial_cap = attn.partial_cap;
  return launch_dense<T>(pa, stream);
}

}  // namespace ergm_decode

// dtype: 0 = float32, 1 = bfloat16. h [B, D] with row stride ldh; ck/cv and
// ck_scale/cv_scale point at layer li of the stacked caches; mask [B, Lc] or
// null. qbuf, abuf [B, D], has [B] and partial (partial_cap floats; with
// kMaxSplits * B * D each projection splits fully) are scratch buffers:
// qbuf holds the q projection and then the sublayer's output. Returns a
// cudaError_t.
extern "C" int ergm_fused_cross_decode(const void* h, int ldh, const void* ln_s,
                                       const void* ln_b, float eps, const void* wq,
                                       const void* bq, const void* wp, const void* bp,
                                       const void* ck, const void* cv, const void* ck_scale,
                                       const void* cv_scale, const void* mask, void* qbuf,
                                       void* abuf, void* has, void* partial,
                                       long long partial_cap, int dtype, int B, int Lc, int H,
                                       int Dh, float scale, void* stream) {
  using namespace ergm_decode;
  const int D = H * Dh;
  if (D % kBK || D % kBN || Dh % 8 || Lc < 1) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs attn{qbuf, static_cast<const int8_t*>(ck), static_cast<const int8_t*>(cv),
                static_cast<const float*>(ck_scale), static_cast<const float*>(cv_scale),
                static_cast<const float*>(mask), abuf, static_cast<float*>(has),
                static_cast<float*>(partial), partial_cap, Lc, H, Dh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch_cross<float>(h, ldh, ln_s, ln_b, eps, wq, bq, wp, bp, attn, B, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_cross<__nv_bfloat16>(h, ldh, ln_s, ln_b, eps, wq, bq, wp, bp, attn, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
