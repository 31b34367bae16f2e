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
// What bounds it on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16). At the
// slice's shape, B = 256, Lc = 32, D = 768, one layer reads 12.6 MB of int8
// cache, 0.8 MB of scales and 2.4 MB of weights: 4.9 us of bytes, against
// 0.6 GFLOP of projections (0.6 us): bytes bind it.
//
// Three launches, split where JAX rounds to the compute dtype, so no value
// changes at a boundary: (1) LN prologue + q projection, (2) the attention
// below, (3) c_proj + bias + capless-row gate + residual. The projections
// are the dense layer of decode_gemm.cuh: in bf16 on the tensor cores
// (mma.sync m16n8k16), each CTA on all B rows of a 64-column tile, K split
// over a cluster of 6 CTAs whose partials are added through distributed
// shared memory in a fixed order (no workspace, no reduce launch, no
// atomics; c_proj starts early by programmatic dependent launch); in fp32
// on the CUDA cores, unsplit (K3's fp32 bar is 2e-4). q and the attention
// output share one [B, D] buffer, which stays in L2: the attention reads
// its row of q into shared memory and writes its output over it. The
// capless-row gate is formed from the mask in (3)'s epilogue.
//
// The attention is one CTA of 256 threads per batch row and group of
// heads (6 of 12 at B = 256: the grid is kept within four CTAs an SM),
// launched by programmatic dependent launch. At its start it requests, by
// cp.async, the row's scales and mask and its ck and cv codes for up to 64
// caption tokens (all 32 of the slice's), read in place at layer li's
// offset into the stacked [L, B, Lc, D] / [L, B, Lc, H] buffers with
// 16-byte copies, consecutive threads on consecutive bytes; then it waits
// for the q projection and requests q. The reductions read shared memory:
// a thread takes one 16-byte chunk of its columns (8-byte where head_dim %
// 16 != 0) and every G-th token, the chunks of a head are added in order
// for the scores, and the groups are added in order for PV. One warp per
// head runs the f32 softmax. Longer captions go tile by tile. The scales
// keep the port's unpadded [.., H] layout (JAX's 128-lane padding is a TPU
// workaround).
//
// The tensor-parallel form: a model rank holds H of the model's heads, so
// its head width Dl = H * Dh differs from the model width Dm; Wq is [Dm,
// Dl] (its columns), Wp [Dl, Dm] (its rows) and the cross cache holds its
// heads. The q projection reads Dm-wide rows and writes Dl-wide ones, the
// attention runs on the rank's heads, and with partial = 1 c_proj writes
// its f32 partial product [B, Dm] (decode_gemm.cuh's kEpiPartial): the
// caller sums the partials over the model group and forms
// round(h + round(round(sum + bp) * has_caption)) itself.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py,
// device time): 0.039 ms a call in bf16, against 0.261 ms for the plain
// version and 0.0821 ms for the five-launch CUDA-core design before it;
// 8 times its bound. The attention kernel takes 12.4-14.6 us of device
// time (starting 2.5-4.4 us before the q projection ends);
// decode_gemm.cuh says what binds the projections.

#include <cstdint>

#include "decode_gemm.cuh"

namespace ergm_decode {

constexpr int kAttnThreads = 256;
constexpr int kAttnSmemMax = 200 * 1024;  // what a CTA may take; three fit an SM at Lc = 32

struct AttnArgs {
  void* qa;          // [B, D]: q in, the attention output out (D = H * Dh, this rank's heads)
  const int8_t* ck;  // layer li: [B, Lc, D]
  const int8_t* cv;
  const float* ks;   // layer li: [B, Lc, H]
  const float* vs;
  const float* mask;  // [B, Lc] 1 = real caption token, or null (all real)
  int Lc, H, Dh;
  float scale;
};

// V bytes of int8 codes (from shared memory) as floats.
template <int V>
__device__ __forceinline__ void codes(const int8_t* p, float (&x)[V]) {
  if constexpr (V == 16) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = static_cast<float>(c[e]);
  } else {
    const int2 raw = *reinterpret_cast<const int2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = static_cast<float>(c[e]);
  }
}

// 4 bytes from device to shared memory by cp.async.
__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The attention's shared memory for a token tile of tt caption tokens:
// the ck and cv tiles, q, the row's scales and mask, the scores and the
// partial sums.
inline size_t attn_smem(int D, int H, int Lc, int V, int tt) {
  const int nch = D / V, span = nch < kAttnThreads ? nch : kAttnThreads;
  const int groups = kAttnThreads / span;
  const int part = tt * nch > groups * D ? tt * nch : groups * D;
  return 2 * static_cast<size_t>(tt) * D +
         sizeof(float) * (static_cast<size_t>(D) + 3 * static_cast<size_t>(H) * Lc + Lc + part);
}

// Tokens a tile holds: the whole caption up to 64, fewer where the shared
// memory would not hold them; 0 if not even one token fits.
inline int attn_tile(int D, int H, int Lc, int V) {
  int tt = Lc < 64 ? Lc : 64;
  while (tt > 0 && attn_smem(D, H, Lc, V, tt) > kAttnSmemMax) --tt;
  return tt;
}

// One CTA per batch row and group of Hc heads (grid B x H / Hc). The ck
// and cv codes of a tile of tt tokens are staged in shared memory by
// 16-byte cp.async copies, consecutive threads on consecutive bytes, all
// issued at the start where the caption fits one tile; the reductions then
// read them from shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(kAttnThreads) cross_attn_kernel(const AttnArgs a, const int tt) {
  extern __shared__ __align__(16) unsigned char attn_smem_raw[];  // apart from the dense kernel's
  const int D = a.H * a.Dh, Hc = a.H / gridDim.y, h0 = blockIdx.y * Hc;
  const int Dl = Hc * a.Dh, col0 = h0 * a.Dh;  // this CTA's columns of the row
  const int nch = Dl / V, G = a.Dh / V, n16 = Dl / 16;
  const int span = min(nch, kAttnThreads), groups = kAttnThreads / span;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = tid / span, c0 = tid % span;  // token group and first chunk of this thread
  const bool busy = gi < groups;
  int8_t* kt = reinterpret_cast<int8_t*>(attn_smem_raw);  // [tt][Dl] ck tile
  int8_t* vt = kt + tt * Dl;                               // [tt][Dl] cv tile
  T* qs = reinterpret_cast<T*>(vt + tt * Dl);              // [Dl] q
  float* part = reinterpret_cast<float*>(qs + Dl);         // partial sums of both reductions
  float* ksm = part + (tt * nch > groups * Dl ? tt * nch : groups * Dl);  // [Lc][Hc] ck scales
  float* vsm = ksm + a.Lc * Hc;                            // [Lc][Hc] cv scales of the row
  float* mk = vsm + a.Lc * Hc;                             // [Lc] mask
  float* sc = mk + a.Lc;                                   // [Hc][Lc] scores, then p * v_scale
  const int b = blockIdx.x;
  const long long row = static_cast<long long>(b) * a.Lc;
  const int8_t* ck = a.ck + row * D + col0;
  const int8_t* cv = a.cv + row * D + col0;
  auto stage = [&](int8_t* dst, const int8_t* src, int t0, int n) {
    for (int i = tid; i < n * n16; i += kAttnThreads) {
      const int t = i / n16, c = i % n16;
      ergm_async::copy16(dst + t * Dl + c * 16, src + static_cast<long long>(t0 + t) * D + c * 16);
    }
    ergm_async::commit();
  };
  // the row's scales and mask with the first ck tile, then the first cv
  // tile, then (once the q projection is done) q
  for (int i = tid; i < a.Lc * Hc; i += kAttnThreads) {
    const long long at = (row + i / Hc) * a.H + h0 + i % Hc;
    copy4(ksm + i, a.ks + at);
    copy4(vsm + i, a.vs + at);
  }
  if (a.mask)
    for (int t = tid; t < a.Lc; t += kAttnThreads) copy4(mk + t, a.mask + row + t);
  stage(kt, ck, 0, min(tt, a.Lc));
  stage(vt, cv, 0, min(tt, a.Lc));
  griddep_wait();
  T* qa = static_cast<T*>(a.qa) + static_cast<long long>(b) * D + col0;
  constexpr int kQ16 = 16 / sizeof(T);
  for (int i = tid; i < Dl / kQ16; i += kAttnThreads)
    ergm_async::copy16(qs + i * kQ16, qa + i * kQ16);
  ergm_async::commit();

  // scores: thread (gi, c) forms chunk c's dot for tokens gi, gi + groups, ...
  for (int t0 = 0; t0 < a.Lc; t0 += tt) {
    const int nt = min(tt, a.Lc - t0);
    if (t0 > 0) stage(kt, ck, t0, nt);
    ergm_async::wait<0>();
    __syncthreads();
    if (busy) {
      for (int c = c0; c < nch; c += span) {
        float q[V], x[V];
#pragma unroll
        for (int e = 0; e < V; ++e) q[e] = Cvt<T>::load(qs + c * V + e);
        for (int tl = gi; tl < nt; tl += groups) {
          codes<V>(kt + tl * Dl + c * V, x);
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(x[e], q[e], s);
          part[tl * nch + c] = s;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * Hc; i += kAttnThreads) {  // a head's chunks, in order
      const int tl = i / Hc, h = i % Hc, t = t0 + tl;
      const float* p = part + tl * nch + h * G;
      float s = 0.0f;
      for (int j = 0; j < G; ++j) s += p[j];
      s = s * a.scale * ksm[t * Hc + h];
      if (a.mask) s += (1.0f - mk[t]) * kNegInf;
      sc[h * a.Lc + t] = s;
    }
    __syncthreads();  // the tile and the partials are consumed
  }

  for (int h = warp; h < Hc; h += kAttnThreads / 32) {
    float* srow = sc + h * a.Lc;
    float m = -INFINITY;
    for (int t = lane; t < a.Lc; t += 32) m = fmaxf(m, srow[t]);
    m = warp_max(m);
    float z = 0.0f;
    for (int t = lane; t < a.Lc; t += 32) z += expf(srow[t] - m);
    z = warp_sum(z);
    for (int t = lane; t < a.Lc; t += 32)
      srow[t] = expf(srow[t] - m) / z * vsm[t * Hc + h];
  }

  // PV: thread (gi, c) sums chunk c over tokens gi, gi + groups, ... in
  // order, across tiles in part; the groups are added in order at the end
  for (int t0 = 0; t0 < a.Lc; t0 += tt) {
    const int nt = min(tt, a.Lc - t0);
    if (t0 > 0) {
      __syncthreads();  // the previous cv tile is consumed
      stage(vt, cv, t0, nt);
    }
    ergm_async::wait<0>();
    __syncthreads();  // the cv tile and the probabilities are in place
    if (busy) {
      for (int c = c0; c < nch; c += span) {
        const float* w = sc + (c * V / a.Dh) * a.Lc + t0;
        float* pd = part + gi * Dl + c * V;
        float acc[V], x[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = t0 > 0 ? pd[e] : 0.0f;
        for (int tl = gi; tl < nt; tl += groups) {
          codes<V>(vt + tl * Dl + c * V, x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(x[e], w[tl], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(pd + e) =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      }
    }
  }
  __syncthreads();
  griddep_launch();  // the codes are read; c_proj may start
  for (int d = tid; d < Dl; d += kAttnThreads) {
    float s = 0.0f;
    for (int j = 0; j < groups; ++j) s += part[j * Dl + d];
    Cvt<T>::store(qa + d, s);
  }
}

// Heads a CTA takes: the fewest (a divisor of H, with 16-byte rows of
// codes) that keep the grid within four CTAs an SM.
inline int attn_heads(int B, int H, int Dh, int sms) {
  int hc = H;
  for (int d = H - 1; d >= 1; --d)
    if (H % d == 0 && (d * Dh) % 16 == 0 && static_cast<long long>(B) * (H / d) <= 4LL * sms)
      hc = d;
  return hc;
}

template <typename T, int V>
cudaError_t launch_attn(const AttnArgs& a, int B, cudaStream_t stream, int* launches) {
  static int sms = 0;  // once a process: the SM count and the kernel's shared-memory limit
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaFuncSetAttribute(
        cross_attn_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnSmemMax);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  const int hc = attn_heads(B, a.H, a.Dh, sms), dl = hc * a.Dh;
  const int tt = attn_tile(dl, hc, a.Lc, V);
  if (tt < 1) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, a.H / hc);
  cfg.blockDim = dim3(kAttnThreads);
  cfg.dynamicSmemBytes = attn_smem(dl, hc, a.Lc, V, tt);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];  // q is the output of the kernel launched just before
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cross_attn_kernel<T, V>, a, tt);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

template <typename T>
cudaError_t launch_cross(const void* h, int ldh, const void* ln_s, const void* ln_b, float eps,
                         const void* wq, const void* bq, const void* wp, const void* bp,
                         const AttnArgs& attn, void* out, int B, int Dm, bool partial,
                         cudaStream_t stream, int* launches) {
  const int D = attn.H * attn.Dh;  // the heads' width; Dm the model's
  DenseArgs qa{};
  qa.a = h;
  qa.lda = ldh;
  qa.w = wq;
  qa.bias = bq;
  qa.ln_scale = ln_s;
  qa.ln_bias = ln_b;
  qa.eps = eps;
  qa.out = attn.qa;
  qa.ldo = D;
  qa.M = B;
  qa.N = D;
  qa.K = Dm;
  qa.epi = kEpiNone;
  cudaError_t err = launch_dense<T>(qa, stream, launches);
  if (err != cudaSuccess) return err;

  err = attn.Dh % 16 == 0 ? launch_attn<T, 16>(attn, B, stream, launches)
                          : launch_attn<T, 8>(attn, B, stream, launches);
  if (err != cudaSuccess) return err;

  DenseArgs pa{};
  pa.a = attn.qa;
  pa.lda = D;
  pa.w = wp;
  pa.bias = bp;
  pa.res = h;
  pa.ldr = ldh;
  pa.gate_mask = attn.mask;
  pa.gate_len = attn.Lc;
  pa.out = out;
  pa.ldo = Dm;
  pa.M = B;
  pa.N = Dm;
  pa.K = D;
  pa.epi = partial ? kEpiPartial : kEpiResidual;
  return launch_dense<T>(pa, stream, launches, true);
}

}  // namespace ergm_decode

// dtype: 0 = float32, 1 = bfloat16. h [B, Dm] with row stride ldh; H heads
// of Dh (D = H * Dh: Dm itself on one card, this rank's heads under tensor
// parallelism); ck/cv and ck_scale/cv_scale point at layer li of the stacked
// caches; mask [B, Lc] or null. qa [B, D] holds q and then the attention
// output; out [B, Dm] gets the result, or with partial = 1 (f32) c_proj's
// partial product. *launches is set to the number of kernels started.
// Returns a cudaError_t.
extern "C" int ergm_fused_cross_decode(const void* h, int ldh, const void* ln_s,
                                       const void* ln_b, float eps, const void* wq,
                                       const void* bq, const void* wp, const void* bp,
                                       const void* ck, const void* cv, const void* ck_scale,
                                       const void* cv_scale, const void* mask, void* qa,
                                       void* out, int dtype, int B, int Lc, int H, int Dh,
                                       int Dm, int partial, float scale, int* launches,
                                       void* stream) {
  using namespace ergm_decode;
  *launches = 0;
  const int D = H * Dh;
  if (D % kTcBK || D % kTcBN || Dm % kTcBK || Dm % kTcBN || Dh % 8 || Lc < 1 ||
      (!partial && D != Dm))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs attn{qa, static_cast<const int8_t*>(ck), static_cast<const int8_t*>(cv),
                static_cast<const float*>(ck_scale), static_cast<const float*>(cv_scale),
                static_cast<const float*>(mask), Lc, H, Dh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch_cross<float>(h, ldh, ln_s, ln_b, eps, wq, bq, wp, bp, attn, out, B, Dm,
                            partial != 0, s, launches));
  if (dtype == 1)
    return static_cast<int>(
        launch_cross<bf16>(h, ldh, ln_s, ln_b, eps, wq, bq, wp, bp, attn, out, B, Dm,
                           partial != 0, s, launches));
  return static_cast<int>(cudaErrorInvalidValue);
}
