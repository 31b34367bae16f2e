// Single-token attention over an int8 KV cache for Hopper (sm_90a): kernel
// K2 of the port.
//
// Replaces ergm_tpu/ops/decode_attention.py::_call (the Pallas kernel behind
// decode_mha_int8). For one layer's int8 cache k, v [B, H, T, 64] with
// per-(token, head) scales ks, vs [B, H, T] and q [B, H, 64] it computes,
// per (b, h), the scale-factored math of the T >= 512 decode branch
// (ergm_tpu/models/gpt2.py:876-904):
//   s[t] = (q . k[t]) * scale * ks[t] + (1 - mask[t]) * -1e9   (f32)
//   p    = softmax over t <= index
//   out  = round(sum_t round(p[t] * vs[t]) * v[t])             [B, H*64]
// The rounding of p * vs to the compute dtype before the PV product is the
// model branch's (gpt2.py:900); in f32 it is exact, so with no mask this is
// JAX's kernel. Keys after `index` are skipped: their additive -1e9 tail
// mask makes exp(s - max) exactly 0 in f32 whenever a key at or before
// `index` is visible, which the decode step guarantees (its own token).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM). At the long-history shape,
// B = 64, H = 12, T = 512, one layer reads 2 * B * H * T * 64 = 50 MB of
// int8 cache (15 us at the HBM rate) and does 4 * B * H * T * 64 = 0.1 GFLOP:
// it is bound by the cache bytes. The design reads each cache byte once,
// straight from the stacked cache at layer li's offset (no dequantised
// copy, no per-layer slice), and keeps scores and probabilities in shared
// memory. One CTA of 128 threads per (b, h), 768 at that shape: one thread
// per key forms a score from four 16-byte loads of the int8 row; a two-pass
// f32 softmax over the row; then 64 threads per half of the keys accumulate
// p * v with consecutive threads on consecutive bytes, and the halves add.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit, B = 64, T = 512,
// index 400: 0.040-0.064 ms per call in bf16 over three runs, against
// 0.245-0.351 ms for the plain version.

#include <cstdint>

#include "decode_gemm.cuh"

namespace ergm_decode {

constexpr int kDh = 64;
constexpr int kDecodeThreads = 128;

struct DecodeArgs {
  const void* q;       // [B, H, 64] with strides q_sb, q_sh
  const int8_t* k;     // [B, H, T, 64]
  const int8_t* v;
  const void* ks;      // [B, H, T], f32 or bf16 (scale_bf16)
  const void* vs;
  const float* mask;   // [B, >= T] with row stride mask_sb, or null
  void* out;           // [B, H * 64]
  long long q_sb, q_sh, mask_sb;
  int H, T, index;
  float scale;
  int scale_bf16;
};

// One scale; the dtype flag is uniform across the grid, so the branch
// never diverges.
__device__ __forceinline__ float load_scale(const void* base, long long i, int bf16) {
  return bf16 ? Cvt<__nv_bfloat16>::load(static_cast<const __nv_bfloat16*>(base) + i)
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ float block_reduce_decode(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kDecodeThreads / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ float p[];  // [n] scores, then round(p * v_scale)
  __shared__ float qs[kDh];
  __shared__ float red[kDecodeThreads / 32];
  __shared__ float part[kDh];
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, tid = threadIdx.x;
  const int n = min(a.T, a.index + 1);
  const long long bh = static_cast<long long>(b) * a.H + h;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  if (tid < kDh) qs[tid] = Cvt<T>::load(q + tid);
  __syncthreads();

  const int8_t* k = a.k + bh * a.T * kDh;
  const float* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;
  float m = -INFINITY;
  for (int t = tid; t < n; t += kDecodeThreads) {
    const int4* kr = reinterpret_cast<const int4*>(k + static_cast<long long>(t) * kDh);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kDh / 16; ++c) {
      const int4 raw = kr[c];
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) s = fmaf(static_cast<float>(e[j]), qs[16 * c + j], s);
    }
    s = s * a.scale * load_scale(a.ks, bh * a.T + t, a.scale_bf16);
    if (mask) s += (1.0f - mask[t]) * kNegInf;
    p[t] = s;
    m = fmaxf(m, s);
  }
  m = block_reduce_decode(m, red, true);
  float z = 0.0f;
  for (int t = tid; t < n; t += kDecodeThreads) z += expf(p[t] - m);
  z = block_reduce_decode(z, red, false);
  for (int t = tid; t < n; t += kDecodeThreads)
    p[t] = Cvt<T>::round(expf(p[t] - m) / z * load_scale(a.vs, bh * a.T + t, a.scale_bf16));
  __syncthreads();

  const int8_t* v = a.v + bh * a.T * kDh;
  const int d = tid % kDh, half = tid / kDh;
  float acc = 0.0f;
  for (int t = half; t < n; t += kDecodeThreads / kDh)
    acc = fmaf(p[t], static_cast<float>(v[static_cast<long long>(t) * kDh + d]), acc);
  if (half == 1) part[d] = acc;
  __syncthreads();
  if (half == 0) Cvt<T>::store(static_cast<T*>(a.out) + bh * kDh + d, acc + part[d]);
}

template <typename T>
cudaError_t launch_decode(const DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(a.index + 1 < a.T ? a.index + 1 : a.T);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<B * a.H, kDecodeThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ergm_decode

// dtype (q and out): 0 = float32, 1 = bfloat16; scale_dtype (ks, vs) the
// same codes. k, v [B, H, T, 64] and ks, vs [B, H, T] contiguous (one layer
// of the stacked cache, by offset); mask [B, >= T] f32 with row stride
// mask_sb, or null. Keys 0..index are attended. Returns a cudaError_t.
extern "C" int ergm_decode_mha_int8(const void* q, long long q_sb, long long q_sh,
                                    const void* k, const void* v, const void* ks,
                                    const void* vs, const void* mask, long long mask_sb,
                                    void* out, int dtype, int scale_dtype, int B, int H, int T,
                                    int index, float scale, void* stream) {
  if (index < 0 || T < 1 || (scale_dtype != 0 && scale_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  using namespace ergm_decode;
  DecodeArgs a{q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks, vs,
               static_cast<const float*>(mask), out, q_sb, q_sh, mask_sb, H, T, index, scale,
               scale_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_decode<float>(a, B, s));
  if (dtype == 1) return static_cast<int>(launch_decode<__nv_bfloat16>(a, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
