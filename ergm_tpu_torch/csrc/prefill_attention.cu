// Prefill attention for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces ergm_tpu/ops/prefill_attention.py::_call, the Pallas kernel
// behind prefill_mha. It computes attention over merged-layout operands,
// q [B, L, H*64] and k/v [B, Lk, H*64], in two forms: causal (the prompt's
// self-attention prefill) and rectangular non-causal (cross-attention over
// the caption). The math and its rounding points are JAX's:
//   s = (q . k) * scale in f32;
//   causal form: s = where(kpos <= qpos, s, -1e9);
//   s += (1 - mask) * -1e9;
//   p = exp(s - m) / z with m and z taken over the whole row (two passes);
//   p rounded to v's dtype, out = sum_k p * v accumulated in f32,
//   rounded to the input dtype.
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s bf16 dense,
// 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s HBM). At the slice's self
// form, B=256, L=Lk=128, D=768, one layer is 4*B*L*L*D = 12.9 GFLOP,
// 13 us at the tensor-core rate, and its q/k/v/out traffic is
// 4*B*L*D*2 bytes = 201 MB, 60 us at the HBM rate: the problem is bound by
// bytes, not by the tensor cores. The design keeps the bytes at that floor:
// each (batch row, head) reads its q, k and v once, at head stride, straight
// out of the merged tensors (no split or merge copies), the scores and
// probabilities live only in shared memory (the plain path writes and
// re-reads f32 [B, H, L, Lk] scores, 201 MB per layer at this shape), and
// the output is written merged. Causal chunks above a query tile's
// diagonal are skipped. This first version forms both products in f32 on
// the CUDA cores, which sets its own floor near 190 us per layer at the
// self form, above the byte bound; moving them onto the tensor cores
// (mma.sync or wgmma) is the next step.
//
// Layout: one CTA of 128 threads per (batch row, head). Query rows go in
// tiles of 32; K and then V stream through shared memory in chunks of 64
// keys as f32. Each thread owns a 4x4 register tile: rows tr + 8i and keys
// (or head dims) tc + 16j. Shared rows are padded so column reads are free
// of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDh = 64;             // head dim (the GPT-2 family)
constexpr int kQT = 32;             // query rows per tile
constexpr int kCK = 64;             // keys per staged K/V chunk
constexpr int kThreads = 128;
constexpr int kRowPad = kDh + 1;    // f32 row stride of the q and k/v tiles
constexpr float kNegInf = -1e9f;    // the large-negative fill of JAX's math

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
  int score_stride;  // f32 row stride of the score tile
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

template <typename T>
cudaError_t launch(Args a, cudaStream_t stream) {
  // Score rows padded to 16 mod 32 floats: the two rows a warp touches
  // fall in opposite halves of the 32 banks.
  a.score_stride = (a.Lk + 31) / 32 * 32 + 16;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQT + kCK) * kRowPad +
                       static_cast<size_t>(kQT) * a.score_stride + a.Lk);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  prefill_mha_kernel<T><<<a.B * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int ergm_prefill_mha(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int dtype, int B,
                                int L, int Lk, int H, int q_sb, int q_sl,
                                int k_sb, int k_sl, int v_sb, int v_sl,
                                float scale, int causal, void* stream) {
  Args a{q, k, v, static_cast<const float*>(mask), out, B, L, Lk, H,
         q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, causal, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(a, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
