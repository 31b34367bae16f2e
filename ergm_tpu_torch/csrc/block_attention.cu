// Masked attention with probability dropout, forward and backward, for
// Hopper (sm_90a): kernel K5 of the port.
//
// Replaces ergm_tpu/ops/block_attention.py::_fwd and ::_bwd, the Pallas
// kernels behind block_mha (bodies _fwd_kernel and _bwd_kernel). The math
// and its rounding points are JAX's (one q sub-block, the whole row):
//   s = (q . k) * scale in f32; s = where(kv_mask & causal, s, -1e9);
//   pn = exp(s - m) / max(l, 1e-30) with m, l over the row; pn = 0 on
//   padded query rows; dropout: pn = keep ? pn / (1 - rate) : 0;
//   pn rounded to the input type, o = sum pn . v accumulated in f32.
// Backward: dpn = dO . v; with dropout dpn = keep ? dpn * inv : 0 and the
// dV operand pv = keep ? pn * inv : 0; ds = pn * (dpn - delta), rounded to
// the input type; dQ = scale * ds . K, dK = scale * ds^T . Q, dV = pv^T dO.
//
// The keep mask is JAX's counter hash of its interpret mode (_keep_mask):
// mix = seed + b*H + h, x = r*Lk + c + mix*2654435761 (mod 2^32), three
// xorshift-multiply rounds, keep iff x >= rate*2^32. The TPU's hardware
// random stream cannot be reproduced on another device; the hash gives the
// same mask here, in the plain version and in JAX's interpret-mode kernel,
// and the backward and a rematerialised forward regenerate it from the seed.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).
// At the training slice, B=48, H=12, L=512, Dh=64, causal, one layer's
// forward reads q, k, v and writes o: 4 x 37.7 MB = 151 MB, 45 us at the
// HBM rate, against ~19 GFLOP of products, 20 us on the tensor cores: bytes
// bind. The backward moves about 8 x 37.7 MB, ~90 us. The TPU kernel holds
// a whole [L, L] f32 score block in VMEM (1 MB at L=512); an SM has 227 KB
// of shared memory, so this design tiles: 64-row query tiles against
// 64-key tiles, scores only in shared memory, causal tiles above the
// diagonal skipped. To keep JAX's rounding points (the probabilities are
// normalised by the whole row's statistics before they are rounded) the
// forward walks the keys twice: pass 1 takes the row max m and sum l online
// in f32, pass 2 recomputes s and accumulates the rounded pn . V. It writes
// m and l (8 bytes a row) so that the backward's pn is bit-identical to the
// forward's without a pass of its own. The backward is two kernels with no
// atomics, so its result does not depend on scheduling: dQ (one CTA per
// query tile, over the key tiles; it also writes delta = rowsum(dO * O) in
// f32, which equals JAX's sum(pn * dpn) up to summation order in f32 and
// differs in bf16 by O's rounding), then dK/dV (one CTA per key tile, over
// the query tiles that see it). bf16 products run on the tensor cores
// through nvcuda::wmma (16x16x16, f32 accumulate); f32 operands use f32
// FMAs on the CUDA cores, so the f32 result holds JAX's bars with TF32 off.
// bf16 tiles arrive by cp.async, all of a tile's copies in flight at once.
// wgmma, TMA and keeping the score tiles in registers are later work.
//
// Rows whose every visible key is masked (causal rows before the first real
// key) get JAX's forward result too: the uniform distribution over all Lk
// keys; their query tiles walk every key tile instead of stopping at the
// diagonal. Their gradient is the forward's true one (the plain version's):
// masked scores are constants, so their ds is 0 (JAX's hand-written
// backward gives them pn * (dpn - delta)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "cp_async.cuh"

namespace ergm_block {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kDh = 64;       // head dim
constexpr int kT = 64;        // query rows and keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e9f;

template <typename T>
struct Tr;

template <>
struct Tr<float> {
  static constexpr int kLd = kT + 1;   // element stride of operand tiles
  static constexpr int kLdC = kT + 1;  // f32 stride of score and sum tiles
  static __device__ __forceinline__ float cvt(float x) { return x; }
  static __device__ __forceinline__ float f32(float x) { return x; }
};

template <>
struct Tr<bf16> {
  static constexpr int kLd = kT + 8;   // wmma: a multiple of 8, rows 16 B aligned
  static constexpr int kLdC = kT + 4;  // wmma: a multiple of 4
  static __device__ __forceinline__ bf16 cvt(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;    // forward: o
  void* dq;
  void* dk;
  void* dv;
  float* ml;     // [2, B, H, L]: row max m, then row sum l
  float* delta;  // [B, H, L]
  const int* qmask;  // [B, L]
  const int* kmask;  // [B, Lk]
  int B, H, L, Lk;
  long long st[8][3];  // (batch, head, row) strides of q, k, v, o, dout, dq, dk, dv
  float scale;
  int causal, dropout;
  float drop_div, drop_mul;  // 1 - rate and 1 / (1 - rate)
  unsigned thr, seed;
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ bool keep(const Args& a, int b, int h, int r, int c) {
  const unsigned mix = a.seed + static_cast<unsigned>(b * a.H + h);
  unsigned x = static_cast<unsigned>(r) * static_cast<unsigned>(a.Lk) +
               static_cast<unsigned>(c) + mix * 2654435761u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= a.thr;
}

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

template <typename T>
__device__ __forceinline__ const T* head(const Args& a, const void* base, int which, int b,
                                         int h) {
  return static_cast<const T*>(base) + b * a.st[which][0] + h * a.st[which][1];
}

// Stage rows [0, 64) of one head (row stride sl elements, 64 contiguous
// elements each) into an operand tile, 16 bytes at a time: bf16 rows by
// cp.async (complete after ergm_async::wait_all()), f32 rows, whose odd
// tile stride is not 16-byte aligned, through registers.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long sl) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = kDh / kVec;
  constexpr int ld = Tr<T>::kLd;
  for (int i = threadIdx.x; i < kT * kPer; i += kThreads) {
    const int r = i / kPer, c = (i % kPer) * kVec;
    if constexpr (sizeof(T) == 2) {
      ergm_async::copy16(dst + r * ld + c, src + r * sl + c);
    } else {
      const uint4 val = *reinterpret_cast<const uint4*>(src + r * sl + c);
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[r * ld + c + e] = f[e];
    }
  }
}

// c[64 x 64] (f32, stride kLdC) = (acc ? c : 0) + A . B over k in [0, 64).
// A(i, k) = a[i*ld + k], or a[k*ld + i] when AT; B(k, j) = b[k*ld + j], or
// b[j*ld + k] when BT. Each output has one owner: bf16 warp w owns rows
// [16w, 16w + 16) through wmma; f32 threads sum k in order with FMAs.
template <typename T, bool AT, bool BT>
__device__ __forceinline__ void mma64(float* c, const T* a, const T* b, bool acc) {
  constexpr int ld = Tr<T>::kLd, ldc = Tr<T>::kLdC;
  if constexpr (std::is_same<T, bf16>::value) {
    using LA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
    const int w = threadIdx.x >> 5;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (acc) {
        wmma::load_matrix_sync(cf[j], c + w * 16 * ldc + j * 16, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(cf[j], 0.0f);
      }
    }
#pragma unroll
    for (int kf = 0; kf < 4; ++kf) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> af;
      wmma::load_matrix_sync(af, AT ? a + kf * 16 * ld + w * 16 : a + w * 16 * ld + kf * 16, ld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> bfr;
        wmma::load_matrix_sync(bfr, BT ? b + j * 16 * ld + kf * 16 : b + kf * 16 * ld + j * 16,
                               ld);
        wmma::mma_sync(cf[j], af, bfr, cf[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(c + w * 16 * ldc + j * 16, cf[j], ldc, wmma::mem_row_major);
  } else {
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
      const int i = idx / kT, j = idx % kT;
      float s = acc ? c[i * ldc + j] : 0.0f;
#pragma unroll 8
      for (int k = 0; k < kT; ++k)
        s = fmaf(AT ? a[k * ld + i] : a[i * ld + k], BT ? b[j * ld + k] : b[k * ld + j], s);
      c[i * ldc + j] = s;
    }
  }
}

// Write a 64 x 64 f32 tile, times mul, rounded to T, to rows of one head.
template <typename T>
__device__ __forceinline__ void write_tile(T* dst, long long sl, const float* c, float mul) {
  for (int i = threadIdx.x; i < kT * kDh; i += kThreads) {
    const int r = i / kDh, d = i % kDh;
    dst[r * sl + d] = Tr<T>::cvt(c[r * Tr<T>::kLdC + d] * mul);
  }
}

template <typename T>
__device__ __forceinline__ void zero_tile(float* c) {
  for (int i = threadIdx.x; i < kT * Tr<T>::kLdC; i += kThreads) c[i] = 0.0f;
}

// The key mask of row b into shared memory, and the first real key.
__device__ __forceinline__ void load_keys(const Args& a, int b, int* keym, int* first) {
  if (threadIdx.x == 0) *first = a.Lk;
  for (int j = threadIdx.x; j < a.Lk; j += kThreads)
    keym[j] = a.kmask[static_cast<long long>(b) * a.Lk + j] != 0;
  __syncthreads();
  for (int j = threadIdx.x; j < a.Lk; j += kThreads)
    if (keym[j]) atomicMin(first, j);
  __syncthreads();
}

// Keys the query tile at q0 walks: up to its diagonal when causal, unless
// it holds rows before the first real key (all their visible keys masked),
// which JAX spreads uniformly over every key.
__device__ __forceinline__ int key_end(const Args& a, int q0, int first) {
  return (a.causal && q0 >= first) ? min(a.Lk, q0 + kT) : a.Lk;
}

// Whether query q0 + r sees key k0 + c, and the masked, scaled score.
__device__ __forceinline__ bool visible(const Args& a, const int* keym, int q0, int r, int k0,
                                        int c) {
  return keym[k0 + c] && (!a.causal || k0 + c <= q0 + r);
}

__device__ __forceinline__ float score(const Args& a, float dot, const int* keym, int q0,
                                       int r, int k0, int c) {
  return visible(a, keym, q0, r, k0, c) ? dot * a.scale : kNegInf;
}

template <typename T>
struct Smem {
  static constexpr size_t tile = sizeof(T) * kT * Tr<T>::kLd;
  static constexpr size_t ftile = sizeof(float) * kT * Tr<T>::kLdC;
  static size_t bytes(int n_tiles, int n_ftiles, int Lk) {
    return n_tiles * tile + n_ftiles * ftile + sizeof(float) * 4 * kT + sizeof(int) * Lk;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int first;
  constexpr int ldc = Tr<T>::kLdC, ld = Tr<T>::kLd;
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + kT * ld;
  T* ps = kvs + kT * ld;
  float* ss = reinterpret_cast<float*>(ps + kT * ld);
  float* os = ss + kT * ldc;
  float* row_m = os + kT * ldc;
  float* row_l = row_m + kT;
  int* row_q = reinterpret_cast<int*>(row_l + 2 * kT);
  int* keym = row_q + kT;

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* q = head<T>(a, a.q, kQ, b, h);
  const T* k = head<T>(a, a.k, kK, b, h);
  const T* v = head<T>(a, a.v, kV, b, h);

  load_keys(a, b, keym, &first);
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    row_q[r] = a.qmask[static_cast<long long>(b) * a.L + q0 + r] != 0;
    row_m[r] = -INFINITY;
    row_l[r] = 0.0f;
  }
  stage(qs, q + q0 * a.st[kQ][2], a.st[kQ][2]);
  zero_tile<T>(os);
  const int kend = key_end(a, q0, first);

  // pass 1: row max and sum, online over the key tiles
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    stage(kvs, k + k0 * a.st[kK][2], a.st[kK][2]);
    ergm_async::wait_all();
    __syncthreads();
    mma64<T, false, true>(ss, qs, kvs, false);
    __syncthreads();
    for (int r = warp; r < kT; r += kThreads / 32) {
      const float s0 = score(a, ss[r * ldc + lane], keym, q0, r, k0, lane);
      const float s1 = score(a, ss[r * ldc + lane + 32], keym, q0, r, k0, lane + 32);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float sum = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + sum;
        row_m[r] = m_new;
      }
    }
  }

  // pass 2: recompute s, normalise, drop, round, accumulate pn . V
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    stage(kvs, k + k0 * a.st[kK][2], a.st[kK][2]);
    ergm_async::wait_all();
    __syncthreads();
    mma64<T, false, true>(ss, qs, kvs, false);
    __syncthreads();
    stage(kvs, v + k0 * a.st[kV][2], a.st[kV][2]);  // K is no longer read
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      const float s = score(a, ss[r * ldc + c], keym, q0, r, k0, c);
      float p = expf(s - row_m[r]) / fmaxf(row_l[r], 1e-30f);
      if (!row_q[r]) p = 0.0f;
      if (a.dropout) p = keep(a, b, h, q0 + r, k0 + c) ? p / a.drop_div : 0.0f;
      ps[r * ld + c] = Tr<T>::cvt(p);
    }
    ergm_async::wait_all();
    __syncthreads();
    mma64<T, false, false>(os, ps, kvs, true);
  }
  __syncthreads();
  T* o = static_cast<T*>(a.out) + b * a.st[kO][0] + h * a.st[kO][1];
  write_tile(o + q0 * a.st[kO][2], a.st[kO][2], os, 1.0f);
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.L + q0;
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    a.ml[row0 + r] = row_m[r];
    a.ml[plane + row0 + r] = row_l[r];
  }
}

// The backward's per-element step for query q0 + r, key k0 + c: pn (the
// forward's, from its m and l), the post-dropout operand pv of dV, and ds.
// A masked score is a constant of the forward (the where's fill), so its
// ds is 0; this only matters on rows with every visible key masked, whose
// pn is not 0 there.
template <typename T>
__device__ __forceinline__ void grad_step(const Args& a, int b, int h, int q0, int r, int k0,
                                          int c, float dot, float dp, const int* keym,
                                          const float* row_m, const float* row_l,
                                          const float* row_d, const int* row_q, T* pv_out,
                                          T* ds_out) {
  const bool ok = visible(a, keym, q0, r, k0, c);
  float pn = expf((ok ? dot * a.scale : kNegInf) - row_m[r]) / fmaxf(row_l[r], 1e-30f);
  if (!row_q[r]) pn = 0.0f;
  float pv = pn;
  if (a.dropout) {
    const bool kp = keep(a, b, h, q0 + r, k0 + c);
    dp = kp ? dp * a.drop_mul : 0.0f;
    pv = kp ? pn * a.drop_mul : 0.0f;
  }
  if (pv_out) *pv_out = Tr<T>::cvt(pv);
  *ds_out = Tr<T>::cvt(ok ? pn * (dp - row_d[r]) : 0.0f);
}

template <typename T>
__device__ __forceinline__ void load_rows(const Args& a, int b, int h, int q0, float* row_m,
                                          float* row_l, float* row_d, int* row_q) {
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.L + q0;
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    row_m[r] = a.ml[row0 + r];
    row_l[r] = a.ml[plane + row0 + r];
    if (row_d) row_d[r] = a.delta[row0 + r];
    row_q[r] = a.qmask[static_cast<long long>(b) * a.L + q0 + r] != 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int first;
  constexpr int ldc = Tr<T>::kLdC, ld = Tr<T>::kLd;
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kT * ld;
  T* ks = dos + kT * ld;
  T* vs = ks + kT * ld;
  T* dss = vs + kT * ld;
  float* ss = reinterpret_cast<float*>(dss + kT * ld);
  float* dps = ss + kT * ldc;
  float* acc = dps + kT * ldc;
  float* row_m = acc + kT * ldc;
  float* row_l = row_m + kT;
  float* row_d = row_l + kT;
  int* row_q = reinterpret_cast<int*>(row_d + kT);
  int* keym = row_q + kT;

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* q = head<T>(a, a.q, kQ, b, h);
  const T* k = head<T>(a, a.k, kK, b, h);
  const T* v = head<T>(a, a.v, kV, b, h);
  const T* o = head<T>(a, a.o, kO, b, h) + q0 * a.st[kO][2];
  const T* dout = head<T>(a, a.dout, kDO, b, h);

  load_keys(a, b, keym, &first);
  load_rows<T>(a, b, h, q0, row_m, row_l, nullptr, row_q);
  stage(qs, q + q0 * a.st[kQ][2], a.st[kQ][2]);
  stage(dos, dout + q0 * a.st[kDO][2], a.st[kDO][2]);
  zero_tile<T>(acc);
  ergm_async::wait_all();
  __syncthreads();
  // delta = rowsum(dO * O) in f32, for this kernel and the dK/dV kernel
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.L + q0;
  for (int r = warp; r < kT; r += kThreads / 32) {
    const T* orow = o + r * a.st[kO][2];
    const float t = Tr<T>::f32(dos[r * ld + lane]) * Tr<T>::f32(orow[lane]) +
                    Tr<T>::f32(dos[r * ld + lane + 32]) * Tr<T>::f32(orow[lane + 32]);
    const float d = warp_sum(t);
    if (lane == 0) {
      row_d[r] = d;
      a.delta[row0 + r] = d;
    }
  }
  const int kend = key_end(a, q0, first);
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    stage(ks, k + k0 * a.st[kK][2], a.st[kK][2]);
    stage(vs, v + k0 * a.st[kV][2], a.st[kV][2]);
    ergm_async::wait_all();
    __syncthreads();
    mma64<T, false, true>(ss, qs, ks, false);
    mma64<T, false, true>(dps, dos, vs, false);
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      grad_step<T>(a, b, h, q0, r, k0, c, ss[r * ldc + c], dps[r * ldc + c], keym, row_m,
                   row_l, row_d, row_q, nullptr, dss + r * ld + c);
    }
    __syncthreads();
    mma64<T, false, false>(acc, dss, ks, true);
  }
  __syncthreads();
  T* dq = static_cast<T*>(a.dq) + b * a.st[kDQ][0] + h * a.st[kDQ][1];
  write_tile(dq + q0 * a.st[kDQ][2], a.st[kDQ][2], acc, a.scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int first;
  constexpr int ldc = Tr<T>::kLdC, ld = Tr<T>::kLd;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kT * ld;
  T* qs = vs + kT * ld;
  T* dos = qs + kT * ld;
  T* ps = dos + kT * ld;
  T* dss = ps + kT * ld;
  float* ss = reinterpret_cast<float*>(dss + kT * ld);
  float* dps = ss + kT * ldc;
  float* dk_acc = dps + kT * ldc;
  float* dv_acc = dk_acc + kT * ldc;
  float* row_m = dv_acc + kT * ldc;
  float* row_l = row_m + kT;
  float* row_d = row_l + kT;
  int* row_q = reinterpret_cast<int*>(row_d + kT);
  int* keym = row_q + kT;

  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const T* q = head<T>(a, a.q, kQ, b, h);
  const T* k = head<T>(a, a.k, kK, b, h);
  const T* v = head<T>(a, a.v, kV, b, h);
  const T* dout = head<T>(a, a.dout, kDO, b, h);

  load_keys(a, b, keym, &first);
  stage(ks, k + k0 * a.st[kK][2], a.st[kK][2]);
  stage(vs, v + k0 * a.st[kV][2], a.st[kV][2]);
  zero_tile<T>(dk_acc);
  zero_tile<T>(dv_acc);
  for (int q0 = 0; q0 < a.L; q0 += kT) {
    if (k0 >= key_end(a, q0, first)) continue;  // the tile never sees these keys
    __syncthreads();
    load_rows<T>(a, b, h, q0, row_m, row_l, row_d, row_q);
    stage(qs, q + q0 * a.st[kQ][2], a.st[kQ][2]);
    stage(dos, dout + q0 * a.st[kDO][2], a.st[kDO][2]);
    ergm_async::wait_all();
    __syncthreads();
    mma64<T, false, true>(ss, qs, ks, false);
    mma64<T, false, true>(dps, dos, vs, false);
    __syncthreads();
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      grad_step<T>(a, b, h, q0, r, k0, c, ss[r * ldc + c], dps[r * ldc + c], keym, row_m,
                   row_l, row_d, row_q, ps + r * ld + c, dss + r * ld + c);
    }
    __syncthreads();
    mma64<T, true, false>(dv_acc, ps, dos, true);
    mma64<T, true, false>(dk_acc, dss, qs, true);
  }
  __syncthreads();
  T* dk = static_cast<T*>(a.dk) + b * a.st[kDK][0] + h * a.st[kDK][1];
  T* dv = static_cast<T*>(a.dv) + b * a.st[kDV][0] + h * a.st[kDV][1];
  write_tile(dk + k0 * a.st[kDK][2], a.st[kDK][2], dk_acc, a.scale);
  write_tile(dv + k0 * a.st[kDV][2], a.st[kDV][2], dv_acc, 1.0f);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const Args& a, cudaStream_t s) {
  return launch(fwd_kernel<T>, dim3(a.L / kT, a.H, a.B), Smem<T>::bytes(3, 2, a.Lk), a, s);
}

template <typename T>
cudaError_t backward(const Args& a, cudaStream_t s) {
  cudaError_t err =
      launch(bwd_dq_kernel<T>, dim3(a.L / kT, a.H, a.B), Smem<T>::bytes(5, 3, a.Lk), a, s);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkdv_kernel<T>, dim3(a.Lk / kT, a.H, a.B), Smem<T>::bytes(6, 4, a.Lk), a,
                s);
}

Args make_args(int B, int H, int L, int Lk, const long long* strides, int n, float scale,
               int causal, int dropout, float drop_div, float drop_mul, unsigned thr,
               unsigned seed) {
  Args a{};
  a.B = B;
  a.H = H;
  a.L = L;
  a.Lk = Lk;
  for (int t = 0; t < n; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[3 * t + j];
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.drop_div = drop_div;
  a.drop_mul = drop_mul;
  a.thr = thr;
  a.seed = seed;
  return a;
}

}  // namespace ergm_block

// dtype: 0 = float32, 1 = bfloat16. strides: host array of (batch, head,
// row) element strides of q, k, v, o. Returns a cudaError_t (0 on success).
extern "C" int ergm_block_mha_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* ml, const void* qmask, const void* kmask, int dtype,
                                  int B, int H, int L, int Lk, const long long* strides,
                                  float scale, int causal, int dropout, float drop_div,
                                  float drop_mul, unsigned thr, unsigned seed, void* stream) {
  using namespace ergm_block;
  Args a = make_args(B, H, L, Lk, strides, 4, scale, causal, dropout, drop_div, drop_mul, thr,
                     seed);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.ml = static_cast<float*>(ml);
  a.qmask = static_cast<const int*>(qmask);
  a.kmask = static_cast<const int*>(kmask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(forward<float>(a, s));
  if (dtype == 1) return static_cast<int>(forward<bf16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: (batch, head, row) of q, k, v, o, dout, dq, dk, dv. delta is
// [B, H, L] f32 scratch written by the dQ kernel and read by the dK/dV one.
extern "C" int ergm_block_mha_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  const void* ml, void* delta, const void* qmask,
                                  const void* kmask, int dtype, int B, int H, int L, int Lk,
                                  const long long* strides, float scale, int causal,
                                  int dropout, float drop_div, float drop_mul, unsigned thr,
                                  unsigned seed, void* stream) {
  using namespace ergm_block;
  Args a = make_args(B, H, L, Lk, strides, 8, scale, causal, dropout, drop_div, drop_mul, thr,
                     seed);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.ml = static_cast<float*>(const_cast<void*>(ml));
  a.delta = static_cast<float*>(delta);
  a.qmask = static_cast<const int*>(qmask);
  a.kmask = static_cast<const int*>(kmask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(backward<float>(a, s));
  if (dtype == 1) return static_cast<int>(backward<bf16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
