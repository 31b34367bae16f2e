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
// B = 64, H = 12, T = 512, index 400, one call reads the 401 visible slots
// of K and V codes (39.4 MB) and their bf16 scales (1.2 MB): 12.1 us at the
// HBM rate, against 0.04 GFLOP. It is bound by the cache bytes. The design
// before this one (one CTA of 128 threads per (b, h): the scores, a
// two-pass softmax, and only then the V reads) ran at a third of that
// bound: 0.0373 ms at that shape and 0.0214 ms at B = 1, T = 1024, index
// 1000 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py). Its time was one
// CTA's serial chain, and each int8 value took an I2F conversion (222 in
// its SASS).
//
// This design:
// - A row's keys 0..index are split over the C CTAs (C <= 8) of a
//   thread-block cluster; the wrapper picks C from B * H and index + 1
//   (ops/decode_attention.py::plan): a single request over a long cache
//   spreads over 8 CTAs, a batch of 64 rows keeps one CTA a row. A cluster
//   of one is launched as a plain grid and syncs as a CTA.
// - A CTA has 4 warps, or 8 when its slice has kWideSlice keys or more.
//   Warp w of W owns the slice's 16-key steps w, w + W, ...: it requests
//   their K codes (16-byte cp.async into shared memory), loads their scales
//   and mask, and, once its K codes have landed, requests their V codes, so
//   that across the card the V reads overlap the scores and the softmax.
//   It then forms their scores, its max, exps and sum, and their PV
//   product; the warps of a CTA meet only to add their outputs.
// - Codes become floats by a byte permute into the mantissa of 2^23 and one
//   subtraction of 2^23 + 128; a pair of such exact floats becomes a bf16x2
//   word by one more permute (their low 16 bits are 0). No I2F.
// - bf16: both products on mma.sync m16n8k16 with f32 accumulators. QK:
//   16 keys a step are the rows of A, q is column 0 of B; PV: V's transpose
//   is A (4 tiles of 16 dims), round(p * vs) column 0 of B. A product's
//   depth may take its terms in any order as long as A and B agree, so each
//   lane converts whole 16-byte (K) or 8-byte (V) pieces of rows. f32 (the
//   tests' 3e-4 bar; TF32 would miss it): the CUDA cores, same conversion.
// - One exp a key. Each warp sends its max m_w and sum z_w = sum exp(s -
//   m_w) to every CTA of the cluster through distributed shared memory; one
//   cluster barrier later each forms the row's max M and sum Z = sum z_w
//   exp(m_w - M) in one fixed order, and round(exp(s - m_w) exp(m_w - M) /
//   Z * vs), p rounded where the model rounds it (not flash-decoding's
//   rescaled partial outputs). M is finite, as key 0 is in rank 0's slice;
//   a warp without keys sends -inf and 0, a masked one about -1e9, and
//   neither weighs anything.
// - Each CTA adds its warps' partial [64] outputs and sends them to the
//   CTA that owns their dims (dim d: rank d % C); one more cluster barrier
//   and the owners add the C partials in rank order: one launch a call, no
//   workspace, no atomics, and a repeat is bitwise equal.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py,
// bf16, CUDA events; device duration by torch.profiler in brackets):
// B = 64, T = 512, index 400: 0.0246 ms (21.4 us), against the 12.2 us
// bound; B = 1, T = 1024, index 1000: 0.0095 ms (5.7 us); B = 256, T =
// 256, index 200: 0.0426 ms (39.0 us). At B = 64 a CTA keeps its 416 keys
// of codes in shared memory, 3 CTAs an SM, so the grid runs in two waves
// whose arithmetic is not overlapped by loads (scripts/k2_phases.py).

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "decode_gemm.cuh"

namespace ergm_decode {

constexpr int kDh = 64;
constexpr int kMaxWarps = 8;     // 256 threads: a CTA of a wide slice
constexpr int kWideSlice = 320;  // keys of a slice from which a CTA takes 8 warps, not 4
constexpr int kMaxKeys = 1024;  // keys a CTA takes: MAX_T = 8192 over a cluster of 8
// shared memory a key: K and V codes, score, two scales, mask term, bf16 p
constexpr int kSmemPerKey = 2 * kDh + 4 * sizeof(float) + sizeof(bf16);

struct DecodeArgs {
  const void* q;       // [B, H, 64] with strides q_sb, q_sh
  const int8_t* k;     // [B, H, T, 64]
  const int8_t* v;
  const void* ks;      // [B, H, T], f32 or bf16 (scale_bf16)
  const void* vs;
  const float* mask;   // [B, >= T] with row stride mask_sb, or null
  void* out;           // [B, H * 64]
  long long q_sb, q_sh, mask_sb;
  int H, T;
  int n;               // keys attended: min(T, index + 1)
  int chunk;           // keys a CTA: a multiple of 16
  float scale;
  int scale_bf16;
};

// One scale; the dtype flag is uniform across the grid, so the branch
// never diverges.
__device__ __forceinline__ float load_scale(const void* base, long long i, int bf16) {
  return bf16 ? Cvt<__nv_bfloat16>::load(static_cast<const __nv_bfloat16*>(base) + i)
              : static_cast<const float*>(base)[i];
}

// Four int8 codes (one 32-bit word, lowest byte first) as exact floats:
// the biased byte x + 128 goes into the low mantissa of 2^23 by a byte
// permute, and subtracting 2^23 + 128 leaves x.
__device__ __forceinline__ void codes4(unsigned w, float (&f)[4]) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) - 8388736.0f;
}

// Two floats that are exact in bf16 with zero low halves (the codes above)
// as one bf16x2 word, lo in the low half.
__device__ __forceinline__ unsigned bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

#ifdef ERGM_K2_PHASES
// Built only by scripts/k2_phases.py: thread 0 of each of the first
// kPhaseCtas CTAs stamps clock64 at the kernel's phase boundaries, and
// %globaltimer at its start and end.
constexpr int kPhaseCtas = 8192, kPhases = 9;
__device__ long long g_phases[kPhaseCtas * (kPhases + 2)];
__device__ __forceinline__ void phase(int i) {
  if (threadIdx.x || blockIdx.x >= kPhaseCtas) return;
  long long* p = g_phases + blockIdx.x * (kPhases + 2);
  p[i] = clock64();
  if (i == 0 || i == kPhases - 1) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p[kPhases + (i ? 1 : 0)] = static_cast<long long>(t);
  }
}
#else
__device__ __forceinline__ void phase(int) {}
#endif

// V rows sit in shared memory with their 16-byte chunks swizzled (chunk c
// of row r at c ^ (r & 2)), so that the PV fragment loads, 8 bytes of rows
// t, t + 4, t + 8, t + 12 of a step for lanes t = 0..3, hit no bank twice.
__device__ __forceinline__ int v_at(int r, int byte) {
  return r * kDh + ((((byte >> 4) ^ (r & 2))) << 4) + (byte & 15);
}

// The cluster barrier in halves: arrive (relaxed: it orders nothing) and
// wait; and whole, with release and acquire, so that the stores into
// another CTA's shared memory before it are seen after it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid B * H * C, clusters of C CTAs along x: rank r of the cluster of
// (b, h) takes keys [r * chunk, (r + 1) * chunk) below n. CTAs exchange
// values by storing into each other's shared memory before a cluster
// barrier and reading their own after it: no CTA reads another's shared
// memory, so none waits for the others to leave.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps) decode_kernel(const DecodeArgs a) {
  constexpr bool kTc = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* kc = reinterpret_cast<int8_t*>(smem);  // [chunk][64] K codes
  int8_t* vc = kc + a.chunk * kDh;               // [chunk][64] V codes, swizzled
  float* sc = reinterpret_cast<float*>(vc + a.chunk * kDh);  // scores, then exp, (f32) p
  float* kss = sc + a.chunk;
  float* vss = kss + a.chunk;
  float* add = vss + a.chunk;                    // the mask term
  bf16* p16 = reinterpret_cast<bf16*>(add + a.chunk);  // round(p * vs), B of PV
  __shared__ float qs[kDh];                      // f32 only
  __shared__ float part[kMaxWarps][kDh];
  // slot W r + w: warp w of rank r's max and sum (W warps a CTA); slot r:
  // rank r's partial output
  __shared__ float xm[kMaxCluster * kMaxWarps], xz[kMaxCluster * kMaxWarps];
  __shared__ float xo[kMaxCluster][kDh];

  phase(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // a cluster of one needs no cluster barrier: the CTA's own does
  auto sync = [csize] {
    if (csize > 1) {
      cluster_sync();
    } else {
      __syncthreads();
    }
  };
  if (csize > 1) cluster_arrive_relaxed();  // waited for before the first store into another CTA
  const int bh = static_cast<int>(blockIdx.x) / csize;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = rank * a.chunk;
  const int nk = max(0, min(a.chunk, a.n - k0));
  const int steps = (nk + 15) / 16;  // rows zero-filled up to a whole step
  // the warp's keys one a lane: lanes 0-15 and 16-31 take alternate steps
  const int j0 = warp + nw * (lane >> 4), lk = lane & 15, stride = 2 * nw;

  // the warp's K codes are requested first, then its scales and mask
  // terms; its V codes once the K codes have landed, so that across the
  // card's CTAs the V reads fill the time of the scores and the softmax
  const long long row0 = static_cast<long long>(bh) * a.T + k0;  // the slice's first slot
  const int8_t* kg = a.k + row0 * kDh;
  const int8_t* vg = a.v + row0 * kDh;
  for (int j = warp; j < steps; j += nw)
#pragma unroll
    for (int i = lane; i < 64; i += 32) {
      const int r = 16 * j + (i >> 2), c = i & 3;
      copy16_zfill(kc + r * kDh + c * 16, r < nk ? kg + r * kDh + c * 16 : kg, r < nk);
    }
  ergm_async::commit();
  auto request_v = [&] {
    for (int j = warp; j < steps; j += nw)
#pragma unroll
      for (int i = lane; i < 64; i += 32) {
        const int r = 16 * j + (i >> 2), c = i & 3;
        copy16_zfill(vc + v_at(r, c * 16), r < nk ? vg + r * kDh + c * 16 : vg, r < nk);
      }
    ergm_async::commit();
  };
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* mask = a.mask ? a.mask + b * a.mask_sb + k0 : nullptr;
  for (int j = j0; j < steps; j += stride) {
    const int l = 16 * j + lk;
    if (l < nk) {
      kss[l] = load_scale(a.ks, row0 + l, a.scale_bf16);
      vss[l] = load_scale(a.vs, row0 + l, a.scale_bf16);
      add[l] = mask ? (1.0f - mask[l]) * kNegInf : 0.0f;
    }
  }

  phase(1);  // K requested, scales and mask terms landed

  // scores of the warp's keys; keys past n are -inf
  float m = -INFINITY;
  auto score = [&](int l, float dot) {
    float s = -INFINITY;
    if (l < nk) {
      s = dot * a.scale * kss[l];
      if (mask) s += add[l];
    }
    sc[l] = s;
    m = fmaxf(m, s);
  };
  if constexpr (kTc) {
    // QK: 16 keys a step are A's rows, q is B's column 0 (lanes (0, t));
    // lane t's k slots 2t, 2t + 1 and 2t + 8, 2t + 9 of product kk are
    // dims 16t + 4kk + {0, 1} and {2, 3}, so a lane converts bytes
    // 16t .. 16t + 15 of rows g and g + 8
    unsigned qb[4][2] = {};
    if (g == 0)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* qd = q + 16 * t4 + 4 * kk;
        qb[kk][0] = ergm_mma::pack(Cvt<T>::load(qd), Cvt<T>::load(qd + 1));
        qb[kk][1] = ergm_mma::pack(Cvt<T>::load(qd + 2), Cvt<T>::load(qd + 3));
      }
    ergm_async::wait<0>();  // the warp's K codes have landed
    __syncwarp();
    phase(2);
    request_v();
#pragma unroll 2
    for (int j = warp; j < steps; j += nw) {
      const uint4 w0 = *reinterpret_cast<const uint4*>(kc + (16 * j + g) * kDh + 16 * t4);
      const uint4 w1 = *reinterpret_cast<const uint4*>(kc + (16 * j + g + 8) * kDh + 16 * t4);
      const unsigned r0[4] = {w0.x, w0.y, w0.z, w0.w}, r1[4] = {w1.x, w1.y, w1.z, w1.w};
      float c[2][4] = {};  // products 0-1 and 2-3: two chains of two
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float f0[4], f1[4];
        codes4(r0[kk], f0);
        codes4(r1[kk], f1);
        const unsigned af[4] = {bf16x2_exact(f0[0], f0[1]), bf16x2_exact(f1[0], f1[1]),
                                bf16x2_exact(f0[2], f0[3]), bf16x2_exact(f1[2], f1[3])};
        ergm_mma::mma(c[kk >> 1], af, qb[kk][0], qb[kk][1]);
      }
      if (t4 == 0) {  // column 0: the scores of keys g and g + 8 of the step
        score(16 * j + g, c[0][0] + c[1][0]);
        score(16 * j + g + 8, c[0][2] + c[1][2]);
      }
    }
  } else {
    if (tid < kDh) qs[tid] = Cvt<T>::load(q + tid);
    ergm_async::wait<0>();
    __syncthreads();
    request_v();
    for (int j = j0; j < steps; j += stride) {
      const int l = 16 * j + lk;
      const uint4* row = reinterpret_cast<const uint4*>(kc + l * kDh);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < kDh / 16; ++c) {
        const uint4 w = row[c];
        const unsigned wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f[4];
          codes4(wv[e], f);
#pragma unroll
          for (int i = 0; i < 4; ++i) s = fmaf(f[i], qs[16 * c + 4 * e + i], s);
        }
      }
      score(l, s);
    }
  }

  phase(3);  // QK

  // the warp's max m_w and sum z_w = sum exp(s - m_w): one exp a key
  m = warp_max(m);
  __syncwarp();
  float z = 0.0f;
  for (int j = j0; j < steps; j += stride) {
    const int l = 16 * j + lk;
    if (l < nk) {
      const float e = expf(sc[l] - m);
      sc[l] = e;
      z += e;
    }
  }
  z = warp_sum(z);
  phase(4);  // the warp's softmax
  if (csize > 1) cluster_wait();  // every CTA of the cluster has started
  if (lane < csize) {  // into slot W rank + warp of every CTA of the cluster
    *cluster.map_shared_rank(xm + nw * rank + warp, lane) = m;
    *cluster.map_shared_rank(xz + nw * rank + warp, lane) = z;
  }
  sync();
  phase(5);  // the exchange
  // the row's max M (finite: key 0 is rank 0's) and sum Z = sum_i z_i
  // exp(m_i - M), lane i on slots i and i + 32, in the same order in every
  // warp; a warp without keys has m_i = -inf and z_i = 0
  const int nslot = nw * csize;
  const float m0 = lane < nslot ? xm[lane] : -INFINITY;
  const float m1 = lane + 32 < nslot ? xm[lane + 32] : -INFINITY;
  const float mrow = warp_max(fmaxf(m0, m1));
  const float z0 = lane < nslot && xz[lane] > 0.0f ? xz[lane] * expf(m0 - mrow) : 0.0f;
  const float z1 = lane + 32 < nslot && xz[lane + 32] > 0.0f ? xz[lane + 32] * expf(m1 - mrow)
                                                              : 0.0f;
  const float zrow = warp_sum(z0 + z1);
  const float f = expf(m - mrow) / zrow;  // exp(s - M) / Z = exp(s - m_w) f

  // round(p * vs), where the model rounds it
  for (int j = j0; j < steps; j += stride) {
    const int l = 16 * j + lk;
    const float p = l < nk ? Cvt<T>::round(sc[l] * f * vss[l]) : 0.0f;
    if constexpr (kTc) {
      p16[l] = __float2bfloat16_rn(p);
    } else {
      sc[l] = p;
    }
  }
  ergm_async::wait<0>();  // the warp's V codes have landed
  __syncwarp();

  phase(6);  // p, and the V codes landed
  if constexpr (kTc) {
    // PV: V's transpose is A (4 tiles of 16 dims), round(p * vs) is B's
    // column 0 (lanes (0, t)); keys 16j + t + 4i (i = 0..3) are the k slots
    // 2t, 2t + 1, 2t + 8, 2t + 9 of lane t in A and in B; row g of tile mt
    // is dim 8g + 2mt, row g + 8 dim 8g + 2mt + 1, so lane (g, t) converts
    // bytes 8g .. 8g + 7 of its four keys' rows
    float acc[4][4] = {};
#pragma unroll 2
    for (int j = warp; j < steps; j += nw) {
      const int kb = 16 * j;
      unsigned pb[2] = {0u, 0u};
      if (g == 0) {
        const unsigned short* pu = reinterpret_cast<const unsigned short*>(p16 + kb + t4);
        pb[0] = pu[0] | (static_cast<unsigned>(pu[4]) << 16);
        pb[1] = pu[8] | (static_cast<unsigned>(pu[12]) << 16);
      }
      unsigned raw[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 w = *reinterpret_cast<const uint2*>(vc + v_at(kb + t4 + 4 * i, 8 * g));
        raw[i][0] = w.x ^ 0x80808080u;
        raw[i][1] = w.y ^ 0x80808080u;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float fv[4][2];  // key i, dims 2mt and 2mt + 1
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            fv[i][e] = __uint_as_float(__byte_perm(raw[i][mt >> 1], 0x4B000000u,
                                                   0x7440u + 2 * (mt & 1) + e)) - 8388736.0f;
        const unsigned af[4] = {
            bf16x2_exact(fv[0][0], fv[1][0]), bf16x2_exact(fv[0][1], fv[1][1]),
            bf16x2_exact(fv[2][0], fv[3][0]), bf16x2_exact(fv[2][1], fv[3][1])};
        ergm_mma::mma(acc[mt], af, pb[0], pb[1]);
      }
    }
    if (t4 == 0)  // column 0: rows g and g + 8 of tile mt
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        part[warp][8 * g + 2 * mt] = acc[mt][0];
        part[warp][8 * g + 2 * mt + 1] = acc[mt][2];
      }
  } else {  // lane: dims lane and lane + 32
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int j = warp; j < steps; j += nw)
      for (int l = 16 * j; l < min(16 * j + 16, nk); ++l) {
        const unsigned u0 = static_cast<unsigned char>(vc[v_at(l, lane)]) ^ 0x80u;
        const unsigned u1 = static_cast<unsigned char>(vc[v_at(l, lane + 32)]) ^ 0x80u;
        acc0 = fmaf(sc[l], __uint_as_float(__byte_perm(u0, 0x4B000000u, 0x7440u)) - 8388736.0f,
                    acc0);
        acc1 = fmaf(sc[l], __uint_as_float(__byte_perm(u1, 0x4B000000u, 0x7440u)) - 8388736.0f,
                    acc1);
      }
    part[warp][lane] = acc0;
    part[warp][lane + 32] = acc1;
  }
  phase(7);  // PV
  __syncthreads();
  if (tid < kDh) {  // this CTA's partial, into slot `rank` of dim d's owner, rank d % C
    float o = part[0][tid];
#pragma unroll
    for (int w = 1; w < kMaxWarps; ++w)
      if (w < nw) o += part[w][tid];
    *cluster.map_shared_rank(&xo[rank][tid], tid % csize) = o;
  }
  sync();
  if (tid < kDh && tid % csize == rank) {  // the C partials in rank order
    float o = xo[0][tid];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < csize) o += xo[r][tid];
    Cvt<T>::store(static_cast<T*>(a.out) + static_cast<long long>(bh) * kDh + tid, o);
  }
  phase(8);  // the output
}

template <typename T>
cudaError_t launch_decode(const DecodeArgs& a, int B, int csize, cudaStream_t stream) {
  static bool ready = false;  // once a process: the shared-memory limit of the widest slice
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxKeys * kSmemPerKey);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H * csize);
  cfg.blockDim = dim3(a.chunk >= kWideSlice ? 32 * kMaxWarps : 32 * kMaxWarps / 2);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.chunk) * kSmemPerKey;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;  // a CTA alone is a cluster of one
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<T>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ergm_decode

#ifdef ERGM_K2_PHASES
// Copies the phase stamps to `host` (kPhaseCtas x (kPhases + 2) values).
extern "C" int ergm_decode_phases(long long* host) {
  using namespace ergm_decode;
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases)));
}
#endif

// dtype (q and out): 0 = float32, 1 = bfloat16; scale_dtype (ks, vs) the
// same codes. k, v [B, H, T, 64] and ks, vs [B, H, T] contiguous (one layer
// of the stacked cache, by offset); mask [B, >= T] f32 with row stride
// mask_sb, or null. Keys 0..index are attended, split over clusters of
// `cluster` CTAs (1..8) of at most 1024 keys each. Returns a cudaError_t.
extern "C" int ergm_decode_mha_int8(const void* q, long long q_sb, long long q_sh,
                                    const void* k, const void* v, const void* ks,
                                    const void* vs, const void* mask, long long mask_sb,
                                    void* out, int dtype, int scale_dtype, int B, int H, int T,
                                    int index, float scale, int cluster, void* stream) {
  using namespace ergm_decode;
  if (index < 0 || T < 1 || B < 1 || H < 1 || cluster < 1 || cluster > kMaxCluster ||
      (scale_dtype != 0 && scale_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = index + 1 < T ? index + 1 : T;
  const int chunk = ((n + cluster - 1) / cluster + 15) / 16 * 16;
  if (chunk > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks, vs,
               static_cast<const float*>(mask), out, q_sb, q_sh, mask_sb, H, T, n, chunk, scale,
               scale_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_decode<float>(a, B, cluster, s));
  if (dtype == 1) return static_cast<int>(launch_decode<__nv_bfloat16>(a, B, cluster, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
