// Masked attention with probability dropout, forward and backward, for
// Hopper (sm_90a): kernels K5 and K7 of the port.
//
// K5 replaces ergm_tpu/ops/block_attention.py::_fwd and ::_bwd, the Pallas
// kernels behind block_mha (bodies _fwd_kernel and _bwd_kernel); K7
// replaces ergm_tpu/ops/flash_attention.py::flash_mha, which wraps JAX's
// library TPU flash kernel for what the block kernel's VMEM cap refuses
// (L > 1024, causal Lq < Lk at offset 0, head widths past the block
// gate's). Which gate reaches which namespace:
//   JAX's block gate -> ops/block_attention.py::block_mha ->
//     ergm_block_mha_fwd / _bwd -> blk:: (bf16) and f32:: at DH = 32, 64, 96
//     and 128 (other widths of the gate padded to them), dropout or not;
//   JAX's flash gate (no dropout) -> ops/flash_attention.py::flash_mha ->
//     ergm_flash_mha_fwd / _bwd -> bf16: flash:: at DH = 64 and 128 (any
//     width below 128 padded to one of them) and at 256 and 384, wide:: at
//     128 m for m >= 4; f32: f32:: at K5's widths and, past 128, the
//     128-wide template over m slices.
// The entry point, never a guess from the shape, picks the family. The
// math and its rounding points of blk::, f32:: and wide:: are JAX's block
// kernel's (one q sub-block, the whole row); the bf16 one-pass kernels
// (flash::, below) compute what JAX's library flash kernel computes:
//   s = (q . k) * scale in f32; s = where(kv_mask & causal, s, -1e9);
//   pn = exp(s - m) / max(l, 1e-30) with m, l over the row; pn = 0 on
//   padded query rows; dropout: pn = keep ? pn / (1 - rate) : 0;
//   pn rounded to the input type, o = sum pn . v accumulated in f32.
// Backward: dpn = dO . v; with dropout dpn = keep ? dpn * inv : 0 and the
// dV operand pv = keep ? pn * inv : 0; ds = pn * (dpn - delta), rounded to
// the input type; dQ = scale * ds . K, dK = scale * ds^T . Q, dV = pv^T dO.
// Causal means query i sees keys <= i, also when Lq < Lk.
//
// The keep mask is JAX's counter hash of its interpret mode (_keep_mask):
// mix = seed + b*S + h, x = r*Lk + c + mix*2654435761 (mod 2^32), three
// xorshift-multiply rounds, keep iff x >= rate*2^32. The TPU's hardware
// random stream cannot be reproduced on another device; the hash gives the
// same mask here, in the plain version and in JAX's interpret-mode kernel,
// and the backward and a rematerialised forward regenerate it from the
// seed instead of storing it. S is the head stride, H unless the caller
// runs a shard of a larger problem: rows from b0 and heads from h0 of one
// with H_global heads draw its masks with seed + b0*H_global + h0 and
// S = H_global (tensor parallelism over head groups).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM).
// At the training slice, B=48, H=12, L=512, Dh=64, causal, one layer's
// forward reads q, k, v and writes o: 4 x 37.7 MB = 151 MB, 45 us at the
// HBM rate, against ~19 GFLOP of products, 20 us on the tensor cores: bytes
// bind the function. The kernels' own work is larger: two passes over the
// keys (3 products where one pass needs 2), an exp per score and pass, and
// ~10 integer operations of the hash per score when dropout is on. Neither
// the loads nor the products' rate sets their pace (PERF.md,
// scripts/k5_split.py): a build that streams every tile and forms no
// product takes a third to a half of the time, one that forms every product
// on tiles already loaded takes all of it, and the time follows the number
// of scores, not the head width. The chain product -> per-score work (mask,
// exp, hash, rounding) -> product does, with too few warps to hide its
// latency.
//
// bf16 design (blk::, on flash::'s parts below): a CTA is a producer
// warpgroup and two consumer warpgroups of 64 rows (wgmma's M), 128 query
// rows (keys, in dK/dV) an item. The producer keeps a two-stage ring of TMA
// loads in flight on mbarriers; the consumers form each tile's products
// with wgmma, operands read from shared memory by descriptor in the swizzle
// that the TMA writes (column blocks of 64 bf16 and the 128-byte swizzle at
// DH = 64 and 128, of 32 and the 64-byte one at 32 and 96, so that neither
// is padded). The scores stay in the accumulator's registers, whose layout
// is mma.sync's repeated a warp at a time (rows 16w + g and + 8, columns 8j
// + 2t and + 1), so the mask (score::mask_scores), the hash and the
// per-lane row statistics keep the code written for that layout; the
// rounded probabilities (and pv, ds) are the A operand of the next product
// in registers, never stored. Latency bounds the per-score work, so where
// the registers allow it a kernel runs two CTAs an SM, 16 consumer warps,
// in 80 registers a thread: at DH = 32 and 64 the forward (64-key tiles)
// and dQ (32-key tiles), at 32 dK/dV (32-query tiles); that took the
// forward at 64 from 0.284 to 0.204 ms (PERF.md). The others (DH = 96 and
// 128; dK/dV at 64, which sums two 64 x 64 f32 tiles a warpgroup) run one
// CTA an SM, their consumers raised to 240 registers (setmaxnreg; ptxas
// allocates each side to its share), with 128-key forward tiles and 64-row
// dQ and dK/dV tiles above 64. A kernel at one CTA an SM walks the items
// (a tile of one head, the longest causal walks first) and loads the next
// item's resident operands into a second buffer while the current ones are
// in use; at two, the SM's other CTA covers a CTA's start and end, and each
// item has a CTA of its own (each grid's A/B: PERF.md). To keep JAX's
// rounding points (the probabilities are normalised by the whole row's
// statistics before they are rounded) the forward walks the keys twice:
// pass 1 streams K and keeps each lane's running max and sum, reduced over a
// row's four lanes at its end; pass 2 streams K and V, recomputes s and
// accumulates the rounded pn . V. It writes m (in log2 units) and l, 8
// bytes a row, so that the backward's pn is the forward's without a pass of
// its own. The backward is two kernels with no atomics, so its result does
// not depend on scheduling: dQ (Q and dO resident, over the K and V tiles
// twice: pass 1 takes each row's delta = sum(pn * dpn) in f32, JAX's, pass
// 2 accumulates dS . K; it also writes each row's m, 1/l and delta;
// rowsum(dO * O) in its place would carry O's bf16 rounding into every ds
// of a row, which a nearly uniform row turns into a dQ error many times
// JAX's), then dK/dV (K and V resident, each consumer warpgroup owning 64
// keys and summing both dK and dV; Q, dO and the rows' (m, 1/l, delta)
// streamed, the query tiles holding dead rows first, then from the
// diagonal). Both regenerate the keep mask from the hash rather than read a
// bit mask stored by the forward, which would hold 19 MB a layer at the
// slice until the backward (PERF.md weighs the two); dQ keeping pass 1's
// bits in shared memory for pass 2 ran slower than hashing them again. A
// pre-pass turns the key mask into bits and finds where each batch row's
// dead rows end, once per call.
//
// f32 design (f32::, the fp32 bars only): tiles of 64 rows (32 above a
// 64-wide head, so that the dK/dV kernel's ten tiles fit in shared memory)
// and 128 threads, scores in shared memory, products as f32 FMAs on the
// CUDA cores in order, so the f32 result holds JAX's bars with TF32 off.
//
// Head widths. JAX's block gate takes every head width DH that is a
// multiple of 8 up to 128; its flash gate sends every width to JAX's
// library kernel, which takes any DH below 128 and any multiple of 128
// (it raises at other widths above 128). The blk:: and f32:: kernels are
// templates built for DH = 32, 64, 96 and 128, the narrow one-pass kernels
// for 64 and 128; the wrappers (ops/block_attention.py,
// ops/flash_attention.py) pad q, k and v with zero columns to the next of
// them and slice the result back, which is exact: the zero columns add
// nothing to q . k and give zero output and gradient columns, and the
// softmax scale passed in is the true width's. The keep mask's hash does
// not read DH. f32 runs a wide head, DH = 128 m with m >= 2 (flash gate
// only: no dropout), on the 128-wide template over m slices of the width,
// m column groups on the grid's y axis.
//
// One-pass kernels in bf16 (flash::, DH = 64, 128, 256 and 384): the
// counterpart of JAX's library TPU flash kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// reached from ergm_tpu/ops/flash_attention.py::flash_mha :66) and its
// arithmetic: the forward is one pass over the key tiles with an online
// softmax, the running max m and sum l in f32, p = exp(s - m) rounded to
// bf16 before the P . V product (before it is normalised), the f32 sum
// rescaled as m moves and normalised once at the end; the backward takes
// delta = rowsum(o * dO) in f32 (JAX's di, computed outside its kernels;
// here in the dQ kernel's prologue), recomputes p from the saved m and l,
// and rounds ds = p (dP - delta) scale before dQ = ds . K and dK = ds^T . Q
// and p before dV = p^T . dO. The masking is the port's (key bits, dead
// rows over every key, padded rows zero), as in the other kernels.
// What bounds them on an H100 at [2, 16, 2048, 256], causal: ~59 GFLOP of
// products in the forward and ~148 in the backward (its five products)
// against 134 and 268 MB of operands: operations, 0.06 and 0.15 ms at 989
// TFLOP/s. The kernels before these (wide::, below) ran 22x / 29x those
// bounds (NVIDIA H100 80GB HBM3, 700 W; PERF.md), recomputing the scores over the whole width in each of m CTAs
// per row tile (5 product units in the forward where 2 suffice, 15 in the
// backward where 7 do) and restaging the owned rows' slices for every
// streamed tile. Here one CTA owns the whole width, so each (query tile,
// key tile) pair's scores are formed once (at 384, once per group of 192
// output columns: twice), on wgmma: 64-row products by warpgroup, the
// operands read from shared memory by descriptor in the 128-byte swizzle
// that the TMA writes, P and dS kept in registers as the A operand of the
// next product. A producer warpgroup (forward, dK/dV) keeps a two-stage
// ring of TMA loads in flight on mbarriers and gives its registers to the
// consumers (setmaxnreg). Forward: 128 query rows a CTA in two consumer
// warpgroups, Q resident, K and V tiles of 64 keys (384: 32) streamed.
// dQ: one warpgroup of 64 query rows with Q and dO resident, loading its
// own K and V tiles. dK/dV: 64 keys a CTA with K and V resident and Q, dO
// and the rows' (m, 1/l, delta) streamed; one consumer forms S^T and p^T
// and sums dV, the other dP^T and ds^T and sums dK, p^T handed over through
// shared memory, so each 64 x 256 f32 sum (128 registers a thread) has its
// own warpgroup. No atomics: the result repeats bit for bit. A 64 x 256 f32
// sum a warpgroup is what caps the tiles: two consumer warpgroups an SM,
// one in dQ, whose 192 KB of shared memory leave no room for a second. At
// DH = 384 the output columns split into two groups of 192 and the
// streamed tiles into 32 rows, so that Q and the ring fit. DH = 128 m for
// m >= 4 keeps the wide:: kernels: 64-row CTAs and m column groups of
// 128, the scores summed over m slices through a cp.async ring.
//
// The narrow one-pass instances (D64, D128; Shape::QT > 0). What bounds
// them at K7's rows, [8, 12, 2048, 64] and [2, 6, 2048, 128], causal:
// operations, 0.042 / 0.106 ms and 0.011 / 0.029 ms (forward / backward)
// at 989 TFLOP/s. At these widths a warpgroup holds what it cannot at 256:
// a 64 x 128 f32 score tile and a 64 x 128 f32 sum are 64 registers a
// thread each. Forward: fwd_kernel as above, K and V tiles of 128 keys
// (the tile, and the plain version's key block, of JAX's 128-blocks);
// 83,008 / 164,928 bytes of shared memory; 168 registers at launch, the
// consumers raised to 232. (Letting the two consumer warpgroups take turns
// on the tensor cores, or issuing tile i's scores beside tile i-1's P . V,
// ran slower: PERF.md.) dQ: the same kernel, K and V tiles of 128 keys,
// 83,008 / 164,928 bytes, 238 / 254 registers. dK/dV (bwd_dkdv_pair_kernel):
// 128 keys a CTA, each consumer warpgroup owning 64 with K and V resident
// and summing both dK and dV itself (two 64 x DH f32 sums), Q, dO and the
// rows' (m, 1/l, delta) streamed in tiles of QT = 128 / 64 query rows: no
// p^T hand-over, and each Q and dO tile serves 128 keys; 103,488 /
// 134,208 bytes, 168 registers at launch, the consumers raised to 240 and
// the producer lowered to 24. No spills (ptxas, chip_smoke.py prints it).

// Dead rows, real rows whose every visible key is masked (causal rows
// before the first real key), get JAX's forward result too: the uniform
// distribution over all Lk keys; their query tiles walk every key tile
// instead of stopping at the diagonal (padded rows there give 0 and stop).
// Their gradient is the forward's true one (the plain version's): masked
// scores are constants, so their ds is 0 (JAX's hand-written backward
// gives them pn * (dpn - delta)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace ergm_block {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;  // forward: o
  void* dq;
  void* dk;
  void* dv;
  float* ml;    // [2, B, H, L]: row max m (bf16: in log2 units), then row sum l
  float* stat;  // [B, H, L, 4]: the backward's (m, 1/l or 0, delta, -) of each row
  const int* qmask;       // [B, L]
  const unsigned* kbits;  // [B, Lk / 32]: bit c of word w = key 32w + c is real
  const int* dead;        // [B]: rows before it may be dead (see prep_kernel)
  int B, H, L, Lk;
  long long st[8][3];  // (batch, head, row) strides of q, k, v, o, dout, dq, dk, dv
  float scale;
  int causal, dropout;
  float drop_div, drop_mul;  // 1 - rate and 1 / (1 - rate)
  unsigned thr, seed;
  int hs;  // the hash's head stride
  int m;   // the head's slices of the kernel's width (wide heads: Dh / 128), else 1
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

// The hash's per-(batch row, head) term, mix * 2654435761 (mod 2^32).
__device__ __forceinline__ unsigned hash_base(const Args& a, int b, int h) {
  return (a.seed + static_cast<unsigned>(b * a.hs + h)) * 2654435761u;
}

// keep iff the hash of x = r*Lk + c + hash_base >= thr
__device__ __forceinline__ bool keep(const Args& a, unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= a.thr;
}

__device__ __forceinline__ bool key_real(const Args& a, int b, int c) {
  return (a.kbits[static_cast<long long>(b) * (a.Lk >> 5) + (c >> 5)] >> (c & 31)) & 1u;
}

__device__ __forceinline__ long long row_index(const Args& a, int b, int h, int r) {
  return (static_cast<long long>(b) * a.H + h) * a.L + r;
}

template <typename T>
__device__ __forceinline__ const T* head(const Args& a, const void* base, int which, int b,
                                         int h) {
  return static_cast<const T*>(base) + b * a.st[which][0] + h * a.st[which][1];
}

template <typename T>
__device__ __forceinline__ T* head_out(const Args& a, void* base, int which, int b, int h) {
  return static_cast<T*>(base) + b * a.st[which][0] + h * a.st[which][1];
}

// The CTA's head and first output column: grid y runs over (head, column
// group of `width`), a.m groups a head (one below a wide head).
__device__ __forceinline__ void head_group(const Args& a, int width, int& h, int& gc) {
  h = blockIdx.y / a.m;
  gc = (blockIdx.y % a.m) * width;
}

// The key mask as bits, and where each batch row's dead rows end: one CTA
// per batch row. A dead row is a real query row before the first real key
// (causal: it sees no real key, and JAX spreads it over every key); rows
// from dead[b] on walk only up to the diagonal. Padded rows before the
// first real key are not dead: their output is 0 whatever they walk.
__global__ void prep_kernel(const int* kmask, const int* qmask, unsigned* kbits, int* dead,
                            int L, int Lk) {
  __shared__ int warp_best[32];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = Lk >> 5, warps = blockDim.x >> 5;
  int mine = Lk;  // words rise along a warp's loop: its first hit is its least key
  for (int w = warp; w < nw; w += warps) {
    const unsigned bits =
        __ballot_sync(0xffffffffu, kmask[static_cast<long long>(b) * Lk + w * 32 + lane] != 0);
    if (lane == 0) kbits[static_cast<long long>(b) * nw + w] = bits;
    if (bits && mine == Lk) mine = w * 32 + __ffs(bits) - 1;
  }
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  int first = warp_best[0];
  for (int w = 1; w < warps; ++w) first = min(first, warp_best[w]);
  __syncthreads();
  int last = -1;  // the last real query row before the first real key
  for (int r = threadIdx.x; r < min(first, L); r += blockDim.x)
    if (qmask[static_cast<long long>(b) * L + r]) last = r;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) warp_best[warp] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) last = max(last, warp_best[w]);
    dead[b] = last + 1;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products in order, scores in shared memory.
namespace f32 {

constexpr int kThreads = 128;

// The tiles of a DH-wide head: T query rows (or keys) by DH, odd strides so
// that column walks hit distinct banks.
template <int DH>
struct Tiles {
  static constexpr int T = DH <= 64 ? 64 : 32;  // query rows and keys per tile
  static constexpr int LdD = DH + 1;            // [T][DH] tiles
  static constexpr int LdS = T + 1;             // [T][T] score tiles
  // shared memory of `data` [T][DH] tiles, `score` [T][T] tiles and four
  // per-row vectors
  static constexpr size_t bytes(int data, int score) {
    return sizeof(float) * (static_cast<size_t>(data) * T * LdD +
                            static_cast<size_t>(score) * T * LdS + 4 * T);
  }
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

// Stage rows [0, T) of one head (row stride sl floats) into a [T][DH] tile.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, long long sl) {
  using S = Tiles<DH>;
  constexpr int kVec = DH / 4;
  for (int i = threadIdx.x; i < S::T * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const float4 val = *reinterpret_cast<const float4*>(src + r * sl + c);
    dst[r * S::LdD + c] = val.x;
    dst[r * S::LdD + c + 1] = val.y;
    dst[r * S::LdD + c + 2] = val.z;
    dst[r * S::LdD + c + 3] = val.w;
  }
}

// c[M x N] = (acc ? c : 0) + A . B over k in [0, K), strides LDC, LDA, LDB.
// A(i, k) = a[i*LDA + k], or a[k*LDA + i] when AT; B(k, j) = b[k*LDB + j],
// or b[j*LDB + k] when BT. Each output has one owner, which sums k in order
// with FMAs.
template <int M, int N, int K, bool AT, bool BT, int LDC, int LDA, int LDB>
__device__ __forceinline__ void mm(float* c, const float* a, const float* b, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx % N;
    float s = acc ? c[i * LDC + j] : 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      s = fmaf(AT ? a[k * LDA + i] : a[i * LDA + k], BT ? b[j * LDB + k] : b[k * LDB + j], s);
    c[i * LDC + j] = s;
  }
}

// scores [T][T] = x . y^T over the head's whole width, DH * a.m columns:
// rows [0, T) of x and y (row strides sx, sy) staged into the [T][DH] tiles
// xs and ys a slice of DH columns at a time and summed over the slices in
// order, as one sum over the width. An operand marked resident is already
// staged when the head is one slice. Barriers before and after.
template <int DH>
__device__ __forceinline__ void scores(const Args& a, float* c, float* xs, const float* x,
                                       long long sx, bool x_resident, float* ys,
                                       const float* y, long long sy, bool y_resident) {
  using S = Tiles<DH>;
  for (int j = 0; j < a.m; ++j) {
    __syncthreads();
    if (!x_resident || a.m > 1) stage<DH>(xs, x + j * DH, sx);
    if (!y_resident || a.m > 1) stage<DH>(ys, y + j * DH, sy);
    __syncthreads();
    mm<S::T, S::T, DH, false, true, S::LdS, S::LdD, S::LdD>(c, xs, ys, j > 0);
  }
  __syncthreads();
}

// c [T][DH] += p [T][T] (p^T when PT) . y [T][DH]
template <int DH, bool PT>
__device__ __forceinline__ void mm_acc(float* c, const float* p, const float* y) {
  using S = Tiles<DH>;
  mm<S::T, DH, S::T, PT, false, S::LdD, S::LdS, S::LdD>(c, p, y, true);
}

// Write a [T][DH] tile, times mul, to rows of one head.
template <int DH>
__device__ __forceinline__ void write_tile(float* dst, long long sl, const float* c, float mul) {
  using S = Tiles<DH>;
  for (int i = threadIdx.x; i < S::T * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * sl + d] = c[r * S::LdD + d] * mul;
  }
}

template <int DH>
__device__ __forceinline__ void zero_tile(float* c) {
  using S = Tiles<DH>;
  for (int i = threadIdx.x; i < S::T * S::LdD; i += kThreads) c[i] = 0.0f;
}

// Keys the query tile at q0 (T rows) walks: up to its diagonal when causal,
// unless it holds dead rows (all their visible keys masked), which JAX
// spreads uniformly over every key.
__device__ __forceinline__ int key_end(const Args& a, int q0, int T, int dead) {
  return (a.causal && q0 >= dead) ? min(a.Lk, q0 + T) : a.Lk;
}

// Whether query q0 + r sees key k0 + c.
__device__ __forceinline__ bool visible(const Args& a, int b, int q0, int r, int k0, int c) {
  return key_real(a, b, k0 + c) && (!a.causal || k0 + c <= q0 + r);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  using S = Tiles<DH>;
  constexpr int T = S::T, LdD = S::LdD, LdS = S::LdS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = qs + T * LdD;
  float* os = kvs + T * LdD;
  float* ps = os + T * LdD;
  float* ss = ps + T * LdS;
  float* row_m = ss + T * LdS;
  float* row_l = row_m + T;
  int* row_q = reinterpret_cast<int*>(row_l + T);

  const int q0 = blockIdx.x * T, b = blockIdx.z;
  int h, gc;
  head_group(a, DH, h, gc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sq = a.st[kQ][2], sk = a.st[kK][2];
  const float* q = head<float>(a, a.q, kQ, b, h) + q0 * sq;
  const float* k = head<float>(a, a.k, kK, b, h);
  const float* v = head<float>(a, a.v, kV, b, h);
  const unsigned hb = hash_base(a, b, h);

  for (int r = threadIdx.x; r < T; r += kThreads) {
    row_q[r] = a.qmask[static_cast<long long>(b) * a.L + q0 + r] != 0;
    row_m[r] = -INFINITY;
    row_l[r] = 0.0f;
  }
  if (a.m == 1) stage<DH>(qs, q, sq);
  zero_tile<DH>(os);
  const int kend = key_end(a, q0, T, a.dead[b]);

  // pass 1: row max and sum, online over the key tiles
  for (int k0 = 0; k0 < kend; k0 += T) {
    scores<DH>(a, ss, qs, q, sq, true, kvs, k + k0 * sk, sk, false);
    for (int r = warp; r < T; r += kThreads / 32) {
      float s[T / 32], mx = kNegInf;
#pragma unroll
      for (int e = 0; e < T / 32; ++e) {
        const int c = lane + 32 * e;
        s[e] = visible(a, b, q0, r, k0, c) ? ss[r * LdS + c] * a.scale : kNegInf;
        mx = fmaxf(mx, s[e]);
      }
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float part = 0.0f;
#pragma unroll
      for (int e = 0; e < T / 32; ++e) part += expf(s[e] - m_new);
      const float sum = warp_sum(part);
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + sum;
        row_m[r] = m_new;
      }
    }
  }

  // pass 2: recompute s, normalise, drop, accumulate pn . V
  for (int k0 = 0; k0 < kend; k0 += T) {
    scores<DH>(a, ss, qs, q, sq, true, kvs, k + k0 * sk, sk, false);
    stage<DH>(kvs, v + k0 * a.st[kV][2] + gc, a.st[kV][2]);  // K is no longer read
    for (int i = threadIdx.x; i < T * T; i += kThreads) {
      const int r = i / T, c = i % T;
      const float s = visible(a, b, q0, r, k0, c) ? ss[r * LdS + c] * a.scale : kNegInf;
      float p = expf(s - row_m[r]) / fmaxf(row_l[r], 1e-30f);
      if (!row_q[r]) p = 0.0f;
      if (a.dropout) {
        const unsigned x = static_cast<unsigned>(q0 + r) * static_cast<unsigned>(a.Lk) +
                           static_cast<unsigned>(k0 + c) + hb;
        p = keep(a, x) ? p / a.drop_div : 0.0f;
      }
      ps[r * LdS + c] = p;
    }
    __syncthreads();
    mm_acc<DH, false>(os, ps, kvs);
  }
  __syncthreads();
  float* o = head_out<float>(a, a.out, kO, b, h);
  write_tile<DH>(o + q0 * a.st[kO][2] + gc, a.st[kO][2], os, 1.0f);
  const long long row0 = row_index(a, b, h, q0);
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
  for (int r = threadIdx.x; r < T && gc == 0; r += kThreads) {
    a.ml[row0 + r] = row_m[r];
    a.ml[plane + row0 + r] = row_l[r];
  }
}

// The backward's per-element step for query q0 + r, key k0 + c: pn (the
// forward's, from its m and l), the post-dropout operand pv of dV, and ds.
// A masked score is a constant of the forward (the where's fill), so its
// ds is 0; this only matters on rows with every visible key masked, whose
// pn is not 0 there.
__device__ __forceinline__ void grad_step(const Args& a, int b, unsigned hb, int q0, int r,
                                          int k0, int c, float dot, float dp,
                                          const float* row_m, const float* row_l,
                                          const float* row_d, const int* row_q, float* pv_out,
                                          float* ds_out) {
  const bool ok = visible(a, b, q0, r, k0, c);
  float pn = expf((ok ? dot * a.scale : kNegInf) - row_m[r]) / fmaxf(row_l[r], 1e-30f);
  if (!row_q[r]) pn = 0.0f;
  float pv = pn;
  if (a.dropout) {
    const unsigned x = static_cast<unsigned>(q0 + r) * static_cast<unsigned>(a.Lk) +
                       static_cast<unsigned>(k0 + c) + hb;
    const bool kp = keep(a, x);
    dp = kp ? dp * a.drop_mul : 0.0f;
    pv = kp ? pn * a.drop_mul : 0.0f;
  }
  if (pv_out) *pv_out = pv;
  *ds_out = ok ? pn * (dp - row_d[r]) : 0.0f;
}

__device__ __forceinline__ void load_rows(const Args& a, int b, int h, int q0, int T,
                                          float* row_m, float* row_l, float* row_d, int* row_q) {
  const long long row0 = row_index(a, b, h, q0);
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
  for (int r = threadIdx.x; r < T; r += kThreads) {
    row_m[r] = a.ml[row0 + r];
    row_l[r] = a.ml[plane + row0 + r];
    if (row_d) row_d[r] = a.stat[4 * (row0 + r) + 2];
    row_q[r] = a.qmask[static_cast<long long>(b) * a.L + q0 + r] != 0;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  using S = Tiles<DH>;
  constexpr int T = S::T, LdD = S::LdD, LdS = S::LdS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + T * LdD;
  float* ks = dos + T * LdD;
  float* vs = ks + T * LdD;
  float* acc = vs + T * LdD;
  float* dss = acc + T * LdD;
  float* ss = dss + T * LdS;
  float* dps = ss + T * LdS;
  float* row_m = dps + T * LdS;
  float* row_l = row_m + T;
  float* row_d = row_l + T;
  int* row_q = reinterpret_cast<int*>(row_d + T);

  const int q0 = blockIdx.x * T, b = blockIdx.z;
  int h, gc;
  head_group(a, DH, h, gc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long sq = a.st[kQ][2], sk = a.st[kK][2], sv = a.st[kV][2], sdo = a.st[kDO][2];
  const float* q = head<float>(a, a.q, kQ, b, h) + q0 * sq;
  const float* k = head<float>(a, a.k, kK, b, h);
  const float* v = head<float>(a, a.v, kV, b, h);
  const float* o = head<float>(a, a.o, kO, b, h) + q0 * a.st[kO][2];
  const float* dout = head<float>(a, a.dout, kDO, b, h) + q0 * sdo;
  const unsigned hb = hash_base(a, b, h);

  load_rows(a, b, h, q0, T, row_m, row_l, nullptr, row_q);
  if (a.m == 1) {
    stage<DH>(qs, q, sq);
    stage<DH>(dos, dout, sdo);
  }
  zero_tile<DH>(acc);
  // delta = rowsum(dO * O) over the whole width in f32, for this kernel and
  // the dK/dV kernel
  const long long row0 = row_index(a, b, h, q0);
  for (int r = warp; r < T; r += kThreads / 32) {
    const float* orow = o + r * a.st[kO][2];
    const float* drow = dout + r * sdo;
    float part = 0.0f;
    for (int c = lane; c < DH * a.m; c += 32) part += drow[c] * orow[c];
    const float d = warp_sum(part);
    if (lane == 0) {
      row_d[r] = d;
      if (gc == 0) a.stat[4 * (row0 + r) + 2] = d;
    }
  }
  const int kend = key_end(a, q0, T, a.dead[b]);
  for (int k0 = 0; k0 < kend; k0 += T) {
    scores<DH>(a, ss, qs, q, sq, true, ks, k + k0 * sk, sk, false);
    scores<DH>(a, dps, dos, dout, sdo, true, vs, v + k0 * sv, sv, false);
    if (a.m > 1) stage<DH>(ks, k + k0 * sk + gc, sk);  // the group's columns, for dS . K
    for (int i = threadIdx.x; i < T * T; i += kThreads) {
      const int r = i / T, c = i % T;
      grad_step(a, b, hb, q0, r, k0, c, ss[r * LdS + c], dps[r * LdS + c], row_m, row_l, row_d,
                row_q, nullptr, dss + r * LdS + c);
    }
    __syncthreads();
    mm_acc<DH, false>(acc, dss, ks);
  }
  __syncthreads();
  float* dq = head_out<float>(a, a.dq, kDQ, b, h);
  write_tile<DH>(dq + q0 * a.st[kDQ][2] + gc, a.st[kDQ][2], acc, a.scale);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Args a) {
  using S = Tiles<DH>;
  constexpr int T = S::T, LdD = S::LdD, LdS = S::LdS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + T * LdD;
  float* qs = vs + T * LdD;
  float* dos = qs + T * LdD;
  float* dk_acc = dos + T * LdD;
  float* dv_acc = dk_acc + T * LdD;
  float* ps = dv_acc + T * LdD;
  float* dss = ps + T * LdS;
  float* ss = dss + T * LdS;
  float* dps = ss + T * LdS;
  float* row_m = dps + T * LdS;
  float* row_l = row_m + T;
  float* row_d = row_l + T;
  int* row_q = reinterpret_cast<int*>(row_d + T);

  const int k0 = blockIdx.x * T, b = blockIdx.z;
  int h, gc;
  head_group(a, DH, h, gc);
  const long long sq = a.st[kQ][2], sk = a.st[kK][2], sv = a.st[kV][2], sdo = a.st[kDO][2];
  const float* q = head<float>(a, a.q, kQ, b, h);
  const float* k = head<float>(a, a.k, kK, b, h) + k0 * sk;
  const float* v = head<float>(a, a.v, kV, b, h) + k0 * sv;
  const float* dout = head<float>(a, a.dout, kDO, b, h);
  const unsigned hb = hash_base(a, b, h);
  const int dead = a.dead[b];

  if (a.m == 1) {
    stage<DH>(ks, k, sk);
    stage<DH>(vs, v, sv);
  }
  zero_tile<DH>(dk_acc);
  zero_tile<DH>(dv_acc);
  for (int q0 = 0; q0 < a.L; q0 += T) {
    if (k0 >= key_end(a, q0, T, dead)) continue;  // the tile never sees these keys
    __syncthreads();
    load_rows(a, b, h, q0, T, row_m, row_l, row_d, row_q);
    scores<DH>(a, ss, qs, q + q0 * sq, sq, false, ks, k, sk, true);
    scores<DH>(a, dps, dos, dout + q0 * sdo, sdo, false, vs, v, sv, true);
    if (a.m > 1) {  // the group's columns, for pv^T . dO and dS^T . Q
      stage<DH>(qs, q + q0 * sq + gc, sq);
      stage<DH>(dos, dout + q0 * sdo + gc, sdo);
    }
    for (int i = threadIdx.x; i < T * T; i += kThreads) {
      const int r = i / T, c = i % T;
      grad_step(a, b, hb, q0, r, k0, c, ss[r * LdS + c], dps[r * LdS + c], row_m, row_l, row_d,
                row_q, ps + r * LdS + c, dss + r * LdS + c);
    }
    __syncthreads();
    mm_acc<DH, true>(dv_acc, ps, dos);
    mm_acc<DH, true>(dk_acc, dss, qs);
  }
  __syncthreads();
  float* dk = head_out<float>(a, a.dk, kDK, b, h);
  float* dv = head_out<float>(a, a.dv, kDV, b, h);
  write_tile<DH>(dk + k0 * a.st[kDK][2] + gc, a.st[kDK][2], dk_acc, a.scale);
  write_tile<DH>(dv + k0 * a.st[kDV][2] + gc, a.st[kDV][2], dv_acc, 1.0f);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// The scores' mask, shared by the bf16 kernels (blk::, wide::, flash::): the
// m16n8k16 accumulator layout, which wgmma's m64nN accumulator repeats a
// warp at a time (rows 16w + g and + 8, columns 8j + 2t and + 1).
namespace score {

constexpr int kSub = 32;                     // mask_scores' keys at a time
constexpr float kMaskL2 = kNegInf * kLog2e;  // the where's fill, in log2 units

// Mask the scores of the warp's 16 rows (from r0) against the 32 keys at c0
// (bits: their key-mask bits from bit 0), scaled into log2 units:
// s*scale*log2(e) where visible, exactly kMaskL2 (the where's fill) elsewhere.
__device__ __forceinline__ void mask_scores(const Args& a, unsigned bits, float (&sc)[4][4],
                                            int r0, int c0, float sl2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (bits == ~0u && (!a.causal || c0 + kSub - 1 <= r0)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= sl2;
    return;
  }
  const unsigned kw = bits >> (2 * t);
  const int lim = r0 + g - c0 - 2 * t;  // visible iff column offset <= lim + row offset
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + (e & 1);  // the column, less c0 + 2t
      const bool vis = ((kw >> c) & 1u) && (!a.causal || c <= lim + 8 * (e >> 1));
      sc[j][e] = vis ? sc[j][e] * sl2 : kMaskL2;
    }
}

}  // namespace score

// ---------------------------------------------------------------------------
// Wide heads, bf16: Dh = 128 m with m >= 4 (the flash:: kernels take 256
// and 384), no dropout (JAX's flash gate only). Scores and dP over the
// whole width, in m sub-steps of 128 columns.
namespace wide {

using ergm_mma::ex2;
using ergm_mma::ld_of;
using ergm_mma::prod_nn;
using ergm_mma::prod_nt_acc;
using ergm_mma::store_rows;
using ergm_mma::zero;
using score::kMaskL2;
using score::mask_scores;

constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kRows = 64;      // rows a CTA owns: queries (forward, dQ) or keys (dK/dV)
constexpr int kW = 128;        // a slice of the width, and a CTA's output columns
constexpr int kLd = ld_of<kW>();
constexpr int kTile = 64;      // forward, dQ: keys a streamed tile (2 sub-steps of 32)
constexpr int kQTile = 32;     // dK/dV: queries a streamed tile
// a ring slot: a slice of the owned rows' operand, then one of the streamed
// tile's (or, alone, the group's columns of a streamed operand)
constexpr int kSlotRows = kRows + kTile, kQSlotRows = kRows + kQTile;
constexpr size_t kFwdBytes = 2 * sizeof(bf16) * kSlotRows * kLd;  // also dQ's
constexpr size_t kDkdvBytes = 2 * sizeof(bf16) * kQSlotRows * kLd + 2 * kQTile * sizeof(float4);

template <int N>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long sl) {
  ergm_mma::stage<N, kThreads, kW>(dst, src, sl);
}

__device__ __forceinline__ unsigned key_word(const Args& a, int b, int c0) {
  return a.kbits[static_cast<long long>(b) * (a.Lk >> 5) + (c0 >> 5)];
}

// Forward: pass 1 takes m sub-steps a key tile (Q_j and K_j into the scores),
// pass 2 m + 1 (the scores again, then the group's columns of V for pn . V).
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][kSlotRows][kLd]
  const int m = a.m;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal rows first
  const int b = blockIdx.z;
  int h, gc;
  head_group(a, kW, h, gc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;
  const long long sq = a.st[kQ][2], sk = a.st[kK][2], sv = a.st[kV][2];
  const bf16* q = head<bf16>(a, a.q, kQ, b, h) + q0 * sq;
  const bf16* k = head<bf16>(a, a.k, kK, b, h);
  const bf16* v = head<bf16>(a, a.v, kV, b, h);
  const int dead = a.dead[b];
  // the keys the CTA's rows and the warp's walk (all of them for dead rows)
  const int kend = (a.causal && q0 >= dead) ? min(a.Lk, q0 + kRows) : a.Lk;
  const int wend = (a.causal && r0 >= dead) ? min(a.Lk, r0 + 16) : a.Lk;
  const int n = kend / kTile, n1 = n * m, steps = n1 + n * (m + 1);
  const float sl2 = a.scale * kLog2e;
  auto at = [&](int s, int& k0, int& j) {
    const int per = s < n1 ? m : m + 1, i = s < n1 ? s : s - n1;
    k0 = (i / per) * kTile;
    j = i % per;
  };
  auto issue = [&](int s) {
    if (s < steps) {
      int k0, j;
      at(s, k0, j);
      bf16* slot = ring + (s & 1) * kSlotRows * kLd;
      if (j < m) {
        stage<kRows>(slot, q + j * kW, sq);
        stage<kTile>(slot + kRows * kLd, k + k0 * sk + j * kW, sk);
      } else {
        stage<kTile>(slot + kRows * kLd, v + k0 * sv + gc, sv);
      }
    }
    ergm_async::commit();
  };
  issue(0);

  float mt[2] = {-INFINITY, -INFINITY}, lt[2] = {0.0f, 0.0f};  // the lane's share of m, l
  float mrow[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
  float o[kW / 8][4];
  zero(o);
  float sc[kTile / 32][4][4];

  for (int s = 0; s < steps; ++s) {
    int k0, j;
    at(s, k0, j);
    issue(s + 1);
    ergm_async::wait<1>();
    __syncthreads();
    if (s == n1) {
      // the row's m and l from the four lanes that hold it
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float l = lt[i] * ex2(mt[i] - mx);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = r0 + g + 8 * i;
        mrow[i] = mx;
        inv[i] = a.qmask[static_cast<long long>(b) * a.L + r] != 0 ? 1.0f / fmaxf(l, 1e-30f)
                                                                    : 0.0f;
        if (t == 0 && gc == 0) {
          const long long idx = row_index(a, b, h, r);
          a.ml[idx] = mx;
          a.ml[static_cast<long long>(a.B) * a.H * a.L + idx] = l;
        }
      }
    }
    const bf16* slot = ring + (s & 1) * kSlotRows * kLd;
    const bf16* tt = slot + kRows * kLd;
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int c0 = k0 + u * 32;
      if (c0 >= wend) continue;
      if (j < m) {
        if (j == 0) zero(sc[u]);
        prod_nt_acc<kW>(sc[u], slot, warp * 16, tt, u * 32);
      }
      if (j == m - 1) {
        mask_scores(a, key_word(a, b, c0), sc[u], r0, c0, sl2);
        if (s < n1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float w[4];  // a tree: independent maxima, then sums
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) w[jj] = fmaxf(sc[u][jj][2 * i], sc[u][jj][2 * i + 1]);
            const float mx = fmaxf(mt[i], fmaxf(fmaxf(w[0], w[1]), fmaxf(w[2], w[3])));
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              w[jj] = ex2(sc[u][jj][2 * i] - mx) + ex2(sc[u][jj][2 * i + 1] - mx);
            lt[i] = lt[i] * ex2(mt[i] - mx) + ((w[0] + w[1]) + (w[2] + w[3]));
            mt[i] = mx;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[u][jj][e] = ex2(sc[u][jj][e] - mrow[e >> 1]) * inv[e >> 1];
        }
      } else if (j == m) {
        prod_nn<kW>(o, sc[u], tt, u * 32);
      }
    }
    __syncthreads();
  }
  store_rows<kW>(head_out<bf16>(a, a.out, kO, b, h) + gc, a.st[kO][2], r0 + g, o, 1.0f);
}

// dQ: pass 1 takes 2m sub-steps a key tile (Q_j K_j^T into the scores, then
// dO_j V_j^T into dP) for delta = rowsum(pn * dpn), pass 2 2m + 1 (the same,
// then the group's columns of K for dS . K).
__global__ void __launch_bounds__(kThreads, 2) bwd_dq_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][kSlotRows][kLd]
  const int m = a.m;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.z;
  int h, gc;
  head_group(a, kW, h, gc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16;
  const long long sq = a.st[kQ][2], sdo = a.st[kDO][2], sk = a.st[kK][2], sv = a.st[kV][2];
  const bf16* q = head<bf16>(a, a.q, kQ, b, h) + q0 * sq;
  const bf16* dout = head<bf16>(a, a.dout, kDO, b, h) + q0 * sdo;
  const bf16* k = head<bf16>(a, a.k, kK, b, h);
  const bf16* v = head<bf16>(a, a.v, kV, b, h);
  const int dead = a.dead[b];
  const int kend = (a.causal && q0 >= dead) ? min(a.Lk, q0 + kRows) : a.Lk;
  const int wend = (a.causal && r0 >= dead) ? min(a.Lk, r0 + 16) : a.Lk;
  const int n = kend / kTile, n1 = n * 2 * m, steps = n1 + n * (2 * m + 1);
  const float sl2 = a.scale * kLog2e;
  auto at = [&](int s, int& k0, int& j) {
    const int per = s < n1 ? 2 * m : 2 * m + 1, i = s < n1 ? s : s - n1;
    k0 = (i / per) * kTile;
    j = i % per;
  };
  auto issue = [&](int s) {
    if (s < steps) {
      int k0, j;
      at(s, k0, j);
      bf16* slot = ring + (s & 1) * kSlotRows * kLd;
      if (j < m) {
        stage<kRows>(slot, q + j * kW, sq);
        stage<kTile>(slot + kRows * kLd, k + k0 * sk + j * kW, sk);
      } else if (j < 2 * m) {
        stage<kRows>(slot, dout + (j - m) * kW, sdo);
        stage<kTile>(slot + kRows * kLd, v + k0 * sv + (j - m) * kW, sv);
      } else {
        stage<kTile>(slot + kRows * kLd, k + k0 * sk + gc, sk);
      }
    }
    ergm_async::commit();
  };
  issue(0);

  float mrow[2], inv[2], delta[2] = {0.0f, 0.0f};  // delta: the lane's share until step n1
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    const long long idx = row_index(a, b, h, r);
    mrow[i] = a.ml[idx];
    inv[i] = a.qmask[static_cast<long long>(b) * a.L + r] != 0
                 ? 1.0f / fmaxf(a.ml[plane + idx], 1e-30f) : 0.0f;
  }
  float acc[kW / 8][4];
  zero(acc);
  float sc[kTile / 32][4][4], dp[kTile / 32][4][4];

  for (int s = 0; s < steps; ++s) {
    int k0, j;
    at(s, k0, j);
    issue(s + 1);
    ergm_async::wait<1>();
    __syncthreads();
    if (s == n1) {
      // delta of each row from the four lanes that hold it; the rows' (m,
      // 1/l, delta) go to the dK/dV kernel
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
      }
      if (t == 0 && gc == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          reinterpret_cast<float4*>(a.stat)[row_index(a, b, h, r0 + g + 8 * i)] =
              make_float4(mrow[i], inv[i], delta[i], 0.0f);
      }
    }
    const bf16* slot = ring + (s & 1) * kSlotRows * kLd;
    const bf16* tt = slot + kRows * kLd;
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int c0 = k0 + u * 32;
      if (c0 >= wend) continue;
      if (j < m) {
        if (j == 0) zero(sc[u]);
        prod_nt_acc<kW>(sc[u], slot, warp * 16, tt, u * 32);
      } else if (j < 2 * m) {
        if (j == m) zero(dp[u]);
        prod_nt_acc<kW>(dp[u], slot, warp * 16, tt, u * 32);
      }
      if (j == 2 * m - 1) {
        // pass 1: delta += pn * dpn; pass 2: ds = pn * (dpn - delta), both
        // where visible, 0 where masked
        mask_scores(a, key_word(a, b, c0), sc[u], r0, c0, sl2);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float pn = sc[u][jj][e] == kMaskL2 ? 0.0f : ex2(sc[u][jj][e] - mrow[i]) * inv[i];
            if (s < n1)
              delta[i] += pn * dp[u][jj][e];
            else
              sc[u][jj][e] = pn * (dp[u][jj][e] - delta[i]);
          }
      } else if (j == 2 * m) {
        prod_nn<kW>(acc, sc[u], tt, u * 32);
      }
    }
    __syncthreads();
  }
  store_rows<kW>(head_out<bf16>(a, a.dq, kDQ, b, h) + gc, a.st[kDQ][2], r0 + g, acc, a.scale);
}

// dK/dV: one CTA per 64 keys and group, over the query tiles that see them;
// a tile takes 2m + 2 sub-steps: K_j Q_j^T into S^T, V_j dO_j^T into dP^T,
// then the group's columns of dO (dV += pv^T dO) and of Q (dK += dS^T Q).
__global__ void __launch_bounds__(kThreads, 2) bwd_dkdv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][kQSlotRows][kLd]
  float4* sts = reinterpret_cast<float4*>(ring + 2 * kQSlotRows * kLd);  // [2][kQTile]
  const int m = a.m, per = 2 * m + 2;
  const int k0 = blockIdx.x * kRows, b = blockIdx.z;
  int h, gc;
  head_group(a, kW, h, gc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + warp * 16;  // the warp's first key
  const long long sq = a.st[kQ][2], sdo = a.st[kDO][2], sk = a.st[kK][2], sv = a.st[kV][2];
  const bf16* q = head<bf16>(a, a.q, kQ, b, h);
  const bf16* dout = head<bf16>(a, a.dout, kDO, b, h);
  const bf16* k = head<bf16>(a, a.k, kK, b, h) + k0 * sk;
  const bf16* v = head<bf16>(a, a.v, kV, b, h) + k0 * sv;
  const float4* stat = reinterpret_cast<const float4*>(a.stat) + row_index(a, b, h, 0);
  const int dead = a.dead[b];
  const float sl2 = a.scale * kLog2e;

  // the query tiles that see these keys: those holding dead rows (they see
  // every key), then the diagonal onwards
  const int nq = a.L / kQTile;
  const int from = a.causal ? min(k0 / kQTile, nq) : 0;
  const int lo = a.causal ? min((dead + kQTile - 1) / kQTile, from) : 0;
  const int steps = (lo + nq - from) * per;
  auto tile = [&](int i) { return (i < lo ? i : from + i - lo) * kQTile; };
  auto issue = [&](int s) {
    if (s < steps) {
      const int i = s / per, j = s % per, q0 = tile(i);
      bf16* slot = ring + (s & 1) * kQSlotRows * kLd;
      bf16* tt = slot + kRows * kLd;
      if (j < m) {
        stage<kRows>(slot, k + j * kW, sk);
        stage<kQTile>(tt, q + q0 * sq + j * kW, sq);
      } else if (j < 2 * m) {
        stage<kRows>(slot, v + (j - m) * kW, sv);
        stage<kQTile>(tt, dout + q0 * sdo + (j - m) * kW, sdo);
      } else {
        stage<kQTile>(tt, j == 2 * m ? dout + q0 * sdo + gc : q + q0 * sq + gc,
                      j == 2 * m ? sdo : sq);
      }
      if (j == 0 && threadIdx.x < kQTile)
        ergm_async::copy16(sts + (i & 1) * kQTile + threadIdx.x, stat + q0 + threadIdx.x);
    }
    ergm_async::commit();
  };
  issue(0);

  int kr[2];
  bool kreal[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kr[i] = kw0 + g + 8 * i;
    kreal[i] = key_real(a, b, kr[i]);
  }
  const bool wreal = __all_sync(0xffffffffu, kreal[0] && kreal[1]);  // the warp's keys all real
  float dk[kW / 8][4], dv[kW / 8][4], sc[4][4], dp[4][4];
  zero(dk);
  zero(dv);

  for (int s = 0; s < steps; ++s) {
    const int i = s / per, j = s % per, c0 = tile(i);  // c0: the tile's first query
    issue(s + 1);
    ergm_async::wait<1>();
    __syncthreads();
    const bf16* slot = ring + (s & 1) * kQSlotRows * kLd;
    const bf16* tt = slot + kRows * kLd;
    if (!a.causal || c0 + kQTile - 1 >= kw0 || c0 < dead) {
      if (j < m) {
        if (j == 0) zero(sc);
        prod_nt_acc<kW>(sc, slot, warp * 16, tt, 0);
      } else if (j < 2 * m) {
        if (j == m) zero(dp);
        prod_nt_acc<kW>(dp, slot, warp * 16, tt, 0);
      }
      if (j == 2 * m - 1) {
        // S^T and dP^T done: the warp's 16 keys as rows, 32 queries as
        // columns; pv (no dropout: pn) into sc, ds into dp
        const float4* st = sts + (i & 1) * kQTile;
        const bool full = wreal && (!a.causal || kw0 + 15 <= c0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int qc = c0 + 8 * jj + 2 * t + e1;
            const float4 rs = st[qc - c0];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + e1;
              const bool ok = full || (kreal[r] && (!a.causal || kr[r] <= qc));
              const float pn = ex2((ok ? sc[jj][e] * sl2 : kMaskL2) - rs.x) * rs.y;
              dp[jj][e] = ok ? pn * (dp[jj][e] - rs.z) : 0.0f;
              sc[jj][e] = pn;
            }
          }
      } else if (j == 2 * m) {
        prod_nn<kW>(dv, sc, tt, 0);  // dV += pv^T dO
      } else if (j == 2 * m + 1) {
        prod_nn<kW>(dk, dp, tt, 0);  // dK += ds^T Q
      }
    }
    __syncthreads();
  }
  store_rows<kW>(head_out<bf16>(a, a.dk, kDK, b, h) + gc, a.st[kDK][2], kw0 + g, dk, a.scale);
  store_rows<kW>(head_out<bf16>(a, a.dv, kDV, b, h) + gc, a.st[kDV][2], kw0 + g, dv, 1.0f);
}

}  // namespace wide

// ---------------------------------------------------------------------------
// One-pass kernels, bf16 at Dh = 64, 128, 256 and 384 without dropout
// (JAX's flash gate only): the arithmetic of JAX's library flash kernel on
// wgmma, operands loaded by TMA (the note at the top).
namespace flash {

using ergm_hopper::bar_arrive;
using ergm_hopper::bar_sync;
using ergm_hopper::bulk_load;
using ergm_hopper::mbar_arrive;
using ergm_hopper::mbar_expect;
using ergm_hopper::mbar_fence_init;
using ergm_hopper::mbar_init;
using ergm_hopper::mbar_wait;
using ergm_hopper::pin;
using ergm_hopper::sm_desc;
using ergm_hopper::tma_load_4d;
using ergm_hopper::wg_commit;
using ergm_hopper::wg_fence;
using ergm_hopper::wg_wait;
using ergm_hopper::wgmma_rs;
using ergm_hopper::wgmma_ss;
using ergm_mma::ex2;
using ergm_mma::pack;
using ergm_mma::store_rows;
using ergm_mma::zero;
using score::kMaskL2;
using score::mask_scores;

constexpr int kOwn = 64;             // rows a warpgroup owns: queries (forward, dQ) or keys
constexpr int kQRows = 2 * kOwn;     // forward: query rows a CTA owns
constexpr int kStages = 2;           // the ring of streamed tiles
constexpr int kWgThreads = 384;      // a producer warpgroup, two consumer warpgroups
constexpr int kDqThreads = 128;      // dQ: one warpgroup, its own loads
constexpr size_t kAlign = 1024;      // the swizzle's pattern

// A head width's shapes: DH the scores' depth, GW the output columns a
// CTA owns (DH / GW column groups on grid y), KT the rows of a streamed
// tile, QT (where not 0) the query rows of the paired dK/dV kernel's
// streamed tile. Tiles are 128-byte column blocks [rows][64], DH / 64 (NB)
// of them a row, GW / 64 (GB) a group; shared memory (bytes) of each kernel.
template <int DH_, int GW_, int KT_, int QT_ = 0>
struct Shape {
  static constexpr int DH = DH_, GW = GW_, KT = KT_, QT = QT_;
  static constexpr int NB = DH / 64, GB = GW / 64, kGroups = DH / GW;
  // forward: Q [128][DH]; stages of K [KT][DH] and V's group [KT][GW]
  static constexpr size_t kFwdBytes =
      kAlign + 2 * (kQRows * DH + kStages * (KT * DH + KT * GW)) + 64;
  // dQ: Q, dO [64][DH]; stages of K, V [KT][DH]
  static constexpr size_t kDqBytes = kAlign + 2 * (2 * kOwn * DH + kStages * 2 * KT * DH) + 64;
  // dK/dV: K, V [64][DH]; stages of Q, dO [KT][DH] and the KT rows'
  // (m, 1/l, delta, -); p^T [64][KT] f32
  static constexpr size_t kDkdvBytes = kAlign + 2 * (2 * kOwn * DH + kStages * 2 * KT * DH) +
                                       kStages * KT * 16 + kOwn * KT * 4 + 64;
  // paired dK/dV: K, V [2 * 64][DH]; stages of Q, dO [QT][DH] and the QT
  // rows' (m, 1/l, delta, -)
  static constexpr size_t kPairBytes =
      kAlign + 2 * (2 * 2 * kOwn * DH + kStages * 2 * QT * DH) + kStages * QT * 16 + 64;
};
using D64 = Shape<64, 64, 128, 128>;    // JAX's flash gate below 64 (padded) and at 64
using D128 = Shape<128, 128, 128, 64>;  // 65 to 128 (padded below)
using D256 = Shape<256, 256, 64>;   // one group: every CTA owns the whole width
using D384 = Shape<384, 192, 32>;   // two groups of 192; 32-row tiles to fit the ring

// The tensor maps of a kernel's operands: [B, H, rows, DH] bf16 over the
// callers' strides, boxes of 64 columns by the rows a tile takes
struct Maps {
  CUtensorMap q, k, v, dout;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (ergm_mma::saddr(raw) & (kAlign - 1))) & (kAlign - 1));
}

// TMA: rows [r0, r0 + X) of head (b, h), the N column blocks from blk0,
// into a tile of N column blocks [X][BW] (BW = 64: the 128-byte swizzle;
// 32: the 64-byte one)
template <int X, int N, int BW = 64>
__device__ __forceinline__ void load_rows(const CUtensorMap* map, bf16* dst, uint64_t* bar, int r0,
                                          int h, int b, int blk0 = 0) {
#pragma unroll
  for (int c = 0; c < N; ++c) tma_load_4d(map, dst + c * X * BW, bar, (blk0 + c) * BW, r0, h, b);
}

// The descriptors' swizzle for column blocks of BW bf16
template <int BW>
__host__ __device__ constexpr unsigned swizzle_of() {
  return BW == 64 ? 1u : 2u;
}

// k16 step kk of a K-major operand: rows from row0 of an X-row tile
template <int X, int BW = 64>
__device__ __forceinline__ uint64_t desc_k(const bf16* t, int row0, int kk) {
  constexpr int kSteps = BW / 16;  // k16 steps a column block
  return sm_desc(t + (kk / kSteps) * X * BW + row0 * BW + (kk % kSteps) * 16, 16, 16 * BW,
                 swizzle_of<BW>());
}

// k16 step kk of an X-row tile read MN-major (its rows as the product's
// depth, its column blocks from t as N)
template <int X, int BW = 64>
__device__ __forceinline__ uint64_t desc_mn(const bf16* t, int kk) {
  return sm_desc(t + kk * 16 * BW, X * BW * 2, 16 * BW, swizzle_of<BW>());
}

// s = A . B^T over the whole depth: A the 64 rows from arow of an XA-row
// tile, B a KT-row tile; issued, not waited for
template <class S, int XA>
__device__ __forceinline__ void scores(float (&s)[S::KT / 8][4], const bf16* ta, int arow,
                                       const bf16* tb) {
#pragma unroll
  for (int kk = 0; kk < S::DH / 16; ++kk)
    wgmma_ss<S::KT>(s, desc_k<XA>(ta, arow, kk), desc_k<S::KT>(tb, 0, kk), kk);
}

// acc += x . B for x the warpgroup's 64 x KT block (the accumulator layout
// of scores), rounded to bf16 as the A operand in registers, and B the GW
// columns from tb of a KT-row tile; waited for
template <class S>
__device__ __forceinline__ void accumulate(float (&acc)[S::GW / 8][4],
                                           const float (&x)[S::KT / 8][4], const bf16* tb) {
  constexpr int kSteps = S::KT / 16;
  unsigned a[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    a[kk][0] = pack(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<S::GW>(acc, a[kk], desc_mn<S::KT>(tb, kk));
  wg_commit();
  wg_wait<0>();
  pin(acc);
}

// Mask the warp's 16 rows (from r0) of a KT-key score block at k0, scaled
// into log2 units (score::mask_scores, 32 keys at a time)
template <int KT>
__device__ __forceinline__ void mask_keys(const Args& a, int b, float (&s)[KT / 8][4], int r0,
                                          int k0, float sl2) {
  auto& part = reinterpret_cast<float(&)[KT / 32][4][4]>(s);
#pragma unroll
  for (int u = 0; u < KT / 32; ++u)
    mask_scores(a, a.kbits[static_cast<long long>(b) * (a.Lk >> 5) + ((k0 >> 5) + u)], part[u],
                r0, k0 + 32 * u, sl2);
}

// Forward: 128 query rows and one column group a CTA, in two consumer
// warpgroups of 64 rows; a producer warpgroup loads Q once and K tiles
// (and V's group columns) of KT keys through the ring. One pass: the
// running max m (log2 units) and sum l in f32, p = 2^(s - m) rounded to
// bf16 before P . V, the f32 sum rescaled as m moves and normalised once
// at the end. Group 0 writes m and l.
template <class S>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int KT = S::KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // [NB][128][64]
  bf16* ring = qs + kQRows * S::DH;  // [kStages]: K [NB][KT][64], V [GB][KT][64]
  constexpr int kStage = KT * (S::DH + S::GW);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // the longest causal rows first
  const int h = blockIdx.y / S::kGroups, grp = blockIdx.y % S::kGroups, b = blockIdx.z;
  const int wg = threadIdx.x / 128, dead = a.dead[b];
  // the key tiles the CTA's rows walk (all of them where it holds dead rows)
  const int n = (((a.causal && q0 >= dead) ? min(a.Lk, q0 + kQRows) : a.Lk) + KT - 1) / KT;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
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
      mbar_expect(qbar, 2 * kQRows * S::DH);
      load_rows<kQRows, S::NB>(&maps.q, qs, qbar, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        bf16* kt = ring + s * kStage;
        mbar_wait(empty + s, ((i / kStages) + 1) & 1);
        mbar_expect(full + s, 2 * kStage);
        load_rows<KT, S::NB>(&maps.k, kt, full + s, i * KT, h, b);
        load_rows<KT, S::GB>(&maps.v, kt + KT * S::DH, full + s, i * KT, h, b, grp * S::GB);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + kOwn * c;                        // the warpgroup's rows
  const int rw = r0 + 16 * ((threadIdx.x >> 5) & 3);  // the warp's
  const int wend = (a.causal && r0 >= dead) ? min(a.Lk, r0 + kOwn) : a.Lk;
  const float sl2 = a.scale * kLog2e;
  float o[S::GW / 8][4], mrow[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};
  zero(o);
  mbar_wait(qbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages, k0 = i * KT;
    const bf16* kt = ring + s * kStage;
    mbar_wait(full + s, (i / kStages) & 1);
    if (k0 < wend) {
      float sc[KT / 8][4];
      wg_fence();
      scores<S, kQRows>(sc, qs, kOwn * c, kt);
      wg_commit();
      wg_wait<0>();
      pin(sc);
      mask_keys<KT>(a, b, sc, rw, k0, sl2);
      // the row max over this block and the running one (the four lanes of
      // a row agree), p = 2^(s - m) and the lane's share of l
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = mrow[r];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = ex2(mrow[r] - mx);
        mrow[r] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          sc[j][2 * r] = ex2(sc[j][2 * r] - mx);
          sc[j][2 * r + 1] = ex2(sc[j][2 * r + 1] - mx);
          sum += sc[j][2 * r] + sc[j][2 * r + 1];
        }
        lsum[r] = lsum[r] * alpha[r] + sum;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int j = 0; j < S::GW / 8; ++j) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
      }
      accumulate<S>(o, sc, kt + KT * S::DH);
    }
    if (lane == 0) mbar_arrive(empty + s);
  }
  // l of each row from the four lanes that hold it; padded rows give 0
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    const int row = rw + g + 8 * r;
    const float inv = a.qmask[static_cast<long long>(b) * a.L + row] != 0
                          ? 1.0f / fmaxf(lsum[r], 1e-30f) : 0.0f;
#pragma unroll
    for (int j = 0; j < S::GW / 8; ++j) {
      o[j][2 * r] *= inv;
      o[j][2 * r + 1] *= inv;
    }
    if (t == 0 && grp == 0) {
      const long long idx = row_index(a, b, h, row);
      a.ml[idx] = mrow[r];
      a.ml[plane + idx] = lsum[r];
    }
  }
  store_rows<S::GW>(head_out<bf16>(a, a.out, kO, b, h) + grp * S::GW, a.st[kO][2], rw + g, o,
                    1.0f);
}

// dQ: one warpgroup of 64 query rows and one column group with Q and dO
// resident; K and V tiles of KT keys through the ring, loaded by the CTA's
// first thread once the tile before has been used. Per key tile S = Q K^T
// and dP = dO V^T once, ds = p (dP - delta) scale rounded to bf16, dQ +=
// ds K over the group's columns. delta = rowsum(o * dO) in f32 (JAX's di)
// is taken first; group 0 hands the rows' (m, 1/l, delta) to the dK/dV
// kernel.
template <class S>
__global__ void __launch_bounds__(kDqThreads, 1)
    bwd_dq_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int KT = S::KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // [NB][64][64]
  bf16* dos = qs + kOwn * S::DH;
  bf16* ring = dos + kOwn * S::DH;  // [kStages]: K, V [NB][KT][64]
  constexpr int kStage = 2 * KT * S::DH;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* full = qbar + 1;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;
  const int h = blockIdx.y / S::kGroups, grp = blockIdx.y % S::kGroups, b = blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = q0 + 16 * (threadIdx.x >> 5);  // the warp's rows
  const int dead = a.dead[b];
  const int n = (((a.causal && q0 >= dead) ? min(a.Lk, q0 + kOwn) : a.Lk) + KT - 1) / KT;
  auto issue = [&](int i) {
    const int s = i % kStages;
    bf16* kt = ring + s * kStage;
    mbar_expect(full + s, 2 * kStage);
    load_rows<KT, S::NB>(&maps.k, kt, full + s, i * KT, h, b);
    load_rows<KT, S::NB>(&maps.v, kt + KT * S::DH, full + s, i * KT, h, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(qbar, 2 * 2 * kOwn * S::DH);
    load_rows<kOwn, S::NB>(&maps.q, qs, qbar, q0, h, b);
    load_rows<kOwn, S::NB>(&maps.dout, dos, qbar, q0, h, b);
    for (int i = 0; i < min(n, kStages); ++i) issue(i);
  }

  // each row's m, 1/l (0 on padded rows) and delta: lane t of a row's four
  // sums a quarter of its columns
  float mrow[2], inv[2], delta[2];
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
  const bf16* o = head<bf16>(a, a.o, kO, b, h);
  const bf16* dout = head<bf16>(a, a.dout, kDO, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + g + 8 * r;
    const long long idx = row_index(a, b, h, row);
    mrow[r] = a.ml[idx];
    inv[r] = a.qmask[static_cast<long long>(b) * a.L + row] != 0
                 ? 1.0f / fmaxf(a.ml[plane + idx], 1e-30f) : 0.0f;
    constexpr int kQuarter = S::DH / 4;
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * a.st[kO][2] + kQuarter * t);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + row * a.st[kDO][2] + kQuarter * t);
    float part = 0.0f;
#pragma unroll
    for (int w = 0; w < kQuarter / 8; ++w) {
      const uint4 x = orow[w], y = drow[w];
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
        part = fmaf(xf.x, yf.x, part);
        part = fmaf(xf.y, yf.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta[r] = part;
    if (t == 0 && grp == 0)
      reinterpret_cast<float4*>(a.stat)[idx] = make_float4(mrow[r], inv[r], part, 0.0f);
  }
  const float sl2 = a.scale * kLog2e;
  float acc[S::GW / 8][4];
  zero(acc);
  mbar_wait(qbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages, k0 = i * KT;
    const bf16* kt = ring + s * kStage;
    mbar_wait(full + s, (i / kStages) & 1);
    float sc[KT / 8][4], dp[KT / 8][4];
    wg_fence();
    scores<S, kOwn>(sc, qs, 0, kt);
    scores<S, kOwn>(dp, dos, 0, kt + KT * S::DH);
    wg_commit();
    wg_wait<0>();
    pin(sc);
    pin(dp);
    mask_keys<KT>(a, b, sc, rw, k0, sl2);
    // ds = p (dp - delta) scale where visible, 0 where masked (mask_scores
    // wrote the fill there; no visible score comes near it)
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        sc[j][e] = sc[j][e] == kMaskL2
                       ? 0.0f
                       : ex2(sc[j][e] - mrow[r]) * inv[r] * (dp[j][e] - delta[r]) * a.scale;
      }
    accumulate<S>(acc, sc, kt + grp * S::GB * KT * 64);
    __syncthreads();  // every warp is done with the stage
    if (threadIdx.x == 0 && i + kStages < n) issue(i + kStages);
  }
  store_rows<S::GW>(head_out<bf16>(a, a.dq, kDQ, b, h) + grp * S::GW, a.st[kDQ][2], rw + g, acc,
                    1.0f);
}

// dK/dV: one CTA per 64 keys and column group with K and V resident, over
// the query tiles of KT rows that see them (those holding dead rows first,
// then from the diagonal); a producer warpgroup streams Q, dO and the
// rows' (m, 1/l, delta) through the ring. Consumer 0 computes S^T = K Q^T
// and p^T, hands p^T to consumer 1 through shared memory and accumulates
// dV += p^T dO; consumer 1 computes dP^T = V dO^T, ds^T = p^T (dP^T -
// delta) scale and accumulates dK += ds^T Q. Each owns one 64 x GW f32 sum.
template <class S>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkdv_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int KT = S::KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // [NB][64][64]
  bf16* vs = ks + kOwn * S::DH;
  bf16* ring = vs + kOwn * S::DH;  // [kStages]: Q, dO [NB][KT][64]
  constexpr int kStage = 2 * KT * S::DH;
  float4* sts = reinterpret_cast<float4*>(ring + kStages * kStage);  // [kStages][KT]
  float* pex = reinterpret_cast<float*>(sts + kStages * KT);        // [KT / 2][128]: p^T
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(pex + kOwn * KT);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kOwn, b = blockIdx.z;
  const int h = blockIdx.y / S::kGroups, grp = blockIdx.y % S::kGroups, wg = threadIdx.x / 128;
  const int dead = a.dead[b];
  const int nq = a.L / KT;
  const int from = a.causal ? min(k0 / KT, nq) : 0;
  const int lo = a.causal ? min((dead + KT - 1) / KT, from) : 0;
  const int n = lo + nq - from;
  auto tile = [&](int i) { return (i < lo ? i : from + i - lo) * KT; };
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const float4* stat = reinterpret_cast<const float4*>(a.stat) + row_index(a, b, h, 0);
      mbar_expect(kvbar, 2 * 2 * kOwn * S::DH);
      load_rows<kOwn, S::NB>(&maps.k, ks, kvbar, k0, h, b);
      load_rows<kOwn, S::NB>(&maps.v, vs, kvbar, k0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, q0 = tile(i);
        bf16* qt = ring + s * kStage;
        mbar_wait(empty + s, ((i / kStages) + 1) & 1);
        mbar_expect(full + s, 2 * kStage + KT * 16);
        load_rows<KT, S::NB>(&maps.q, qt, full + s, q0, h, b);
        load_rows<KT, S::NB>(&maps.dout, qt + KT * S::DH, full + s, q0, h, b);
        bulk_load(sts + s * KT, stat + q0, KT * 16, full + s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tid = threadIdx.x & 127, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int kw0 = k0 + 16 * (tid >> 5);  // the warp's first key
  int kr[2];
  bool kreal[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = kw0 + g + 8 * r;
    kreal[r] = key_real(a, b, kr[r]);
  }
  const bool wreal = __all_sync(0xffffffffu, kreal[0] && kreal[1]);  // the warp's keys all real
  const float sl2 = a.scale * kLog2e;
  float acc[S::GW / 8][4];
  zero(acc);
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages, q0 = tile(i);
    const bf16* qt = ring + s * kStage;
    const bf16* dt = qt + KT * S::DH;
    const float4* st = sts + s * KT;
    mbar_wait(full + s, (i / kStages) & 1);
    float x[KT / 8][4];  // S^T (consumer 0) or dP^T (consumer 1): keys as rows
    wg_fence();
    scores<S, kOwn>(x, c == 0 ? ks : vs, 0, c == 0 ? qt : dt);
    wg_commit();
    wg_wait<0>();
    pin(x);
    // f(x[j][e], whether key kr[r] is visible to query qc, qc's (m, 1/l,
    // delta, -), the element's place in p^T's hand-over)
    const bool full_tile = wreal && (!a.causal || kw0 + 15 <= q0);
    auto each = [&](auto f) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int qc = q0 + 8 * j + 2 * t + e1;
          const float4 rs = st[qc - q0];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + e1;
            f(x[j][e], full_tile || (kreal[r] && (!a.causal || kr[r] <= qc)), rs,
              pex + (4 * j + e) * 128 + tid);
          }
        }
    };
    if (c == 0) {
      // p (a dead row's 1/Lk on a masked key), handed to consumer 1 once it
      // has read the tile before's
      each([&](float& v, bool ok, float4 rs, float*) {
        v = ex2((ok ? v * sl2 : kMaskL2) - rs.x) * rs.y;
      });
      if (i > 0) bar_sync(2, 256);
      each([&](float& v, bool, float4, float* slot) { *slot = v; });
      bar_arrive(1, 256);
    } else {
      bar_sync(1, 256);
      each([&](float& v, bool ok, float4 rs, float* slot) {
        v = ok ? *slot * (v - rs.z) * a.scale : 0.0f;
      });
      if (i + 1 < n) bar_arrive(2, 256);
    }
    // dV += p^T dO, dK += ds^T Q over the group's columns
    accumulate<S>(acc, x, (c == 0 ? dt : qt) + grp * S::GB * KT * 64);
    if (lane == 0) mbar_arrive(empty + s);
  }
  const int which = c == 0 ? kDV : kDK;
  store_rows<S::GW>(head_out<bf16>(a, c == 0 ? a.dv : a.dk, which, b, h) + grp * S::GW,
                    a.st[which][2], kw0 + g, acc, 1.0f);
}

// dK/dV at the narrow widths (S::QT > 0: DH = 64 and 128): one CTA per 128
// keys, each consumer warpgroup owning 64 of them with K and V resident;
// the producer warpgroup streams Q, dO and the rows' (m, 1/l, delta) in
// tiles of QT query rows (those holding dead rows first, then from the
// diagonal). Each consumer forms S^T = K Q^T and dP^T = V dO^T for its
// keys, p^T and ds^T = p^T (dP^T - delta) scale in registers, and sums
// both dV += p^T dO and dK += ds^T Q: no hand-over between warpgroups, and
// each Q and dO tile serves 128 keys. Its two 64 x DH f32 sums and two
// 64 x QT score tiles fit a warpgroup's registers only at these widths.
template <class S>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkdv_pair_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int QT = S::QT, KR = 2 * kOwn;  // streamed query rows, the CTA's keys
  using T = Shape<S::DH, S::GW, QT>;         // the products over a QT-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // [NB][128][64]
  bf16* vs = ks + KR * S::DH;
  bf16* ring = vs + KR * S::DH;  // [kStages]: Q, dO [NB][QT][64]
  constexpr int kStage = 2 * QT * S::DH;
  float4* sts = reinterpret_cast<float4*>(ring + kStages * kStage);  // [kStages][QT]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sts + kStages * QT);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * KR, h = blockIdx.y, b = blockIdx.z, wg = threadIdx.x / 128;
  const int dead = a.dead[b];
  const int nq = a.L / QT;
  const int from = a.causal ? min(k0 / QT, nq) : 0;
  const int lo = a.causal ? min((dead + QT - 1) / QT, from) : 0;
  const int n = lo + nq - from;
  auto tile = [&](int i) { return (i < lo ? i : from + i - lo) * QT; };
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const float4* stat = reinterpret_cast<const float4*>(a.stat) + row_index(a, b, h, 0);
      mbar_expect(kvbar, 2 * 2 * KR * S::DH);
      load_rows<KR, S::NB>(&maps.k, ks, kvbar, k0, h, b);
      load_rows<KR, S::NB>(&maps.v, vs, kvbar, k0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages, q0 = tile(i);
        bf16* qt = ring + s * kStage;
        mbar_wait(empty + s, ((i / kStages) + 1) & 1);
        mbar_expect(full + s, 2 * kStage + QT * 16);
        load_rows<QT, S::NB>(&maps.q, qt, full + s, q0, h, b);
        load_rows<QT, S::NB>(&maps.dout, qt + QT * S::DH, full + s, q0, h, b);
        bulk_load(sts + s * QT, stat + q0, QT * 16, full + s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1, tid = threadIdx.x & 127, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int kw0 = k0 + kOwn * c + 16 * (tid >> 5);  // the warp's first key
  int kr[2];
  bool kreal[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = kw0 + g + 8 * r;
    kreal[r] = key_real(a, b, kr[r]);
  }
  const bool wreal = __all_sync(0xffffffffu, kreal[0] && kreal[1]);  // the warp's keys all real
  const float sl2 = a.scale * kLog2e;
  float dv[S::GW / 8][4], dk[S::GW / 8][4];
  zero(dv);
  zero(dk);
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages, q0 = tile(i);
    const bf16* qt = ring + s * kStage;
    const bf16* dt = qt + QT * S::DH;
    const float4* st = sts + s * QT;
    mbar_wait(full + s, (i / kStages) & 1);
    float x[QT / 8][4], dp[QT / 8][4];  // S^T and dP^T: keys as rows
    wg_fence();
    scores<T, KR>(x, ks, kOwn * c, qt);
    scores<T, KR>(dp, vs, kOwn * c, dt);
    wg_commit();
    wg_wait<0>();
    pin(x);
    pin(dp);
    // p^T (a dead row's 1/Lk on a masked key) and ds^T (0 where masked)
    const bool full_tile = wreal && (!a.causal || kw0 + 15 <= q0);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int qc = q0 + 8 * j + 2 * t + e1;
        const float4 rs = st[qc - q0];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + e1;
          const bool ok = full_tile || (kreal[r] && (!a.causal || kr[r] <= qc));
          const float p = ex2((ok ? x[j][e] * sl2 : kMaskL2) - rs.x) * rs.y;
          dp[j][e] = ok ? p * (dp[j][e] - rs.z) * a.scale : 0.0f;
          x[j][e] = p;
        }
      }
    // dV += p^T dO and dK += ds^T Q, issued together, p^T and ds^T rounded
    // to bf16 as the A operands in registers
    constexpr int kSteps = QT / 16;
    unsigned ap[kSteps][4], ad[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ap[kk][0] = pack(x[2 * kk][0], x[2 * kk][1]);
      ap[kk][1] = pack(x[2 * kk][2], x[2 * kk][3]);
      ap[kk][2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      ap[kk][3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
      ad[kk][0] = pack(dp[2 * kk][0], dp[2 * kk][1]);
      ad[kk][1] = pack(dp[2 * kk][2], dp[2 * kk][3]);
      ad[kk][2] = pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      ad[kk][3] = pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<S::GW>(dv, ap[kk], desc_mn<QT>(dt, kk));
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<S::GW>(dk, ad[kk], desc_mn<QT>(qt, kk));
    wg_commit();
    wg_wait<0>();
    pin(dv);
    pin(dk);
    if (lane == 0) mbar_arrive(empty + s);
  }
  store_rows<S::GW>(head_out<bf16>(a, a.dk, kDK, b, h), a.st[kDK][2], kw0 + g, dk, 1.0f);
  store_rows<S::GW>(head_out<bf16>(a, a.dv, kDV, b, h), a.st[kDV][2], kw0 + g, dv, 1.0f);
}

// The tensor map of one operand: [B, H, rows, dh] bf16 over the (batch,
// head, row) element strides st, boxes of bw columns (64: the 128-byte
// swizzle; 32: the 64-byte one) by box_rows rows
inline bool head_map(CUtensorMap* map, const void* p, const long long* st, int B, int H,
                     int rows, int dh, int box_rows, int bw) {
  const ergm_hopper::EncodeTiled encode = ergm_hopper::encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The maps of q, k, v and dO for a kernel whose q / dO tiles take qrows
// rows and k / v tiles krows, in column blocks of bw (dO's only where dout
// is given)
inline bool make_maps(Maps* m, const Args& a, int dh, int qrows, int krows, int bw = 64) {
  return head_map(&m->q, a.q, a.st[kQ], a.B, a.H, a.L, dh, qrows, bw) &&
         head_map(&m->k, a.k, a.st[kK], a.B, a.H, a.Lk, dh, krows, bw) &&
         head_map(&m->v, a.v, a.st[kV], a.B, a.H, a.Lk, dh, krows, bw) &&
         (!a.dout || head_map(&m->dout, a.dout, a.st[kDO], a.B, a.H, a.L, dh, qrows, bw));
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const Maps& maps, const Args& a,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(maps, a);
  return cudaGetLastError();
}

template <class S>
cudaError_t forward(const Args& a, cudaStream_t s) {
  Maps m{};
  if (!make_maps(&m, a, S::DH, kQRows, S::KT)) return cudaErrorInvalidValue;
  return launch(fwd_kernel<S>, dim3(a.L / kQRows, a.H * S::kGroups, a.B), kWgThreads,
                S::kFwdBytes, m, a, s);
}

template <class S>
cudaError_t backward(const Args& a, cudaStream_t s) {
  constexpr bool pair = S::QT > 0;  // the paired dK/dV kernel: 128 keys a CTA
  constexpr int kKeys = pair ? 2 * kOwn : kOwn, kRows = pair ? S::QT : S::KT;
  Maps dq{}, dkdv{};
  if (!make_maps(&dq, a, S::DH, kOwn, S::KT) || !make_maps(&dkdv, a, S::DH, kRows, kKeys))
    return cudaErrorInvalidValue;
  const dim3 grid_q(a.L / kOwn, a.H * S::kGroups, a.B), grid_k(a.Lk / kKeys, a.H * S::kGroups, a.B);
  cudaError_t err = launch(bwd_dq_kernel<S>, grid_q, kDqThreads, S::kDqBytes, dq, a, s);
  if (err != cudaSuccess) return err;
  if constexpr (pair)
    return launch(bwd_dkdv_pair_kernel<S>, grid_k, kWgThreads, S::kPairBytes, dkdv, a, s);
  else
    return launch(bwd_dkdv_kernel<S>, grid_k, kWgThreads, S::kDkdvBytes, dkdv, a, s);
}

}  // namespace flash

// ---------------------------------------------------------------------------
// K5 in bf16 (JAX's block gate, DH = 32, 64, 96, 128, dropout or not): JAX's
// block-kernel arithmetic, two passes over the keys, on flash::'s parts:
// wgmma, TMA loads on an mbarrier ring, a producer warpgroup that hands its
// registers to two consumer warpgroups (the note at the top).
namespace blk {

using ergm_hopper::bulk_load;
using ergm_hopper::mbar_arrive;
using ergm_hopper::mbar_expect;
using ergm_hopper::mbar_fence_init;
using ergm_hopper::mbar_init;
using ergm_hopper::mbar_wait;
using ergm_hopper::pin;
using ergm_hopper::wg_commit;
using ergm_hopper::wg_fence;
using ergm_hopper::wg_wait;
using ergm_hopper::wgmma_rs;
using ergm_hopper::wgmma_ss;
using ergm_mma::ex2;
using ergm_mma::pack;
using ergm_mma::store_rows;
using ergm_mma::zero;
using score::kMaskL2;
using flash::aligned_smem;
using flash::desc_k;
using flash::desc_mn;
using flash::kAlign;
using flash::kOwn;
using flash::kStages;
using flash::kWgThreads;
using flash::load_rows;
using flash::make_maps;
using flash::Maps;
using flash::mask_keys;

constexpr int kRows = 2 * kOwn;  // rows a CTA owns: queries (forward, dQ) or keys (dK/dV)
// A kernel's grid, by its CTAs an SM (C): at one, that CTA walks the items
// (an item: a tile of one head) and loads the next item's resident operands
// into a second buffer while the current one's are in use (persistent); at
// two, one CTA an item, the SM's other CTA covering a CTA's start and end
template <int C>
constexpr bool kWalks = C == 1;
template <int C>
constexpr int kBufs = kWalks<C> ? 2 : 1;  // buffers of the resident operands

// A head width's shapes: KT the keys of the forward's streamed tiles, DKT
// dQ's, QT the query rows of dK/dV's; FC, DC and KC the CTAs an SM of the
// forward, dQ and dK/dV (1, or 2 with smaller register shares); column
// blocks of BW (64: the 128-byte swizzle; 32, at 32 and 96, the 64-byte
// one), NB of them a row; shared memory (bytes) of each kernel: the ring,
// kBufs of its resident operands, eight barriers.
template <int DH_, int KT_, int DKT_, int QT_, int FC_ = 1, int DC_ = 1, int KC_ = 1>
struct Shape {
  static constexpr int DH = DH_, KT = KT_, DKT = DKT_, QT = QT_, FC = FC_, DC = DC_, KC = KC_;
  static constexpr int BW = DH % 64 == 0 ? 64 : 32, NB = DH / BW;
  // forward: stages of K, V [KT][DH]; Q [128][DH]
  static constexpr size_t kFwdBytes =
      kAlign + 2 * (kStages * 2 * KT * DH + kBufs<FC> * kRows * DH) + 64;
  // dQ: stages of K, V [DKT][DH]; Q, dO [128][DH]
  static constexpr size_t kDqBytes =
      kAlign + 2 * (kStages * 2 * DKT * DH + kBufs<DC> * 2 * kRows * DH) + 64;
  // dK/dV: stages of Q, dO [QT][DH] and the QT rows' (m, 1/l, delta, -);
  // K, V [128][DH]
  static constexpr size_t kDkdvBytes =
      kAlign + 2 * (kStages * 2 * QT * DH + kBufs<KC> * 2 * kRows * DH) + kStages * QT * 16 +
      64;
};
using D32 = Shape<32, 64, 32, 32, 2, 2, 2>;
using D64 = Shape<64, 64, 32, 128, 2, 2, 1>;
using D96 = Shape<96, 128, 64, 64>;
using D128 = Shape<128, 128, 64, 64>;

// s = A . B^T over the whole depth: A the 64 rows from arow of an XA-row
// tile, B an X-row tile; issued, not waited for
template <class S, int XA, int X>
__device__ __forceinline__ void scores(float (&s)[X / 8][4], const bf16* ta, int arow,
                                       const bf16* tb) {
#pragma unroll
  for (int kk = 0; kk < S::DH / 16; ++kk)
    wgmma_ss<X>(s, desc_k<XA, S::BW>(ta, arow, kk), desc_k<X, S::BW>(tb, 0, kk), kk);
}

// The m16n8k16 A operand of k16 step kk from a 64 x N accumulator block,
// rounded to bf16
template <int J>
__device__ __forceinline__ void a_operand(unsigned (&a)[4], const float (&x)[J][4], int kk) {
  a[0] = pack(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// acc += x . B: x the warpgroup's 64 x X block (rounded to bf16, the A
// operand in registers), B the DH columns of an X-row tile; waited for
template <class S, int X>
__device__ __forceinline__ void accumulate(float (&acc)[S::DH / 8][4], const float (&x)[X / 8][4],
                                           const bf16* tb) {
  unsigned a[X / 16][4];
#pragma unroll
  for (int kk = 0; kk < X / 16; ++kk) a_operand(a[kk], x, kk);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < X / 16; ++kk) wgmma_rs<S::DH>(acc, a[kk], desc_mn<X, S::BW>(tb, kk));
  wg_commit();
  wg_wait<0>();
  pin(acc);
}

// The producer warpgroup gives up registers and the consumers take them
// (ptxas allocates each side's code to its share): at one CTA an SM 168 a
// thread at launch, 24 and 240 after; at two, 80, then 24 and 104
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
}
template <int CTAS>
__device__ __forceinline__ void take_registers() {
  if constexpr (CTAS == 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n");
}

// The barriers after the ring and the resident buffers: res_full and
// res_free of each resident buffer, full and empty of each stage
struct Bars {
  uint64_t *res_full, *res_free, *full, *empty;
  __device__ explicit Bars(void* at) {
    res_full = static_cast<uint64_t*>(at);
    res_free = res_full + 2;
    full = res_free + 2;
    empty = full + kStages;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mbar_init(res_full + i, 1);
        mbar_init(res_free + i, 8);  // the consumers' eight warps
      }
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, 8);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// An item: tile x of head h of batch row b. Items run in rank order over
// every (b, h), tile rank 0 first: the last query tile (forward, dQ;
// `reverse`) or the first key tile (dK/dV), the longest causal walks.
struct Item {
  int x, h, b;
  __device__ Item(const Args& a, int tiles, int idx, bool reverse) {
    const int bh = idx % (a.B * a.H), rank = idx / (a.B * a.H);
    x = reverse ? tiles - 1 - rank : rank;
    h = bh % a.H;
    b = bh / a.H;
  }
};

// The key tiles (KT keys) that query rows [r0, r0 + rows) walk: up to the
// diagonal when causal, all of them where the rows hold dead ones
__device__ __forceinline__ int key_tiles(const Args& a, int r0, int rows, int dead, int kt) {
  return ((a.causal && r0 >= dead) ? min(a.Lk, r0 + rows) : a.Lk) / kt;
}

// Forward: 128 query rows an item in two consumer warpgroups of 64, Q
// resident; the producer streams K tiles of KT keys (pass 1), then K and V
// tiles (pass 2). Pass 1: each lane's running max and sum of its scores
// (log2 units), reduced over a row's four lanes at its end; pass 2: the
// scores again, pn = 2^(s - m) / l, dropped and rounded, o += pn . V. Writes
// m and l.
template <class S>
__global__ void __launch_bounds__(kWgThreads, S::FC)
    fwd_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int KT = S::KT, DH = S::DH;
  constexpr int kStage = 2 * KT * DH;  // K, V [NB][KT][BW]
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* qs = ring + kStages * kStage;  // [kBufs<S::FC>]: Q [NB][128][BW]
  const Bars bar(qs + kBufs<S::FC> * kRows * DH);
  const int tiles = a.L / kRows, items = tiles * a.H * a.B;

  if (threadIdx.x < 128) {  // the producer
    give_registers();
    if (threadIdx.x != 0) return;
    int it = 0;  // ring steps so far
    for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
      const Item m(a, tiles, idx, true);
      const int n = key_tiles(a, m.x * kRows, kRows, a.dead[m.b], KT), buf = w % kBufs<S::FC>;
      if (w >= kBufs<S::FC>) mbar_wait(bar.res_free + buf, ((w / kBufs<S::FC>) + 1) & 1);
      mbar_expect(bar.res_full + buf, 2 * kRows * DH);
      load_rows<kRows, S::NB, S::BW>(&maps.q, qs + buf * kRows * DH, bar.res_full + buf,
                                     m.x * kRows, m.h, m.b);
      for (int i = 0; i < 2 * n; ++i, ++it) {  // 0..n-1: pass 1 (K); n..2n-1: pass 2 (K, V)
        const int s = it % kStages, k0 = (i < n ? i : i - n) * KT;
        bf16* kt = ring + s * kStage;
        mbar_wait(bar.empty + s, ((it / kStages) + 1) & 1);
        mbar_expect(bar.full + s, (i < n ? 1 : 2) * 2 * KT * DH);
        load_rows<KT, S::NB, S::BW>(&maps.k, kt, bar.full + s, k0, m.h, m.b);
        if (i >= n) load_rows<KT, S::NB, S::BW>(&maps.v, kt + KT * DH, bar.full + s, k0, m.h, m.b);
      }
    }
    return;
  }
  take_registers<S::FC>();
  const int c = threadIdx.x / 128 - 1, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = kOwn * c + 16 * ((threadIdx.x >> 5) & 3);  // the warp's rows in an item
  const float sl2 = a.scale * kLog2e;
  int it = 0;
  for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
    const Item m(a, tiles, idx, true);
    const int q0 = m.x * kRows, b = m.b, h = m.h, dead = a.dead[b], buf = w % kBufs<S::FC>;
    const int n = key_tiles(a, q0, kRows, dead, KT);
    const int wend = key_tiles(a, q0 + kOwn * c, kOwn, dead, 1);  // the warpgroup's keys
    const int rw = q0 + wrow;
    const bf16* qt = qs + buf * kRows * DH;
    unsigned xrow[2];  // the hash's r*Lk + mix*G + 2t for the lane's rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
      xrow[r] = static_cast<unsigned>(rw + g + 8 * r) * static_cast<unsigned>(a.Lk) +
                hash_base(a, b, h) + 2 * t;
    float mt[2] = {-INFINITY, -INFINITY}, lt[2] = {0.0f, 0.0f};  // the lane's share of m, l
    float inv[2] = {0.0f, 0.0f};
    float o[DH / 8][4];
    zero(o);
    mbar_wait(bar.res_full + buf, (w / kBufs<S::FC>) & 1);
    for (int i = 0; i < 2 * n; ++i, ++it) {
      const int s = it % kStages, k0 = (i < n ? i : i - n) * KT;
      const bf16* kt = ring + s * kStage;
      if (i == n) {
        // the row's m and l from the four lanes that hold it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float l = lt[r] * ex2(mt[r] - mx);
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          const int row = rw + g + 8 * r;
          const bool real = a.qmask[static_cast<long long>(b) * a.L + row] != 0;
          mt[r] = mx;
          inv[r] = real ? (a.dropout ? a.drop_mul : 1.0f) / fmaxf(l, 1e-30f) : 0.0f;
          if (t == 0) {
            const long long ri = row_index(a, b, h, row);
            a.ml[ri] = mx;
            a.ml[static_cast<long long>(a.B) * a.H * a.L + ri] = l;
          }
        }
      }
      mbar_wait(bar.full + s, (it / kStages) & 1);
      if (k0 < wend) {
        float sc[KT / 8][4];
        wg_fence();
        scores<S, kRows, KT>(sc, qt, kOwn * c, kt);
        wg_commit();
        wg_wait<0>();
        pin(sc);
        mask_keys<KT>(a, b, sc, rw, k0, sl2);
        if (i < n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = mt[r];
#pragma unroll
            for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < KT / 8; ++j)
              sum += ex2(sc[j][2 * r] - mx) + ex2(sc[j][2 * r + 1] - mx);
            lt[r] = lt[r] * ex2(mt[r] - mx) + sum;
            mt[r] = mx;
          }
        } else {
          // pn = 2^(s - m) / l (a masked score gives a dead row's 1/Lk, else
          // 0), dropped and scaled, then rounded as the PV product's operand
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              float p = ex2(sc[j][e] - mt[r]) * inv[r];
              if (a.dropout && !keep(a, xrow[r] + k0 + 8 * j + (e & 1))) p = 0.0f;
              sc[j][e] = p;
            }
          accumulate<S, KT>(o, sc, kt + KT * DH);
        }
      }
      if (lane == 0) mbar_arrive(bar.empty + s);
    }
    if (lane == 0) mbar_arrive(bar.res_free + buf);
    store_rows<DH>(head_out<bf16>(a, a.out, kO, b, h), a.st[kO][2], rw + g, o, 1.0f);
  }
}

// dQ: 128 query rows an item in two consumer warpgroups of 64 with Q and
// dO resident; the producer streams K and V tiles of DKT keys twice. Pass
// 1: S = Q K^T and dP = dO V^T, delta = rowsum(pn * dpn) in f32 (JAX's;
// each lane's share, reduced over a row's four lanes at its end); pass 2: S
// and dP again, ds = pn (dpn - delta) rounded, dQ += ds K. Reads m and l,
// writes the rows' (m, 1/l, delta) for the dK/dV kernel.
template <class S>
__global__ void __launch_bounds__(kWgThreads, S::DC)
    bwd_dq_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int KT = S::DKT, DH = S::DH;
  constexpr int kStage = 2 * KT * DH;  // K, V [NB][KT][BW]
  constexpr int kRes = 2 * kRows * DH;  // Q, dO [NB][128][BW]
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* res = ring + kStages * kStage;  // [kBufs<S::DC>]: Q, dO
  const Bars bar(res + kBufs<S::DC> * kRes);
  const int tiles = a.L / kRows, items = tiles * a.H * a.B;

  if (threadIdx.x < 128) {
    give_registers();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
      const Item m(a, tiles, idx, true);
      const int n = key_tiles(a, m.x * kRows, kRows, a.dead[m.b], KT), buf = w % kBufs<S::DC>;
      bf16* qs = res + buf * kRes;
      if (w >= kBufs<S::DC>) mbar_wait(bar.res_free + buf, ((w / kBufs<S::DC>) + 1) & 1);
      mbar_expect(bar.res_full + buf, 2 * kRes);
      load_rows<kRows, S::NB, S::BW>(&maps.q, qs, bar.res_full + buf, m.x * kRows, m.h, m.b);
      load_rows<kRows, S::NB, S::BW>(&maps.dout, qs + kRows * DH, bar.res_full + buf,
                                     m.x * kRows, m.h, m.b);
      for (int i = 0; i < 2 * n; ++i, ++it) {  // the key tiles twice
        const int s = it % kStages, k0 = (i < n ? i : i - n) * KT;
        bf16* kt = ring + s * kStage;
        mbar_wait(bar.empty + s, ((it / kStages) + 1) & 1);
        mbar_expect(bar.full + s, 2 * kStage);
        load_rows<KT, S::NB, S::BW>(&maps.k, kt, bar.full + s, k0, m.h, m.b);
        load_rows<KT, S::NB, S::BW>(&maps.v, kt + KT * DH, bar.full + s, k0, m.h, m.b);
      }
    }
    return;
  }
  take_registers<S::DC>();
  const int c = threadIdx.x / 128 - 1, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = kOwn * c + 16 * ((threadIdx.x >> 5) & 3);
  const float sl2 = a.scale * kLog2e;
  const long long plane = static_cast<long long>(a.B) * a.H * a.L;
  int it = 0;
  for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
    const Item m(a, tiles, idx, true);
    const int q0 = m.x * kRows, b = m.b, h = m.h, dead = a.dead[b], buf = w % kBufs<S::DC>;
    const int n = key_tiles(a, q0, kRows, dead, KT);
    const int wend = key_tiles(a, q0 + kOwn * c, kOwn, dead, 1);
    const int rw = q0 + wrow;
    const bf16* qs = res + buf * kRes;
    float mrow[2], inv[2], delta[2] = {0.0f, 0.0f};  // delta: the lane's share until step n
    unsigned xrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw + g + 8 * r;
      const long long ri = row_index(a, b, h, row);
      mrow[r] = a.ml[ri];
      inv[r] = a.qmask[static_cast<long long>(b) * a.L + row] != 0
                   ? 1.0f / fmaxf(a.ml[plane + ri], 1e-30f) : 0.0f;
      xrow[r] = static_cast<unsigned>(row) * static_cast<unsigned>(a.Lk) + hash_base(a, b, h) +
                2 * t;
    }
    float acc[DH / 8][4];
    zero(acc);
    mbar_wait(bar.res_full + buf, (w / kBufs<S::DC>) & 1);
    for (int i = 0; i < 2 * n; ++i, ++it) {
      const int s = it % kStages, k0 = (i < n ? i : i - n) * KT;
      const bf16* kt = ring + s * kStage;
      if (i == n) {
        // delta from the four lanes that hold a row; the rows' (m, 1/l,
        // delta) go to the dK/dV kernel
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
          delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
          if (t == 0)
            reinterpret_cast<float4*>(a.stat)[row_index(a, b, h, rw + g + 8 * r)] =
                make_float4(mrow[r], inv[r], delta[r], 0.0f);
        }
      }
      mbar_wait(bar.full + s, (it / kStages) & 1);
      if (k0 < wend) {
        float sc[KT / 8][4], dp[KT / 8][4];
        wg_fence();
        scores<S, kRows, KT>(sc, qs, kOwn * c, kt);
        scores<S, kRows, KT>(dp, qs + kRows * DH, kOwn * c, kt + KT * DH);
        wg_commit();
        wg_wait<0>();
        pin(sc);
        pin(dp);
        mask_keys<KT>(a, b, sc, rw, k0, sl2);
        // pass 1: delta += pn * dpn; pass 2: ds = pn * (dpn - delta), both
        // where visible, 0 where masked (mask_scores wrote the fill there;
        // no visible score comes near -1e9)
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float d = dp[j][e];
            if (a.dropout) d = keep(a, xrow[r] + k0 + 8 * j + (e & 1)) ? d * a.drop_mul : 0.0f;
            const float pn = sc[j][e] == kMaskL2 ? 0.0f : ex2(sc[j][e] - mrow[r]) * inv[r];
            if (i < n)
              delta[r] += pn * d;
            else
              sc[j][e] = pn * (d - delta[r]);
          }
        if (i >= n) accumulate<S, KT>(acc, sc, kt);
      }
      if (lane == 0) mbar_arrive(bar.empty + s);
    }
    if (lane == 0) mbar_arrive(bar.res_free + buf);
    store_rows<DH>(head_out<bf16>(a, a.dq, kDQ, b, h), a.st[kDQ][2], rw + g, acc, a.scale);
  }
}

// dK/dV: 128 keys an item, each consumer warpgroup owning 64 with K and V
// resident; the producer streams Q, dO and the rows' (m, 1/l, delta) in
// tiles of QT query rows (those holding dead rows first, then from the
// diagonal). Each consumer forms S^T = K Q^T and dP^T = V dO^T for its
// keys; pn^T from the forward's m and l, the post-dropout dV operand pv and
// ds^T = pn (dpn - delta), both rounded to bf16 in registers; dV += pv^T dO,
// dK += ds^T Q, scaled at the end.
template <class S>
__global__ void __launch_bounds__(kWgThreads, S::KC)
    bwd_dkdv_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int QT = S::QT, DH = S::DH;
  constexpr int kStage = 2 * QT * DH;  // Q, dO [NB][QT][BW]
  constexpr int kRes = 2 * kRows * DH;  // K, V [NB][128][BW]
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* res = ring + kStages * kStage;  // [kBufs<S::KC>]: K, V
  float4* sts = reinterpret_cast<float4*>(res + kBufs<S::KC> * kRes);  // [kStages][QT]
  const Bars bar(sts + kStages * QT);
  const int tiles = a.Lk / kRows, items = tiles * a.H * a.B, nq = a.L / QT;
  // the query tiles that see keys from k0: those holding dead rows, then
  // from the diagonal (from i = lo on, tile from + i - lo)
  auto walk = [&](int k0, int dead, int& lo, int& from) {
    from = a.causal ? min(k0 / QT, nq) : 0;
    lo = a.causal ? min((dead + QT - 1) / QT, from) : 0;
    return lo + nq - from;
  };

  if (threadIdx.x < 128) {
    give_registers();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
      const Item m(a, tiles, idx, false);
      const int k0 = m.x * kRows, buf = w % kBufs<S::KC>;
      int lo, from;
      const int n = walk(k0, a.dead[m.b], lo, from);
      const float4* stat = reinterpret_cast<const float4*>(a.stat) + row_index(a, m.b, m.h, 0);
      bf16* ks = res + buf * kRes;
      if (w >= kBufs<S::KC>) mbar_wait(bar.res_free + buf, ((w / kBufs<S::KC>) + 1) & 1);
      mbar_expect(bar.res_full + buf, 2 * kRes);
      load_rows<kRows, S::NB, S::BW>(&maps.k, ks, bar.res_full + buf, k0, m.h, m.b);
      load_rows<kRows, S::NB, S::BW>(&maps.v, ks + kRows * DH, bar.res_full + buf, k0, m.h, m.b);
      for (int i = 0; i < n; ++i, ++it) {
        const int s = it % kStages, q0 = (i < lo ? i : from + i - lo) * QT;
        bf16* qt = ring + s * kStage;
        mbar_wait(bar.empty + s, ((it / kStages) + 1) & 1);
        mbar_expect(bar.full + s, 2 * kStage + QT * 16);
        load_rows<QT, S::NB, S::BW>(&maps.q, qt, bar.full + s, q0, m.h, m.b);
        load_rows<QT, S::NB, S::BW>(&maps.dout, qt + QT * DH, bar.full + s, q0, m.h, m.b);
        bulk_load(sts + s * QT, stat + q0, QT * 16, bar.full + s);
      }
    }
    return;
  }
  take_registers<S::KC>();
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x & 127, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  const int wkey = kOwn * c + 16 * (tid >> 5);  // the warp's keys in an item
  const float sl2 = a.scale * kLog2e;
  int it = 0;
  for (int idx = blockIdx.x, w = 0; idx < items; idx += gridDim.x, ++w) {
    const Item m(a, tiles, idx, false);
    const int k0 = m.x * kRows, b = m.b, h = m.h, buf = w % kBufs<S::KC>;
    int lo, from;
    const int n = walk(k0, a.dead[b], lo, from);
    const int kw0 = k0 + wkey;  // the warp's first key
    const bf16* ks = res + buf * kRes;
    int kr[2];
    bool kreal[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kr[r] = kw0 + g + 8 * r;
      kreal[r] = key_real(a, b, kr[r]);
    }
    const bool wreal = __all_sync(0xffffffffu, kreal[0] && kreal[1]);  // the warp's keys all real
    const unsigned hb = hash_base(a, b, h);
    float dv[DH / 8][4], dk[DH / 8][4];
    zero(dv);
    zero(dk);
    mbar_wait(bar.res_full + buf, (w / kBufs<S::KC>) & 1);
    for (int i = 0; i < n; ++i, ++it) {
      const int s = it % kStages, q0 = (i < lo ? i : from + i - lo) * QT;
      const bf16* qt = ring + s * kStage;
      const bf16* dt = qt + QT * DH;
      const float4* st = sts + s * QT;
      mbar_wait(bar.full + s, (it / kStages) & 1);
      float x[QT / 8][4], dp[QT / 8][4];  // S^T and dP^T: keys as rows
      wg_fence();
      scores<S, kRows, QT>(x, ks, kOwn * c, qt);
      scores<S, kRows, QT>(dp, ks + kRows * DH, kOwn * c, dt);
      wg_commit();
      wg_wait<0>();
      pin(x);
      pin(dp);
      // pv^T (a dead row's 1/Lk on a masked key), ds^T (0 where masked)
      const bool full_tile = wreal && (!a.causal || kw0 + 15 <= q0);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int qc = q0 + 8 * j + 2 * t + e1;
          const float4 rs = st[qc - q0];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + e1;
            const bool ok = full_tile || (kreal[r] && (!a.causal || kr[r] <= qc));
            const float pn = ex2((ok ? x[j][e] * sl2 : kMaskL2) - rs.x) * rs.y;
            float d = dp[j][e], pv = pn;
            if (a.dropout) {
              const bool kp = keep(a, static_cast<unsigned>(qc) * static_cast<unsigned>(a.Lk) +
                                          static_cast<unsigned>(kr[r]) + hb);
              d = kp ? d * a.drop_mul : 0.0f;
              pv = kp ? pn * a.drop_mul : 0.0f;
            }
            x[j][e] = pv;
            dp[j][e] = ok ? pn * (d - rs.z) : 0.0f;
          }
        }
      // dV += pv^T dO and dK += ds^T Q, issued together
      unsigned ap[QT / 16][4], ad[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        a_operand(ap[kk], x, kk);
        a_operand(ad[kk], dp, kk);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) wgmma_rs<DH>(dv, ap[kk], desc_mn<QT, S::BW>(dt, kk));
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) wgmma_rs<DH>(dk, ad[kk], desc_mn<QT, S::BW>(qt, kk));
      wg_commit();
      wg_wait<0>();
      pin(dv);
      pin(dk);
      if (lane == 0) mbar_arrive(bar.empty + s);
    }
    if (lane == 0) mbar_arrive(bar.res_free + buf);
    store_rows<DH>(head_out<bf16>(a, a.dk, kDK, b, h), a.st[kDK][2], kw0 + g, dk, a.scale);
    store_rows<DH>(head_out<bf16>(a, a.dv, kDV, b, h), a.st[kDV][2], kw0 + g, dv, 1.0f);
  }
}

// The CTAs of a grid over `items` at C CTAs an SM
template <int C>
int ctas(int items) {
  if (!kWalks<C>) return items;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return items;
  return min(items, sms * C);
}

template <class S>
cudaError_t forward(const Args& a, cudaStream_t s) {
  Maps m{};
  if (!make_maps(&m, a, S::DH, kRows, S::KT, S::BW)) return cudaErrorInvalidValue;
  return flash::launch(fwd_kernel<S>, dim3(ctas<S::FC>(a.L / kRows * a.H * a.B)),
                       kWgThreads, S::kFwdBytes, m, a, s);
}

template <class S>
cudaError_t backward(const Args& a, cudaStream_t s) {
  Maps dq{}, dkdv{};
  if (!make_maps(&dq, a, S::DH, kRows, S::DKT, S::BW) ||
      !make_maps(&dkdv, a, S::DH, S::QT, kRows, S::BW))
    return cudaErrorInvalidValue;
  cudaError_t err = flash::launch(bwd_dq_kernel<S>, dim3(ctas<S::DC>(a.L / kRows * a.H * a.B)),
                                  kWgThreads, S::kDqBytes, dq, a, s);
  if (err != cudaSuccess) return err;
  return flash::launch(bwd_dkdv_kernel<S>, dim3(ctas<S::KC>(a.Lk / kRows * a.H * a.B)),
                       kWgThreads, S::kDkdvBytes, dkdv, a, s);
}

}  // namespace blk

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const Args& a,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t f32_forward(const Args& a, cudaStream_t s) {
  using S = f32::Tiles<DH>;
  return launch(f32::fwd_kernel<DH>, dim3(a.L / S::T, a.H * a.m, a.B), f32::kThreads,
                S::bytes(3, 2), a, s);
}

template <int DH>
cudaError_t f32_backward(const Args& a, cudaStream_t s) {
  using S = f32::Tiles<DH>;
  cudaError_t err = launch(f32::bwd_dq_kernel<DH>, dim3(a.L / S::T, a.H * a.m, a.B),
                           f32::kThreads, S::bytes(5, 3), a, s);
  if (err != cudaSuccess) return err;
  return launch(f32::bwd_dkdv_kernel<DH>, dim3(a.Lk / S::T, a.H * a.m, a.B), f32::kThreads,
                S::bytes(6, 4), a, s);
}

// K5, JAX's block gate: the blk:: (bf16) and f32:: kernels at the head widths
// they are built for (ops/block_attention.py's HEAD_DIMS).
bool block_dh_ok(int dh) { return dh == 32 || dh == 64 || dh == 96 || dh == 128; }

cudaError_t block_forward(const Args& a, int dh, bool bf, cudaStream_t s) {
  switch (dh) {
    case 32: return bf ? blk::forward<blk::D32>(a, s) : f32_forward<32>(a, s);
    case 64: return bf ? blk::forward<blk::D64>(a, s) : f32_forward<64>(a, s);
    case 96: return bf ? blk::forward<blk::D96>(a, s) : f32_forward<96>(a, s);
    default: return bf ? blk::forward<blk::D128>(a, s) : f32_forward<128>(a, s);
  }
}

cudaError_t block_backward(const Args& a, int dh, bool bf, cudaStream_t s) {
  switch (dh) {
    case 32: return bf ? blk::backward<blk::D32>(a, s) : f32_backward<32>(a, s);
    case 64: return bf ? blk::backward<blk::D64>(a, s) : f32_backward<64>(a, s);
    case 96: return bf ? blk::backward<blk::D96>(a, s) : f32_backward<96>(a, s);
    default: return bf ? blk::backward<blk::D128>(a, s) : f32_backward<128>(a, s);
  }
}

// K7, JAX's flash gate (no dropout; ops/flash_attention.py): bf16 on the
// one-pass kernels at DH = 64, 128, 256 and 384 and on the wide:: kernels at
// 128 m for m >= 4; f32 on the f32:: kernels at K5's widths and, past 128,
// on the 128-wide template over m slices. A wide head's m column groups of
// 128 a head lie on grid y.
bool flash_dh_ok(int dh, bool bf) {
  return (bf ? dh == 64 : block_dh_ok(dh)) || (dh >= 128 && dh % 128 == 0);
}

cudaError_t flash_forward(Args& a, int dh, bool bf, cudaStream_t s) {
  a.m = dh > 128 ? dh / 128 : 1;
  if (!bf) return block_forward(a, dh > 128 ? 128 : dh, false, s);
  switch (dh) {
    case 64: return flash::forward<flash::D64>(a, s);
    case 128: return flash::forward<flash::D128>(a, s);
    case 256: return flash::forward<flash::D256>(a, s);
    case 384: return flash::forward<flash::D384>(a, s);
    default:
      return launch(wide::fwd_kernel, dim3(a.L / wide::kRows, a.H * a.m, a.B), wide::kThreads,
                    wide::kFwdBytes, a, s);
  }
}

cudaError_t flash_backward(Args& a, int dh, bool bf, cudaStream_t s) {
  a.m = dh > 128 ? dh / 128 : 1;
  if (!bf) return block_backward(a, dh > 128 ? 128 : dh, false, s);
  switch (dh) {
    case 64: return flash::backward<flash::D64>(a, s);
    case 128: return flash::backward<flash::D128>(a, s);
    case 256: return flash::backward<flash::D256>(a, s);
    case 384: return flash::backward<flash::D384>(a, s);
    default: break;
  }
  cudaError_t err = launch(wide::bwd_dq_kernel, dim3(a.L / wide::kRows, a.H * a.m, a.B),
                           wide::kThreads, wide::kFwdBytes, a, s);
  if (err != cudaSuccess) return err;
  return launch(wide::bwd_dkdv_kernel, dim3(a.Lk / wide::kRows, a.H * a.m, a.B),
                wide::kThreads, wide::kDkdvBytes, a, s);
}

Args make_args(int B, int H, int L, int Lk, const long long* strides, int n, float scale,
               int causal, int dropout, float drop_div, float drop_mul, unsigned thr,
               unsigned seed, int hs) {
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
  a.hs = hs;
  a.m = 1;
  return a;
}

// The pre-pass (key bits, dead rows), then the forward's arguments
cudaError_t prep_forward(Args& a, const void* q, const void* k, const void* v, void* o, void* ml,
                         const void* qmask, const void* kmask, void* kbits, void* dead,
                         cudaStream_t s) {
  prep_kernel<<<a.B, 256, 0, s>>>(static_cast<const int*>(kmask), static_cast<const int*>(qmask),
                                  static_cast<unsigned*>(kbits), static_cast<int*>(dead), a.L,
                                  a.Lk);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.ml = static_cast<float*>(ml);
  a.qmask = static_cast<const int*>(qmask);
  a.kbits = static_cast<const unsigned*>(kbits);
  a.dead = static_cast<const int*>(dead);
  return cudaGetLastError();
}

void set_backward(Args& a, const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv, const void* ml, void* stat,
                  const void* qmask, const void* kbits, const void* dead) {
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.ml = static_cast<float*>(const_cast<void*>(ml));
  a.stat = static_cast<float*>(stat);
  a.qmask = static_cast<const int*>(qmask);
  a.kbits = static_cast<const unsigned*>(kbits);
  a.dead = static_cast<const int*>(dead);
}

}  // namespace ergm_block

// K5 (ops/block_attention.py, JAX's block gate). dtype: 0 = float32, 1 =
// bfloat16; dh: the head width, 32, 64, 96 or 128. strides: host array of
// (batch, head, row) element strides of q, k, v, o. kbits [B, Lk/32] and
// dead [B] are written here (by the pre-pass) for the backward.
// head_stride: the dropout hash's (H for a whole problem). Returns a
// cudaError_t (0 on success).
extern "C" int ergm_block_mha_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* ml, const void* qmask, const void* kmask, void* kbits,
                                  void* dead, int dtype, int dh, int B, int H, int L, int Lk,
                                  const long long* strides, float scale, int causal,
                                  int dropout, float drop_div, float drop_mul, unsigned thr,
                                  unsigned seed, int head_stride, void* stream) {
  using namespace ergm_block;
  if ((dtype != 0 && dtype != 1) || !block_dh_ok(dh))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = make_args(B, H, L, Lk, strides, 4, scale, causal, dropout, drop_div, drop_mul, thr,
                     seed, head_stride);
  cudaError_t err = prep_forward(a, q, k, v, o, ml, qmask, kmask, kbits, dead, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(block_forward(a, dh, dtype == 1, s));
}

// strides: (batch, head, row) of q, k, v, o, dout, dq, dk, dv. stat is
// [B, H, L, 4] f32 scratch written by the dQ kernel and read by the dK/dV
// one; kbits and dead are the forward's.
extern "C" int ergm_block_mha_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  const void* ml, void* stat, const void* qmask,
                                  const void* kbits, const void* dead, int dtype, int dh, int B,
                                  int H, int L, int Lk, const long long* strides, float scale,
                                  int causal, int dropout, float drop_div, float drop_mul,
                                  unsigned thr, unsigned seed, int head_stride,
                                  void* stream) {
  using namespace ergm_block;
  if ((dtype != 0 && dtype != 1) || !block_dh_ok(dh))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(B, H, L, Lk, strides, 8, scale, causal, dropout, drop_div, drop_mul, thr,
                     seed, head_stride);
  set_backward(a, q, k, v, o, dout, dq, dk, dv, ml, stat, qmask, kbits, dead);
  return static_cast<int>(block_backward(a, dh, dtype == 1, static_cast<cudaStream_t>(stream)));
}

// K7 (ops/flash_attention.py, JAX's flash gate; no dropout): the same
// arguments and contracts as ergm_block_mha_fwd / _bwd without the dropout
// ones. dh: bf16 64 or a multiple of 128; f32 32, 64, 96, 128 or a
// multiple of 128.
extern "C" int ergm_flash_mha_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* ml, const void* qmask, const void* kmask, void* kbits,
                                  void* dead, int dtype, int dh, int B, int H, int L, int Lk,
                                  const long long* strides, float scale, int causal,
                                  void* stream) {
  using namespace ergm_block;
  if ((dtype != 0 && dtype != 1) || !flash_dh_ok(dh, dtype == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = make_args(B, H, L, Lk, strides, 4, scale, causal, 0, 1.0f, 1.0f, 0u, 0u, H);
  cudaError_t err = prep_forward(a, q, k, v, o, ml, qmask, kmask, kbits, dead, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(flash_forward(a, dh, dtype == 1, s));
}

extern "C" int ergm_flash_mha_bwd(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  const void* ml, void* stat, const void* qmask,
                                  const void* kbits, const void* dead, int dtype, int dh, int B,
                                  int H, int L, int Lk, const long long* strides, float scale,
                                  int causal, void* stream) {
  using namespace ergm_block;
  if ((dtype != 0 && dtype != 1) || !flash_dh_ok(dh, dtype == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(B, H, L, Lk, strides, 8, scale, causal, 0, 1.0f, 1.0f, 0u, 0u, H);
  set_backward(a, q, k, v, o, dout, dq, dk, dv, ml, stat, qmask, kbits, dead);
  return static_cast<int>(flash_backward(a, dh, dtype == 1, static_cast<cudaStream_t>(stream)));
}
