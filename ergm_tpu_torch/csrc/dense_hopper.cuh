// Dense layer of the fused LN2 + MLP decode kernel K4 in bf16, for Hopper
// (sm_90a): wgmma products whose weights stream by TMA.
//
// out = epilogue(round(A' @ W + bias)) for A [M, K] (row stride lda), W
// [K, N] row-major ([in, out], GPT-2's Conv1D orientation) and bias [N],
// bf16, f32 accumulation. A' is A, or the LayerNorm of A's rows when
// ln_s is given: f32 statistics (mean, then the mean of centred squares),
// (x * rstd - mean * rstd) * scale + bias, rounded to bf16 (the rounding
// point of the plain layer_norm). The epilogues are decode_gemm.cuh's
// dense_epi (kEpiGeluTanh / kEpiGeluErf: round(act(round(y))) for the up
// projection; kEpiResidual: round(res + round(y)) for the down projection;
// kEpiPartial: the f32 sum as it is, the tensor-parallel form's partial).
//
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16): W's bytes. At
// decode M is the batch, 8 to 256 rows, and each weight is read once: 4.7
// MB a projection at gpt2, 52 MB at Cerebras-GPT-2.7B's width (15.6 us).
// At gpt2's B = 256 the operations come close (1.2 GFLOP, 1.2 us).
//
// Design. A CTA is a producer warpgroup and two consumer warpgroups (384
// threads, one CTA an SM). It owns NT columns (64 or 128) of up to 256
// rows and a contiguous share of K's 64-deep chunks: K is split S ways (S
// <= 8), and the S CTAs of a column tile form a thread-block cluster (with
// a LayerNorm prologue the cluster also spans Cn column tiles, S * Cn <=
// 8). The grid (column tiles x S x row tiles) is planned on the host
// (ops/fused_decode.py::plan) to take one wave: no more CTAs than the card
// holds at once in clusters of the plan's size (max_clusters); the kernel
// takes it as given. The producer's first thread streams each chunk, A [rows][64]
// and W [64][NT], through a ring of up to eight stages on mbarriers by TMA
// (128-byte swizzle; rows past M are TMA's zeros). The consumers' products
// are wgmma m64nNT k16: each warpgroup owns MB row blocks of 64 (two at
// 256 rows; at 64 rows or fewer the two warpgroups share the block and take
// the chunks in turn, SK); W is the B operand read MN-major from its
// stage. Without a LayerNorm A is read from its stage by descriptor; with
// one, each warp loads its A fragments by ldmatrix, applies the LayerNorm
// in registers and rounds them, and the product takes A from registers.
// The LayerNorm statistics are formed once a cluster: CTA rank r forms
// those of rows r, r + csize, ... from h, and the cluster reads each row's
// from its owner's shared memory after a cluster barrier; meanwhile the
// ring fills. The split partials are summed without a workspace and
// without atomics: each CTA leaves its f32 tile in its shared memory (the
// ring's), and after a cluster barrier the CTA with K share k finishes
// rows k, k + S, ... by adding the S tiles through distributed shared
// memory in K order, then applies bias and epilogue. A repeat is bitwise
// equal. A launch after the kernel that writes its A (K4's down
// projection) uses programmatic dependent launch: its producer requests
// the first stages' W while that kernel finishes and waits for it before
// it requests A. Tensor maps are cached by their arguments
// (ergm_hopper::encode_cached), so a decode step encodes none.
#pragma once

#include <cooperative_groups.h>

#include "decode_gemm.cuh"
#include "hopper.cuh"

namespace ergm_decode {
namespace wg {

namespace cg = cooperative_groups;
using ergm_hopper::bar_sync;
using ergm_hopper::cluster_arrive;
using ergm_hopper::cluster_arrive_relaxed;
using ergm_hopper::cluster_wait;
using ergm_hopper::mbar_arrive;
using ergm_hopper::mbar_expect;
using ergm_hopper::mbar_fence_init;
using ergm_hopper::mbar_init;
using ergm_hopper::mbar_wait;
using ergm_hopper::pin;
using ergm_hopper::sm_desc;
using ergm_hopper::tma_load_2d;
using ergm_hopper::wg_commit;
using ergm_hopper::wg_fence;
using ergm_hopper::wg_wait;
using ergm_hopper::wgmma_rs;
using ergm_hopper::wgmma_ss_mn;

constexpr int kThreads = 384;      // a producer warpgroup, two consumer warpgroups
constexpr int kChunk = 64;         // the depth of a streamed chunk
constexpr int kTileRows = 256;     // rows a CTA covers; grid y takes the rest
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr size_t kRing = 196608;   // the ring's bytes (at most eight stages)
constexpr size_t kSmemMax = 232448;
constexpr size_t kAlign = 1024;    // the 128-byte swizzle's pattern

struct Args {
  int M, N, K;
  int splits, csize;         // K's split S (a column tile's CTAs) and the cluster's size
  const bf16* bias;          // [N] (unread under kEpiPartial)
  const bf16* res;           // [M, N] residual (kEpiResidual), row stride ldr
  int ldr;
  void* out;                 // [M, N], row stride ldo: bf16, f32 under kEpiPartial
  int ldo;
  int epi;
  const bf16* h;             // with ln_s: the rows whose LayerNorm is A, row stride ldh
  int ldh;
  const bf16* ln_s;          // [K] LayerNorm scale, or null: A as it is
  const bf16* ln_b;          // [K]
  float eps;
  int after;                 // A is the output of the kernel launched just before
};

// MB: the row blocks of 64 each consumer warpgroup owns; NT: a CTA's
// columns; SK: at 64 rows or fewer the two warpgroups share one row block
// and take the chunks in turn (even, odd), each summing its own partial
template <int MB_, int NT_, bool SK_>
struct Shape {
  static constexpr int MB = MB_, NT = NT_;
  static constexpr bool SK = SK_;
  static constexpr int kRows = SK ? 64 : 128 * MB;  // A rows a stage holds
  static constexpr int kA = kRows * kChunk, kW = kChunk * NT;  // a stage's elements
  static constexpr size_t kStageBytes = 2 * (kA + kW);
  static constexpr int kStages = kRing / kStageBytes > 8 ? 8 : static_cast<int>(kRing / kStageBytes);
  static constexpr int kParts = SK ? 2 : 1;  // f32 partial tiles a CTA leaves
  static constexpr int kLdr = NT + 8;        // their row pitch (conflict-free float2 stores)
  static_assert(sizeof(float) * kParts * kRows * kLdr <= kStages * kStageBytes,
                "the partial tiles reuse the ring");
  // shared memory past the ring: the owned rows' (mean, rstd), the
  // barriers; then the LayerNorm parameters of the CTA's chunks
  static constexpr size_t kFixed = kAlign + kStages * kStageBytes +
                                   sizeof(float) * 2 * kTileRows + 8 * 2 * kStages;
};

// A LayerNorm'd pair of an A fragment register, rounded to bf16
__device__ __forceinline__ unsigned ln2(unsigned u, float rstd, float shift, float2 sc,
                                        float2 bi) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  const __nv_bfloat162 y = __floats2bfloat162_rn(fmaf(fmaf(x.x, rstd, shift), sc.x, bi.x),
                                                 fmaf(fmaf(x.y, rstd, shift), sc.y, bi.y));
  return *reinterpret_cast<const unsigned*>(&y);
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The row's f32 mean and rstd from global memory, a warp a row: the mean,
// then the mean of centred squares
__device__ __forceinline__ void row_stats(const bf16* x, int K, float eps, float& mean,
                                          float& rstd) {
  const int lane = threadIdx.x & 31;
  float e8[8], sum = 0.0f;
  for (int k = 8 * lane; k < K; k += 256) {
    unpack8(*reinterpret_cast<const uint4*>(x + k), e8);
    sum += ((e8[0] + e8[1]) + (e8[2] + e8[3])) + ((e8[4] + e8[5]) + (e8[6] + e8[7]));
  }
  mean = warp_sum(sum) / K;
  float sq = 0.0f;
  for (int k = 8 * lane; k < K; k += 256) {
    unpack8(*reinterpret_cast<const uint4*>(x + k), e8);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = e8[e] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  rstd = rsqrtf(warp_sum(sq) / K + eps);
}

// grid (N / NT * S, ceil(M / 256)), clusters of csize = S * Cn CTAs along
// x: blockIdx.x = column tile * S + K share, cluster rank (tile % Cn) * S +
// K share. The CTA with K share k takes chunks [k nk / S, (k + 1) nk / S).
template <class S>
__global__ void __launch_bounds__(kThreads, 1)
    dense_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap wmap, const Args a) {
  constexpr int ST = S::kStages, NT = S::NT, MB = S::MB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kAlign - (ergm_mma::saddr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  bf16* ring = reinterpret_cast<bf16*>(base);  // [ST]: A [kRows][64], W [NT / 64][64][64]
  float* own = reinterpret_cast<float*>(base + ST * S::kStageBytes);  // [2][256]: mean, rstd
  uint64_t* full = reinterpret_cast<uint64_t*>(own + 2 * kTileRows);
  uint64_t* empty = full + ST;
  bf16* lnp = reinterpret_cast<bf16*>(empty + ST);  // [2][chunks * 64]: scale, bias

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int kidx = rank % a.splits;
  const int n0 = (blockIdx.x / a.splits) * NT, m0 = blockIdx.y * kTileRows;
  const int rows = min(kTileRows, a.M - m0);
  const int nk = a.K / kChunk, c0 = kidx * nk / a.splits;
  const int chunks = (kidx + 1) * nk / a.splits - c0;
  const bool ln = a.ln_s != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, S::SK ? 4 : 8);  // the warps that read a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: its first thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (ln) cluster_arrive_relaxed();  // the statistics' phase: nothing of its own
    if (threadIdx.x == 0) {
      auto load_w = [&](int i) {
        const int s = i % ST;
        bf16* w = ring + s * (S::kA + S::kW) + S::kA;
#pragma unroll
        for (int cb = 0; cb < NT / 64; ++cb)
          tma_load_2d(&wmap, w + cb * 64 * kChunk, full + s, n0 + 64 * cb, (c0 + i) * kChunk);
      };
      auto load_a = [&](int i) {
        const int s = i % ST;
        tma_load_2d(&amap, ring + s * (S::kA + S::kW), full + s, (c0 + i) * kChunk, m0);
      };
      // the first stages' W before the wait for the kernel that writes A
      const int pre = a.after ? min(ST, chunks) : 0;
      for (int i = 0; i < pre; ++i) {
        mbar_expect(full + i, S::kStageBytes);
        load_w(i);
      }
      if (a.after) griddep_wait();
      for (int i = 0; i < pre; ++i) load_a(i);
      for (int i = pre; i < chunks; ++i) {
        const int s = i % ST;
        mbar_wait(empty + s, ((i / ST) + 1) & 1);
        mbar_expect(full + s, S::kStageBytes);
        load_w(i);
        load_a(i);
      }
    }
    griddep_launch();
    if (ln) cluster_wait();
    cluster_arrive();  // the partials' phase, then the last
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1, ct = threadIdx.x - 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wi = (threadIdx.x >> 5) & 3;
  const int kr = chunks * kChunk;
  auto block = [&](int mb) { return S::SK ? 0 : c * MB + mb; };  // a row block of 64

  // LayerNorm constants of the lane's fragment rows (rows past M: 0)
  float lrstd[MB][2] = {}, lshift[MB][2] = {};
  if (ln) {
    for (int i = ct; i < kr / 8; i += 256) {
      *reinterpret_cast<uint4*>(lnp + 8 * i) =
          *reinterpret_cast<const uint4*>(a.ln_s + c0 * kChunk + 8 * i);
      *reinterpret_cast<uint4*>(lnp + kr + 8 * i) =
          *reinterpret_cast<const uint4*>(a.ln_b + c0 * kChunk + 8 * i);
    }
    // this rank's rows, a warp a row
    for (int r = rank + a.csize * (ct >> 5); r < rows; r += a.csize * 8) {
      float mean, rstd;
      row_stats(a.h + static_cast<long long>(m0 + r) * a.ldh, a.K, a.eps, mean, rstd);
      if (lane == 0) {
        own[r] = mean;
        own[kTileRows + r] = rstd;
      }
    }
    cluster_arrive();
    cluster_wait();  // every owner's statistics (and the parameters) are written
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 64 * block(mb) + 16 * wi + g + 8 * hf;
        if (r < rows) {
          const int owner = r % a.csize;
          const float mean = *cluster.map_shared_rank(own + r, owner);
          const float rstd = *cluster.map_shared_rank(own + kTileRows + r, owner);
          lrstd[mb][hf] = rstd;
          lshift[mb][hf] = -mean * rstd;
        }
      }
  }

  float acc[MB][NT / 8][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) ergm_mma::zero(acc[mb]);
  for (int i = 0; i < chunks; ++i) {
    if (S::SK && (i & 1) != c) continue;
    const int s = i % ST;
    const bf16* at = ring + s * (S::kA + S::kW);
    const bf16* wt = at + S::kA;
    mbar_wait(full + s, (i / ST) & 1);
    if (ln) {
      unsigned fr[MB][kChunk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        // fragment registers: (row g, k 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
        const int k = i * kChunk + kk * 16 + 2 * t;
        const float2 s0 = bf2(lnp + k), s8 = bf2(lnp + k + 8);
        const float2 b0 = bf2(lnp + kr + k), b8 = bf2(lnp + kr + k + 8);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          // row r's 16-byte chunk q lies at chunk q ^ (r % 8) (the swizzle)
          const int r = 64 * block(mb) + 16 * wi + (lane & 15), q = 2 * kk + (lane >> 4);
          ergm_mma::ldsm4(fr[mb][kk], ergm_mma::saddr(at) + r * 128 + ((q ^ (r & 7)) << 4));
          fr[mb][kk][0] = ln2(fr[mb][kk][0], lrstd[mb][0], lshift[mb][0], s0, b0);
          fr[mb][kk][1] = ln2(fr[mb][kk][1], lrstd[mb][1], lshift[mb][1], s0, b0);
          fr[mb][kk][2] = ln2(fr[mb][kk][2], lrstd[mb][0], lshift[mb][0], s8, b8);
          fr[mb][kk][3] = ln2(fr[mb][kk][3], lrstd[mb][1], lshift[mb][1], s8, b8);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          wgmma_rs<NT>(acc[mb], fr[mb][kk], sm_desc(wt + kk * 16 * 64, kChunk * 128, 1024));
    } else {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          wgmma_ss_mn<NT>(acc[mb], sm_desc(at + 64 * block(mb) * 64 + kk * 16, 16, 1024),
                       sm_desc(wt + kk * 16 * 64, kChunk * 128, 1024), 1);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) pin(acc[mb]);
    if (lane == 0) mbar_arrive(empty + s);
  }
  griddep_launch();  // this CTA has read its inputs

  // this CTA's f32 partial tile(s) into the ring, once both warpgroups
  // are done with it
  bar_sync(1, 256);
  float* red = reinterpret_cast<float*>(ring);  // [kParts][kRows][kLdr]
  float* part = red + (S::SK ? c * S::kRows * S::kLdr : 0);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 64 * block(mb) + 16 * wi + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
        *reinterpret_cast<float2*>(part + r * S::kLdr + 8 * j + 2 * t) =
            make_float2(acc[mb][j][2 * hf], acc[mb][j][2 * hf + 1]);
    }
  cluster_arrive();
  cluster_wait();  // every partial tile of the cluster is written

  // K share k finishes rows k, k + S, ...: the S ranks' tiles (each rank's
  // two under SK) in K order, then bias and epilogue
  constexpr int kQuads = NT / 4;
  const int first = rank - kidx, mine = (rows - kidx + a.splits - 1) / a.splits;
  DenseArgs e{};
  e.epi = a.epi;
  for (int idx = ct; idx < mine * kQuads; idx += 256) {
    const int r = kidx + (idx / kQuads) * a.splits, c4 = (idx % kQuads) * 4;
    float4 p[kMaxSplits * S::kParts];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < a.splits)
#pragma unroll
        for (int pt = 0; pt < S::kParts; ++pt)
          p[q * S::kParts + pt] = *cluster.map_shared_rank(
              reinterpret_cast<float4*>(red + (pt * S::kRows + r) * S::kLdr + c4), first + q);
    float4 sum = p[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits * S::kParts; ++q)
      if (q < a.splits * S::kParts) {
        sum.x += p[q].x;
        sum.y += p[q].y;
        sum.z += p[q].z;
        sum.w += p[q].w;
      }
    const long long row = m0 + r;
    const int col = n0 + c4;
    if (a.epi == kEpiPartial) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + row * a.ldo + col) = sum;
      continue;
    }
    const float acc4[4] = {sum.x, sum.y, sum.z, sum.w};
    const uint2 braw = *reinterpret_cast<const uint2*>(a.bias + col);
    uint2 rraw = make_uint2(0u, 0u);
    if (a.epi == kEpiResidual) rraw = *reinterpret_cast<const uint2*>(a.res + row * a.ldr + col);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&braw);
    const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&rraw);
    const float b4[4] = {__low2float(bh[0]), __high2float(bh[0]), __low2float(bh[1]),
                         __high2float(bh[1])};
    const float r4[4] = {__low2float(rh[0]), __high2float(rh[0]), __low2float(rh[1]),
                         __high2float(rh[1])};
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = dense_epi<bf16>(e, acc4[q], b4[q], r4[q], 1.0f);
    uint2 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
    oh[0] = __floats2bfloat162_rn(y[0], y[1]);
    oh[1] = __floats2bfloat162_rn(y[2], y[3]);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + row * a.ldo + col) = o;
  }
  cluster_arrive();
  cluster_wait();  // no CTA leaves while another still reads its tiles
}

// A 2-D bf16 map over [outer, inner] with row stride ld (elements), boxes
// of 64 x box_rows, the 128-byte swizzle
inline bool map_2d(CUtensorMap* map, const void* p, int inner, int outer, long long ld,
                   int box_rows) {
  ergm_hopper::MapArgs m{};
  m.ptr = p;
  m.rank = 2;
  m.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  m.dims[0] = static_cast<cuuint64_t>(inner);
  m.dims[1] = static_cast<cuuint64_t>(outer);
  m.strides[0] = static_cast<cuuint64_t>(ld) * 2;
  m.box[0] = 64;
  m.box[1] = static_cast<cuuint32_t>(box_rows);
  return ergm_hopper::encode_cached(map, m);
}

template <class S>
cudaError_t launch_shape(const Args& a, const void* A, int lda, const void* W, int cn,
                         cudaStream_t stream, int* dims) {
  CUtensorMap amap, wmap;
  if (!map_2d(&amap, A, a.K, a.M, lda, S::kRows) || !map_2d(&wmap, W, a.N, a.K, a.N, kChunk))
    return cudaErrorInvalidValue;
  const int most = (a.K / kChunk + a.splits - 1) / a.splits;  // a CTA's most chunks
  const size_t smem = S::kFixed + (a.ln_s ? 2 * 2 * most * kChunk : 0);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = ergm_hopper::smem_limit(dense_kernel<S>, kSmemMax);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.N / S::NT * a.splits, (a.M + kTileRows - 1) / kTileRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits * cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.after ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, dense_kernel<S>, amap, wmap, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) {
    dims[0] = static_cast<int>(cfg.gridDim.x);
    dims[1] = static_cast<int>(cfg.gridDim.y);
    dims[2] = static_cast<int>(attr[0].val.clusterDim.x);
  }
  return err;
}

// One launch on `stream` over A (row stride lda) and W with the host's
// plan: NT columns a CTA (64 or 128), K split a.splits ways (<= 8,
// <= K / 64), clusters of a.splits * cn CTAs (<= 8, cn dividing the column
// tiles). N and K are multiples of 64; A, W, bias, residual and output rows
// start on 16-byte boundaries (row strides multiples of 8 elements).
// info[0] counts the kernels started; launch i writes the grid's x and y
// and the cluster's size it started with to info[1 + 3 i .. 3 + 3 i].
inline cudaError_t launch(Args a, const void* A, int lda, const void* W, int nt, int cn,
                          cudaStream_t stream, int* info) {
  if ((nt != 64 && nt != 128) || a.N % nt || a.K % kChunk || a.M < 1 || a.splits < 1 ||
      a.splits > kMaxSplits || a.splits > a.K / kChunk || cn < 1 ||
      a.splits * cn > kMaxSplits || (a.N / nt) % cn)
    return cudaErrorInvalidValue;
  a.csize = a.splits * cn;
  const int rows = a.M < kTileRows ? a.M : kTileRows;
  int* dims = info + 1 + 3 * info[0];
  cudaError_t err;
  if (rows <= 64)
    err = nt == 64 ? launch_shape<Shape<1, 64, true>>(a, A, lda, W, cn, stream, dims)
                   : launch_shape<Shape<1, 128, true>>(a, A, lda, W, cn, stream, dims);
  else if (rows <= 128)
    err = nt == 64 ? launch_shape<Shape<1, 64, false>>(a, A, lda, W, cn, stream, dims)
                   : launch_shape<Shape<1, 128, false>>(a, A, lda, W, cn, stream, dims);
  else
    err = nt == 64 ? launch_shape<Shape<2, 64, false>>(a, A, lda, W, cn, stream, dims)
                   : launch_shape<Shape<2, 128, false>>(a, A, lda, W, cn, stream, dims);
  if (err == cudaSuccess) ++info[0];
  return err;
}

// How many clusters of csize CTAs of the product (one CTA an SM) the
// device holds at once: a cluster's CTAs share a GPC, so a size that does
// not divide the GPCs' SM counts leaves SMs idle
inline cudaError_t max_clusters(int csize, int* count) {
  using S = Shape<1, 64, true>;
  cudaError_t err = ergm_hopper::smem_limit(dense_kernel<S>, kSmemMax);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kFixed;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, dense_kernel<S>, &cfg);
}

}  // namespace wg
}  // namespace ergm_decode
