// Fused LN2 + MLP + residual of a decode step for Hopper (sm_90a): kernel
// K4 of the port.
//
// Replaces ergm_tpu/ops/fused_decode.py::_call (the Pallas kernel behind
// fused_ln_mlp). For h [B, D] (one token per row) it computes
//   a   = act(round(LN2(h) @ Wfc + bfc))        [B, F], rounded to T
//   out = round(h + round(a @ Wproj + bproj))    [B, D]
// with f32 LayerNorm statistics, f32 accumulation and f32 bias, rounded to
// the compute dtype T after LN, after the up projection, after the GELU and
// after the down projection: the rounding points of JAX's kernel
// (fused_decode.py:71-88) and of the port's unfused layer_norm/dense/gelu.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 on the tensor cores,
// 3.35 TB/s HBM): the weights. At the slice's shape, B = 256, D = 768, F =
// 3072, the two products are 2 * 2 * B * D * F = 2.4 GFLOP (2.4 us) and the
// weights 9.4 MB (2.8 us): the layer sits on the ridge, and its bound is 3.1
// us. At Cerebras-GPT-2.7B's width (D = 2,560, F = 10,240) and B = 64 the
// weights are 105 MB (31.3 us) and the products 6.7 GFLOP.
//
// bf16: two launches of dense_hopper.cuh's product, split where JAX
// already rounds (the bf16 [B, F] activation, which stays in L2 between
// them), so the split changes no value: (1) LN prologue + up projection +
// bias + GELU into the [B, F] buffer, (2) down projection + bias +
// residual, launched by programmatic dependent launch so that it requests
// its first weight stages while (1) finishes. Two launches rather than
// one: each product gets the grid its own N and K want (one wave on the
// SMs, K split over a cluster), and one launch would need a grid-wide
// barrier at the activation. Each launch streams its weights by TMA
// through a ring of up to eight stages that a producer warp keeps full,
// forms its products on wgmma, and sums its K split through distributed
// shared memory in a fixed order: no atomics, and a repeat is bitwise
// equal. The grids come from the host (ops/fused_decode.py::plan, within
// the clusters the card holds at once), which the CPU tests check. In fp32 the two products run on decode_gemm.cuh's
// CUDA-core kernel, unsplit (the fp32 bars only).
//
// The tensor-parallel form (partial = 1): on a model rank holding the
// columns [f0, f1) of Wfc and bfc and the rows [f0, f1) of Wproj (F is
// then this rank's F_local), the up projection and its GELU are this
// rank's own, and the down projection writes its f32 partial product
// [B, D] (kEpiPartial): the caller sums the partials over the model group
// and forms round(h + round(sum + bproj)) itself.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit: PERF.md's K4
// rows (chip_smoke.py and scripts/k1_k4_times.py, device time).

#include "decode_gemm.cuh"
#include "dense_hopper.cuh"

namespace ergm_decode {

// fp32: decode_gemm.cuh's CUDA-core dense layer, twice
cudaError_t launch_mlp_f32(const void* h, int ldh, const void* ln_s, const void* ln_b, float eps,
                           const void* wfc, const void* bfc, const void* wpr, const void* bpr,
                           void* act, void* out, int B, int D, int F, int epi_act, bool partial,
                           cudaStream_t stream, int* launches) {
  DenseArgs up{};
  up.a = h;
  up.lda = ldh;
  up.w = wfc;
  up.bias = bfc;
  up.ln_scale = ln_s;
  up.ln_bias = ln_b;
  up.eps = eps;
  up.out = act;
  up.ldo = F;
  up.M = B;
  up.N = F;
  up.K = D;
  up.epi = epi_act;
  cudaError_t err = launch_dense<float>(up, stream, launches);
  if (err != cudaSuccess) return err;

  DenseArgs down{};
  down.a = act;
  down.lda = F;
  down.w = wpr;
  down.bias = bpr;
  down.res = h;
  down.ldr = ldh;
  down.out = out;
  down.ldo = D;
  down.M = B;
  down.N = D;
  down.K = F;
  down.epi = partial ? kEpiPartial : kEpiResidual;
  return launch_dense<float>(down, stream, launches);
}

// bf16: the Hopper product twice, with the host's plan of each (columns a
// CTA, K split, cluster's column tiles)
cudaError_t launch_mlp_bf16(const void* h, int ldh, const void* ln_s, const void* ln_b,
                            float eps, const void* wfc, const void* bfc, const void* wpr,
                            const void* bpr, void* act, void* out, int B, int D, int F,
                            int epi_act, bool partial, const int* plan, cudaStream_t stream,
                            int* info) {
  wg::Args up{};
  up.M = B;
  up.N = F;
  up.K = D;
  up.splits = plan[1];
  up.bias = static_cast<const bf16*>(bfc);
  up.out = act;
  up.ldo = F;
  up.epi = epi_act;
  up.h = static_cast<const bf16*>(h);
  up.ldh = ldh;
  up.ln_s = static_cast<const bf16*>(ln_s);
  up.ln_b = static_cast<const bf16*>(ln_b);
  up.eps = eps;
  cudaError_t err = wg::launch(up, h, ldh, wfc, plan[0], plan[2], stream, info);
  if (err != cudaSuccess) return err;

  wg::Args down{};
  down.M = B;
  down.N = D;
  down.K = F;
  down.splits = plan[4];
  down.bias = static_cast<const bf16*>(bpr);
  down.res = static_cast<const bf16*>(h);
  down.ldr = ldh;
  down.out = out;
  down.ldo = D;
  down.epi = partial ? kEpiPartial : kEpiResidual;
  down.after = 1;
  return wg::launch(down, act, F, wpr, plan[3], 1, stream, info);
}

}  // namespace ergm_decode

// dtype: 0 = float32, 1 = bfloat16. approximate: 1 = gelu_new (tanh form),
// 0 = gelu (erf form). h has row stride ldh; act [B, F] receives the
// activation, out [B, D] the result, both contiguous; with partial = 1, out
// is f32 and receives the down projection's partial product (bpr unread).
// bf16 reads the host's plan, five ints: the up projection's columns a CTA,
// K split and cluster column tiles, the down projection's columns and K
// split; fp32 ignores it. info (seven ints) receives the number of kernels
// started and, for each bf16 launch, the grid's x and y and the cluster
// size it started with (zeros in fp32). Returns a cudaError_t (0 on
// success).
extern "C" int ergm_fused_ln_mlp(const void* h, int ldh, const void* ln_s, const void* ln_b,
                                 float eps, const void* wfc, const void* bfc,
                                 const void* wpr, const void* bpr, void* act, void* out,
                                 int dtype, int B, int D, int F, int approximate, int partial,
                                 const int* plan, int* info, void* stream) {
  using namespace ergm_decode;
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (D % kTcBK || D % kTcBN || F % kTcBK || F % kTcBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int epi = approximate ? kEpiGeluTanh : kEpiGeluErf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_mlp_f32(h, ldh, ln_s, ln_b, eps, wfc, bfc, wpr, bpr, act,
                                           out, B, D, F, epi, partial != 0, s, info));
  if (dtype == 1)
    return static_cast<int>(launch_mlp_bf16(h, ldh, ln_s, ln_b, eps, wfc, bfc, wpr, bpr, act,
                                            out, B, D, F, epi, partial != 0, plan, s, info));
  return static_cast<int>(cudaErrorInvalidValue);
}

// *count: how many clusters of csize (1..8) of K4's bf16 product the
// current device holds at once. Returns a cudaError_t (0 on success).
extern "C" int ergm_fused_ln_mlp_clusters(int csize, int* count) {
  *count = 0;
  if (csize < 1 || csize > ergm_decode::wg::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ergm_decode::wg::max_clusters(csize, count));
}
