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
// 3.35 TB/s HBM). At the slice's shape, B = 256, D = 768, F = 3072, the
// two products are 2 * 2 * B * D * F = 2.4 GFLOP (2.4 us) and the weights
// 9.4 MB (2.8 us): the layer sits on the ridge, and its bound is 3.1 us.
//
// Two launches of the dense layer in decode_gemm.cuh, split where JAX
// already rounds (the bf16 [B, F] activation, 1.5 MB, which stays in L2
// between them), so the split changes no value: (1) LN prologue + up
// projection + bias + GELU into the [B, F] buffer, (2) down projection +
// bias + residual. In bf16 both products run on the tensor cores
// (mma.sync m16n8k16); each CTA covers all B rows of a 64-column tile, and
// K is split over a thread-block cluster whose CTAs add their partials
// through distributed shared memory in a fixed order: the up projection
// (N = 3072, K = 768) splits K in 2 and its clusters of 8 span 4 column
// tiles, which share the LayerNorm statistics; the down projection (N =
// 768, K = 3072) splits K in 8. No workspace in device memory, no reduce
// launch, no atomics: two launches a call, and a repeat is bitwise equal;
// the down projection starts early by programmatic dependent launch. In
// fp32 the same two products run on the CUDA cores, unsplit.
//
// The tensor-parallel form (partial = 1): on a model rank holding the
// columns [f0, f1) of Wfc and bfc and the rows [f0, f1) of Wproj (F is
// then this rank's F_local), the up projection and its GELU are this
// rank's own, and the down projection writes its f32 partial product
// [B, D] (decode_gemm.cuh's kEpiPartial): the caller sums the partials
// over the model group and forms round(h + round(sum + bproj)) itself.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit (chip_smoke.py,
// device time): 0.039 ms a call in bf16, against 0.063 ms for the plain
// version and 0.2015 ms for the CUDA-core design before it; 13 times its
// bound. decode_gemm.cuh says what binds it.

#include "decode_gemm.cuh"

namespace ergm_decode {

template <typename T>
cudaError_t launch_mlp(const void* h, int ldh, const void* ln_s, const void* ln_b, float eps,
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
  cudaError_t err = launch_dense<T>(up, stream, launches);
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
  return launch_dense<T>(down, stream, launches, true);
}

}  // namespace ergm_decode

// dtype: 0 = float32, 1 = bfloat16. approximate: 1 = gelu_new (tanh form),
// 0 = gelu (erf form). h has row stride ldh; act [B, F] receives the
// activation, out [B, D] the result, both contiguous; with partial = 1, out
// is f32 and receives the down projection's partial product (bpr unread).
// *launches is set to the number of kernels started. Returns a cudaError_t
// (0 on success).
extern "C" int ergm_fused_ln_mlp(const void* h, int ldh, const void* ln_s, const void* ln_b,
                                 float eps, const void* wfc, const void* bfc,
                                 const void* wpr, const void* bpr, void* act, void* out,
                                 int dtype, int B, int D, int F, int approximate, int partial,
                                 int* launches, void* stream) {
  using namespace ergm_decode;
  *launches = 0;
  if (D % kTcBK || D % kTcBN || F % kTcBK || F % kTcBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int epi = approximate ? kEpiGeluTanh : kEpiGeluErf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_mlp<float>(h, ldh, ln_s, ln_b, eps, wfc, bfc, wpr, bpr, act,
                                              out, B, D, F, epi, partial != 0, s, launches));
  if (dtype == 1)
    return static_cast<int>(launch_mlp<bf16>(h, ldh, ln_s, ln_b, eps, wfc, bfc, wpr, bpr, act,
                                             out, B, D, F, epi, partial != 0, s, launches));
  return static_cast<int>(cudaErrorInvalidValue);
}
