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
// Two products of the row-tiled dense layer in decode_gemm.cuh. The split
// between them sits on a point where JAX already rounds (the bf16 [B, F]
// activation), so it changes no value: (1) LN prologue + up projection +
// bias + GELU into a [B, F] buffer the wrapper allocates, (2) down
// projection + bias + residual. At the slice's shape the down projection's
// 192 tiles would leave most SMs idle over a K of 3,072, so it splits K four
// ways and adds the f32 partials in a second launch: three launches in all,
// and no value is rounded at the extra boundary.
//
// What bounds it on an H100 SXM (data sheet: 67 TFLOP/s f32 on the CUDA
// cores, 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM). At the
// slice's shape, B = 256, D = 768, F = 3072, the two products are
// 2 * 2 * B * D * F = 2.4 GFLOP; the weights are 9.4 MB in bf16 (2.8 us at
// the HBM rate) and the activations under 2 MB. On the tensor cores the
// layer would be bound by its weight bytes; this first version forms the
// products in f32 on the CUDA cores, which sets its floor near 36 us per
// layer (2.4 GFLOP at 67 TFLOP/s). The design keeps the weight traffic at
// one pass from device memory (each W tile is re-read from L2 by the 16
// row tiles) and keeps the [B, D] LayerNorm output out of device memory
// (each CTA recomputes its 16 rows' statistics). Measured on an NVIDIA
// H100 80GB HBM3 at its 700 W limit: 0.202 ms per call in bf16 (12 TFLOP/s),
// against 0.225 ms for the plain version. Moving the products to mma.sync /
// wgmma is the next step.

#include "decode_gemm.cuh"

namespace ergm_decode {

template <typename T>
cudaError_t launch_mlp(const void* h, int ldh, const void* ln_s, const void* ln_b, float eps,
                       const void* wfc, const void* bfc, const void* wpr, const void* bpr,
                       void* act, float* partial, long long partial_cap, void* out, int B,
                       int D, int F, int epi_act, cudaStream_t stream) {
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
  up.partial = partial;
  up.partial_cap = partial_cap;
  cudaError_t err = launch_dense<T>(up, stream);
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
  down.epi = kEpiResidual;
  down.partial = partial;
  down.partial_cap = partial_cap;
  return launch_dense<T>(down, stream);
}

}  // namespace ergm_decode

// dtype: 0 = float32, 1 = bfloat16. approximate: 1 = gelu_new (tanh form),
// 0 = gelu (erf form). h has row stride ldh; act is a [B, F] scratch buffer,
// partial an f32 workspace of partial_cap floats for the split products
// (kMaxSplits * B * F lets every product split fully), out [B, D], all
// contiguous. Returns a cudaError_t (0 on success).
extern "C" int ergm_fused_ln_mlp(const void* h, int ldh, const void* ln_s, const void* ln_b,
                                 float eps, const void* wfc, const void* bfc,
                                 const void* wpr, const void* bpr, void* act, void* partial,
                                 long long partial_cap, void* out, int dtype, int B, int D,
                                 int F, int approximate, void* stream) {
  using namespace ergm_decode;
  if (D % kBK || D % kBN || F % kBK || F % kBN) return static_cast<int>(cudaErrorInvalidValue);
  const int epi = approximate ? kEpiGeluTanh : kEpiGeluErf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  if (dtype == 0)
    return static_cast<int>(launch_mlp<float>(h, ldh, ln_s, ln_b, eps, wfc, bfc, wpr, bpr, act,
                                              ws, partial_cap, out, B, D, F, epi, s));
  if (dtype == 1)
    return static_cast<int>(launch_mlp<__nv_bfloat16>(h, ldh, ln_s, ln_b, eps, wfc, bfc, wpr,
                                                      bpr, act, ws, partial_cap, out, B, D, F,
                                                      epi, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
