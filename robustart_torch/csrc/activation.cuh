// The activations of the MLP kernels' epilogues: linear_fused.cu (K7's fc1)
// and token_mlp.cu (K10). They are the four of the JAX package's
// robustart_tpu/ops/pallas_mlp.py::_act_fn (:44-55), each in f32:
//
//   1 gelu        0.5·h·(1 + erf(h/√2))
//   2 gelu_tanh   0.5·h·(1 + tanh(√(2/π)·(h + 0.044715·h³)))
//   3 quick_gelu  h·σ(1.702·h), σ(z) = 1/(1 + exp(−z))  (CLIP)
//   4 relu        max(h, 0)
//
// and 0 for none. The codes are ops/linear.py::ACT_CODE. Every function is
// 0 at 0, so a padded hidden unit stays an exact zero.
//
// An epilogue spends its issue slots on these (fc1's is 77 M values at
// ViT-B), so gelu's erf is the TPU kernel's own, the polynomial of
// Abramowitz & Stegun 7.1.26 (pallas_mlp.py::_erf_poly, |error| ≤ 1.5e-7,
// a fraction of a bf16 ulp; XLA's reference takes the exact erf), with the
// reciprocal and the exponential on the special-function unit, and
// quick_gelu's σ takes the same two. The plain versions compute the exact
// functions.

#pragma once

enum ActCode : int { kActNone = 0, kActGelu = 1, kActGeluTanh = 2, kActQuickGelu = 3, kActRelu = 4 };

// erf by Abramowitz & Stegun 7.1.26, as pallas_mlp.py::_erf_poly
__device__ __forceinline__ float erf_poly(float x) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  return copysignf(fmaf(-poly, __expf(-ax * ax), 1.0f), x);
}

__device__ __forceinline__ float act_apply(int act, float h) {
  switch (act) {
    case kActGelu:
      return 0.5f * h * (1.0f + erf_poly(h * 0.70710678118654752440f));
    case kActGeluTanh: {
      const float inner = 0.79788456080286535588f * (h + 0.044715f * h * h * h);
      return 0.5f * h * (1.0f + tanhf(inner));
    }
    case kActQuickGelu:
      return h * __fdividef(1.0f, 1.0f + __expf(-1.702f * h));
    case kActRelu:
      return fmaxf(h, 0.0f);
    default:
      return h;
  }
}
