// activation.cuh — the activation epilogues that the fused matmul
// (fused_matmul.cu) and the fused LayerNorm (fused_layer_norm.cu) apply to
// their float32 results before the single write. The codes follow
// FUSED_MATMUL_ACTIVATIONS (deeplearning4j_tpu_torch/ops/nn_ops.py):
// none, relu, tanh, gelu (the tanh approximation), gelu_exact (the erf
// form).

#pragma once

#include <cuda_runtime.h>

namespace epilogue {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_GELU = 3,
           ACT_GELU_EXACT = 4 };

// the activations in float32, as the plain versions' PyTorch ops compute
// them on the card (torch's gelu kernels use these formulas)
__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return y < 0.f ? 0.f : y;  // NaN passes, as torch.relu
    case ACT_TANH:
      return tanhf(y);
    case ACT_GELU: {
      const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float k_kappa = 0.044715f;
      const float inner = k_beta * (y + k_kappa * y * y * y);
      return 0.5f * y * (1.f + tanhf(inner));
    }
    case ACT_GELU_EXACT:
      return y * 0.5f * (1.f + erff(y * 0.7071067811865476f));
    default:
      return y;
  }
}

}  // namespace epilogue
