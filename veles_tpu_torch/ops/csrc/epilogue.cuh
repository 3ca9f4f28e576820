// The dense layer's epilogue, one definition shared by K6's two routes:
// the bf16 route on K5's Hopper mainloop (gemm_sm90.cuh) and the
// true-f32 tile (gemm_tiles.cuh). The bias is added to the f32
// accumulator and the activation applied before the single store, as in
// _mm_epilogue_kernel (veles_tpu/ops/gemm.py:199); the activations are
// ops/activations.ACTIVATIONS.

#pragma once

namespace epilogue {

// EPI_NONE: K5, no bias; the rest: K6's activations, by the index
// ops/gemm._ACTIVATION_IDS gives them
constexpr int EPI_NONE = -1;
constexpr int EPI_LINEAR = 0;
constexpr int EPI_TANH = 1;
constexpr int EPI_SIGMOID = 2;
constexpr int EPI_RELU = 3;         // Znicz "relu" is softplus
constexpr int EPI_STRICT_RELU = 4;

// the activation of the pre-activation x (accumulator plus bias)
template <int EPI>
__device__ __forceinline__ float activate(float x) {
  if (EPI == EPI_TANH) return 1.7159f * tanhf(0.6666f * x);
  if (EPI == EPI_SIGMOID) return 1.f / (1.f + expf(-x));
  if (EPI == EPI_RELU) return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  if (EPI == EPI_STRICT_RELU) return fmaxf(x, 0.f);
  return x;
}

}  // namespace epilogue
