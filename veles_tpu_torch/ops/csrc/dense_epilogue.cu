// K6: the fused dense layer act(A @ B + bias), f32 accumulator, f32 out.
//
// Replaces _mm_epilogue_kernel via pallas_dense (veles_tpu/ops/gemm.py:199,
// :228): the bias add and the activation run on the f32 accumulator
// before the single store, so the pre-activation never reaches device
// memory. On the training path it is the forward of every eligible dense
// layer (m 4096, k 784, n 4096, tanh on the wide MLP). The tile
// machinery, its bound and its design are in gemm_tiles.cuh; the
// activation is a template argument, one instantiation each.

#include "gemm_tiles.cuh"

using namespace gemm_tiles;

template <int EPI>
static int run(const Problem& p, bool bf16, cudaStream_t s) {
  return bf16 ? launch<float, EPI, true>(p, s)
              : launch<float, EPI, false>(p, s);
}

// dtype: 0 float32 operands, 1 bfloat16; activation: the index of
// EPI_LINEAR .. EPI_STRICT_RELU (linear, tanh, sigmoid, relu,
// strict_relu). Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an unknown activation).
extern "C" int veles_dense(const void* a, const void* b, const float* bias,
                           float* c, int m, int n, int k, long long lda,
                           int a_k_contig, long long ldb, int b_n_contig,
                           long long ldc, int dtype, int activation,
                           int vec_a, int vec_b, void* stream) {
  Problem p{a, b, bias, c, m, n, k, lda, ldb, ldc,
            a_k_contig != 0, b_n_contig != 0, vec_a != 0, vec_b != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool bf16 = dtype == 1;
  switch (activation) {
    case EPI_LINEAR: return run<EPI_LINEAR>(p, bf16, s);
    case EPI_TANH: return run<EPI_TANH>(p, bf16, s);
    case EPI_SIGMOID: return run<EPI_SIGMOID>(p, bf16, s);
    case EPI_RELU: return run<EPI_RELU>(p, bf16, s);
    case EPI_STRICT_RELU: return run<EPI_STRICT_RELU>(p, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
