// K6: the fused dense layer act(A @ B + bias), f32 accumulator, f32 out.
//
// Replaces _mm_epilogue_kernel via pallas_dense (veles_tpu/ops/gemm.py:199,
// :246): the bias add and the activation run on the f32 accumulator
// before the single store, so the pre-activation never reaches device
// memory. On the training path it is the forward of every eligible dense
// layer (m 4096, k 784, n 4096, tanh on the wide MLP). bf16 operands run
// K5's Hopper mainloop (gemm_sm90.cuh: TMA ring, wgmma) with the epilogue
// in its store loop; f32 operands (levels 1-2) the true-f32 FMA tile of
// gemm_tiles.cuh. Both take the activation from epilogue.cuh as a
// template argument, one instantiation each; each header states its bound
// and design.

#include "gemm_sm90.cuh"
#include "gemm_tiles.cuh"

template <int EPI>
static int run(const void* a, const void* b, const float* bias, float* c,
               int m, int n, int k, long long lda, int a_k_contig,
               long long ldb, int b_n_contig, long long ldc, bool bf16,
               int vec_a, int vec_b, int bn, cudaStream_t s) {
  if (bf16)
    return gemm_sm90::run<float, EPI>(a, b, c, m, n, k, lda, a_k_contig == 0,
                                      ldb, b_n_contig != 0, ldc, s, bn, bias);
  gemm_tiles::Problem p{a, b, bias, c, m, n, k, lda, ldb, ldc,
                        a_k_contig != 0, b_n_contig != 0, vec_a != 0,
                        vec_b != 0};
  return gemm_tiles::launch<float, EPI>(p, s);
}

// dtype: 0 float32 operands, 1 bfloat16; activation: the index of
// EPI_LINEAR .. EPI_STRICT_RELU (linear, tanh, sigmoid, relu,
// strict_relu). bf16 operands must be 16-byte aligned with a leading
// stride that is a multiple of 8 elements (TMA's rule; the wrapper copies
// what is not); vec_a / vec_b (16-byte loads) are read for f32 only; bn
// is the bf16 route's tile width (128, 256, or 0 for gemm_sm90::pick_bn's).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unknown activation), or minus a CUresult when a TMA tensor map is
// refused.
extern "C" int veles_dense(const void* a, const void* b, const float* bias,
                           float* c, int m, int n, int k, long long lda,
                           int a_k_contig, long long ldb, int b_n_contig,
                           long long ldc, int dtype, int activation,
                           int vec_a, int vec_b, int bn, void* stream) {
  using namespace epilogue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  switch (activation) {
    case EPI_LINEAR:
      return run<EPI_LINEAR>(a, b, bias, c, m, n, k, lda, a_k_contig, ldb,
                             b_n_contig, ldc, bf16, vec_a, vec_b, bn, s);
    case EPI_TANH:
      return run<EPI_TANH>(a, b, bias, c, m, n, k, lda, a_k_contig, ldb,
                           b_n_contig, ldc, bf16, vec_a, vec_b, bn, s);
    case EPI_SIGMOID:
      return run<EPI_SIGMOID>(a, b, bias, c, m, n, k, lda, a_k_contig, ldb,
                              b_n_contig, ldc, bf16, vec_a, vec_b, bn, s);
    case EPI_RELU:
      return run<EPI_RELU>(a, b, bias, c, m, n, k, lda, a_k_contig, ldb,
                           b_n_contig, ldc, bf16, vec_a, vec_b, bn, s);
    case EPI_STRICT_RELU:
      return run<EPI_STRICT_RELU>(a, b, bias, c, m, n, k, lda, a_k_contig,
                                  ldb, b_n_contig, ldc, bf16, vec_a, vec_b,
                                  bn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
