// K5: the blocked GEMM C = A @ B (f32 accumulator, output f32 or bf16).
//
// Replaces _mm_kernel via pallas_matmul (veles_tpu/ops/gemm.py:133,
// :155). On the training path it computes the weight gradient x.T @ err
// of every eligible dense layer (m 784, k 4096, n 4096 on the wide MLP,
// x.T read in place) and the input gradient err @ w.T of deeper ones.
// bf16 operands run the Hopper mainloop of gemm_sm90.cuh (TMA ring,
// wgmma) with no epilogue; f32 operands the true-f32 FMA tile of
// gemm_tiles.cuh. Each header states its bound and design.

#include "gemm_sm90.cuh"
#include "gemm_tiles.cuh"

using namespace gemm_tiles;

// dtype: 0 float32 operands, 1 bfloat16; out_dtype: 0 float32, 1 bfloat16.
// bf16 operands must be 16-byte aligned with a leading stride that is a
// multiple of 8 elements (TMA's rule; the wrapper copies what is not).
// Returns the cudaError_t of the launch, or minus a CUresult when a TMA
// tensor map is refused.
extern "C" int veles_gemm(const void* a, const void* b, void* c, int m,
                          int n, int k, long long lda, int a_k_contig,
                          long long ldb, int b_n_contig, long long ldc,
                          int dtype, int out_dtype, int vec_a, int vec_b,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (out_dtype == 1)
      return gemm_sm90::run(a, b, static_cast<__nv_bfloat16*>(c), m, n, k,
                            lda, a_k_contig == 0, ldb, b_n_contig != 0, ldc,
                            s);
    return gemm_sm90::run(a, b, static_cast<float*>(c), m, n, k, lda,
                          a_k_contig == 0, ldb, b_n_contig != 0, ldc, s);
  }
  Problem p{a, b, nullptr, c, m, n, k, lda, ldb, ldc,
            a_k_contig != 0, b_n_contig != 0, vec_a != 0, vec_b != 0};
  if (out_dtype == 1) return launch<__nv_bfloat16, EPI_NONE>(p, s);
  return launch<float, EPI_NONE>(p, s);
}
