// K5: the blocked GEMM C = A @ B (f32 accumulator, output f32 or bf16).
//
// Replaces _mm_kernel via pallas_matmul (veles_tpu/ops/gemm.py:133,
// :155). On the training path it computes the weight gradient x.T @ err
// of every eligible dense layer (m 784, k 4096, n 4096 on the wide MLP,
// x.T read in place) and the input gradient err @ w.T of deeper ones. The
// tile machinery, its bound and its design are in gemm_tiles.cuh.

#include "gemm_tiles.cuh"

using namespace gemm_tiles;

// dtype: 0 float32 operands, 1 bfloat16; out_dtype: 0 float32, 1 bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int veles_gemm(const void* a, const void* b, void* c, int m,
                          int n, int k, long long lda, int a_k_contig,
                          long long ldb, int b_n_contig, long long ldc,
                          int dtype, int out_dtype, int vec_a, int vec_b,
                          void* stream) {
  Problem p{a, b, nullptr, c, m, n, k, lda, ldb, ldc,
            a_k_contig != 0, b_n_contig != 0, vec_a != 0, vec_b != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch<__nv_bfloat16, EPI_NONE>(p, dtype == 1, s);
  return launch<float, EPI_NONE>(p, dtype == 1, s);
}
