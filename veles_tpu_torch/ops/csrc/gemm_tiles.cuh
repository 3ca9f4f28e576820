// The true-f32 tile GEMM shared by K5 (gemm.cu, the plain product) and
// K6 (dense_epilogue.cu, the product with a bias + activation epilogue)
// for float32 operands (precision levels 1 and 2, the agreement runs);
// bf16 operands run the Hopper mainloop of gemm_sm90.cuh.
//
// Replaces the TPU kernels _mm_kernel and _mm_epilogue_kernel
// (veles_tpu/ops/gemm.py:133, :199) at Precision.HIGHEST. What they
// compute: C = A @ B with an f32 accumulator, the epilogue applied to the
// f32 tile before the single store. What bounds it on the H100: at the
// training path's shapes (26.3 GFLOP each) the operations at the f32
// rate outside the tensor cores, 0.39 ms at 67 TFLOP/s.
//
// Design (simple, no TMA or pipelining):
// - One 256-thread block per 128 x 128 output tile; a loop over K in
//   tiles replaces the TPU grid's sequential K dimension, so nothing
//   carries between blocks. Each thread owns 8 x 8 outputs and runs true
//   f32 FMA (never TF32).
// - Ragged edges are masked, not padded: a tile element past M, N or K
//   loads as zero (zero adds nothing to a sum) and a store past M or N is
//   skipped. No operand is copied.
// - A and B are read in place through a leading stride, either layout:
//   A (m, k) with k contiguous or with m contiguous (x.T of a row-major
//   x), B (k, n) with n contiguous or with k contiguous (w.T). A tile
//   keeps its global layout in shared memory (the contiguous axis
//   innermost), so loads are 16 bytes wide along it where the stride and
//   the pointer allow; the layouts are template arguments (a transposing
//   copy into one fixed layout hit 16-way bank conflicts on its stores).
// - The epilogue (epilogue.cuh) adds the bias and applies the activation
//   to each f32 accumulator before its store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace gemm_tiles {

using namespace epilogue;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int EPI>
__device__ __forceinline__ float apply(float acc, const float* bias,
                                       int col) {
  if (EPI == EPI_NONE) return acc;
  return activate<EPI>(acc + bias[col]);
}

// Load the R x C tile at (r0, c0) of a rows x cols matrix whose rows lie
// ld elements apart (columns contiguous) into s[r][c] (row stride LD).
// Out-of-range elements load as zero. vec: 16-byte loads are allowed (ld
// a multiple of the vector and g 16-byte aligned).
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g,
                                          long long ld, bool vec, int r0,
                                          int c0, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < R * C / V; idx += THREADS) {
    int r = idx / (C / V), c = (idx % (C / V)) * V;
    int gr = r0 + r, gc = c0 + c;
    T* dst = s + r * LD + c;
    if (vec && gr < rows && gc + V <= cols) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + gr * ld + gc);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        dst[v] = (gr < rows && gc + v < cols) ? g[gr * ld + gc + v]
                                              : T(0);
    }
  }
}

struct Problem {
  const void* a;
  const void* b;
  const float* bias;
  void* c;
  int m, n, k;
  long long lda, ldb, ldc;
  bool a_k_contig;  // A (m, k) at a[m * lda + k]; else a[k * lda + m]
  bool b_n_contig;  // B (k, n) at b[k * ldb + n]; else b[n * ldb + k]
  bool vec_a, vec_b;
};

// The K-tile step of A (m, k) and B (k, n) into shared memory, each in its
// global layout: A_COL means m contiguous (tile [BK][BM]), else k
// contiguous ([BM][BK]); B_COL means k contiguous ([BN][BK]), else n
// contiguous ([BK][BN]). LDA/LDB are the tiles' row strides.
template <typename T, int BK, bool A_COL, bool B_COL, int LDA, int LDB>
__device__ __forceinline__ void load_tiles(T* sa, T* sb, const Problem& p,
                                           int m0, int n0, int k0) {
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  if constexpr (A_COL)
    load_tile<T, BK, BM, LDA>(sa, a, p.lda, p.vec_a, k0, m0, p.k, p.m);
  else
    load_tile<T, BM, BK, LDA>(sa, a, p.lda, p.vec_a, m0, k0, p.m, p.k);
  if constexpr (B_COL)
    load_tile<T, BN, BK, LDB>(sb, b, p.ldb, p.vec_b, n0, k0, p.n, p.k);
  else
    load_tile<T, BK, BN, LDB>(sb, b, p.ldb, p.vec_b, k0, n0, p.k, p.n);
}

// ---- f32 operands: true f32 FMA --------------------------------------------
constexpr int BK32 = 16;
// row strides padded by 4 elements: rows stay 16-byte aligned
constexpr int PAD32 = 4;

template <typename OutT, int EPI, bool A_COL, bool B_COL>
__global__ void __launch_bounds__(THREADS)
    gemm_f32(Problem p) {
  constexpr int LDA = (A_COL ? BM : BK32) + PAD32;
  constexpr int LDB = (B_COL ? BK32 : BN) + PAD32;
  __shared__ __align__(16) float sa[(A_COL ? BK32 : BM) * LDA];
  __shared__ __align__(16) float sb[(B_COL ? BN : BK32) * LDB];
  int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, i, j < 8
  int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k; k0 += BK32) {
    load_tiles<float, BK32, A_COL, B_COL, LDA, LDB>(sa, sb, p, m0, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float fa[8], fb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int m = ty + 16 * i;
        fa[i] = A_COL ? sa[kk * LDA + m] : sa[m * LDA + kk];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int n = tx + 16 * j;
        fb[j] = B_COL ? sb[n * LDB + kk] : sb[kk * LDB + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  OutT* c = static_cast<OutT*>(p.c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int r = m0 + ty + 16 * i;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int col = n0 + tx + 16 * j;
      if (col < p.n)
        store_out(c + r * p.ldc + col, apply<EPI>(acc[i][j], p.bias, col));
    }
  }
}

template <typename OutT, int EPI, bool A_COL, bool B_COL>
inline void launch_layout(const Problem& p, cudaStream_t stream) {
  dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  gemm_f32<OutT, EPI, A_COL, B_COL><<<grid, THREADS, 0, stream>>>(p);
}

// Launch the f32-operand instantiation for the operands' layouts;
// returns the cudaError_t of the launch.
template <typename OutT, int EPI>
inline int launch(const Problem& p, cudaStream_t stream) {
  bool a_col = !p.a_k_contig, b_col = !p.b_n_contig;
  if (a_col && b_col)
    launch_layout<OutT, EPI, true, true>(p, stream);
  else if (a_col)
    launch_layout<OutT, EPI, true, false>(p, stream);
  else if (b_col)
    launch_layout<OutT, EPI, false, true>(p, stream);
  else
    launch_layout<OutT, EPI, false, false>(p, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm_tiles
