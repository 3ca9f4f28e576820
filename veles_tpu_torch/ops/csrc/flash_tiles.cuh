// Tile helpers shared by the flash-attention kernels: the mma.sync kernels
// of K7 (forward, flash_attention.cu: fwd_wide), K8 and
// K9 (backward, flash_attention_bwd.cu: dkv_wide, dq_wide), and the
// constants and small helpers (Strides, pack, allow_smem) that the wgmma
// kernels of both files take from here.
//
// The mma.sync kernels run their bf16 products on the tensor cores through
// mma.sync.m16n8k16 (bf16 operands, f32 accumulator), whose fragment
// layouts the PTX ISA fixes. With lane = threadIdx.x % 32, g = lane / 4
// and c = lane % 4, a warp holds:
//   A (16 x 16, row-major): reg 0 = A[g][2c, 2c+1], reg 1 = A[g+8][2c,
//     2c+1], reg 2 = A[g][2c+8, 2c+9], reg 3 = A[g+8][2c+8, 2c+9];
//   B (16 x 8, k x n):      reg 0 = B[2c, 2c+1][g], reg 1 = B[2c+8,
//     2c+9][g];
//   C (16 x 8, f32):        c[0], c[1] = C[g][2c, 2c+1], c[2], c[3] =
//     C[g+8][2c, 2c+1].
// Two neighbouring C tiles (16 x 16 together) are therefore exactly the
// registers of an A fragment once packed to bf16: a score tile computed
// by one product feeds the next product from registers (the
// FlashAttention-2 arrangement), with no trip through shared memory.
// Every register pair packs the lower column in the lower half.
//
// Tiles live in shared memory row-major with rows padded by 8 elements
// (16 bytes): the 8 row groups of a fragment load then fall on 8
// different bank quads, so fragment loads are conflict-free.
//
// Head widths: the wgmma kernels (sm90.cuh) hold a whole row of the width
// they are built for (K7 at 128 and 256, K8 and K9 at 128). Every other
// multiple of 128 runs a "wide" kernel here: a grid axis over the output's
// 128-wide column chunks (kChunk), each block summing its scores over the
// full width in 128-wide steps through shared memory and writing only
// its own chunk; the score work repeats once a chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_tiles {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps a block
constexpr int kChunk = 128;    // the wide kernels' output column chunk
constexpr int kPad = 8;        // row padding of a shared tile, elements
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// element strides of a (B, T, H, D) operand (the head axis contiguous)
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 of one row
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column, `ld` elements apart
__device__ __forceinline__ uint32_t ld_column(const bf16* p, int ld) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[ld];
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b on the tensor cores
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a
// row-major shared tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bf16* p = s + (r0 + g) * ld + c0 + 2 * c;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// The A fragment of a 16 x 16 tile held as two C tiles (columns 0-7 in
// lo, 8-15 in hi), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// B = M^T for the 16 x 8 block M[n0 .. n0+8][k0 .. k0+16] of a row-major
// tile (k along the row): the score product's B, keys or queries as n.
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int ld, int n0,
                                            int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * c;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// B = the 16 x 8 block M[k0 .. k0+16][n0 .. n0+8] of a row-major tile (k
// down the column): the value-side products' B, d as n.
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int ld, int k0,
                                            int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bf16* p = s + (k0 + 2 * c) * ld + n0 + g;
  b0 = ld_column(p, ld);
  b1 = ld_column(p + 8 * ld, ld);
}

// Copy rows [r0, r0 + R) of a (rows, D) matrix whose rows lie `st`
// elements apart (D contiguous, 16-byte aligned) into a shared tile [R][LD]
// (LD * sizeof(T) a multiple of 16); rows at or past `rows` are zero.
// THREADS threads share the copy.
template <typename T, int D, int R, int LD, int THREADS = kThreads>
__device__ __forceinline__ void load_rows(T* s, const T* __restrict__ g,
                                          long long st, int r0, int rows) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte vector
  constexpr int PER_ROW = D / V;
  for (int i = threadIdx.x; i < R * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(g + (r0 + r) * st + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// Store a warp's 16 x W f32 accumulator (rows r0 + g scaled by f0, rows
// r0 + g + 8 by f1) as bf16 into columns [col0, col0 + W) of a contiguous
// (B, T, H, D) output; rows at or past T are skipped. The wide kernels'
// store of one 128-wide column chunk.
template <int W>
__device__ __forceinline__ void store_chunk(bf16* __restrict__ out,
                                            const float (&acc)[W / 8][4],
                                            int b, int h, int H, int T, int D,
                                            int col0, int r0, float f0,
                                            float f1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T) continue;
    const float f = half ? f1 : f0;
    bf16* p = out + (((long long)b * T + row) * H + h) * D + col0 + 2 * c;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack(acc[n][2 * half] * f, acc[n][2 * half + 1] * f);
  }
}

// the row max / sum over the four lanes that share a fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Let a kernel take `bytes` of dynamic shared memory (above 48 KB only
// after this call); the cudaError_t of the call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash_tiles
