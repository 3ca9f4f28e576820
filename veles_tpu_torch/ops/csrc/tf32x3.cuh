// The 3xTF32 arithmetic shared by the flash kernels' f32 routes: K7's
// fwd_tf32 (flash_attention.cu) and K8 and K9's dkv_tf32 and dq_tf32
// (flash_attention_bwd.cu). Each f32 product runs on the tensor cores as
// three TF32 products (mma.sync m16n8k8) of operands split into hi and lo
// in registers; every kernel of the route is a block of eight warps, 16
// of its own rows a warp, walking the other axis in tiles that come
// through a two-stage cp.async ring of 128-wide column chunks in padded
// shared memory.

#pragma once

#include "flash_tiles.cuh"
#include "int8_tile.cuh"  // cp_async

namespace tf32x3 {

using flash_tiles::kChunk;

constexpr int kT32Threads = 256;  // eight warps, 16 of the block's rows each
// rows padded by 4 floats (a row stride of 4 mod 32 banks): every
// fragment load of a warp, eight rows by four columns or four row pairs
// by eight columns, falls on 32 distinct banks
constexpr int kT32LD = kChunk + 4;

// Copy rows [r0, r0 + R) of one 128-wide column chunk (`g` points at its
// first column; rows `st` floats apart) into a shared tile [R][kT32LD]
// by cp.async; rows at or past `rows` are stored as zeros.
template <int R>
__device__ __forceinline__ void rows_async(float* s, const float* g,
                                           long long st, int r0, int rows) {
  constexpr int kVecs = kChunk / 4;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < R * kVecs; i += kT32Threads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float* dst = s + r * kT32LD + c;
    if (r0 + r < rows)
      int8_tile::cp_async<16>(dst, g + (r0 + r) * st + c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// x rounded to TF32 (round to nearest, ties away from zero: f32 bits are
// sign and magnitude, so adding half of the lowest kept bit rounds the
// magnitude), the low 13 bits zero: cvt.rna.tf32.f32 in integer form,
// which stays off the slower conversion pipe (with the conversion K8 3.26
// ms and K9 2.43 against 3.05 and 2.28 at (1, 8192, 4, 128) causal on an
// H100, tools/flash_f32_ab.py)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo for the 3xTF32 products; the mma reads the top 19 bits of
// each (sign, exponent, 10 bits of mantissa) and ignores the rest.
// Rounded to nearest (kNearest), hi = tf32(x) and lo = tf32(x - hi) keep
// 22 significant bits: lo * hi + hi * lo + hi * hi misses x * y by about
// 2^-22 of it, where hi * hi alone misses by 2^-11. Truncated, hi = x's
// top bits and lo = x - hi as the mma reads it: one operation less on
// each side and 2^-20 of error, biased toward zero. dP takes the nearest
// split: dS = P (dP - di) nearly cancels in a row with one dominant key
// (the causal first rows), so dP's error is the one such a row shows;
// S's error is damped by 1/sqrt(D) in the exponent and the value
// products' spreads over their rows (tools/flash_f32_ab.py on an H100:
// K8 + K9 at (1, 8192, 4, 128) causal 6.06 ms nearest everywhere, 5.33
// this way; the worst row, a causal second query, 1.7e-5 of its norm
// either way and 4.5e-5 with dP truncated too).
template <bool kNearest>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kNearest) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// c += a * b on the tensor cores, m16n8k8 with TF32 operands: A (16 x 8)
// a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4];
// B (8 x 8) b0 = B[t][g], b1 = B[t + 4][g]; C as for the bf16 mma (g =
// lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: the two small cross terms first, then the large
// one (CUTLASS's OpMultiplyAddFastF32). The tensor cores round their sums
// toward zero: a sum carried in c across many calls drifts (1.1e-4 of a
// dK row over a walk of 8192 queries against 4.0e-6 summed as here,
// tools/flash_f32_ab.py on an H100), so the callers sum short runs
// from zero and add them up in f32, rounding to nearest.
template <bool kNearest>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split<kNearest>(b0, h0, l0);
  split<kNearest>(b1, h1, l1);
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// the A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a shared
// [.][kT32LD] tile, split
template <bool kNearest>
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float* s, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (r0 + (lane >> 2)) * kT32LD + c0 + (lane & 3);
  split<kNearest>(p[0], hi[0], lo[0]);
  split<kNearest>(p[8 * kT32LD], hi[1], lo[1]);
  split<kNearest>(p[4], hi[2], lo[2]);
  split<kNearest>(p[8 * kT32LD + 4], hi[3], lo[3]);
}

// acc (16 x 128) += P (16 x 8N, C fragments in registers) times the
// walked tile `w` (8N x 128, rows as the product's k). A C fragment
// holds columns 2t and 2t + 1 where an A fragment holds t and t + 4, so
// the k order inside each 8-wide step is permuted: A position t takes
// column 2t, position t + 4 column 2t + 1, and B's rows follow. Each
// 8-wide column block sums the tile's products from zero and adds them
// to acc in f32.
template <bool kNearest, int N>
__device__ __forceinline__ void value_tile(float (&acc)[kChunk / 8][4],
                                           const float (&p)[N][4],
                                           const float* w) {
  const int lane = threadIdx.x & 31;
  const float* col = w + 2 * (lane & 3) * kT32LD + (lane >> 2);
  uint32_t ah[N][4], al[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    split<kNearest>(p[j][0], ah[j][0], al[j][0]);
    split<kNearest>(p[j][2], ah[j][1], al[j][1]);
    split<kNearest>(p[j][1], ah[j][2], al[j][2]);
    split<kNearest>(p[j][3], ah[j][3], al[j][3]);
  }
  // four column blocks at a time: four independent chains of mmas (one
  // chain of 12 left the tensor cores waiting: K8 3.16 ms against 3.05 at
  // (1, 8192, 4, 128) causal on an H100, tools/flash_f32_ab.py)
#pragma unroll
  for (int n0 = 0; n0 < kChunk / 8; n0 += 4) {
    float t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pw = col + 8 * j * kT32LD + 8 * (n0 + i);
        mma3<kNearest>(t[i], ah[j], al[j], pw[0], pw[kT32LD]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + i][e] += t[i][e];
  }
}

// store a warp's 16 x 128 f32 accumulator as columns [col0, col0 + 128)
// of rows r0 .. r0 + 15 of a contiguous (B, T, H, D) output; rows at or
// past T are skipped
__device__ __forceinline__ void store_f32(float* __restrict__ out,
                                          const float (&acc)[kChunk / 8][4],
                                          int b, int h, int H, int T, int D,
                                          int col0, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + (lane >> 2) + 8 * half;
    if (row >= T) continue;
    float* p = out + (((long long)b * T + row) * H + h) * D + col0 +
               2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// The walk of fwd_tf32, dkv_tf32 and dq_tf32: each walked tile is one
// item at head width 128 (scores and values from one stage); at wider heads it is one
// item a 128-wide chunk of the scores, each reloading the block's own
// chunk, then one value item holding the walked tile's output chunk.
__device__ __forceinline__ int items_a_tile(int chunks) {
  return chunks == 1 ? 1 : chunks + 1;
}

}  // namespace tf32x3
