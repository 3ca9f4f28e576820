// The tile of one-query int8-KV decode attention, shared by K4
// (cache_attend_int8.cu, a dense slab lane) and K3 (paged_attention_int8.cu,
// pages walked through a page table). Both read the head-major layout: a
// (row or page, head)'s codes are D rows of consecutive positions, so a
// position's D-vector lies across D rows, and per-position f32 scales.
//
// A block of kThreads threads owns one (row, head)'s split of positions and
// walks it in stages of TPS positions (128 at D <= 128, fewer at wider heads
// so that a stage stays near 32 KB, 8 past D = 1024: stage_positions). The
// kernel copies each
// stage into shared memory in two cp.async groups, the K codes with the
// per-position vectors (k_scale, v_scale, and K4's mask), then the V codes,
// so the scores start while the V codes land; a split of several stages runs
// a two-stage ring. Then, per stage (attend_stage):
// - int8 widens exactly through the f32 magic number 2^23 + (c + 128): a
//   byte permute and a subtraction, at the full rate (a conversion
//   instruction runs at a quarter of it);
// - scores: TPS/4 lanes take a quad of positions each and the block's
//   kThreads / (TPS/4) row groups a share of the d-rows (a warp reads 128
//   consecutive bytes of a row); the row groups' partial dots meet in shared
//   memory in a fixed order, then the kernel's score rule gives s;
// - a block max, p = exp(s - max), a block sum, and the weights w kept in
//   f32 (the kernel's weight rule, p * v_scale for a position that counts);
// - values: P lanes a d-row (P = 128 / D where D <= 64), each summing its
//   share of the positions with 16-byte reads into a register; the stages
//   meet by the online-softmax rescale, the P lanes by shuffles at the end
//   (finish_values). Up to D = 1024 a thread holds at most 8 d-rows' sums
//   in registers (a row group or lane past D idles).
// - Past D = 1024 (the wide tile, TPS = 8) the split's f32 accumulator
//   lives in shared memory beside q: each thread reads, rescales and
//   writes back its own d-rows in every stage (8-byte reads of 8 codes a
//   row), so D is any width up to kMaxHeadDim, the widest at which one
//   head's f32 q and accumulator (64 KB) and one stage fit the 227 KB a
//   block may opt in to. Past it K3 and K4 leave the tile for the wide
//   path (wide_attend.cuh), which keeps nothing of the width in shared
//   memory.
// Code rows lie RS = TPS + 16 bytes apart in shared memory, so the eight
// rows a quarter warp reads at one column hit distinct banks; the wide
// tile's 8-byte rows lie back to back (a warp's reads of one column are
// then consecutive words).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace int8_tile {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the widest head the tile takes (past it the wide path), and the widest
// whose value sums a thread holds in registers (8 d-rows); past it the
// wide tile
constexpr int kMaxHeadDim = 8192;
constexpr int kRegisterHeadDim = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a BYTES-byte copy (16, 8 or 4) from global into shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the reduction of `v` over the block (max or sum), in a fixed order;
// every thread gets it. `scratch` holds one float per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  __syncthreads();  // the scratch of a previous reduction has been read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i)
    v = kMax ? fmaxf(v, scratch[i]) : v + scratch[i];
  return v;
}

// the four int8 values of a word, each exactly as f32: 2^23 + (v + 128)
// minus 2^23 + 128 (a byte permute and a subtraction a value, where a
// conversion instruction runs at a quarter of the rate)
__device__ __forceinline__ void widen(uint32_t u, float (&f)[4]) {
  u ^= 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// A stage's layout: K code rows (D rows of TPS codes, RS bytes apart), V
// code rows alike, then NV per-position float vectors of TPS (k_scale,
// v_scale and, in K4, the mask).
template <int TPS, int NV>
struct Stage {
  static constexpr int RS = TPS >= 16 ? TPS + 16 : TPS;
  __host__ __device__ static constexpr int bytes(int D) {
    return 2 * D * RS + NV * TPS * 4;
  }
};

// the stage width (positions) for head width D
__host__ __device__ constexpr int stage_positions(int D) {
  return D <= 128
             ? 128
             : (D <= 256 ? 64
                         : (D <= 512 ? 32 : (D <= kRegisterHeadDim ? 16 : 8)));
}

// D rounded up to whole 16-byte groups of floats: q and the split's acc
// take this many each, so what follows them stays 16-byte aligned at any D
__host__ __device__ constexpr int padded(int D) { return (D + 3) & ~3; }

// the shared memory a block's tile takes besides its stages: q, the
// split's acc (padded(D) each), the partial dots (RG x TPS = 512) and the
// weights
__host__ __device__ constexpr int work_floats(int D, int TPS) {
  return 2 * padded(D) + 4 * kThreads + TPS;
}

// The block's running state over its stages: every thread holds the same
// max and sum of p, and the value sums of its d-rows (in shared memory in
// the wide tile, TPS = 8).
template <int TPS>
struct Running {
  static constexpr bool kWide = TPS < 16;
  static constexpr int RPT = kWide ? 1 : kThreads / TPS;  // d-rows a thread
  float m = -INFINITY, l = 0.f;
  float acc[RPT] = {};
};

// the wide tile's accumulator starts at zero (each thread its own d-rows,
// the ones it rescales and adds to in every stage)
template <int TPS>
__device__ __forceinline__ void start_values(float* sm_acc, int D) {
  if constexpr (Running<TPS>::kWide)
    for (int d = threadIdx.x; d < D; d += kThreads) sm_acc[d] = 0.f;
}

// The value pass's split of the d-rows: P lanes share a row (P = 128 / D
// rounded down to a power of two where D <= 128, else 1).
__device__ __forceinline__ int lanes_a_row(int D) {
  return D >= kThreads ? 1 : (D > 32 ? (D > 64 ? 1 : 2) : 4);
}

// One stage of `count` positions (1..TPS; the rest of the stage counts for
// nothing) at `st`, whose K half is the newest-but-one copy group pair in
// flight and V half the newest-but-two when `more` (the next stage's two
// groups are in flight behind it), else the last two. sm_q holds q (D,
// f32). score(vec, t, dot) gives position t's score from its q.k dot and
// weight(vec, t, p) its value weight, `vec` the stage's float vectors;
// both are called for t < TPS only.
template <int TPS, int NV, typename Score, typename Weight>
__device__ __forceinline__ void attend_stage(
    const char* st, const float* sm_q, float* sm_part, float* sm_w,
    float* sm_red, float* sm_acc, int D, int count, bool more,
    Running<TPS>& run, Score score, Weight weight) {
  constexpr int RS = Stage<TPS, NV>::RS;
  constexpr int Q = TPS / 4;          // lanes of a row in the score pass
  constexpr int RG = kThreads / Q;    // row groups of the score pass
  const int tid = threadIdx.x;
  if (more)
    cp_async_wait<3>();
  else
    cp_async_wait<1>();
  __syncthreads();  // the stage's K half has landed for every thread
  const int8_t* sk = reinterpret_cast<const int8_t*>(st);
  const int8_t* sv = sk + D * RS;
  const float* vec = reinterpret_cast<const float*>(sv + D * RS);

  // 1. partial dots: quad `quad` of row group `rg`'s d-rows
  {
    const int quad = tid % Q, rg = tid / Q;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    if (4 * quad < count) {
#pragma unroll 4
      for (int d = rg; d < D; d += RG) {
        float c[4];
        widen(*reinterpret_cast<const uint32_t*>(sk + d * RS + 4 * quad), c);
        const float qd = sm_q[d];
        s0 = fmaf(qd, c[0], s0);
        s1 = fmaf(qd, c[1], s1);
        s2 = fmaf(qd, c[2], s2);
        s3 = fmaf(qd, c[3], s3);
      }
    }
    reinterpret_cast<float4*>(sm_part)[rg * Q + quad] =
        make_float4(s0, s1, s2, s3);
  }
  __syncthreads();
  // 2. scores, the block max, p and the weights
  float s = -INFINITY;
  if (tid < TPS) {
    float dot = sm_part[tid];
#pragma unroll
    for (int r = 1; r < RG; ++r) dot += sm_part[r * TPS + tid];
    s = score(vec, tid, dot);
  }
  // the stage's first position counts, so the max is a real score
  const float mx = fmaxf(run.m, block_reduce<true>(s, sm_red));
  // 0 on the first stage (exp(-inf)); 1 while the max stays
  const float alpha = expf(run.m - mx);
  float p = 0.f;
  if (tid < TPS) {
    p = expf(s - mx);
    sm_w[tid] = weight(vec, tid, p);
  }
  if (more)  // the stage's V half
    cp_async_wait<2>();
  else
    cp_async_wait<0>();
  // the reduction's barriers also publish the weights and the V half
  run.l = run.l * alpha + block_reduce<false>(p, sm_red);
  run.m = mx;

  // 3. values: acc = acc * alpha + sum over the part's positions of w v
  if constexpr (Running<TPS>::kWide) {
    // one lane a d-row, its 8 codes in one read, its sum in shared memory
    for (int d = tid; d < D; d += kThreads) {
      const uint2 u = *reinterpret_cast<const uint2*>(sv + d * RS);
      float c[2][4];
      widen(u.x, c[0]);
      widen(u.y, c[1]);
      float a = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) a = fmaf(sm_w[t], c[t / 4][t % 4], a);
      sm_acc[d] = fmaf(sm_acc[d], alpha, a);
    }
    __syncthreads();  // the stage's buffer and the weights are free
    return;
  }
  const int P = lanes_a_row(D);
  const int rows_per_pass = kThreads / P;
  const int part = tid % P;
  const int seg = TPS / P;            // positions of a part, a multiple of 16
  const int end = min(seg, count - part * seg);
#pragma unroll
  for (int r = 0; r < Running<TPS>::RPT; ++r) {
    const int d = tid / P + r * rows_per_pass;
    if (d < D) {
      const int8_t* row = sv + d * RS + part * seg;
      const float4* w4 = reinterpret_cast<const float4*>(sm_w + part * seg);
      float a = 0.f;
      for (int t = 0; t < end; t += 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + t);
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float c[4];
          widen(words[i], c);
          const float4 w = w4[t / 4 + i];
          a = fmaf(w.x, c[0], a);
          a = fmaf(w.y, c[1], a);
          a = fmaf(w.z, c[2], a);
          a = fmaf(w.w, c[3], a);
        }
      }
      run.acc[r] = run.acc[r] * alpha + a;
    }
  }
  __syncthreads();  // the stage's buffer and the weights are free
}

// the P lanes of a row meet (consecutive lanes, by shuffles) and the
// split's acc goes to sm_acc (D floats), published by a barrier
template <int TPS>
__device__ __forceinline__ void finish_values(const Running<TPS>& run,
                                              float* sm_acc, int D) {
  if constexpr (Running<TPS>::kWide) return;  // sm_acc holds it already
  const int tid = threadIdx.x;
  const int P = lanes_a_row(D);
  const int rows_per_pass = kThreads / P;
#pragma unroll
  for (int r = 0; r < Running<TPS>::RPT; ++r) {
    float a = run.acc[r];
    for (int o = P / 2; o > 0; o >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    const int d = tid / P + r * rows_per_pass;
    if (tid % P == 0 && d < D) sm_acc[d] = a;
  }
  __syncthreads();
}

}  // namespace int8_tile
