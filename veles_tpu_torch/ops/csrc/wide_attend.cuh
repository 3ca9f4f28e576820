// One split of one-query decode attention past the shared-memory widths,
// shared by K1 (paged_attention.cu), K3 (paged_attention_int8.cu) and K4
// (cache_attend_int8.cu) at head widths past 8192.
//
// Up to 8192 the three kernels stage K and V rows in shared memory and
// keep q and the split's f32 accumulator there too; at 8192 those fill
// the 227 KB a block may opt in to. Past it a block keeps nothing of the
// width in shared memory:
// - q is read from global memory (through L1 and L2) wherever a dot needs
//   it, and K and V too, a group of kGroup positions at a time: the
//   threads stride over d, so a group's row reads are coalesced in the
//   position-major pool, and in the head-major int8 layouts the group's
//   codes of one d share a sector;
// - the split's f32 accumulator is its own row of the merge workspace,
//   acc at ws[(item * splits + split) * D + d] (split_softmax.cuh's
//   layout), read, rescaled and written back by the one thread that owns
//   element d in every group, so it takes no barrier;
// - the group's dots are summed over the block in a fixed order (each
//   warp by shuffles, then the warps in order), and every thread holds the
//   same running (max, sum).
// Shared memory holds kGroup floats a warp, so the width has no upper
// bound but the workspace's memory. The block then ends as the staged
// paths do (split_softmax::finish, which reads the accumulator where it
// lies). Correct first: a group re-reads q from L2, and each position's
// row is read once.
//
// The caller's source `Src` describes one split's positions:
//   float q(int d)              the query, widened to f32
//   void group(int t0, int n)   positions t0 .. t0 + n - 1 of the split
//                               come next (n <= kGroup): read their row
//                               bases, scales and addends
//   float k(int i, int d)       K of the group's position i at d, f32
//   float v(int i, int d)       V of the group's position i at d, f32
//   float score(int i, float dot)   the score of position i from its dot
//   float weight(int i, float p)    the value weight from its softmax p

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wide_attend {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;

// Runs positions 0 .. n_pos - 1 (n_pos >= 1) of `src` into `acc` (D
// floats of global memory, written, never read before the first group) and
// returns the split's max and sum in m and l (the same in every thread).
template <typename Src>
__device__ __forceinline__ void run(Src& src, int n_pos, int D,
                                    float* __restrict__ acc, float& m_out,
                                    float& l_out) {
  __shared__ float red[kGroup][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < n_pos; t0 += kGroup) {
    const int n = min(kGroup, n_pos - t0);
    src.group(t0, n);
    // 1. the group's dots: each thread over its d's, then the block
    float dot[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) dot[i] = 0.f;
    for (int d = tid; d < D; d += kThreads) {
      const float qd = src.q(d);
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (i < n) dot[i] = fmaf(qd, src.k(i, d), dot[i]);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float v = dot[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[i][warp] = v;
    }
    __syncthreads();
    // 2. scores, the running max, the weights, the running sum
    float sc[kGroup], w[kGroup];
    float mx = m;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float s = red[i][0];
#pragma unroll
      for (int r = 1; r < kWarps; ++r) s += red[i][r];
      sc[i] = i < n ? src.score(i, s) : -INFINITY;
      mx = fmaxf(mx, sc[i]);
    }
    __syncthreads();  // red is free for the next group
    const float alpha = expf(m - mx);  // 0 on the first group
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float p = i < n ? expf(sc[i] - mx) : 0.f;
      psum += p;
      w[i] = i < n ? src.weight(i, p) : 0.f;
    }
    l = l * alpha + psum;
    m = mx;
    // 3. values: each thread its own d's of the accumulator
    for (int d = tid; d < D; d += kThreads) {
      float a = t0 ? acc[d] * alpha : 0.f;
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (i < n) a = fmaf(w[i], src.v(i, d), a);
      acc[d] = a;
    }
  }
  m_out = m;
  l_out = l;
}

}  // namespace wide_attend
