// The split softmax of one-query decode attention, shared by K1
// (paged_attention.cu) and K4 (cache_attend_int8.cu).
//
// Both kernels cut each (row, head)'s positions into splits, one block a
// split, so that a decode call spreads over the whole card. A block ends
// with its split's softmax state in f32: the max m of its scores, the sum
// l of exp(s - m) and acc[d] = sum_t exp(s_t - m) * w_t * v[t, d]. The
// splits meet in the same launch: each block writes its state to a
// workspace the wrapper keeps per stream, and the last block of the
// (row, head) to arrive, found by an acquire-release counter, merges the
// states in split order by the online-softmax rule,
//     M = max_s m_s,  out[d] = sum_s acc_s[d] exp(m_s - M)
//                              / sum_s l_s exp(m_s - M),
// and resets the counter to 0 for the next call. The order is fixed, so
// two calls give bit-equal outputs. A split whose positions are all
// masked (-1e30) has m_s = -1e30 and weight exp(-1e30 - M) = 0 beside a
// visible one; where every split is masked, M = -1e30 and every weight is
// 1: the uniform softmax of an all-masked row, as one pass gives it.
//
// Workspace layout for `items` (row, head) pairs of at most `splits`
// splits: acc at ws[(item * splits + s) * D + d], then (m, l) at
// ws[items * splits * D + (item * splits + s) * 2 + {0, 1}].

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split_softmax {

// the most splits a (row, head) may have (the plans in ops/quant.py and
// ops/paged_attention.py stay within it): the merge walks them all in
// one block
constexpr int kMaxSplits = 256;

// add 1 to a counter with release and acquire semantics at the device's
// scope; returns the old count
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// The end of a block that holds split `split` of item `item`'s state: m
// and l (the same in every thread) and acc[D] in shared memory, or, past
// the staged widths (wide_attend.cuh), in the split's own row of the
// workspace already (read after a barrier). With one split it writes out[d] = acc[d] / l itself;
// otherwise it writes its state, counts itself in counters[item] against
// `arrivals` (the item's number of splits that reach this point), and the
// last block merges: each thread walks the splits in order for its
// outputs, kBatch splits at a time (one L2 round trip for each batch),
// rescaling its sums to each batch's max (the online-softmax rule).
template <int THREADS>
__device__ __forceinline__ void finish(const float* acc, float m, float l,
                                       int D, int item, int split,
                                       int splits, int arrivals, int items,
                                       float* __restrict__ ws,
                                       int* __restrict__ counters,
                                       float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (arrivals == 1) {
    const float inv_l = 1.f / l;
    for (int d = tid; d < D; d += THREADS) out[d] = acc[d] * inv_l;
    return;
  }
  const size_t row = (size_t)item * splits;
  float* ws_acc = ws + row * D;
  float* ws_ml = ws + (size_t)items * splits * D + row * 2;
  if (acc != ws_acc + (size_t)split * D)
    for (int d = tid; d < D; d += THREADS)
      ws_acc[(size_t)split * D + d] = acc[d];
  if (tid == 0) {
    ws_ml[2 * split] = m;
    ws_ml[2 * split + 1] = l;
  }
  // the block's state is ordered before thread 0's release (the barrier),
  // and the last block's reads after its acquire (the barrier)
  __shared__ int last;
  __syncthreads();
  if (tid == 0) last = arrive(counters + item) == arrivals - 1;
  __syncthreads();
  if (!last) return;

  constexpr int kBatch = 8;
  for (int d0 = 0; d0 < D; d0 += THREADS) {
    const int d = d0 + tid;
    float mx = -INFINITY, lsum = 0.f, a = 0.f;
    for (int s0 = 0; s0 < arrivals; s0 += kBatch) {
      float ms[kBatch], ls[kBatch], as[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int s = s0 + i;
        if (s < arrivals) {
          ms[i] = __ldcg(ws_ml + 2 * s);
          ls[i] = __ldcg(ws_ml + 2 * s + 1);
          as[i] = d < D ? __ldcg(ws_acc + (size_t)s * D + d) : 0.f;
        }
      }
      // the batch's max first, then its weights side by side: 0 for
      // everything before the first batch (exp(-inf)); a split all of
      // whose positions are masked weighs exp(-1e30 - M) = 0 beside a
      // visible one, and 1 where every split is masked
      float next = mx;
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (s0 + i < arrivals) next = fmaxf(next, ms[i]);
      const float keep = expf(mx - next);
      lsum *= keep;
      a *= keep;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (s0 + i < arrivals) {
          const float w = expf(ms[i] - next);
          lsum = fmaf(ls[i], w, lsum);
          a = fmaf(as[i], w, a);
        }
      }
      mx = next;
    }
    if (d < D) out[d] = a / lsum;
  }
  if (tid == 0) counters[item] = 0;
}

}  // namespace split_softmax
