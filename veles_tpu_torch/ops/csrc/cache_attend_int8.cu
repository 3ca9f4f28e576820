// Dense int8-KV decode attention: one query per (row, head) against the
// row's int8 cache lane in the head-major (B, H, D, T) layout, dequantized
// by the per-position scales inside the dots, under an additive mask, with
// an f32 softmax.
//
// Replaces: veles_tpu/ops/quant.py _attend_kernel via _pallas_cache_attend
// (quant.py:161-218, gate :245), which the dense slot slab's int8-KV decode
// step calls once per block (decode.py:612-616).
//
// What bounds it on the H100: bytes. Every position of the lane is read
// (the mask is data, not a length): one int8 K and V code per (head, d)
// and two f32 scales per head, 2 * H * (D + 4) bytes a position, for
// 4 * D operations per head: far below the compute line.
//
// Layout. Positions are minor: row d of one (row, head) holds T
// consecutive codes, and a position's D-vector lies across D rows. The
// slot engine hands the kernel a view of its slab cut to the attended span
// (`span` < the slab's max_len), so rows are `sd` elements apart, not T:
// the kernel takes the strides of the codes, the scales and the mask and
// reads the view in place (no copy of the slab).
//
// Design. The TPU kernel ran one grid cell per batch row with a static
// loop over heads and the whole (D, T) tile in VMEM. Here one block of 256
// threads owns one (row, head) and walks the lane in tiles of kTileT
// positions, each in three passes over shared memory holding the tile's
// scores:
//   1. scores: positions go on lanes, four consecutive positions (a quad)
//      to a thread, read with one 4-byte load per d-row, so a warp reads
//      128 consecutive bytes of a row per d; s = (q . k) * k_scale + mask;
//   2. softmax: the block max m of the scores seen so far, p = exp(s - m),
//      the block sum, and the weights w = p * v_scale kept in f32 (the TPU
//      kernel's numerics; JAX's XLA formulation rounds them to bf16 for a
//      bf16 q, which this kernel does not);
//   3. values: one warp per d-row, lanes over quads, a shuffle sum into
//      that row's f32 accumulator.
// Across tiles the accumulators and the running sum of p are rescaled by
// exp(old max - new max), an online softmax; a lane of one tile (every
// smoke shape) computes exactly the one-pass sums. out = acc / sum p.
// A masked position's addend (-1e30) makes its exp an exact zero once a
// visible position has set the max. q is pre-scaled by 1/sqrt(D) by the
// caller. Simple first: no split of T over blocks, no cp.async/TMA, one
// wave of B * H blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// d-rows read per unrolled step of the score pass (D % 16 == 0)
constexpr int kRowUnroll = 16;
// positions a tile: its f32 scores, then weights, live in shared memory
constexpr int kTileT = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the reduction of `v` over the block (max or sum); every thread gets it
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

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
cache_attend_int8_kernel(const TQ* __restrict__ q,
                         const int8_t* __restrict__ k_q,
                         const float* __restrict__ k_scale,
                         const int8_t* __restrict__ v_q,
                         const float* __restrict__ v_scale,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int H, int D, int T,
                         long long code_sb, long long code_sh,
                         long long code_sd, long long scale_sb,
                         long long scale_sh, long long mask_sb) {
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // D floats
  float* sm_acc = sm_q + D;                       // D floats
  float4* sm_w = smem4 + D / 2;                   // kTileT / 4 quads
  __shared__ float sm_red[kWarps];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t code0 = (size_t)b * code_sb + (size_t)h * code_sh;
  const size_t scale0 = (size_t)b * scale_sb + (size_t)h * scale_sh;
  const int8_t* krow = k_q + code0;
  const int8_t* vrow = v_q + code0;
  const float4* ks4 = reinterpret_cast<const float4*>(k_scale + scale0);
  const float4* vs4 = reinterpret_cast<const float4*>(v_scale + scale0);
  const float4* mask4 =
      reinterpret_cast<const float4*>(mask + (size_t)b * mask_sb);

  for (int d = tid; d < D; d += kThreads) {
    sm_q[d] = to_f32(q[((size_t)b * H + h) * D + d]);
    sm_acc[d] = 0.f;
  }
  __syncthreads();

  // every thread holds the same running max and sum of p
  float run_max = -INFINITY, run_sum = 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileT) {
    const int n_quads = min(T - t0, kTileT) >> 2;
    const int g0 = t0 >> 2;

    // 1. scores of this thread's quads into shared memory
    float m = -INFINITY;
    for (int g = tid; g < n_quads; g += kThreads) {
      const int8_t* kt = krow + t0 + (g << 2);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d0 = 0; d0 < D; d0 += kRowUnroll) {
#pragma unroll
        for (int j = 0; j < kRowUnroll; ++j) {
          const char4 c = __ldg(reinterpret_cast<const char4*>(
              kt + (size_t)(d0 + j) * code_sd));
          const float qd = sm_q[d0 + j];
          s0 = fmaf(qd, (float)c.x, s0);
          s1 = fmaf(qd, (float)c.y, s1);
          s2 = fmaf(qd, (float)c.z, s2);
          s3 = fmaf(qd, (float)c.w, s3);
        }
      }
      const float4 ks = __ldg(ks4 + g0 + g);
      const float4 mk = __ldg(mask4 + g0 + g);
      const float4 s = make_float4(fmaf(s0, ks.x, mk.x),
                                   fmaf(s1, ks.y, mk.y),
                                   fmaf(s2, ks.z, mk.z),
                                   fmaf(s3, ks.w, mk.w));
      sm_w[g] = s;
      m = fmaxf(m, fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w)));
    }
    // every position has a finite score, so the block max is finite and a
    // thread that saw no quad (m = -inf) changes nothing
    const float mx = fmaxf(run_max, block_reduce<true>(m, sm_red));
    // 0 on the first tile (exp(-inf)); 1 while the max stays
    const float alpha = expf(run_max - mx);

    // 2. p = exp(s - max); the weights p * v_scale replace the scores
    float l = 0.f;
    for (int g = tid; g < n_quads; g += kThreads) {
      const float4 s = sm_w[g];
      const float4 vs = __ldg(vs4 + g0 + g);
      const float p0 = expf(s.x - mx), p1 = expf(s.y - mx);
      const float p2 = expf(s.z - mx), p3 = expf(s.w - mx);
      l += (p0 + p1) + (p2 + p3);
      sm_w[g] = make_float4(p0 * vs.x, p1 * vs.y, p2 * vs.z, p3 * vs.w);
    }
    // the reduction's barriers also publish every thread's weights
    run_sum = run_sum * alpha + block_reduce<false>(l, sm_red);
    run_max = mx;

    // 3. one warp per d-row: acc[d] = acc[d] * alpha + sum_t w[t] v[d, t]
    for (int d = warp; d < D; d += kWarps) {
      const int8_t* row = vrow + (size_t)d * code_sd + t0;
      float a = 0.f;
#pragma unroll 4
      for (int g = lane; g < n_quads; g += 32) {
        const char4 c = __ldg(reinterpret_cast<const char4*>(row + (g << 2)));
        const float4 w = sm_w[g];
        a = fmaf(w.x, (float)c.x, a);
        a = fmaf(w.y, (float)c.y, a);
        a = fmaf(w.z, (float)c.z, a);
        a = fmaf(w.w, (float)c.w, a);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      // lane 0 of the row's warp alone reads and writes its accumulator
      if (lane == 0) sm_acc[d] = sm_acc[d] * alpha + a;
    }
    __syncthreads();  // the next tile's scores overwrite the weights
  }

  const float inv_l = 1.f / run_sum;
  if (lane == 0)
    for (int d = warp; d < D; d += kWarps)
      out[((size_t)b * H + h) * D + d] = sm_acc[d] * inv_l;
}

template <typename TQ>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* mask, void* out, int B, int H, int D,
           int T, long long code_sb, long long code_sh, long long code_sd,
           long long scale_sb, long long scale_sh, long long mask_sb,
           cudaStream_t stream) {
  // the query, the accumulators and one tile of weights: at most
  // (2 * 1024 + 8192) * 4 bytes, under the 48 KB default
  const int tile = T < kTileT ? T : kTileT;
  const size_t smem = (size_t)(2 * D + tile) * sizeof(float);
  cache_attend_int8_kernel<TQ><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const float*>(mask),
      static_cast<float*>(out), H, D, T, code_sb, code_sh, code_sd, scale_sb,
      scale_sh, mask_sb);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, 1, H, D) contiguous, pre-scaled by 1/sqrt(D); k_q / v_q int8 with
// element strides (code_sb, code_sh, code_sd, 1) over (B, H, D, T);
// k_scale / v_scale float32 with strides (scale_sb, scale_sh, 1) over
// (B, H, T); mask float32 addend with strides (mask_sb, 1) over (B, T),
// mask_sb = 0 for one mask shared by every row; out (B, 1, H, D) float32
// contiguous. Every stride a multiple of 4, codes 4-byte and scales and
// mask 16-byte aligned; T % 4 == 0, 16 <= D <= 1024 with D % 16 == 0 (the
// query and accumulators beside one tile within 48 KB of shared memory).
// q type: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int veles_cache_attend_int8(
    const void* q, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* mask, void* out, int B, int H, int D,
    int T, int q_dtype, long long code_sb, long long code_sh,
    long long code_sd, long long scale_sb, long long scale_sh,
    long long mask_sb, void* stream) {
  if (B < 1 || H < 1 || D < kRowUnroll || D % kRowUnroll || D > 1024 ||
      T < 4 || T % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch<float>(q, k_q, k_scale, v_q, v_scale, mask, out, B, H, D,
                           T, code_sb, code_sh, code_sd, scale_sb, scale_sh,
                           mask_sb, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_q, k_scale, v_q, v_scale, mask, out,
                                   B, H, D, T, code_sb, code_sh, code_sd,
                                   scale_sb, scale_sh, mask_sb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
