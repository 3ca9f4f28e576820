// Fused paged decode attention, int8-KV tier: one query per (slot, head)
// against the slot's live int8 KV pages, walked through the page table in
// the kernel, dequantized in registers by the per-position scales, with an
// online softmax in f32.
//
// Replaces: veles_tpu/ops/paged_attention.py _int8_kernel via
// paged_attend_int8 (paged_attention.py:201-247, :318-344), which
// kv_pool._paged_slot_step calls once per block in every int8-KV decode
// step (kv_pool.py:413-417).
//
// What bounds it on the H100: bytes. Each live position reads one int8 K
// and V code per (head, d) and two f32 scales per head (2 * H * (D + 4)
// bytes) for 4 * D operations per head: far below the compute line.
//
// Layout. The pool is head-major with positions minor: one block's codes
// are (P, H, D, ps), so one position's D-vector of a head lies across D
// rows, ps bytes apart, and one row holds ps consecutive positions of one
// d. Reading a position's vector per lane group, as the float kernel does,
// would touch D rows per position. So positions go on lanes: a lane owns
// four consecutive positions (a "quad", never split across pages since the
// page size is a multiple of 4) and reads each d-row's four codes with one
// 4-byte load; a warp's 32 lanes read 128 consecutive bytes of a row per d.
// The four scales of a quad are one 16-byte load.
//
// Design. The TPU kernel ran a sequential (slot, page) grid with VMEM
// accumulators. Here one block of 128 threads owns one (slot, head), and
// each thread walks quads tid, tid + 128, ... of the slot's visible
// positions (min(length + 1, PB * ps): position `length`, this step's
// append, is visible; the walk stops at the table's PB pages as the TPU
// grid did). Each thread keeps its own online-softmax state: the running
// max, the running sum and an f32 accumulator per d in registers, so the
// value product is a per-lane FMA over its own positions and needs no
// reduction across lanes per page. The threads' states merge once at the
// end (block max, then one warp-shuffle sum per d and a sum over the four
// warps in shared memory). Masked positions of a quad are selected out
// before the max and the sum, an exact zero as the -1e30 sentinel gives
// in the TPU kernel. q is pre-scaled by 1/sqrt(D) by the caller and is
// not scaled again. Simple first: no split of positions over blocks, no
// cp.async/TMA, one wave of S * H blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
paged_attend_int8_kernel(const TQ* __restrict__ q,
                         const int8_t* __restrict__ k_q,
                         const float* __restrict__ k_scale,
                         const int8_t* __restrict__ v_q,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, int H, int PB, int ps) {
  __shared__ float sm_q[D];
  __shared__ float sm_red[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_vis = min(lengths[s] + 1, PB * ps);
  const int n_quads = (n_vis + 3) >> 2;
  const int* pt = page_table + (size_t)s * PB;

  for (int d = tid; d < D; d += kThreads)
    sm_q[d] = to_f32(q[((size_t)s * H + h) * D + d]);
  __syncthreads();

  float m = -1e30f;
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int g = tid; g < n_quads; g += kThreads) {
    const int t0 = g << 2;
    const int off = t0 % ps;
    const size_t head = (size_t)pt[t0 / ps] * H + h;
    const int8_t* krow = k_q + head * D * ps + off;
    const int8_t* vrow = v_q + head * D * ps + off;
    const float4 ks = __ldg(reinterpret_cast<const float4*>(
        k_scale + head * ps + off));
    const float4 vs = __ldg(reinterpret_cast<const float4*>(
        v_scale + head * ps + off));

    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(krow + d * ps));
      const float qd = sm_q[d];
      sc[0] = fmaf(qd, (float)c.x, sc[0]);
      sc[1] = fmaf(qd, (float)c.y, sc[1]);
      sc[2] = fmaf(qd, (float)c.z, sc[2]);
      sc[3] = fmaf(qd, (float)c.w, sc[3]);
    }
    const float kss[4] = {ks.x, ks.y, ks.z, ks.w};
    const float vss[4] = {vs.x, vs.y, vs.z, vs.w};
    bool ok[4];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = t0 + j < n_vis;  // j = 0 always: t0 < n_vis
      sc[j] *= kss[j];
      if (ok[j]) m_new = fmaxf(m_new, sc[j]);
    }
    const float alpha = expf(m - m_new);
    float w[4];
    l *= alpha;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.f;
      l += p;
      w[j] = ok[j] ? p * vss[j] : 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(vrow + d * ps));
      float a = acc[d] * alpha;
      a = fmaf(w[0], (float)c.x, a);
      a = fmaf(w[1], (float)c.y, a);
      a = fmaf(w[2], (float)c.z, a);
      acc[d] = fmaf(w[3], (float)c.w, a);
    }
    m = m_new;
  }

  // block max: position 0 is always visible, so it is a real score and a
  // thread that saw no quad (m = -1e30, l = 0) weighs an exact zero
  float mx = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) sm_red[warp] = mx;
  __syncthreads();
  mx = sm_red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, sm_red[i]);
  const float wt = expf(m - mx);
  float lw = l * wt;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lw += __shfl_xor_sync(0xffffffffu, lw, o);
  __syncthreads();  // every thread has read sm_red
  if (lane == 0) sm_red[warp] = lw;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float a = acc[d] * wt;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) sm_acc[warp][d] = a;
  }
  __syncthreads();
  float lsum = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) lsum += sm_red[i];
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) a += sm_acc[i][d];
    out[((size_t)s * H + h) * D + d] = a / lsum;
  }
}

template <typename TQ>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* pt, const void* len, void* out, int S,
           int H, int D, int PB, int ps, cudaStream_t stream) {
  const dim3 grid(H, S);
#define VELES_INT8_LAUNCH(DIM)                                               \
  paged_attend_int8_kernel<TQ, DIM><<<grid, kThreads, 0, stream>>>(          \
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),             \
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),         \
      static_cast<const float*>(vs), static_cast<const int*>(pt),            \
      static_cast<const int*>(len), static_cast<float*>(out), H, PB, ps)
  switch (D) {
    case 32: VELES_INT8_LAUNCH(32); break;
    case 64: VELES_INT8_LAUNCH(64); break;
    case 128: VELES_INT8_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VELES_INT8_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q (S, H, D) pre-scaled by 1/sqrt(D); k_q / v_q (P, H, D, ps) int8;
// k_scale / v_scale (P, H, ps) float32; page_table (S, PB) int32; lengths
// (S,) int32; out (S, H, D) float32; all contiguous, pools 16-byte aligned.
// q type: 0 = float32, 1 = bfloat16. D in {32, 64, 128}; ps a multiple of
// 4. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int veles_paged_attend_int8(const void* q, const void* k_q,
                                       const void* k_scale, const void* v_q,
                                       const void* v_scale,
                                       const void* page_table,
                                       const void* lengths, void* out, int S,
                                       int H, int D, int PB, int ps,
                                       int q_dtype, void* stream) {
  if (S < 1 || H < 1 || PB < 1 || ps < 4 || ps % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch<float>(q, k_q, k_scale, v_q, v_scale, page_table,
                           lengths, out, S, H, D, PB, ps, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_q, k_scale, v_q, v_scale, page_table,
                                   lengths, out, S, H, D, PB, ps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
