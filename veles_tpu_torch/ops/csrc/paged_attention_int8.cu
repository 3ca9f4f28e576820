// Fused paged decode attention, int8-KV tier: one query per (slot, head)
// against the slot's live int8 KV pages, walked through the page table in
// the kernel, dequantized by the per-position scales inside the dots, with
// an f32 softmax.
//
// Replaces: veles_tpu/ops/paged_attention.py _int8_kernel via
// paged_attend_int8 (paged_attention.py:201-247, :318-344), which
// kv_pool._paged_slot_step calls once per block in every int8-KV decode
// step (kv_pool.py:413-417).
//
// What bounds it on the H100: bytes. Each live position reads one int8 K
// and V code per (head, d) and two f32 scales per head (2 * H * (D + 4)
// bytes) for 4 * D operations per head: far below the compute line. A
// decode call is a few MB spread very unevenly over the slots (one slot
// may hold 1100 positions, its neighbour one), so what sets its time is
// how many bytes the card has in flight and that every SM has its share.
//
// Layout. The pool is head-major with positions minor: one block's codes
// are (P, H, D, ps), so a page's (D, ps) block of one head is contiguous,
// one row holds ps consecutive positions of one d, and the (P, H, ps)
// scales hold a page's ps scales of one head together.
//
// Design. The TPU kernel ran a sequential (slot, page) grid with VMEM
// accumulators. Here the work is cut along the positions, as K1 cuts it
// (paged_attention.cu), and each block runs K4's int8 tile (int8_tile.cuh)
// on pages read through the page table:
// - The plan is K1's (ops/paged_attention._paged_plan, in Python so the
//   CPU tests hold it): splits of whole pages (one 128-token page at the
//   serving shapes, at least 128 positions where the grid still fills the
//   card). The grid runs over (head, split, slot). A slot sees
//   min(length + 1, PB * ps) positions (position `length`, this step's
//   append, is visible; the walk stops at the table's PB pages, as the TPU
//   grid did); a block whose split starts past them exits at once.
// - A block reads the slot's length and its split's page ids in one round
//   trip, then stages its positions in stages of TPS positions (128 at
//   D <= 128, fewer at wider heads, 8 past D = 1024, whole pages or parts
//   of one; past D = 1024 one buffer where two stages do not fit): the K
//   codes with the K and V scales in one cp.async group, the V codes in a
//   second, all issued as the block starts, so the scores start while the V
//   codes land; a split of several stages runs a two-stage ring. Code
//   copies are 16 bytes where the page size is a multiple of 16 (a page's
//   rows then start on 16 bytes and no copy crosses a page), else 4 bytes
//   (the page size is a multiple of 4); a stage copies only its visible
//   positions, rounded up to a copy.
// - Only visible positions count, by selection: a stage position past the
//   split's visible ones gets the score -inf and the weight 0 whatever its
//   shared memory holds (a stale entry of a live page, or bytes never
//   copied), so a NaN or Inf scale there changes nothing (codes widen to
//   finite values always). The scratch page (page 0) pads the table past
//   the live pages and is never read.
// - The splits meet in the same launch (split_softmax.cuh): the number of
//   live splits, ceil(seen / split), is what every block of the slot
//   computes from `lengths[s]` and is the counter's target, so a block that
//   exits never leaves a counter short. The last block merges in split
//   order (deterministic) and resets the counter; a slot with one live
//   split writes its output from that block.
// q is pre-scaled by 1/sqrt(D) by the caller and is not scaled again.
// Past D = 8192 the wide path (wide_attend.cuh) reads q, the codes and the
// scales from global memory and keeps the split's sums in its workspace
// row: no width limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_tile.cuh"
#include "sm90.cuh"           // SmemOptIn
#include "split_softmax.cuh"
#include "wide_attend.cuh"

namespace {

using namespace int8_tile;

constexpr int kVectors = 2;  // k_scale and v_scale a stage
// the largest dynamic shared memory a block may ask for (the opt-in,
// below the H100's 227 KB less the static shared memory); past D = 1024
// the wide tile (8 positions a stage) takes one stage where two do not
// fit (D = 8192: 194 KB)
constexpr int kSmemCap = 192 * 1024;
constexpr int kWideSmemCap = 220 * 1024;

// The copies of the `count` visible positions of the stage whose first
// position is the split's `first` (split-local; the stage's positions lie
// on the split's pages `pages`), as two copy groups: the K codes with
// k_scale and v_scale, then the V codes. Codes in chunks of CV bytes,
// scales in 16-byte chunks (4 positions; never across a page). A chunk's
// column is the same for every chunk a thread copies (TPS / CV divides the
// block), so a thread finds its page once.
template <int TPS, int CV>
__device__ __forceinline__ void load_stage(
    char* st, const int8_t* k_q, const float* k_scale, const int8_t* v_q,
    const float* v_scale, const int* pages, int first, int count, int D,
    int H, int h, int ps) {
  constexpr int RS = Stage<TPS, kVectors>::RS;
  constexpr int kRowChunks = TPS / CV;
  constexpr int kRowStep = kThreads / kRowChunks;  // d-rows a pass
  const int tid = threadIdx.x;
  const int off = (tid % kRowChunks) * CV;
  const bool live = off < count;
  size_t code0 = 0;
  if (live) {
    const int local = first + off;
    code0 = ((size_t)pages[local / ps] * H + h) * D * ps + local % ps;
  }
  // the scale chunks: thread c < TPS / 2 copies 4 positions of k_scale
  // (c < TPS / 4) or of v_scale
  constexpr int kFloatChunks = TPS / 4;
  const int which = tid / kFloatChunks, soff = (tid % kFloatChunks) * 4;
  float* sf = reinterpret_cast<float*>(st + 2 * D * RS);
  if (which < kVectors && soff < count) {
    const int local = first + soff;
    const float* src = (which == 0 ? k_scale : v_scale) +
                       ((size_t)pages[local / ps] * H + h) * ps + local % ps;
    cp_async<16>(sf + which * TPS + soff, src);
  }
  if (live) {
    for (int d = tid / kRowChunks; d < D; d += kRowStep)
      cp_async<CV>(st + d * RS + off, k_q + code0 + (size_t)d * ps);
  }
  cp_async_commit();
  if (live) {
    char* sv = st + D * RS;
    for (int d = tid / kRowChunks; d < D; d += kRowStep)
      cp_async<CV>(sv + d * RS + off, v_q + code0 + (size_t)d * ps);
  }
  cp_async_commit();
}

template <typename TQ, int TPS, int CV>
__global__ void __launch_bounds__(kThreads)
paged_attend_int8_kernel(const TQ* __restrict__ q,
                         const int8_t* __restrict__ k_q,
                         const float* __restrict__ k_scale,
                         const int8_t* __restrict__ v_q,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ counters, int H, int D, int PB,
                         int ps, int pps, int n_buf) {
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // D (padded)
  float* sm_acc = sm_q + padded(D);               // D (padded)
  float* sm_part = sm_acc + padded(D);            // 4 x kThreads
  float* sm_w = sm_part + 4 * kThreads;           // TPS
  char* stages = reinterpret_cast<char*>(sm_w + TPS);
  const int sbytes = Stage<TPS, kVectors>::bytes(D);
  int* sm_pages = reinterpret_cast<int*>(stages + n_buf * sbytes);  // pps
  __shared__ float sm_red[kWarps];

  const int h = blockIdx.x, split = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  // the slot's length and the split's page ids (those in the table) in
  // one round trip: the ids are stored before the length is tested
  const int length = lengths[s];
  const int* pt = page_table + (size_t)s * PB + (size_t)split * pps;
  const int n_tab = min(pps, PB - split * pps);
  for (int i = tid; i < n_tab; i += kThreads) sm_pages[i] = pt[i];
  const int span = pps * ps;         // positions of a split
  const int p0 = split * span;
  const int n_vis = min(length + 1, PB * ps);
  if (p0 >= n_vis) return;           // past the slot's live positions
  const int arrivals = (n_vis + span - 1) / span;
  const int n_pos = min(n_vis - p0, span);
  const int n_st = (n_pos + TPS - 1) / TPS;
  __syncthreads();  // the page ids are in shared memory

  // the first stages' bytes are requested before any arithmetic (every
  // stage's, in a ring of two; with one buffer each stage's as the last
  // one's values are done)
  const bool ring = n_buf > 1;
  load_stage<TPS, CV>(stages, k_q, k_scale, v_q, v_scale, sm_pages, 0,
                      min(TPS, n_pos), D, H, h, ps);
  if (ring && n_st > 1)
    load_stage<TPS, CV>(stages + sbytes, k_q, k_scale, v_q, v_scale,
                        sm_pages, TPS, min(TPS, n_pos - TPS), D, H, h, ps);
  const int item = s * H + h;
  for (int d = tid; d < D; d += kThreads)
    sm_q[d] = to_f32(q[(size_t)item * D + d]);
  start_values<TPS>(sm_acc, D);

  Running<TPS> run;
  for (int j = 0; j < n_st; ++j) {
    const int count = min(TPS, n_pos - j * TPS);
    char* st = stages + (ring ? (j & 1) * sbytes : 0);
    // s = dot * k_scale and w = p * v_scale for a visible position; -inf
    // and 0 for the others, selected, whatever their scales hold
    const auto score = [count](const float* vec, int t, float dot) {
      return t < count ? dot * vec[t] : -INFINITY;
    };
    const auto weight = [count](const float* vec, int t, float p) {
      return t < count ? p * vec[TPS + t] : 0.f;
    };
    attend_stage<TPS, kVectors>(st, sm_q, sm_part, sm_w, sm_red, sm_acc, D,
                                count, ring && j + 1 < n_st, run, score,
                                weight);
    const int next = j + (ring ? 2 : 1);
    if (next < n_st)
      load_stage<TPS, CV>(st, k_q, k_scale, v_q, v_scale, sm_pages,
                          next * TPS, min(TPS, n_pos - next * TPS), D, H, h,
                          ps);
  }
  finish_values(run, sm_acc, D);
  split_softmax::finish<kThreads>(
      sm_acc, run.m, run.l, D, item, split, gridDim.y, arrivals,
      gridDim.z * H, ws, counters, out + (size_t)item * D);
}

template <typename TQ, int TPS, int CV>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* pt, const void* len, void* out,
           void* ws, void* counters, int S, int H, int D, int PB, int ps,
           int pps, cudaStream_t stream) {
  auto kernel = paged_attend_int8_kernel<TQ, TPS, CV>;
  constexpr int cap = Running<TPS>::kWide ? kWideSmemCap : kSmemCap;
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, cap, device);
  if (refused) return refused;
  const int splits = (PB + pps - 1) / pps;
  const size_t fixed = (size_t)work_floats(D, TPS) * sizeof(float) +
                       (size_t)pps * sizeof(int);
  const size_t sbytes = Stage<TPS, kVectors>::bytes(D);
  // a ring of two stages where a split has several and two fit
  const int n_buf = (pps * ps + TPS - 1) / TPS > 1 &&
                            fixed + 2 * sbytes <= (size_t)cap
                        ? 2
                        : 1;
  const size_t smem = fixed + (size_t)n_buf * sbytes;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(H, splits, S), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(len), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, D, PB, ps,
      pps, n_buf);
  return (int)cudaGetLastError();
}

// ---- past kMaxHeadDim: q, codes and scales read from global memory,
// the split's accumulator in its workspace row (wide_attend.cuh) ----

// one split's positions: split-local position t on the split's page
// t / ps of the table, at offset t % ps; a page's (D, ps) codes of one
// head are contiguous, so the group's codes of one d share a sector
template <typename TQ>
struct Int8PagedSource {
  const TQ* qv;
  const int8_t* k_q;
  const float* k_scale;
  const int8_t* v_q;
  const float* v_scale;
  const int* pages;  // the split's page ids in the table
  int ps, H, h, D;
  const int8_t* krow[wide_attend::kGroup];
  const int8_t* vrow[wide_attend::kGroup];
  float ks[wide_attend::kGroup], vs[wide_attend::kGroup];
  __device__ float q(int d) const { return to_f32(qv[d]); }
  __device__ void group(int t0, int n) {
#pragma unroll
    for (int i = 0; i < wide_attend::kGroup; ++i) {
      if (i < n) {
        const int t = t0 + i;
        const size_t head = (size_t)pages[t / ps] * H + h;
        krow[i] = k_q + head * D * ps + t % ps;
        vrow[i] = v_q + head * D * ps + t % ps;
        ks[i] = k_scale[head * ps + t % ps];
        vs[i] = v_scale[head * ps + t % ps];
      }
    }
  }
  __device__ float k(int i, int d) const {
    return (float)krow[i][(size_t)d * ps];
  }
  __device__ float v(int i, int d) const {
    return (float)vrow[i][(size_t)d * ps];
  }
  __device__ float score(int i, float dot) const { return dot * ks[i]; }
  __device__ float weight(int i, float p) const { return p * vs[i]; }
};

template <typename TQ>
__global__ void __launch_bounds__(wide_attend::kThreads)
paged_attend_int8_wide_kernel(
    const TQ* __restrict__ q, const int8_t* __restrict__ k_q,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_q,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int H, int D, int PB,
    int ps, int pps) {
  const int h = blockIdx.x, split = blockIdx.y, s = blockIdx.z;
  const int span = pps * ps;
  const int p0 = split * span;
  const int n_vis = min(lengths[s] + 1, PB * ps);
  if (p0 >= n_vis) return;  // past the slot's live positions
  const int arrivals = (n_vis + span - 1) / span;
  const int item = s * H + h;
  float* acc = ws + ((size_t)item * gridDim.y + split) * D;
  Int8PagedSource<TQ> src{q + (size_t)item * D, k_q, k_scale, v_q, v_scale,
                          page_table + (size_t)s * PB + (size_t)split * pps,
                          ps, H, h, D};
  float m, l;
  wide_attend::run(src, min(n_vis - p0, span), D, acc, m, l);
  __syncthreads();
  split_softmax::finish<wide_attend::kThreads>(
      acc, m, l, D, item, split, gridDim.y, arrivals, gridDim.z * H, ws,
      counters, out + (size_t)item * D);
}

// the stage width for head width D (stage_positions) and the copy width
// for the page size; past kMaxHeadDim the wide path
template <typename TQ>
int launch_width(const void* q, const void* kq, const void* ks,
                 const void* vq, const void* vs, const void* pt,
                 const void* len, void* out, void* ws, void* counters, int S,
                 int H, int D, int PB, int ps, int pps, cudaStream_t st) {
#define VELES_INT8_LAUNCH(TPS, CV)                                 \
  launch<TQ, TPS, CV>(q, kq, ks, vq, vs, pt, len, out, ws, counters, S, \
                      H, D, PB, ps, pps, st)
  if (D > kMaxHeadDim) {
    paged_attend_int8_wide_kernel<TQ>
        <<<dim3(H, (PB + pps - 1) / pps, S), wide_attend::kThreads, 0,
           st>>>(static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
                 static_cast<const float*>(ks),
                 static_cast<const int8_t*>(vq),
                 static_cast<const float*>(vs), static_cast<const int*>(pt),
                 static_cast<const int*>(len), static_cast<float*>(out),
                 static_cast<float*>(ws), static_cast<int*>(counters), H, D,
                 PB, ps, pps);
    return (int)cudaGetLastError();
  }
  const bool c16 = ps % 16 == 0;
  switch (stage_positions(D)) {
    case 128:
      return c16 ? VELES_INT8_LAUNCH(128, 16) : VELES_INT8_LAUNCH(128, 4);
    case 64:
      return c16 ? VELES_INT8_LAUNCH(64, 16) : VELES_INT8_LAUNCH(64, 4);
    case 32:
      return c16 ? VELES_INT8_LAUNCH(32, 16) : VELES_INT8_LAUNCH(32, 4);
    case 16:
      return c16 ? VELES_INT8_LAUNCH(16, 16) : VELES_INT8_LAUNCH(16, 4);
    default:  // the wide tile: 8 positions, 8-byte copies where ps % 8 == 0
      return ps % 8 == 0 ? VELES_INT8_LAUNCH(8, 8) : VELES_INT8_LAUNCH(8, 4);
  }
#undef VELES_INT8_LAUNCH
}

}  // namespace

// q (S, H, D) pre-scaled by 1/sqrt(D); k_q / v_q (P, H, D, ps) int8;
// k_scale / v_scale (P, H, ps) float32; page_table (S, PB) int32; lengths
// (S,) int32; out (S, H, D) float32; all contiguous, pools 16-byte aligned.
// q type: 0 = float32, 1 = bfloat16. D >= 1; ps a multiple of 4. The
// plan: splits of `pps` pages, at most split_softmax::kMaxSplits of them;
// with more than one, or past D = 8192 (where each split's accumulator
// lives there), ws holds S * H * splits * (D + 2) floats; counters hold
// S * H zeroed ints (left zeroed). Launches on `stream` and returns the launch's cudaError_t.
extern "C" int veles_paged_attend_int8(const void* q, const void* k_q,
                                       const void* k_scale, const void* v_q,
                                       const void* v_scale,
                                       const void* page_table,
                                       const void* lengths, void* out,
                                       void* ws, void* counters, int S,
                                       int H, int D, int PB, int ps, int pps,
                                       int q_dtype, void* stream) {
  if (S < 1 || H < 1 || PB < 1 || ps < 4 || ps % 4 || pps < 1 || D < 1 ||
      (PB + pps - 1) / pps > split_softmax::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VELES_INT8_ARGS                                                      \
  q, k_q, k_scale, v_q, v_scale, page_table, lengths, out, ws, counters, S, \
      H, D, PB, ps, pps, st
  switch (q_dtype) {
    case 0: return launch_width<float>(VELES_INT8_ARGS);
    case 1: return launch_width<__nv_bfloat16>(VELES_INT8_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VELES_INT8_ARGS
}
