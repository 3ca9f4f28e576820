// Fused paged decode attention, float tier: one query per (slot, head)
// against the slot's live KV pages, walked through the page table in the
// kernel, with an online softmax in f32.
//
// Replaces: veles_tpu/ops/paged_attention.py _float_kernel via paged_attend
// (paged_attention.py:151-198, :287-315), which kv_pool._paged_slot_step
// calls once per block in every paged decode step (kv_pool.py:436-439).
//
// What bounds it on the H100: bytes. Each live position's K and V rows are
// read once (2 * H * D * 2 bytes per position in bf16) for 4 * D operations
// per head, three orders of magnitude below the card's compute line.
//
// Design. The TPU kernel ran a sequential (slot, page) grid and carried the
// softmax state across pages in VMEM scratch. Hopper blocks run in no order,
// and a decode call is a few MB spread very unevenly over the slots (one
// slot may hold 1100 positions, its neighbour one), so the work is cut
// along the positions:
// - The plan (ops/paged_attention._paged_plan, in Python so the CPU tests
//   hold it) cuts the table's PB * ps positions into splits of whole pages
//   (one 128-token page at the serving shapes, at least 128 positions where
//   the grid still fills the card). The grid runs over (head, split,
//   slot). A slot sees min(length + 1, PB * ps) positions (position
//   `length`, this step's append, is visible; the walk stops at the table's
//   PB pages, as the TPU grid did); a block whose split starts past them
//   exits at once, so the call costs what the live positions cost, spread
//   over as many blocks as they fill.
// - A block reads its split's page ids once, then stages its positions in
//   stages of TPS positions (32 KB of K and V rows; TPS = 128 at 128-byte
//   head rows) with 16-byte cp.async copies, all issued as it starts; a
//   split of several stages runs a two-stage ring. One head a block: a
//   head row (64-512 bytes) is whole 32-byte sectors, so gathering 16 heads
//   of a position in one block would read no fewer lines, and one head a
//   block gives the short slots' blocks to other SMs.
// - A position's D-vector is LP lanes (16 bytes each) of shared memory; the
//   q.k dot is summed over the group by shuffles. Each lane group keeps its
//   own running (max, sum, acc) in registers over its positions, 4 at a
//   time; the groups of a warp meet
//   by shuffles, the warps through shared memory, into the split's state.
// - The splits meet in the same launch (split_softmax.cuh): the number of
//   live splits, ceil(seen / split), is what every block of the slot
//   computes from `lengths[s]` and is the counter's target, so a block that
//   exits never leaves a counter short. The last block merges in split
//   order (deterministic) and resets the counter; a slot with one live
//   split writes its output from that block.
// Masked positions are never loaded: the group that owns them adds nothing,
// which is the -1e30 sentinel's exact zero in the TPU kernel; the scratch
// page (page 0) pads the table past the live pages and is never read.
// Both bf16 and f32 pools and queries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"           // SmemOptIn
#include "split_softmax.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // positions per lane group per step
constexpr int kStageRows = 16 * 1024;  // bytes of K rows (and of V) a stage
// the largest dynamic shared memory a block may ask for (the opt-in)
constexpr int kSmemCap = 96 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of T in shared memory widened to f32
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <int ROW>
struct Stage {
  static constexpr int TPS = kStageRows / ROW;  // positions a stage
  static constexpr int BYTES = 2 * kStageRows;  // K rows, then V rows
};

// the copies of positions [first, first + count) of the split (local
// indices) into a stage: K rows, then V rows, each ROW bytes
template <typename TKV, int LP>
__device__ __forceinline__ void load_stage(
    char* st, const TKV* k_pages, const TKV* v_pages, const int* pages,
    int first, int count, int ps, int H, int h) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int D = LP * VEC;
  constexpr int ROW = D * (int)sizeof(TKV);
  const int chunks = count * LP;
  for (int c = threadIdx.x; c < 2 * chunks; c += kThreads) {
    const bool v = c >= chunks;
    const int r = v ? c - chunks : c;
    const int i = r / LP, part = r % LP;
    const int local = first + i;
    const size_t src =
        (((size_t)pages[local / ps] * ps + local % ps) * H + h) * D +
        part * VEC;
    cp_async16(st + (v ? kStageRows : 0) + i * ROW + part * 16,
               (v ? v_pages : k_pages) + src);
  }
}

// TQ: query type, TKV: pool type, LP: lanes per position (D = LP * VEC)
template <typename TQ, typename TKV, int LP>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int H,
                    int PB, int ps, int pps, float scale) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int D = LP * VEC;
  constexpr int ROW = D * (int)sizeof(TKV);
  constexpr int TPS = Stage<ROW>::TPS;
  constexpr int GPW = 32 / LP;      // lane groups per warp
  constexpr int G = kWarps * GPW;   // lane groups per block
  extern __shared__ float4 smem4[];

  const int h = blockIdx.x, split = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int span = pps * ps;         // positions of a split
  const int p0 = split * span;
  const int n_vis = min(lengths[s] + 1, PB * ps);
  if (p0 >= n_vis) return;           // past the slot's live positions
  const int arrivals = (n_vis + span - 1) / span;
  const int n_pos = min(n_vis - p0, span);
  const int n_st = (n_pos + TPS - 1) / TPS;
  const int n_buf = min(2, (span + TPS - 1) / TPS);

  char* stages = reinterpret_cast<char*>(smem4);
  float* sm_acc =
      reinterpret_cast<float*>(stages + n_buf * Stage<ROW>::BYTES);
  float* sm_blk = sm_acc + kWarps * D;  // the split's acc (D)
  float* sm_m = sm_blk + D;             // kWarps
  float* sm_l = sm_m + kWarps;          // kWarps
  int* sm_pages = reinterpret_cast<int*>(sm_l + kWarps);  // pps

  const int lane = tid & 31;
  const int sub = lane % LP;                          // D segment
  const int grp = (tid >> 5) * GPW + lane / LP;
  const int n_pages = (n_pos + ps - 1) / ps;
  const int* pt = page_table + (size_t)s * PB + (size_t)split * pps;
  for (int i = tid; i < n_pages; i += kThreads) sm_pages[i] = pt[i];
  __syncthreads();
  // every stage's bytes are requested before any arithmetic
  load_stage<TKV, LP>(stages, k_pages, v_pages, sm_pages, 0,
                      min(TPS, n_pos), ps, H, h);
  cp_async_commit();
  if (n_st > 1) {
    load_stage<TKV, LP>(stages + Stage<ROW>::BYTES, k_pages, v_pages,
                        sm_pages, TPS, min(TPS, n_pos - TPS), ps, H, h);
    cp_async_commit();
  }

  float qv[VEC];
  const TQ* qrow = q + ((size_t)s * H + h) * D + sub * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) qv[j] = to_f32(qrow[j]);

  float m = -1e30f;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // stage st has landed for every thread
    const char* buf = stages + (st & 1) * Stage<ROW>::BYTES;
    const TKV* sk = reinterpret_cast<const TKV*>(buf);
    const TKV* sv = reinterpret_cast<const TKV*>(buf + kStageRows);
    const int count = min(TPS, n_pos - st * TPS);
    for (int i0 = 0; i0 < count; i0 += G * kUnroll) {
      float kf[kUnroll][VEC];
      float vf[kUnroll][VEC];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * G + grp;
        ok[u] = i < count;
        if (ok[u]) {
          load16(sk + i * D + sub * VEC, kf[u]);
          load16(sv + i * D + sub * VEC, vf[u]);
        }
      }
      float sc[kUnroll];
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
        if (ok[u]) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) part = fmaf(qv[j], kf[u][j], part);
        }
#pragma unroll
        for (int off = LP / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[u] = part * scale;
        if (ok[u]) m_new = fmaxf(m_new, sc[u]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) {
          const float p = expf(sc[u] - m_new);
          l += p;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(p, vf[u][j], acc[j]);
        }
      }
      m = m_new;
    }
    __syncthreads();  // stage st's buffer is free
    if (st + 2 < n_st) {
      load_stage<TKV, LP>(stages + (st & 1) * Stage<ROW>::BYTES, k_pages,
                          v_pages, sm_pages, (st + 2) * TPS,
                          min(TPS, n_pos - (st + 2) * TPS), ps, H, h);
      cp_async_commit();
    }
  }

  // the groups meet, first the GPW groups of a warp by shuffles, then the
  // warps through shared memory. A group that saw no position kept
  // m = -1e30 and l = 0, and its weight exp(-1e30 - M) is an exact zero
  // (the split's first position is visible, so M is a real score).
#pragma unroll
  for (int off = LP; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float m_new = fmaxf(m, m_o);
    const float a = expf(m - m_new), b = expf(m_o - m_new);
    l = l * a + __shfl_xor_sync(0xffffffffu, l, off) * b;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] = acc[j] * a + __shfl_xor_sync(0xffffffffu, acc[j], off) * b;
    m = m_new;
  }
  const int warp = tid >> 5;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (lane < LP) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) sm_acc[warp * D + sub * VEC + j] = acc[j];
  }
  __syncthreads();
  float mx = -1e30f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wt[kWarps];
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sm_m[w] - mx);
    lsum = fmaf(sm_l[w], wt[w], lsum);
  }
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w * D + d], wt[w], a);
    sm_blk[d] = a;
  }
  __syncthreads();
  const int item = s * H + h;
  split_softmax::finish<kThreads>(
      sm_blk, mx, lsum, D, item, split, gridDim.y, arrivals, gridDim.z * H,
      ws, counters, out + (size_t)item * D);
}

template <typename TQ, typename TKV, int LP>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* len, void* out, void* ws, void* counters, int S,
           int H, int PB, int ps, int pps, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int D = LP * VEC;
  constexpr int ROW = D * (int)sizeof(TKV);
  constexpr int TPS = Stage<ROW>::TPS;
  auto kernel = paged_attend_kernel<TQ, TKV, LP>;
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, kSmemCap, device);
  if (refused) return refused;
  const int span = pps * ps;
  const int n_buf = (span + TPS - 1) / TPS > 1 ? 2 : 1;
  const size_t smem = (size_t)n_buf * Stage<ROW>::BYTES +
                      (size_t)(kWarps * D + D + 2 * kWarps + pps) * 4;
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  const int splits = (PB + pps - 1) / pps;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<dim3(H, splits, S), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(len), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, PB, ps, pps,
      scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_width(const void* q, const void* k, const void* v, const void* pt,
                 const void* len, void* out, void* ws, void* counters, int S,
                 int H, int D, int PB, int ps, int pps, cudaStream_t stream) {
  const int lp = D * (int)sizeof(TKV) / 16;
  if (D * (int)sizeof(TKV) != lp * 16) return (int)cudaErrorInvalidValue;
#define VELES_PAGED_LAUNCH(LP)                                              \
  return launch<TQ, TKV, LP>(q, k, v, pt, len, out, ws, counters, S, H, PB, \
                             ps, pps, stream)
  switch (lp) {
    case 4: VELES_PAGED_LAUNCH(4);
    case 8: VELES_PAGED_LAUNCH(8);
    case 16: VELES_PAGED_LAUNCH(16);
    case 32: VELES_PAGED_LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VELES_PAGED_LAUNCH
}

}  // namespace

// q (S, H, D); k_pages / v_pages (P, ps, H, D); page_table (S, PB) int32;
// lengths (S,) int32; out (S, H, D) float32; all contiguous, pools 16-byte
// aligned. Types: 0 = float32, 1 = bfloat16. D * sizeof(pool type) must be
// 64, 128, 256 or 512 bytes. The plan: splits of `pps` pages, at most
// split_softmax::kMaxSplits of them; with more than one, ws holds
// S * H * splits * (D + 2) floats and counters S * H zeroed ints (left
// zeroed). Launches on `stream` and returns the launch's cudaError_t.
extern "C" int veles_paged_attend(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, void* out, void* ws,
                                  void* counters, int S, int H, int D, int PB,
                                  int ps, int pps, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (S < 1 || H < 1 || PB < 1 || ps < 1 || pps < 1 ||
      (PB + pps - 1) / pps > split_softmax::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VELES_PAGED_ARGS \
  q, k_pages, v_pages, page_table, lengths, out, ws, counters, S, H, D, PB, \
      ps, pps, st
  switch (q_dtype * 2 + kv_dtype) {
    case 0: return launch_width<float, float>(VELES_PAGED_ARGS);
    case 1: return launch_width<float, __nv_bfloat16>(VELES_PAGED_ARGS);
    case 2: return launch_width<__nv_bfloat16, float>(VELES_PAGED_ARGS);
    case 3:
      return launch_width<__nv_bfloat16, __nv_bfloat16>(VELES_PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VELES_PAGED_ARGS
}
