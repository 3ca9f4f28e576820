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
// - A block reads its split's page ids, then stages its positions in
//   stages of TPS positions (up to 128; fewer where a stage's K rows would
//   pass 16 KB, so stages are sub-page past D = 128 in bf16) with
//   cp.async, all issued as the block starts; a split of several stages
//   runs a two-stage ring. (The tile path reads the slot's length with the
//   page ids in one round trip, and copies K rows and V rows in two
//   groups, so the scores start while the V rows land.) One head a
//   block: a head row is whole 32-byte sectors or less, so gathering 16
//   heads of a position in one block would read no fewer lines, and one
//   head a block gives the short slots' blocks to other SMs.
// - Two ways through a stage, chosen by the head row's bytes. At rows of
//   64, 128, 256 or 512 bytes (bf16 heads of 32-256, f32 of 16-128) the
//   lane-group path: each position's row is LP lanes of 16 bytes, lane
//   groups keep their own softmax state in registers and meet at the
//   end. Every other width from 1 to 8192 takes the tile path, K3's tile
//   shape (int8_tile.cuh) transposed to this position-major layout; it
//   reads ~10% slower than the lane-group path at D = 64 (PERF.md), so
//   the narrow rows keep theirs. In the tile path a position's row sits in
//   shared memory as C = ceil(D * sizeof(T) / 16) chunks of 16 bytes, the
//   last one padded with zeros, rows an odd number of chunks apart (so the
//   eight rows a quarter warp reads at one chunk hit distinct banks). Row
//   copies are as wide as the row's byte alignment allows: 16 bytes, else 8
//   or 4 (cp.async), else (a bf16 row of odd width) plain 2-byte loads.
//   Scores: each position's dot is summed by 128 / TPS row groups over
//   their share of its chunks, lanes past D selected out (never
//   multiplied), the groups' partials meeting in shared memory in a fixed
//   order. Values: each d-chunk is summed over the block's threads, P lanes
//   a chunk (P = 128 / C, at most 32) each taking every P-th position, the
//   stages meeting by the online-softmax rescale and the P lanes by shuffles
//   at the end; no thread holds more than 8 of the split's D sums in
//   registers. Past D = 1024 a thread's chunks of the split's sums live in
//   shared memory beside q (read, rescaled and written back in every
//   stage) and a stage may hold a single position, so D goes to 8192, the
//   widest at which one head's f32 q and accumulator (64 KB) and a ring of
//   two one-position stages fit the 227 KB a block may opt in to. Past
//   8192 the wide path (wide_attend.cuh) reads q, K and V from global
//   memory, eight positions a group, and keeps the split's sums in its row
//   of the merge workspace: no width limit.
// - Only visible positions count: a stage copies its visible positions
//   only; in the tile path a position past them gets the score -inf and
//   the weight 0 by selection and its row is never read (the lane groups
//   skip it), so whatever its shared memory holds (a stale row of an
//   earlier stage, bytes never copied) changes no bit. The scratch page
//   (page 0) pads the table past the live pages and is never read.
// - The splits meet in the same launch (split_softmax.cuh): the number of
//   live splits, ceil(seen / split), is what every block of the slot
//   computes from `lengths[s]` and is the counter's target, so a block that
//   exits never leaves a counter short. The last block merges in split
//   order (deterministic) and resets the counter; a slot with one live
//   split writes its output from that block.
// Both bf16 and f32 pools and queries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_tile.cuh"     // cp_async, to_f32
#include "sm90.cuh"           // SmemOptIn
#include "split_softmax.cuh"
#include "wide_attend.cuh"

namespace {

using int8_tile::cp_async;
using int8_tile::cp_async_commit;
using int8_tile::cp_async_wait;
using int8_tile::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // positions per lane group per step
constexpr int kStageRows = 16 * 1024;  // bytes of K rows (and of V) a stage
// the widest head the stages take, and the widest whose value sums a
// thread holds in registers (2 d-chunks); past it the split's accumulator
// lives in shared memory; past kMaxHeadDim the wide path
// (wide_attend.cuh) keeps nothing of the width in shared memory
constexpr int kMaxHeadDim = 8192;
constexpr int kRegisterHeadDim = 1024;
// the largest dynamic shared memory a block may ask for (the opt-in), and
// past kRegisterHeadDim, where one head's f32 q and accumulator take up to
// 64 KB beside stages of one position (D = 8192 f32: 193 KB)
constexpr int kSmemCap = 96 * 1024;
constexpr int kWideSmemCap = 220 * 1024;

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

// ---- the lane-group path: head rows of 64, 128, 256 or 512 bytes ----
// A position's D-vector is LP lanes (16 bytes each) of shared memory; the
// q.k dot is summed over the group by shuffles. Each lane group keeps its
// own running (max, sum, acc) in registers over its positions, kUnroll at
// a time; the groups of a warp meet by shuffles, the warps through shared
// memory, into the split's state. Positions past the split's visible ones
// are never loaded. Kept for these widths: it is ~10% faster there than
// the tile path below (the smoke's A/B at D = 64, PERF.md).

template <int ROW>
struct LaneStage {
  static constexpr int TPS = kStageRows / ROW;  // positions a stage
  static constexpr int BYTES = 2 * kStageRows;  // K rows, then V rows
};

// the copies of positions [first, first + count) of the split (local
// indices) into a stage: K rows, then V rows, each ROW bytes
template <typename TKV, int LP>
__device__ __forceinline__ void load_lane_stage(
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
    cp_async<16>(st + (v ? kStageRows : 0) + i * ROW + part * 16,
               (v ? v_pages : k_pages) + src);
  }
}

// TQ: query type, TKV: pool type, LP: lanes per position (D = LP * VEC)
template <typename TQ, typename TKV, int LP>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel_lanes(const TQ* __restrict__ q,
                          const TKV* __restrict__ k_pages,
                          const TKV* __restrict__ v_pages,
                          const int* __restrict__ page_table,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ counters, int H, int PB, int ps,
                          int pps, float scale) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int D = LP * VEC;
  constexpr int ROW = D * (int)sizeof(TKV);
  constexpr int TPS = LaneStage<ROW>::TPS;
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
      reinterpret_cast<float*>(stages + n_buf * LaneStage<ROW>::BYTES);
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
  load_lane_stage<TKV, LP>(stages, k_pages, v_pages, sm_pages, 0,
                      min(TPS, n_pos), ps, H, h);
  cp_async_commit();
  if (n_st > 1) {
    load_lane_stage<TKV, LP>(stages + LaneStage<ROW>::BYTES, k_pages, v_pages,
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
    const char* buf = stages + (st & 1) * LaneStage<ROW>::BYTES;
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
      load_lane_stage<TKV, LP>(stages + (st & 1) * LaneStage<ROW>::BYTES, k_pages,
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
int launch_lanes(const void* q, const void* k, const void* v,
                 const void* pt, const void* len, void* out, void* ws,
                 void* counters, int S, int H, int PB, int ps, int pps,
                 cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int D = LP * VEC;
  constexpr int ROW = D * (int)sizeof(TKV);
  constexpr int TPS = LaneStage<ROW>::TPS;
  auto kernel = paged_attend_kernel_lanes<TQ, TKV, LP>;
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, kSmemCap, device);
  if (refused) return refused;
  const int span = pps * ps;
  const int n_buf = (span + TPS - 1) / TPS > 1 ? 2 : 1;
  const size_t smem = (size_t)n_buf * LaneStage<ROW>::BYTES +
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

// ---- the tile path: every other width from 1 to 1024 ----

// A row's shape in shared memory at head width D: C chunks of 16 bytes,
// rows RS bytes apart (an odd number of chunks), TPS positions a stage (as
// many as keep its K rows within kStageRows, at least one: a stage of one
// position past D = 4096 f32 or 8192 bf16), WS floats of weights (TPS
// rounded up to whole 16 bytes, so the stages behind them stay aligned).
template <typename TKV>
struct Rows {
  static constexpr int VEC = 16 / (int)sizeof(TKV);  // elements a chunk
  int C, RS, TPS, WS;
  __host__ __device__ explicit Rows(int D) {
    C = (D + VEC - 1) / VEC;
    RS = (C | 1) * 16;
    TPS = 128;
    while (TPS > 1 && TPS * C * 16 > kStageRows) TPS >>= 1;
    WS = (TPS + 3) & ~3;
  }
  __host__ __device__ int stage_bytes() const { return 2 * TPS * RS; }
};

// the widest copy (16, 8 or 4 bytes; 2 means plain loads) that divides a
// row of `row_bytes`: every row starts on a multiple of its size
__host__ __device__ inline int copy_width(int row_bytes) {
  return row_bytes % 16 == 0 ? 16
         : (row_bytes % 8 == 0 ? 8 : (row_bytes % 4 == 0 ? 4 : 2));
}

// the max (or the sum) of `v` over the block in a fixed order, every
// thread getting it; `scratch` (one float a warp) must not be read by a
// previous reduction still: one barrier
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, scratch[w]);
  return v;
}
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v += scratch[w];
  return v;
}

// lanes a d-chunk in the value pass: 128 / C rounded down to a power of
// two, at most 32 (one warp's shuffles meet them), 1 past 128 chunks
__device__ __forceinline__ int lanes_a_chunk(int C) {
  int p = 1;
  while (p < 32 && 2 * p * C <= kThreads) p <<= 1;
  return p;
}

// one copy of CW bytes (a plain 2-byte load at CW = 2): part `part` of
// row `i` of a stage, from position `off` of page `page`
template <typename TKV, int CW>
__device__ __forceinline__ void copy_part(char* st, const TKV* src_pages,
                                          int i, int part, int page, int off,
                                          int ps, int H, int h, int D,
                                          int RS) {
  const char* src = reinterpret_cast<const char*>(
                        src_pages + (((size_t)page * ps + off) * H + h) * D) +
                    part * CW;
  char* dst = st + i * RS + part * CW;
  if constexpr (CW == 2)
    *reinterpret_cast<uint16_t*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  else
    cp_async<CW>(dst, src);
}

// The copies of the `count` visible positions of the stage whose first
// position is the split's `first` (split-local, on the split's pages
// `pages`) as two copy groups, K rows then V rows, each row in copies of
// CW bytes (plain loads at CW = 2). Where a row takes at most kThreads
// copies, a thread keeps one column and steps its position and page.
template <typename TKV, int CW>
__device__ __forceinline__ void load_rows(char* st, const TKV* src_pages,
                                          const int* pages, int first,
                                          int count, int ps, int H, int h,
                                          int D, int RS) {
  const int per_row = D * (int)sizeof(TKV) / CW;
  if (per_row <= kThreads) {
    const int step = kThreads / per_row;
    const int part = threadIdx.x % per_row;
    int i = threadIdx.x / per_row;
    if (i < step) {
      const int local = first + i;
      int pi = local / ps, off = local - pi * ps;
      for (; i < count; i += step) {
        copy_part<TKV, CW>(st, src_pages, i, part, pages[pi], off, ps, H, h,
                           D, RS);
        off += step;
        pi += off / ps;
        off %= ps;
      }
    }
  } else {
    for (int c = threadIdx.x; c < count * per_row; c += kThreads) {
      const int i = c / per_row, local = first + i;
      copy_part<TKV, CW>(st, src_pages, i, c - i * per_row,
                         pages[local / ps], local % ps, ps, H, h, D, RS);
    }
  }
  cp_async_commit();
}

template <typename TKV, int CW>
__device__ __forceinline__ void load_stage(char* st, const TKV* k_pages,
                                           const TKV* v_pages,
                                           const int* pages, int first,
                                           int count, int ps, int H, int h,
                                           int D, const Rows<TKV>& rows) {
  load_rows<TKV, CW>(st, k_pages, pages, first, count, ps, H, h, D, rows.RS);
  load_rows<TKV, CW>(st + rows.TPS * rows.RS, v_pages, pages, first, count,
                     ps, H, h, D, rows.RS);
}

// TQ: query type, TKV: pool type, CW: copy width, CPT: d-chunks a thread
// holds in the value pass (2 only for f32 rows past 128 chunks; 0 past
// kRegisterHeadDim: each thread's chunks of the accumulator live in sm_acc,
// read, rescaled and written back in every stage)
template <typename TQ, typename TKV, int CW, int CPT>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int H,
                    int D, int PB, int ps, int pps, int n_buf, float scale) {
  constexpr int VEC = Rows<TKV>::VEC;
  const Rows<TKV> rows(D);
  const int C = rows.C, RS = rows.RS, TPS = rows.TPS;
  const int Dp = C * VEC;
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // Dp
  float* sm_acc = sm_q + Dp;                      // Dp
  float* sm_part = sm_acc + Dp;                   // kThreads
  float* sm_w = sm_part + kThreads;               // TPS (WS)
  char* stages = reinterpret_cast<char*>(sm_w + rows.WS);
  const int sbytes = rows.stage_bytes();
  int* sm_pages = reinterpret_cast<int*>(stages + n_buf * sbytes);  // pps
  // the block max's and the block sum's scratch (one float a warp each;
  // the stage's last barrier frees them for the next stage)
  __shared__ float sm_red[2][kWarps];

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
  // the zero pad of every row's last chunk (never written by a copy)
  const int row_bytes = D * (int)sizeof(TKV);
  const int pad = C * 16 - row_bytes;
  if (pad)
    for (int r = tid; r < n_buf * 2 * TPS; r += kThreads)
      for (int b = 0; b < pad; b += 2)
        *reinterpret_cast<uint16_t*>(stages + r * RS + row_bytes + b) = 0;
  __syncthreads();  // the page ids are in shared memory

  // every stage's bytes are requested before any arithmetic
  load_stage<TKV, CW>(stages, k_pages, v_pages, sm_pages, 0,
                      min(TPS, n_pos), ps, H, h, D, rows);
  if (n_st > 1)
    load_stage<TKV, CW>(stages + sbytes, k_pages, v_pages, sm_pages, TPS,
                        min(TPS, n_pos - TPS), ps, H, h, D, rows);
  const int item = s * H + h;
  for (int d = tid; d < Dp; d += kThreads)
    sm_q[d] = d < D ? to_f32(q[(size_t)item * D + d]) : 0.f;
  if constexpr (CPT == 0)  // each thread zeroes the chunks it will sum
    for (int d = tid * VEC; d < Dp; d += kThreads * VEC)
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[d + e] = 0.f;

  // the score pass: position t of row group rg
  const int RG = kThreads / TPS;
  const int t_own = tid % TPS, rg = tid / TPS;
  // the value pass: lanes `part` of d-chunk tid / P (+ 128 / P)
  const int P = lanes_a_chunk(C);
  const int part = tid % P;
  float m = -INFINITY, l = 0.f;
  float acc[CPT > 0 ? CPT : 1][VEC] = {};

  for (int j = 0; j < n_st; ++j) {
    const bool more = j + 1 < n_st;
    const int count = min(TPS, n_pos - j * TPS);
    const char* st = stages + (j & 1) * sbytes;
    const TKV* sk = reinterpret_cast<const TKV*>(st);
    const TKV* sv = reinterpret_cast<const TKV*>(st + TPS * RS);
    if (more)  // the stage's K rows (the next stage's groups behind it)
      cp_async_wait<3>();
    else
      cp_async_wait<1>();
    __syncthreads();  // the K rows (and q) are in shared memory

    // 1. partial dots of the visible positions: each chunk's products
    // summed apart, then the chunks in order (short dependent chains)
    float dot = 0.f;
    if (t_own < count) {
      const TKV* row = sk + t_own * (RS / (int)sizeof(TKV));
#pragma unroll 2
      for (int c = rg; c < C; c += RG) {
        float kf[VEC], qc[VEC];
        load16(row + c * VEC, kf);
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          load16(sm_q + c * VEC + e, qc + e);
        const int lim = D - c * VEC;
        float part = 0.f;
        if (lim >= VEC) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) part = fmaf(qc[e], kf[e], part);
        } else {  // the last chunk: its padded lanes are selected out
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (e < lim) part = fmaf(qc[e], kf[e], part);
        }
        dot += part;
      }
    }
    // 2. scores (the row groups' partials meet in shared memory where a
    // position has several), the block max, p and the weights
    float sc = -INFINITY;
    if (RG > 1) {
      sm_part[rg * TPS + t_own] = dot;
      __syncthreads();
      if (tid < TPS && tid < count) {
        float d = sm_part[tid];
        for (int r = 1; r < RG; ++r) d += sm_part[r * TPS + tid];
        sc = d * scale;
      }
    } else if (t_own < count) {
      sc = dot * scale;
    }
    // the stage's first position counts, so the max is a real score
    const float mx = fmaxf(m, block_max(sc, sm_red[0]));
    const float alpha = expf(m - mx);  // 0 on the first stage
    float p = 0.f;
    if (tid < TPS) {
      p = tid < count ? expf(sc - mx) : 0.f;
      sm_w[tid] = p;
    }
    if (more)  // the stage's V rows
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    // the sum's barrier also publishes the weights and the V rows
    l = l * alpha + block_sum(p, sm_red[1]);
    m = mx;

    // 3. values: acc = acc * alpha + sum over the lane's positions of w v
    if constexpr (CPT == 0) {  // P == 1: a thread a chunk, in sm_acc
      for (int c = tid; c < C; c += kThreads) {
        float a[VEC];
#pragma unroll
        for (int e = 0; e < VEC; e += 4) load16(sm_acc + c * VEC + e, a + e);
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] *= alpha;
        const TKV* col = sv + c * VEC;
        for (int t = 0; t < count; ++t) {
          float vf[VEC];
          load16(col + t * (RS / (int)sizeof(TKV)), vf);
          const float w = sm_w[t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[e] = fmaf(w, vf[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(sm_acc + c * VEC + e) =
              make_float4(a[e], a[e + 1], a[e + 2], a[e + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      const int c = tid / P + r * (kThreads / P);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
      if (c < C) {
        const TKV* col = sv + c * VEC;
#pragma unroll 4
        for (int t = part; t < count; t += P) {
          float vf[VEC];
          load16(col + t * (RS / (int)sizeof(TKV)), vf);
          const float w = sm_w[t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(w, vf[e], acc[r][e]);
        }
      }
    }
    __syncthreads();  // the stage's buffer and the weights are free
    if (j + 2 < n_st)
      load_stage<TKV, CW>(stages + (j & 1) * sbytes, k_pages, v_pages,
                          sm_pages, (j + 2) * TPS,
                          min(TPS, n_pos - (j + 2) * TPS), ps, H, h, D, rows);
  }

  // the P lanes of a chunk meet (consecutive lanes, by shuffles), and the
  // split's acc goes to sm_acc (where the wide path keeps it already)
#pragma unroll
  for (int r = 0; r < CPT; ++r) {
    const int c = tid / P + r * (kThreads / P);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = acc[r][e];
      for (int o = P / 2; o > 0; o >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      const int d = c * VEC + e;
      if (part == 0 && c < C && d < D) sm_acc[d] = a;
    }
  }
  __syncthreads();
  split_softmax::finish<kThreads>(
      sm_acc, m, l, D, item, split, gridDim.y, arrivals, gridDim.z * H, ws,
      counters, out + (size_t)item * D);
}

template <typename TQ, typename TKV, int CW, int CPT>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* len, void* out, void* ws, void* counters, int S,
           int H, int D, int PB, int ps, int pps, cudaStream_t stream) {
  auto kernel = paged_attend_kernel<TQ, TKV, CW, CPT>;
  constexpr int cap = CPT == 0 ? kWideSmemCap : kSmemCap;
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, cap, device);
  if (refused) return refused;
  const Rows<TKV> rows(D);
  const int span = pps * ps;
  const int n_buf = (span + rows.TPS - 1) / rows.TPS > 1 ? 2 : 1;
  const int Dp = rows.C * Rows<TKV>::VEC;
  const size_t smem = (size_t)(2 * Dp + kThreads + rows.WS) * 4 +
                      (size_t)n_buf * rows.stage_bytes() + (size_t)pps * 4;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  const int splits = (PB + pps - 1) / pps;
  const float scale = (float)(1.0 / sqrt((double)D));
  kernel<<<dim3(H, splits, S), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(len), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, D, PB, ps,
      pps, n_buf, scale);
  return (int)cudaGetLastError();
}

// ---- past kMaxHeadDim: q, K and V read from global memory, the
// split's accumulator in its workspace row (wide_attend.cuh) ----

// one split's positions: split-local position t on the split's page
// t / ps of the table, at offset t % ps
template <typename TQ, typename TKV>
struct PagedSource {
  const TQ* qv;
  const TKV* k_pages;
  const TKV* v_pages;
  const int* pages;  // the split's page ids in the table
  int ps, H, h, D;
  float scale;
  const TKV* krow[wide_attend::kGroup];
  const TKV* vrow[wide_attend::kGroup];
  __device__ float q(int d) const { return to_f32(qv[d]); }
  __device__ void group(int t0, int n) {
#pragma unroll
    for (int i = 0; i < wide_attend::kGroup; ++i) {
      if (i < n) {
        const int t = t0 + i;
        const size_t base =
            (((size_t)pages[t / ps] * ps + t % ps) * H + h) * D;
        krow[i] = k_pages + base;
        vrow[i] = v_pages + base;
      }
    }
  }
  __device__ float k(int i, int d) const { return to_f32(krow[i][d]); }
  __device__ float v(int i, int d) const { return to_f32(vrow[i][d]); }
  __device__ float score(int, float dot) const { return dot * scale; }
  __device__ float weight(int, float p) const { return p; }
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(wide_attend::kThreads)
paged_attend_wide_kernel(const TQ* __restrict__ q,
                         const TKV* __restrict__ k_pages,
                         const TKV* __restrict__ v_pages,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ counters, int H, int D, int PB,
                         int ps, int pps, float scale) {
  const int h = blockIdx.x, split = blockIdx.y, s = blockIdx.z;
  const int span = pps * ps;
  const int p0 = split * span;
  const int n_vis = min(lengths[s] + 1, PB * ps);
  if (p0 >= n_vis) return;  // past the slot's live positions
  const int arrivals = (n_vis + span - 1) / span;
  const int item = s * H + h;
  float* acc = ws + ((size_t)item * gridDim.y + split) * D;
  PagedSource<TQ, TKV> src{q + (size_t)item * D, k_pages, v_pages,
                           page_table + (size_t)s * PB + (size_t)split * pps,
                           ps, H, h, D, scale};
  float m, l;
  wide_attend::run(src, min(n_vis - p0, span), D, acc, m, l);
  __syncthreads();
  split_softmax::finish<wide_attend::kThreads>(
      acc, m, l, D, item, split, gridDim.y, arrivals, gridDim.z * H, ws,
      counters, out + (size_t)item * D);
}

template <typename TQ, typename TKV>
int launch_wide(const void* q, const void* k, const void* v, const void* pt,
                const void* len, void* out, void* ws, void* counters, int S,
                int H, int D, int PB, int ps, int pps, cudaStream_t stream) {
  const int splits = (PB + pps - 1) / pps;
  const float scale = (float)(1.0 / sqrt((double)D));
  paged_attend_wide_kernel<TQ, TKV>
      <<<dim3(H, splits, S), wide_attend::kThreads, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k),
          static_cast<const TKV*>(v), static_cast<const int*>(pt),
          static_cast<const int*>(len), static_cast<float*>(out),
          static_cast<float*>(ws), static_cast<int*>(counters), H, D, PB, ps,
          pps, scale);
  return (int)cudaGetLastError();
}

// the lane-group path at head rows of 64-512 bytes; elsewhere the tile
// path with the copy width for the row's bytes and the value pass's chunks
// a thread (f32 rows past 512 elements take two; past kRegisterHeadDim the
// accumulator in shared memory)
template <typename TQ, typename TKV>
int launch_width(const void* q, const void* k, const void* v, const void* pt,
                 const void* len, void* out, void* ws, void* counters, int S,
                 int H, int D, int PB, int ps, int pps, cudaStream_t stream) {
#define VELES_LANES_LAUNCH(LP)                                             \
  return launch_lanes<TQ, TKV, LP>(q, k, v, pt, len, out, ws, counters, S, \
                                   H, PB, ps, pps, stream)
#define VELES_TILE_LAUNCH(CW, CPT)                                            \
  return launch<TQ, TKV, CW, CPT>(q, k, v, pt, len, out, ws, counters, S, H, \
                                  D, PB, ps, pps, stream)
  if (D > kMaxHeadDim)
    return launch_wide<TQ, TKV>(q, k, v, pt, len, out, ws, counters, S, H, D,
                                PB, ps, pps, stream);
  const int row_bytes = D * (int)sizeof(TKV);
  switch (row_bytes) {
    case 64: VELES_LANES_LAUNCH(4);
    case 128: VELES_LANES_LAUNCH(8);
    case 256: VELES_LANES_LAUNCH(16);
    case 512: VELES_LANES_LAUNCH(32);
    default: break;
  }
  const int cw = copy_width(row_bytes);
  if (D > kRegisterHeadDim) {
    switch (cw) {
      case 16: VELES_TILE_LAUNCH(16, 0);
      case 8: VELES_TILE_LAUNCH(8, 0);
      case 4: VELES_TILE_LAUNCH(4, 0);
      default:
        if constexpr (sizeof(TKV) == 2) VELES_TILE_LAUNCH(2, 0);
        return (int)cudaErrorInvalidValue;  // f32 rows are 4-byte aligned
    }
  }
  if constexpr (sizeof(TKV) == 4) {
    if (Rows<TKV>(D).C > kThreads) {  // D > 512
      switch (cw) {
        case 16: VELES_TILE_LAUNCH(16, 2);
        case 8: VELES_TILE_LAUNCH(8, 2);
        default: VELES_TILE_LAUNCH(4, 2);
      }
    }
    switch (cw) {
      case 16: VELES_TILE_LAUNCH(16, 1);
      case 8: VELES_TILE_LAUNCH(8, 1);
      default: VELES_TILE_LAUNCH(4, 1);
    }
  } else {
    switch (cw) {
      case 16: VELES_TILE_LAUNCH(16, 1);
      case 8: VELES_TILE_LAUNCH(8, 1);
      case 4: VELES_TILE_LAUNCH(4, 1);
      default: VELES_TILE_LAUNCH(2, 1);
    }
  }
#undef VELES_LANES_LAUNCH
#undef VELES_TILE_LAUNCH
}

}  // namespace

// q (S, H, D); k_pages / v_pages (P, ps, H, D); page_table (S, PB) int32;
// lengths (S,) int32; out (S, H, D) float32; all contiguous, pools 16-byte
// aligned. Types: 0 = float32, 1 = bfloat16. D >= 1. The plan: splits of
// `pps` pages, at most split_softmax::kMaxSplits of them; with more than
// one, or past D = 8192 (where each split's accumulator lives there), ws
// holds S * H * splits * (D + 2) floats; counters hold S * H zeroed ints
// (left zeroed). Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int veles_paged_attend(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, void* out, void* ws,
                                  void* counters, int S, int H, int D, int PB,
                                  int ps, int pps, int q_dtype, int kv_dtype,
                                  void* stream) {
  if (S < 1 || H < 1 || PB < 1 || ps < 1 || pps < 1 || D < 1 ||
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
