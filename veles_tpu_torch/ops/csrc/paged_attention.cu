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
// softmax state across pages in VMEM scratch. Hopper blocks run in no order
// and carry nothing between each other, so one block owns one (slot, head)
// and a loop inside it walks the slot's positions: min(length + 1, PB * ps)
// of them (position `length`, this step's append, is visible; the walk stops
// at the page table's PB pages, as the TPU grid did). A position's D-vector
// of one head is contiguous, so a group of LP lanes reads it with one 16-byte
// load each (D = 64 in bf16 is 128 bytes: 8 lanes, 4 positions per warp
// load); the q.k dot is summed over the group by shuffles. Each lane group
// keeps its own running (max, sum, acc) in registers, processing 4 positions
// per step with all their K/V loads issued first to keep several loads in
// flight; at the end the groups' states merge through shared memory, and
// the block writes the (D,) f32 output. Both bf16 and f32 pools and queries.
// Masked positions are never loaded: the group that owns them adds nothing,
// which is the -1e30 sentinel's exact zero in the TPU kernel.
// Simple first: no split over positions across blocks (flash-decoding), no
// cp.async/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // positions per lane group per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of T at p (16-byte aligned) widened to f32
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// TQ: query type, TKV: pool type, LP: lanes per position (D = LP * VEC)
template <typename TQ, typename TKV, int LP>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int H, int PB, int ps, float scale) {
  constexpr int VEC = 16 / (int)sizeof(TKV);
  constexpr int D = LP * VEC;
  constexpr int GPW = 32 / LP;      // lane groups per warp
  constexpr int G = kWarps * GPW;   // lane groups per block
  __shared__ float sm_m[G];
  __shared__ float sm_l[G];
  __shared__ float sm_acc[G][D];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LP;                          // D segment
  const int grp = (threadIdx.x >> 5) * GPW + lane / LP;
  const int n_vis = min(lengths[s] + 1, PB * ps);
  const int* pt = page_table + (size_t)s * PB;

  float qv[VEC];
  const TQ* qrow = q + ((size_t)s * H + h) * D + sub * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) qv[j] = to_f32(qrow[j]);

  float m = -1e30f;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < n_vis; t0 += G * kUnroll) {
    float kf[kUnroll][VEC];
    float vf[kUnroll][VEC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * G + grp;
      ok[u] = t < n_vis;
      if (ok[u]) {
        const size_t base =
            (((size_t)pt[t / ps] * ps + t % ps) * H + h) * D + sub * VEC;
        load16(k_pages + base, kf[u]);
        load16(v_pages + base, vf[u]);
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

  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) sm_acc[grp][sub * VEC + j] = acc[j];
  __syncthreads();
  // every group that saw no position kept m = -1e30 and l = 0: its weight
  // exp(-1e30 - M) is an exact zero (position 0 is always visible, so M is
  // a real score)
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = -1e30f;
    for (int g = 0; g < G; ++g) mx = fmaxf(mx, sm_m[g]);
    float lsum = 0.f;
    float a = 0.f;
    for (int g = 0; g < G; ++g) {
      const float w = expf(sm_m[g] - mx);
      lsum = fmaf(sm_l[g], w, lsum);
      a = fmaf(sm_acc[g][d], w, a);
    }
    out[((size_t)s * H + h) * D + d] = a / lsum;
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* len, void* out, int S, int H, int D, int PB, int ps,
           cudaStream_t stream) {
  const int lp = D * (int)sizeof(TKV) / 16;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid(H, S);
#define VELES_PAGED_LAUNCH(LP)                                             \
  paged_attend_kernel<TQ, TKV, LP><<<grid, kThreads, 0, stream>>>(         \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),               \
      static_cast<const TKV*>(v), static_cast<const int*>(pt),             \
      static_cast<const int*>(len), static_cast<float*>(out), H, PB, ps,   \
      scale)
  if (D * (int)sizeof(TKV) != lp * 16) return (int)cudaErrorInvalidValue;
  switch (lp) {
    case 4: VELES_PAGED_LAUNCH(4); break;
    case 8: VELES_PAGED_LAUNCH(8); break;
    case 16: VELES_PAGED_LAUNCH(16); break;
    case 32: VELES_PAGED_LAUNCH(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VELES_PAGED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q (S, H, D); k_pages / v_pages (P, ps, H, D); page_table (S, PB) int32;
// lengths (S,) int32; out (S, H, D) float32; all contiguous, pools 16-byte
// aligned. Types: 0 = float32, 1 = bfloat16. D * sizeof(pool type) must be
// 64, 128, 256 or 512 bytes. Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int veles_paged_attend(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, void* out, int S, int H,
                                  int D, int PB, int ps, int q_dtype,
                                  int kv_dtype, void* stream) {
  if (S < 1 || H < 1 || PB < 1 || ps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = q_dtype * 2 + kv_dtype;
  switch (code) {
    case 0:
      return launch<float, float>(q, k_pages, v_pages, page_table, lengths,
                                  out, S, H, D, PB, ps, st);
    case 1:
      return launch<float, __nv_bfloat16>(q, k_pages, v_pages, page_table,
                                          lengths, out, S, H, D, PB, ps, st);
    case 2:
      return launch<__nv_bfloat16, float>(q, k_pages, v_pages, page_table,
                                          lengths, out, S, H, D, PB, ps, st);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          q, k_pages, v_pages, page_table, lengths, out, S, H, D, PB, ps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
