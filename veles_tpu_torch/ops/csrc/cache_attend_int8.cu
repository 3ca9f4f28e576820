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
// Design. The TPU kernel ran one grid cell per batch row with the whole
// (D, T) lane in VMEM. A decode call here is a few MB, so what matters is
// how many bytes the card has in flight, and that every SM has its share:
// - The plan (ops/quant._attend_plan, in Python so the CPU tests hold it)
//   cuts T into `splits` splits of whole 128-position tiles, so that the
//   grid (head, split, row) gives each SM about four blocks of 128
//   threads (6 splits, 768 blocks at the smoke's 8 x 16 heads x 768).
// - Each block walks its split on the int8 tile (int8_tile.cuh): stages of
//   TPS positions copied in two cp.async groups (16-byte copies, 4-byte
//   ones where the code rows are not 16-byte aligned), the K half carrying
//   the mask slice beside the scales; s = dot * k_scale + mask and the
//   weights w = p * v_scale kept in f32 (the TPU kernel's numerics; JAX's
//   XLA formulation rounds them to bf16 for a bf16 q, which this kernel
//   does not).
// - The splits meet in the same launch (split_softmax.cuh): each block
//   writes its (max, sum, acc) to the wrapper's workspace, and the last
//   block of the (row, head) merges them in split order (deterministic)
//   and resets the counter. One split writes the output itself.
// A masked position's addend (-1e30) makes its exp an exact zero once a
// visible position has set the max; an all-masked split weighs zero in
// the merge, and an all-masked row gets the uniform softmax one pass
// gives. q is pre-scaled by 1/sqrt(D) by the caller. Past D = 8192 the
// wide path (wide_attend.cuh) reads q, the codes, scales and mask from
// global memory and keeps the split's sums in its workspace row: no width
// limit.

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

constexpr int kTile = 128;  // the plan's tile: splits are whole tiles
constexpr int kVectors = 3;  // k_scale, v_scale and the mask a stage
// the largest dynamic shared memory a block may ask for (the opt-in,
// below the H100's 227 KB less the static shared memory): two stages at
// D = 1024 take 142 KB; past D = 1024 the wide tile (8 positions a stage)
// takes one stage where two do not fit (D = 8192: 194 KB)
constexpr int kSmemCap = 192 * 1024;
constexpr int kWideSmemCap = 220 * 1024;

// the copies of one code half of the stage of TPS positions from t0 (the
// K codes with k_scale, v_scale and the mask, or the V codes), as one copy
// group: code rows in chunks of CV bytes, the vectors in 16-byte chunks
template <int TPS, int CV>
__device__ __forceinline__ void load_half(char* st, const int8_t* codes,
                                          const float* ks, const float* vs,
                                          const float* mask, int n_vectors,
                                          int D, long long code_sd, int t0) {
  constexpr int RS = Stage<TPS, kVectors>::RS;
  constexpr int kRowChunks = TPS / CV;
  for (int c = threadIdx.x; c < D * kRowChunks; c += kThreads) {
    const int d = c / kRowChunks, off = (c % kRowChunks) * CV;
    cp_async<CV>(st + d * RS + off, codes + (size_t)d * code_sd + t0 + off);
  }
  constexpr int kFloatChunks = TPS / 4;  // 16-byte chunks of one vector
  float* sf = reinterpret_cast<float*>(st + 2 * D * RS);
  for (int c = threadIdx.x; c < n_vectors * kFloatChunks; c += kThreads) {
    const int which = c / kFloatChunks, off = (c % kFloatChunks) * 4;
    const float* src = which == 0 ? ks : (which == 1 ? vs : mask);
    cp_async<16>(sf + which * TPS + off, src + t0 + off);
  }
  cp_async_commit();
}

// the stage of TPS positions from t0 in two copy groups, the K half, then
// the V codes, so the scores can start before the values have landed
template <int TPS, int CV>
__device__ __forceinline__ void load_stage(
    char* st, const int8_t* krow, const int8_t* vrow, const float* ks,
    const float* vs, const float* mask, int D, long long code_sd, int t0) {
  load_half<TPS, CV>(st, krow, ks, vs, mask, kVectors, D, code_sd, t0);
  load_half<TPS, CV>(st + D * Stage<TPS, kVectors>::RS, vrow, ks, vs, mask,
                     0, D, code_sd, t0);
}

template <typename TQ, int TPS, int CV>
__global__ void __launch_bounds__(kThreads)
cache_attend_int8_kernel(const TQ* __restrict__ q,
                         const int8_t* __restrict__ k_q,
                         const float* __restrict__ k_scale,
                         const int8_t* __restrict__ v_q,
                         const float* __restrict__ v_scale,
                         const float* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ counters, int H, int D, int T,
                         int chunk, int n_buf, long long code_sb,
                         long long code_sh, long long code_sd,
                         long long scale_sb, long long scale_sh,
                         long long mask_sb) {
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // D
  float* sm_acc = sm_q + D;                       // D
  float* sm_part = sm_acc + D;                    // 4 x kThreads
  float* sm_w = sm_part + 4 * kThreads;           // TPS
  char* stages = reinterpret_cast<char*>(sm_w + TPS);
  __shared__ float sm_red[kWarps];

  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int item = b * H + h;
  const int tid = threadIdx.x;
  const int t_begin = split * chunk;
  const int n_st = (min(T, t_begin + chunk) - t_begin) / TPS;
  const int sbytes = Stage<TPS, kVectors>::bytes(D);
  const size_t code0 = (size_t)b * code_sb + (size_t)h * code_sh;
  const size_t scale0 = (size_t)b * scale_sb + (size_t)h * scale_sh;
  const int8_t* krow = k_q + code0;
  const int8_t* vrow = v_q + code0;
  const float* ks = k_scale + scale0;
  const float* vs = v_scale + scale0;
  const float* mrow = mask + (size_t)b * mask_sb;

  // the first stages' bytes are requested before any arithmetic (every
  // stage's, in a ring of two; with one buffer each stage's as the last
  // one's values are done)
  const bool ring = n_buf > 1;
  load_stage<TPS, CV>(stages, krow, vrow, ks, vs, mrow, D, code_sd, t_begin);
  if (ring && n_st > 1)
    load_stage<TPS, CV>(stages + sbytes, krow, vrow, ks, vs, mrow, D,
                        code_sd, t_begin + TPS);
  for (int d = tid; d < D; d += kThreads)
    sm_q[d] = to_f32(q[(size_t)item * D + d]);
  start_values<TPS>(sm_acc, D);

  // s = dot * k_scale + mask, w = p * v_scale
  const auto score = [](const float* vec, int t, float dot) {
    return fmaf(dot, vec[t], vec[2 * TPS + t]);
  };
  const auto weight = [](const float* vec, int t, float p) {
    return p * vec[TPS + t];
  };
  Running<TPS> run;
  for (int j = 0; j < n_st; ++j) {
    char* st = stages + (ring ? (j & 1) * sbytes : 0);
    attend_stage<TPS, kVectors>(st, sm_q, sm_part, sm_w, sm_red, sm_acc, D,
                                TPS, ring && j + 1 < n_st, run, score,
                                weight);
    const int next = j + (ring ? 2 : 1);
    if (next < n_st)
      load_stage<TPS, CV>(st, krow, vrow, ks, vs, mrow, D, code_sd,
                          t_begin + next * TPS);
  }
  finish_values(run, sm_acc, D);
  split_softmax::finish<kThreads>(
      sm_acc, run.m, run.l, D, item, split, gridDim.y, gridDim.y,
      gridDim.z * H, ws, counters, out + (size_t)item * D);
}

template <typename TQ, int TPS, int CV>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* mask, void* out, void* ws,
           void* counters, int B, int H, int D, int T, int chunk,
           long long code_sb, long long code_sh, long long code_sd,
           long long scale_sb, long long scale_sh, long long mask_sb,
           cudaStream_t stream) {
  auto kernel = cache_attend_int8_kernel<TQ, TPS, CV>;
  constexpr int cap = Running<TPS>::kWide ? kWideSmemCap : kSmemCap;
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, cap, device);
  if (refused) return refused;
  const int splits = (T + chunk - 1) / chunk;
  const size_t work = (size_t)work_floats(D, TPS) * sizeof(float);
  const size_t sbytes = Stage<TPS, kVectors>::bytes(D);
  // a ring of two stages where a split has several and two fit
  const int n_buf =
      chunk / TPS > 1 && work + 2 * sbytes <= (size_t)cap ? 2 : 1;
  const size_t smem = work + (size_t)n_buf * sbytes;
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(H, splits, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const float*>(mask),
      static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), H, D, T, chunk, n_buf, code_sb, code_sh,
      code_sd, scale_sb, scale_sh, mask_sb);
  return (int)cudaGetLastError();
}

// ---- past kMaxHeadDim: q, codes, scales and mask read from global
// memory, the split's accumulator in its workspace row
// (wide_attend.cuh) ----

// one split's positions from t_begin: row d of the (row, head)'s codes
// holds consecutive positions, so the group's codes of one d share a
// sector
template <typename TQ>
struct Int8SlabSource {
  const TQ* qv;
  const int8_t* krow;  // position t_begin of row d = 0
  const int8_t* vrow;
  const float* ks;     // position t_begin
  const float* vs;
  const float* mrow;
  long long code_sd;
  int t0;
  __device__ float q(int d) const { return to_f32(qv[d]); }
  __device__ void group(int first, int) { t0 = first; }
  __device__ float k(int i, int d) const {
    return (float)krow[(size_t)d * code_sd + t0 + i];
  }
  __device__ float v(int i, int d) const {
    return (float)vrow[(size_t)d * code_sd + t0 + i];
  }
  __device__ float score(int i, float dot) const {
    return fmaf(dot, ks[t0 + i], mrow[t0 + i]);
  }
  __device__ float weight(int i, float p) const { return p * vs[t0 + i]; }
};

template <typename TQ>
__global__ void __launch_bounds__(wide_attend::kThreads)
cache_attend_int8_wide_kernel(
    const TQ* __restrict__ q, const int8_t* __restrict__ k_q,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_q,
    const float* __restrict__ v_scale, const float* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int H, int D, int T, int chunk,
    long long code_sb, long long code_sh, long long code_sd,
    long long scale_sb, long long scale_sh, long long mask_sb) {
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int item = b * H + h;
  const int t_begin = split * chunk;
  const size_t code0 = (size_t)b * code_sb + (size_t)h * code_sh + t_begin;
  const size_t scale0 =
      (size_t)b * scale_sb + (size_t)h * scale_sh + t_begin;
  float* acc = ws + ((size_t)item * gridDim.y + split) * D;
  Int8SlabSource<TQ> src{q + (size_t)item * D, k_q + code0, v_q + code0,
                         k_scale + scale0, v_scale + scale0,
                         mask + (size_t)b * mask_sb + t_begin, code_sd, 0};
  float m, l;
  wide_attend::run(src, min(T, t_begin + chunk) - t_begin, D, acc, m, l);
  __syncthreads();
  split_softmax::finish<wide_attend::kThreads>(
      acc, m, l, D, item, split, gridDim.y, gridDim.y, gridDim.z * H, ws,
      counters, out + (size_t)item * D);
}

// the stage width for head width D (stage_positions); the wide tile's
// 8-position stages copy 8 bytes a row where CV is 16
template <typename TQ, int CV>
int launch_width(const void* q, const void* kq, const void* ks,
                 const void* vq, const void* vs, const void* mask, void* out,
                 void* ws, void* counters, int B, int H, int D, int T,
                 int chunk, long long code_sb, long long code_sh,
                 long long code_sd, long long scale_sb, long long scale_sh,
                 long long mask_sb, cudaStream_t st) {
#define VELES_ATTEND_LAUNCH(TPS)                                            \
  launch<TQ, TPS, CV>(q, kq, ks, vq, vs, mask, out, ws, counters, B, H, D, \
                      T, chunk, code_sb, code_sh, code_sd, scale_sb,        \
                      scale_sh, mask_sb, st)
  if (D > kMaxHeadDim) {
    cache_attend_int8_wide_kernel<TQ>
        <<<dim3(H, (T + chunk - 1) / chunk, B), wide_attend::kThreads, 0,
           st>>>(static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
                 static_cast<const float*>(ks),
                 static_cast<const int8_t*>(vq),
                 static_cast<const float*>(vs),
                 static_cast<const float*>(mask), static_cast<float*>(out),
                 static_cast<float*>(ws), static_cast<int*>(counters), H, D,
                 T, chunk, code_sb, code_sh, code_sd, scale_sb, scale_sh,
                 mask_sb);
    return (int)cudaGetLastError();
  }
  switch (stage_positions(D)) {
    case 128: return VELES_ATTEND_LAUNCH(128);
    case 64: return VELES_ATTEND_LAUNCH(64);
    case 32: return VELES_ATTEND_LAUNCH(32);
    case 16: return VELES_ATTEND_LAUNCH(16);
    default:
      return launch<TQ, 8, CV < 8 ? CV : 8>(
          q, kq, ks, vq, vs, mask, out, ws, counters, B, H, D, T, chunk,
          code_sb, code_sh, code_sd, scale_sb, scale_sh, mask_sb, st);
  }
#undef VELES_ATTEND_LAUNCH
}

}  // namespace

extern "C" int veles_cache_attend_int8(
    const void* q, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* mask, void* out, void* ws,
    void* counters, int B, int H, int D, int T, int chunk, int q_dtype,
    int code16, long long code_sb, long long code_sh, long long code_sd,
    long long scale_sb, long long scale_sh, long long mask_sb,
    void* stream) {
  if (B < 1 || H < 1 || D < 32 || D % 32 || T < kTile ||
      T % kTile || chunk < kTile || chunk % kTile ||
      (T + chunk - 1) / chunk > split_softmax::kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VELES_ATTEND_ARGS                                                   \
  q, k_q, k_scale, v_q, v_scale, mask, out, ws, counters, B, H, D, T, chunk, \
      code_sb, code_sh, code_sd, scale_sb, scale_sh, mask_sb, st
  switch (q_dtype * 2 + (code16 ? 1 : 0)) {
    case 0: return launch_width<float, 4>(VELES_ATTEND_ARGS);
    case 1: return launch_width<float, 16>(VELES_ATTEND_ARGS);
    case 2: return launch_width<__nv_bfloat16, 4>(VELES_ATTEND_ARGS);
    case 3: return launch_width<__nv_bfloat16, 16>(VELES_ATTEND_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VELES_ATTEND_ARGS
}
