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
// - Each block stages its split in stages of TPS positions (128 at D <=
//   128, fewer at wider heads so a stage stays near 32 KB): the (D, TPS)
//   K codes with the K and V scales and the mask slice, then the V codes,
//   two cp.async groups of 16-byte copies (4-byte ones where the code rows
//   are not 16-byte aligned), issued as the block starts, so the scores
//   start while the V codes land; a split of several stages runs a
//   two-stage ring. Code rows lie TPS + 16 bytes apart in shared memory.
// - int8 widens exactly through the f32 magic number 2^23 + (c + 128): a
//   byte permute and a subtraction, at the full rate (a conversion
//   instruction runs at a quarter of it).
// - Scores: TPS/4 lanes take a quad of positions each and the block's
//   128 / (TPS/4) row groups a share of the d-rows (a warp reads 128
//   consecutive bytes); the row groups' partial dots meet in shared memory
//   in a fixed order, then s = dot * k_scale + mask. A block max,
//   p = exp(s - max), a block sum, and the weights w = p * v_scale kept
//   in f32 (the TPU kernel's numerics; JAX's XLA formulation rounds them
//   to bf16 for a bf16 q, which this kernel does not). Values: P lanes a
//   d-row (P = 128 / D where D <= 64), each summing its share of the
//   positions with 16-byte reads into a register; the P lanes meet by
//   shuffles at the end. Stages meet by the online-softmax rescale.
// - The splits meet in the same launch (split_softmax.cuh): each block
//   writes its (max, sum, acc) to the wrapper's workspace, and the last
//   block of the (row, head) merges them in split order (deterministic)
//   and resets the counter. One split writes the output itself.
// A masked position's addend (-1e30) makes its exp an exact zero once a
// visible position has set the max; an all-masked split weighs zero in
// the merge, and an all-masked row gets the uniform softmax one pass
// gives. q is pre-scaled by 1/sqrt(D) by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"           // SmemOptIn
#include "split_softmax.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // the plan's tile: splits are whole tiles
// the largest dynamic shared memory a block may ask for (the opt-in,
// below the H100's 227 KB less the static shared memory): two stages at
// D = 1024 take 142 KB
constexpr int kSmemCap = 192 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a BYTES-byte copy (16 or 4) from global into shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
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

// A stage's layout: K code rows (D rows of TPS codes, RS = TPS + 16 bytes
// apart, so eight rows read at one column hit 32 banks), V code rows
// alike, then k_scale, v_scale and the mask (TPS floats each).
template <int TPS>
struct Stage {
  static constexpr int RS = TPS + 16;
  __host__ __device__ static constexpr int bytes(int D) {
    return 2 * D * RS + 3 * TPS * 4;
  }
};

// the copies of one code half of the stage of TPS positions from t0 (the
// K codes with k_scale, v_scale and the mask, or the V codes), as one copy
// group: code rows in chunks of CV bytes, the vectors in 16-byte chunks
template <int TPS, int CV>
__device__ __forceinline__ void load_half(char* st, const int8_t* codes,
                                          const float* ks, const float* vs,
                                          const float* mask, int n_vectors,
                                          int D, long long code_sd, int t0) {
  constexpr int RS = Stage<TPS>::RS;
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
  load_half<TPS, CV>(st, krow, ks, vs, mask, 3, D, code_sd, t0);
  load_half<TPS, CV>(st + D * Stage<TPS>::RS, vrow, ks, vs, mask, 0, D,
                     code_sd, t0);
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
                         int chunk, long long code_sb, long long code_sh,
                         long long code_sd, long long scale_sb,
                         long long scale_sh, long long mask_sb) {
  constexpr int RS = Stage<TPS>::RS;
  constexpr int Q = TPS / 4;          // lanes of a row in the score pass
  constexpr int RG = kThreads / Q;    // row groups of the score pass
  constexpr int RPT = 128 / TPS;      // d-rows a thread in the value pass
  extern __shared__ float4 smem4[];
  float* sm_q = reinterpret_cast<float*>(smem4);  // D
  float* sm_acc = sm_q + D;                       // D
  float* sm_part = sm_acc + D;                    // RG x TPS
  float* sm_w = sm_part + RG * TPS;               // TPS
  char* stages = reinterpret_cast<char*>(sm_w + TPS);
  __shared__ float sm_red[kWarps];

  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int item = b * H + h;
  const int tid = threadIdx.x;
  const int t_begin = split * chunk;
  const int n_st = (min(T, t_begin + chunk) - t_begin) / TPS;
  const int sbytes = Stage<TPS>::bytes(D);
  const size_t code0 = (size_t)b * code_sb + (size_t)h * code_sh;
  const size_t scale0 = (size_t)b * scale_sb + (size_t)h * scale_sh;
  const int8_t* krow = k_q + code0;
  const int8_t* vrow = v_q + code0;
  const float* ks = k_scale + scale0;
  const float* vs = v_scale + scale0;
  const float* mrow = mask + (size_t)b * mask_sb;

  // every stage's bytes are requested before any arithmetic
  load_stage<TPS, CV>(stages, krow, vrow, ks, vs, mrow, D, code_sd, t_begin);
  if (n_st > 1)
    load_stage<TPS, CV>(stages + sbytes, krow, vrow, ks, vs, mrow, D,
                        code_sd, t_begin + TPS);
  for (int d = tid; d < D; d += kThreads)
    sm_q[d] = to_f32(q[(size_t)item * D + d]);

  // The value pass: P lanes share a d-row (P = 128 / D rounded down to a
  // power of two where D <= 128, else 1), each summing TPS / P positions
  // with 16-byte reads; a thread keeps its rows' sums in registers.
  const int P = D >= kThreads ? 1 : (D > 32 ? (D > 64 ? 1 : 2) : 4);
  const int rows_per_pass = kThreads / P;
  const int part = tid % P;
  const int seg = TPS / P;            // positions of a part, a multiple of 16
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  // every thread holds the same running max and sum of p
  float run_max = -INFINITY, run_sum = 0.f;
  for (int j = 0; j < n_st; ++j) {
    // the groups still in flight behind stage j's: the next stage's two
    const bool more = j + 1 < n_st;
    if (more)
      cp_async_wait<3>();
    else
      cp_async_wait<1>();
    __syncthreads();  // stage j's K half has landed for every thread
    const char* st = stages + (j & 1) * sbytes;
    const int8_t* sk = reinterpret_cast<const int8_t*>(st);
    const int8_t* sv = sk + D * RS;
    const float* sks = reinterpret_cast<const float*>(sv + D * RS);
    const float* svs = sks + TPS;
    const float* smk = svs + TPS;

    // 1. partial dots: quad `quad` of row group `rg`'s d-rows
    {
      const int quad = tid % Q, rg = tid / Q;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
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
      s = fmaf(dot, sks[tid], smk[tid]);
    }
    // every position has a finite score, so the max is finite
    const float mx = fmaxf(
        run_max, block_reduce<true>(s, sm_red));
    // 0 on the first stage (exp(-inf)); 1 while the max stays
    const float alpha = expf(run_max - mx);
    float p = 0.f;
    if (tid < TPS) {
      p = expf(s - mx);
      sm_w[tid] = p * svs[tid];
    }
    if (more)  // stage j's V half
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    // the reduction's barriers also publish the weights and the V half
    run_sum = run_sum * alpha +
              block_reduce<false>(p, sm_red);
    run_max = mx;

    // 3. values: acc = acc * alpha + sum over the part's positions of w v
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int d = tid / P + r * rows_per_pass;
      if (d < D) {
        const int8_t* row = sv + d * RS + part * seg;
        const float4* w4 = reinterpret_cast<const float4*>(sm_w + part * seg);
        float a = 0.f;
        for (int t = 0; t < seg; t += 16) {
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
        acc[r] = acc[r] * alpha + a;
      }
    }
    __syncthreads();  // stage j's buffer and the weights are free
    if (j + 2 < n_st)
      load_stage<TPS, CV>(stages + (j & 1) * sbytes, krow, vrow, ks, vs,
                          mrow, D, code_sd, t_begin + (j + 2) * TPS);
  }
  // the parts of a row meet (P consecutive lanes), then the split's state
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float a = acc[r];
    for (int o = P / 2; o > 0; o >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    const int d = tid / P + r * rows_per_pass;
    if (part == 0 && d < D) sm_acc[d] = a;
  }
  __syncthreads();
  split_softmax::finish<kThreads>(
      sm_acc, run_max, run_sum, D, item, split, gridDim.y, gridDim.y,
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
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, kSmemCap, device);
  if (refused) return refused;
  const int splits = (T + chunk - 1) / chunk;
  const int stages = chunk / TPS > 1 ? 2 : 1;
  const size_t smem = (size_t)(2 * D + (kThreads / (TPS / 4)) * TPS + TPS) *
                          sizeof(float) +
                      (size_t)stages * Stage<TPS>::bytes(D);
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(H, splits, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const float*>(mask),
      static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), H, D, T, chunk, code_sb, code_sh,
      code_sd, scale_sb, scale_sh, mask_sb);
  return (int)cudaGetLastError();
}

// the stage width for head width D: a stage of K and V codes near 32 KB
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
  if (D <= 128) return VELES_ATTEND_LAUNCH(128);
  if (D <= 256) return VELES_ATTEND_LAUNCH(64);
  if (D <= 512) return VELES_ATTEND_LAUNCH(32);
  return VELES_ATTEND_LAUNCH(16);
#undef VELES_ATTEND_LAUNCH
}

}  // namespace

// q (B, 1, H, D) contiguous, pre-scaled by 1/sqrt(D); k_q / v_q int8 with
// element strides (code_sb, code_sh, code_sd, 1) over (B, H, D, T);
// k_scale / v_scale float32 with strides (scale_sb, scale_sh, 1) over
// (B, H, T); mask float32 addend with strides (mask_sb, 1) over (B, T),
// mask_sb = 0 for one mask shared by every row; out (B, 1, H, D) float32
// contiguous. Every stride a multiple of 4, codes 4-byte and scales and
// mask 16-byte aligned; T % 128 == 0, 32 <= D <= 1024 with D % 32 == 0.
// The plan: splits of `chunk` positions (a multiple of 128; the last may
// be shorter), at most split_softmax::kMaxSplits of them; with more than
// one, ws holds B * H * splits * (D + 2) floats and counters B * H zeroed
// ints (left zeroed). code16: the codes' base and strides are 16-byte
// multiples (16-byte copies; else 4-byte ones). q type: 0 = float32,
// 1 = bfloat16. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int veles_cache_attend_int8(
    const void* q, const void* k_q, const void* k_scale, const void* v_q,
    const void* v_scale, const void* mask, void* out, void* ws,
    void* counters, int B, int H, int D, int T, int chunk, int q_dtype,
    int code16, long long code_sb, long long code_sh, long long code_sd,
    long long scale_sb, long long scale_sh, long long mask_sb,
    void* stream) {
  if (B < 1 || H < 1 || D < 32 || D % 32 || D > 1024 || T < kTile ||
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
