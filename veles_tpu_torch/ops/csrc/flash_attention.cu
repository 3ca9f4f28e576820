// K7: the flash-attention forward, O = softmax(Q K^T / sqrt(D)) V and the
// f32 logsumexp of every query row's scaled scores.
//
// Replaces: _flash_attention_kernel via flash_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py:331-557, pallas_call
// :758), which veles_tpu/ops/attention.py:30-37 calls for every attention
// at 4096 positions and more with a head width that is a multiple of 128:
// the long-context prefill and every train and eval minibatch of the
// long-context training tier, at (1, 8192, 8, 128) bf16.
//
// What bounds it on the H100: operations. A causal (B, T, H, D) call does
// two products over the T (T + 1) / 2 visible (query, key) pairs, 2 D
// operations a pair each: 137 GFLOP at (1, 8192, 8, 128), 0.139 ms at 989
// TFLOP/s, against 67 MB of q, k, v, O and logsumexp (0.020 ms at 3.35
// TB/s). The S x S scores never reach device memory.
//
// Design (a simple first version: no TMA, no wgmma, no pipelining):
// - One block of four warps per (64-query tile, head, row); the grid runs
//   the longest (causal) tiles first. q, k, v are (B, T, H, D) read in
//   place through their strides (the qkv projection's split views): no
//   transpose. Ragged T is masked, not padded: rows past T load as zero,
//   keys past T score -inf, rows past T are not stored.
// - Each warp keeps its 16 query rows as mma A fragments in registers and
//   walks the 64-key K/V tiles staged through shared memory; the causal
//   walk stops at the block's diagonal tile, so tiles above the diagonal
//   are never loaded or computed.
// - bf16: S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16,
//   f32 accumulator), the FlashAttention-2 arrangement of flash_tiles.cuh:
//   the score tile becomes P's A fragments in registers. An online softmax
//   in f32 (log2 units): the running max and sum per row, the accumulator
//   rescaled when the max grows. P is rounded to V's type before P V, as
//   the Pallas kernel does (:471, :556); the sum divides the f32
//   accumulator once at the end.
// - f32 (the agreement runs): the same walk on the CUDA cores in true f32
//   FMA, 32-query tiles, eight threads a row.

#include "flash_tiles.cuh"

using namespace flash_tiles;

namespace {

constexpr int kBQ = 64;  // query rows a block, 16 a warp
constexpr int kBK = 64;  // keys a tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int H, int Tq, int Tk, int causal,
             float scale_log2, Strides qs, Strides ks, Strides vs) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* sk = sq + kBQ * LD;                      // [kBK][LD]
  bf16* sv = sk + kBK * LD;                      // [kBK][LD]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int row0 = w0 + g, row1 = row0 + 8;

  load_rows<bf16, D, kBQ, LD>(sq, q + b * qs.b + h * qs.h, qs.t, q0, Tq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qf[kk], sq, LD, warp * 16, kk * 16);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile has been read
    load_rows<bf16, D, kBK, LD>(sk, kb, ks.t, k0, Tk);
    load_rows<bf16, D, kBK, LD>(sv, vb, vs.t, k0, Tk);
    __syncthreads();
    if (causal && k0 > w0 + 15) continue;  // every key past the warp's rows

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, sk, LD, j * 8, kk * 16);
        mma(s[j], qf[kk], b0, b1);
      }
    }
    // scale to log2 units; -inf past T and above the diagonal
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > w0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = k0 + j * 8 + 2 * c + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= Tk || (causal && col > row)) x = -INFINITY;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // a row with no visible key yet keeps exp2(-inf) = 0 everywhere
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * t + half;
        p[half][0] = exp2f(s[j][0] - base0);
        p[half][1] = exp2f(s[j][1] - base0);
        p[half][2] = exp2f(s[j][2] - base1);
        p[half][3] = exp2f(s[j][3] - base1);
        l0 += p[half][0] + p[half][1];
        l1 += p[half][2] + p[half][3];
      }
      uint32_t a[4];
      c_to_a(a, p[0], p[1]);  // P rounded to bf16
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, sv, LD, t * 16, n * 8);
        mma(acc[n], a, b0, b1);
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_acc<D>(o, acc, b, h, H, Tq, w0, l0 > 0.f ? 1.f / l0 : 0.f,
               l1 > 0.f ? 1.f / l1 : 0.f);
  if (c == 0) {
    float* lrow = lse + ((long long)b * H + h) * Tq;
    if (row0 < Tq) lrow[row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < Tq) lrow[row1] = (m1 + log2f(l1)) * kLn2;
  }
}

constexpr int kF32Threads = 256;
constexpr int kF32BQ = 32;  // query rows a block, eight threads a row
constexpr int kF32BK = 32;  // keys a tile, four a thread

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, int H, int Tq, int Tk, int causal,
            float scale_log2, Strides qs, Strides ks, Strides vs) {
  // rows padded by 4 floats: the eight keys a warp reads at one d fall on
  // eight bank quads
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kF32BQ][LD]
  float* sk = sq + kF32BQ * LD;                    // [kF32BK][LD]
  float* sv = sk + kF32BK * LD;                    // [kF32BK][LD]
  float* sp = sv + kF32BK * LD;                    // [kF32BQ][kF32BK + 1]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BQ;
  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int row = q0 + r;

  load_rows<float, D, kF32BQ, LD, kF32Threads>(
      sq, q + b * qs.b + h * qs.h, qs.t, q0, Tq);
  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int k_end = causal ? min(Tk, q0 + kF32BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kF32BK) {
    __syncthreads();
    load_rows<float, D, kF32BK, LD, kF32Threads>(sk, kb, ks.t, k0, Tk);
    load_rows<float, D, kF32BK, LD, kF32Threads>(sv, vb, vs.t, k0, Tk);
    __syncthreads();
    float s[kF32BK / 8] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = sq[r * LD + d];
#pragma unroll
      for (int j = 0; j < kF32BK / 8; ++j)
        s[j] = fmaf(qd, sk[(c8 + 8 * j) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32BK / 8; ++j) {
      const int col = k0 + c8 + 8 * j;
      s[j] = (col >= Tk || (causal && col > row)) ? -INFINITY
                                                  : s[j] * scale_log2;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int o8 = 1; o8 < 8; o8 <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o8));
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - base);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BK / 8; ++j) {
      const float p = exp2f(s[j] - base);
      l += p;
      sp[r * (kF32BK + 1) + c8 + 8 * j] = p;
    }
    __syncwarp();  // a row's eight threads share one warp
#pragma unroll 4
    for (int key = 0; key < kF32BK; ++key) {
      const float p = sp[r * (kF32BK + 1) + key];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        acc[i] = fmaf(p, sv[key * LD + c8 + 8 * i], acc[i]);
    }
  }
#pragma unroll
  for (int o8 = 1; o8 < 8; o8 <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, o8);
  if (row < Tq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* out = o + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) out[c8 + 8 * i] = acc[i] * inv;
    if (c8 == 0)
      lse[((long long)b * H + h) * Tq + row] = (m + log2f(l)) * kLn2;
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Tq, int Tk, int causal, int dtype, float scale,
        Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = (size_t)(kBQ + 2 * kBK) * (D + kPad) * sizeof(bf16);
    err = allow_smem(fwd_bf16<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
    fwd_bf16<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, Tq, Tk,
        causal, scale_log2, qs, ks, vs);
  } else {
    const size_t smem = ((size_t)(kF32BQ + 2 * kF32BK) * (D + 4)
                         + kF32BQ * (kF32BK + 1)) * sizeof(float);
    err = allow_smem(fwd_f32<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Tq + kF32BQ - 1) / kF32BQ, H, B);
    fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, Tq, Tk,
        causal, scale_log2, qs, ks, vs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) through their element strides
// (sb, st, sh; the head axis contiguous); o (B, Tq, H, D) contiguous in
// q's type; lse (B, H, Tq) f32. dtype: 0 float32, 1 bfloat16; D: 128,
// the head width of the repo's flash configuration. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for another D).
extern "C" int veles_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Tq,
                               int Tk, int D, int causal, int dtype,
                               float scale, long long qsb, long long qst,
                               long long qsh, long long ksb, long long kst,
                               long long ksh, long long vsb, long long vst,
                               long long vsh, void* stream) {
  Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return run<128>(q, k, v, o, lse, B, H, Tq, Tk, causal, dtype, scale, qs, ks,
                  vs, s);
}
