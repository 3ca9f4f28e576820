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
// Design of the bf16 kernel at head widths 128 and 256 (fwd_sm90, for
// Hopper: TMA, mbarriers, wgmma; sm90.cuh):
// - One block of three warpgroups per (128-query tile, head, row); the
//   grid runs the longest causal tiles first. Warpgroup 0 is the
//   producer: one thread loads the block's Q tile once and then walks the
//   key tiles (BK keys: 128 at D 128, 64 at D 256), keeping a two-stage
//   ring of K and V tiles filled by TMA, each stage with its own K-full,
//   V-full and empty mbarrier, so a stage's S product starts before its V
//   has landed. Warpgroups 1 and 2 own 64 query rows each.
// - q, k, v are (B, T, H, D) views read in place through rank-4 tensor
//   maps (D, H, T, B) with the views' strides (the qkv projection's split
//   views: nothing is transposed or copied). A 256-byte head row is split
//   into 64-element boxes (the 128-byte swizzle's width), one
//   [rows][64] box a 64-wide column chunk. TMA fills rows past T with
//   zeros; keys past T score -inf and rows past T are not stored.
// - S = Q K^T: wgmma m64nBKk16 with Q (K-major A) and K (K-major B, keys
//   as rows) from shared memory, over D / 16 steps. The online softmax
//   (log2 units, running max and sum per row, the accumulator rescaled
//   when the max grows) runs on the accumulator in registers; P is
//   rounded to bf16 as the Pallas kernel rounds it (:471) and repacked in
//   registers as the A fragments of O += P V: wgmma m64nDk16 with A from
//   registers and V (keys x D, D contiguous) read as an MN-major B
//   through the transpose bit. The causal walk stops at the block's last
//   diagonal tile.
// - The O accumulator is 64 x D f32 a warpgroup (D / 2 registers a
//   thread); setmaxnreg gives the consumers 240 registers.
//
// Other head widths that are multiples of 128 (384, ...) run fwd_wide,
// the mma.sync kernel of flash_tiles.cuh with a grid axis over 128-wide
// output chunks.
//
// f32 operands (a training caller whose parameters are f32: the default
// precision of the transformer step, on one process and in each rank's
// Ulysses attention, once T >= 4096; the agreement runs) run fwd_tf32 at
// every multiple of 128, P unrounded as the f32 plain version keeps it.
// It replaces an f32 FMA kernel on the CUDA cores (5.81 ms at (1, 8192,
// 4, 128) causal on an H100, 11.8 TFLOP/s: each FMA read an operand from
// shared memory, and 32-row query tiles re-read K and V 256 times).
//
// What bounds it: operations, two products of 2 D a visible pair, 68.7
// GFLOP at (1, 8192, 4, 128) causal: 1.03 ms at the 67 TFLOP/s of f32
// FMA, 0.42 ms at 165 TFLOP/s, a third of the tensor cores' 495 TFLOP/s
// in TF32.
//
// Design: both products run 3xTF32 on the tensor cores (mma.sync
// m16n8k8, tf32x3.cuh, K8 and K9's f32 arithmetic): each f32 operand
// splits into hi and lo in registers and a product sums lo * hi, hi * lo
// and hi * hi (tests/test_torch_flash_f32_split.py: one TF32 product
// misses the 1e-5 row rule, three meet it).
// - The tensor cores round their own sums toward zero, so no sum stays in
//   an mma accumulator for long: each 8-deep step of S = Q K^T and each
//   walked tile's P V sum from zero and are added in f32 registers
//   (carried in the mma, the rows drifted to 7.4e-5 of the plain
//   version at (1, 8192, 4, 128) causal on an H100, past the 1e-5 rule).
// - One block of eight warps owns 128 query rows, 16 a warp, and walks
//   the keys in tiles of 64: each K and V tile is read once per 128
//   queries. At head width 128 the Q tile stays in shared memory; the K
//   and V tiles come through a two-stage cp.async ring (203 KB a block;
//   tiles of 32 keys, 135 KB, ran 1.43 ms against 1.35 at (1, 8192, 4,
//   128) causal on an H100, tools/flash_f32_ab.py).
// - A warp's S (16 x 64) stays in registers; the online softmax (log2
//   units, running max and sum per row, O rescaled when the max grows)
//   runs on its C fragments, and P feeds O += P V from registers as A
//   fragments (tf32x3.cuh's value_tile): nothing of P reaches memory.
// - Wider heads keep a grid axis over 128-wide output chunks: a walked
//   tile is one item per 128-wide chunk of S, each reloading the block's
//   own Q chunk, then one item holding V's output chunk.
// - The causal walk stops at the block's diagonal tile, a warp with no
//   visible key in a tile skips it, and the grid runs the longest walks
//   first.

#include "flash_tiles.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

using namespace flash_tiles;
using namespace tf32x3;

namespace {

// ---- bf16, head width 128 or 256: TMA + wgmma ------------------------------

constexpr int kWgThreads = 384;  // producer warpgroup + two consumers
constexpr int kWgBQ = 128;       // query rows a block, 64 a consumer

template <int D>
struct Sm90Tile {
  static constexpr int BK = D == 128 ? 128 : 64;  // keys a tile
  static constexpr int STAGES = 2;
  static constexpr int CH = D / 64;               // 64-wide column chunks
  static constexpr size_t SMEM =
      (static_cast<size_t>(kWgBQ) * D + 2 * STAGES * BK * D) * sizeof(bf16) +
      (1 + 3 * STAGES) * sizeof(uint64_t) + 1024;  // + alignment slack
};

template <int BK>
__device__ __forceinline__ void score_mma(float (&s)[BK / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (BK == 128)
    sm90::wgmma_ss_n128<0, 0>(s, da, db, scale_d);
  else
    sm90::wgmma_ss_n64<0, 0>(s, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void value_mma(float (&o)[D / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (D == 256)
    sm90::wgmma_rs_n256<1>(o, a, db, 1);
  else
    sm90::wgmma_rs_n128<1>(o, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
             float* __restrict__ lse, int H, int Tq, int Tk, int causal,
             float scale_log2) {
  using Tile = Sm90Tile<D>;
  constexpr int BK = Tile::BK, CH = Tile::CH, STAGES = Tile::STAGES;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sk = sq + kWgBQ * D;       // STAGES x CH x [BK][64]
  bf16* sv = sk + STAGES * BK * D;  // STAGES x CH x [BK][64]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sv + STAGES * BK * D);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int k_end = causal ? min(Tk, q0 + kWgBQ) : Tk;
  const int tiles = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&kfull[s], 1);
      sm90::mbar_init(&vfull[s], 1);
      sm90::mbar_init(&empty[s], 256);  // every consumer thread arrives
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      constexpr uint32_t KV_BYTES = BK * D * sizeof(bf16);
      sm90::mbar_expect_tx(qfull, kWgBQ * D * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < CH; ++c)
        sm90::tma_load_4d(sq + c * kWgBQ * 64, &qmap, qfull, 64 * c, h, q0,
                          b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % STAGES, k0 = j * BK;
        if (j >= STAGES) sm90::mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        sm90::mbar_expect_tx(&kfull[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          sm90::tma_load_4d(sk + (s * CH + c) * BK * 64, &kmap, &kfull[s],
                            64 * c, h, k0, b);
        sm90::mbar_expect_tx(&vfull[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          sm90::tma_load_4d(sv + (s * CH + c) * BK * 64, &vmap, &vfull[s],
                            64 * c, h, k0, b);
      }
    }
  } else {
    // ---- consumers: rows q0 + 64 w .. q0 + 64 w + 63 ----
    sm90::reg_alloc<240>();
    const int w = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int c4 = lane & 3;
    const int row0 = q0 + 64 * w + 16 * warp + (lane >> 2), row1 = row0 + 8;
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float sacc[BK / 2];
    sm90::mbar_wait(qfull, 0);
    const bf16* qw = sq + w * 64 * 64;  // the warpgroup's rows, chunk 0

    for (int j = 0; j < tiles; ++j) {
      const int s = j % STAGES, k0 = j * BK;
      const uint32_t parity = (j / STAGES) & 1;
      sm90::mbar_wait(&kfull[s], parity);
      const bf16* kt = sk + s * CH * BK * 64;
      sm90::fence_acc(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          score_mma<BK>(
              sacc, sm90::desc_sw128(qw + c * kWgBQ * 64 + kk * 16, 16, 1024),
              sm90::desc_sw128(kt + c * BK * 64 + kk * 16, 16, 1024),
              (c | kk) != 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sacc);

      // scale to log2 units; -inf past T and above the diagonal
      const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + 64 * w);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * jj + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * jj + 2 * c4 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= Tk || (causal && col > row)) x = -INFINITY;
          }
          sacc[4 * jj + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * jj], sacc[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * jj + 2], sacc[4 * jj + 3]));
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
        oacc[4 * n] *= alpha0;
        oacc[4 * n + 1] *= alpha0;
        oacc[4 * n + 2] *= alpha1;
        oacc[4 * n + 3] *= alpha1;
      }
      // P = exp2(s - max), rounded to bf16 into the A fragments of P V:
      // keys 16 t .. 16 t + 15 are the accumulator's column blocks 2 t and
      // 2 t + 1
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p[e] = exp2f(sacc[8 * t + e] - ((e & 2) ? base1 : base0));
        l0 += p[0] + p[1] + p[4] + p[5];
        l1 += p[2] + p[3] + p[6] + p[7];
        pf[t][0] = pack(p[0], p[1]);
        pf[t][1] = pack(p[2], p[3]);
        pf[t][2] = pack(p[4], p[5]);
        pf[t][3] = pack(p[6], p[7]);
      }

      sm90::mbar_wait(&vfull[s], parity);
      const bf16* vt = sv + s * CH * BK * 64;
      sm90::fence_acc(oacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        value_mma<D>(oacc, pf[t],
                     sm90::desc_sw128(vt + t * 16 * 64, BK * 64 * 2, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(oacc);
      sm90::mbar_arrive(&empty[s]);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float f0 = l0 > 0.f ? 1.f / l0 : 0.f, f1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= Tq) continue;
      const float f = half ? f1 : f0;
      bf16* p = o + (((long long)b * Tq + row) * H + h) * D + 2 * c4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(p + n * 8) =
            pack(oacc[4 * n + 2 * half] * f, oacc[4 * n + 2 * half + 1] * f);
    }
    if (c4 == 0) {
      float* lrow = lse + ((long long)b * H + h) * Tq;
      if (row0 < Tq) lrow[row0] = (m0 + log2f(l0)) * kLn2;
      if (row1 < Tq) lrow[row1] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

template <int D>
int run_sm90(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int Tq, int Tk, int causal,
             float scale_log2, const Strides& qs, const Strides& ks,
             const Strides& vs, cudaStream_t stream) {
  using Tile = Sm90Tile<D>;
  CUtensorMap qmap, kmap, vmap;
  int err = sm90::view_map(&qmap, q, B, Tq, H, D, qs.b, qs.t, qs.h, kWgBQ);
  if (!err)
    err = sm90::view_map(&kmap, k, B, Tk, H, D, ks.b, ks.t, ks.h, Tile::BK);
  if (!err)
    err = sm90::view_map(&vmap, v, B, Tk, H, D, vs.b, vs.t, vs.h, Tile::BK);
  if (err) return err;
  cudaError_t cerr = allow_smem(fwd_sm90<D>, Tile::SMEM);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  dim3 grid((Tq + kWgBQ - 1) / kWgBQ, H, B);
  fwd_sm90<D><<<grid, kWgThreads, Tile::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), lse, H, Tq, Tk, causal,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, any other multiple of 128: mma.sync, a chunk axis ----------------

constexpr int kWideBQ = 64;  // query rows a block, 16 a warp
constexpr int kWideBK = 64;  // keys a tile

__global__ void __launch_bounds__(kThreads)
    fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int H, int Tq, int Tk, int D,
             int causal, float scale_log2, Strides qs, Strides ks,
             Strides vs) {
  constexpr int LD = kChunk + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kWideBQ][LD], a chunk
  bf16* sk = sq + kWideBQ * LD;                  // [kWideBK][LD], a chunk
  bf16* sv = sk + kWideBK * LD;                  // [kWideBK][LD], chunk oc

  const int chunks = D / kChunk;
  const int oc = blockIdx.x % chunks;
  const int q0 = (gridDim.x / chunks - 1 - blockIdx.x / chunks) * kWideBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = q0 + warp * 16;
  const int row0 = w0 + g, row1 = row0 + 8;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  float acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int k_end = causal ? min(Tk, q0 + kWideBQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kWideBK) {
    const bool skip = causal && k0 > w0 + 15;  // every key past the rows
    float s[kWideBK / 8][4];
#pragma unroll
    for (int j = 0; j < kWideBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int dc = 0; dc < chunks; ++dc) {
      __syncthreads();  // the previous chunk (and tile) has been read
      load_rows<bf16, kChunk, kWideBQ, LD>(sq, qb + dc * kChunk, qs.t, q0,
                                           Tq);
      load_rows<bf16, kChunk, kWideBK, LD>(sk, kb + dc * kChunk, ks.t, k0,
                                           Tk);
      if (dc == 0)
        load_rows<bf16, kChunk, kWideBK, LD>(sv, vb + oc * kChunk, vs.t, k0,
                                             Tk);
      __syncthreads();
      if (skip) continue;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t a[4];
        load_a(a, sq, LD, warp * 16, kk * 16);
#pragma unroll
        for (int j = 0; j < kWideBK / 8; ++j) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, sk, LD, j * 8, kk * 16);
          mma(s[j], a, b0, b1);
        }
      }
    }
    if (skip) continue;
    const bool edge = k0 + kWideBK > Tk || (causal && k0 + kWideBK - 1 > w0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kWideBK / 8; ++j) {
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
    const float base0 = mx0 == -INFINITY ? 0.f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int t = 0; t < kWideBK / 16; ++t) {
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
      for (int n = 0; n < kChunk / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, sv, LD, t * 16, n * 8);
        mma(acc[n], a, b0, b1);
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_chunk<kChunk>(o, acc, b, h, H, Tq, D, oc * kChunk, w0,
                      l0 > 0.f ? 1.f / l0 : 0.f, l1 > 0.f ? 1.f / l1 : 0.f);
  if (c == 0 && oc == 0) {
    float* lrow = lse + ((long long)b * H + h) * Tq;
    if (row0 < Tq) lrow[row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < Tq) lrow[row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// ---- f32, any multiple of 128: 3xTF32 on the tensor cores ----------------
// (the splits, mma3, value_tile, rows_async and store_f32: tf32x3.cuh)

constexpr int kT32BQ = 128;  // query rows a block, 16 a warp
constexpr int kT32BK = 64;   // keys a walked tile
constexpr int kT32N = kT32BK / 8;  // the walked tile's 8-wide n-tiles
constexpr int kT32Tile = kT32BK * kT32LD;  // a walked tile's floats
// a ring stage: the walked keys' K and V tiles (at wider heads K's chunk
// or V's output chunk)
constexpr int kT32Stage = 2 * kT32Tile;
constexpr size_t kT32Smem = (kT32BQ * kT32LD + 2 * kT32Stage) * sizeof(float);

// each product's split (tf32x3.cuh's split): both truncated, rows within
// 3.1e-6 of the plain version at (1, 8192, 4, 128) causal on an H100,
// where both rounded to nearest read 2.7e-6 at 1.60 ms against 1.43
// (tools/flash_f32_ab.py, 32-key tiles)
constexpr bool kNearestS = false, kNearestV = false;

// x (16 x kT32BK) += rows [r0, r0 + 16) of the query tile `a` times the
// walked key tile `b` transposed, over one 128-wide chunk, both K-major.
// Each 8-deep step sums from zero in the mma and is added to x in f32.
__device__ __forceinline__ void score_tile(float (&x)[kT32N][4],
                                          const float* a, const float* b,
                                          int r0) {
  const int lane = threadIdx.x & 31;
  const int row = (lane >> 2) * kT32LD + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    uint32_t ah[4], al[4];
    load_a_split<kNearestS>(ah, al, a, r0, 8 * kk);
#pragma unroll
    for (int n = 0; n < kT32N; ++n) {
      const float* pb = b + 8 * n * kT32LD + row + 8 * kk;
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma3<kNearestS>(t, ah, al, pb[0], pb[4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] += t[e];
    }
  }
}

__global__ void __launch_bounds__(kT32Threads, 1)
    fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int Tq, int Tk, int D,
             int causal, float scale_log2, Strides qs, Strides ks,
             Strides vs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kT32BQ][LD], a chunk
  float* ring = sq + kT32BQ * kT32LD;              // 2 x {K, V tiles}

  const int chunks = D / kChunk, per_tile = items_a_tile(chunks);
  const int h = blockIdx.x, b = blockIdx.z;
  const int oc = blockIdx.y % chunks;
  // longest walk first
  const int q0 = (gridDim.y / chunks - 1 - blockIdx.y / chunks) * kT32BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c4 = lane & 3;
  const int wq = 16 * warp;  // the warp's first row in the block
  const int row0 = q0 + wq + (lane >> 2), row1 = row0 + 8;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  const int k_end = causal ? min(Tk, q0 + kT32BQ) : Tk;
  const int items = (k_end + kT32BK - 1) / kT32BK * per_tile;
  // item i into stage i % 2: the walked keys' chunk of K, and on a value
  // item V's output chunk (both on the one item of a 128-wide head)
  auto issue = [&](int i) {
    float* st = ring + (i % 2) * kT32Stage;
    const int k0 = i / per_tile * kT32BK, part = i % per_tile;
    if (part < chunks)
      rows_async<kT32BK>(st, kb + part * kChunk, ks.t, k0, Tk);
    if (chunks == 1 || part == chunks)
      rows_async<kT32BK>(st + kT32Tile, vb + oc * kChunk, vs.t, k0, Tk);
  };

  float acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float s[kT32N][4];  // queries x keys: S, then P
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (chunks == 1)  // the block's rows stay for the whole walk
    rows_async<kT32BQ>(sq, qb, qs.t, q0, Tq);
  issue(0);
  int8_tile::cp_async_commit();
  if (items > 1) issue(1);
  int8_tile::cp_async_commit();
  for (int i = 0; i < items; ++i) {
    const float* stage = ring + (i % 2) * kT32Stage;
    const int k0 = i / per_tile * kT32BK, part = i % per_tile;
    if (chunks > 1 && part < chunks) {  // the own rows' chunk `part`
      rows_async<kT32BQ>(sq, qb + part * kChunk, qs.t, q0, Tq);
      int8_tile::cp_async_commit();
      int8_tile::cp_async_wait<0>();
    } else {
      int8_tile::cp_async_wait<1>();
    }
    __syncthreads();  // item i (and the own chunk) has landed everywhere
    // a warp whose rows all lie before the tile's keys skips it
    if (!(causal && k0 > q0 + wq + 15)) {
      if (part == 0) {
#pragma unroll
        for (int n = 0; n < kT32N; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
      if (part < chunks) score_tile(s, sq, stage, wq);  // S = Q K^T
      if (chunks == 1 || part == chunks) {
        // the online softmax in log2 units on the C fragments: -inf past
        // Tk and above the diagonal, the running max and sum of each row,
        // O rescaled when the max grows
        const bool edge = k0 + kT32BK > Tk ||
                          (causal && k0 + kT32BK - 1 > q0 + wq);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < kT32N; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[n][e] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * n + 2 * c4 + (e & 1);
              const int row = e < 2 ? row0 : row1;
              if (key >= Tk || (causal && key > row)) x = -INFINITY;
            }
            s[n][e] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
          mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
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
        for (int n = 0; n < kChunk / 8; ++n) {
          acc[n][0] *= alpha0;
          acc[n][1] *= alpha0;
          acc[n][2] *= alpha1;
          acc[n][3] *= alpha1;
        }
        // P = exp2(s - max), unrounded, as the f32 plain version keeps it
#pragma unroll
        for (int n = 0; n < kT32N; ++n) {
          s[n][0] = exp2f(s[n][0] - base0);
          s[n][1] = exp2f(s[n][1] - base0);
          s[n][2] = exp2f(s[n][2] - base1);
          s[n][3] = exp2f(s[n][3] - base1);
          l0 += s[n][0] + s[n][1];
          l1 += s[n][2] + s[n][3];
        }
        value_tile<kNearestV>(acc, s, stage + kT32Tile);  // O += P V
      }
    }
    __syncthreads();  // every warp is done with item i's stage
    if (i + 2 < items) issue(i + 2);
    int8_tile::cp_async_commit();
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float f0 = l0 > 0.f ? 1.f / l0 : 0.f, f1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n) {
    acc[n][0] *= f0;
    acc[n][1] *= f0;
    acc[n][2] *= f1;
    acc[n][3] *= f1;
  }
  store_f32(o, acc, b, h, H, Tq, D, oc * kChunk, q0 + wq);
  if (c4 == 0 && oc == 0) {
    float* lrow = lse + ((long long)b * H + h) * Tq;
    if (row0 < Tq) lrow[row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < Tq) lrow[row1] = (m1 + log2f(l1)) * kLn2;
  }
}

int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Tq, int Tk, int D, int causal, int dtype,
        float scale, const Strides& qs, const Strides& ks, const Strides& vs,
        cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  const int chunks = D / kChunk;
  cudaError_t err;
  if (dtype == 1) {
    if (D == 128)
      return run_sm90<128>(q, k, v, o, lse, B, H, Tq, Tk, causal, scale_log2,
                           qs, ks, vs, stream);
    if (D == 256)
      return run_sm90<256>(q, k, v, o, lse, B, H, Tq, Tk, causal, scale_log2,
                           qs, ks, vs, stream);
    const size_t smem =
        (size_t)(kWideBQ + 2 * kWideBK) * (kChunk + kPad) * sizeof(bf16);
    err = allow_smem(fwd_wide, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Tq + kWideBQ - 1) / kWideBQ * chunks, H, B);
    fwd_wide<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, Tq, Tk,
        D, causal, scale_log2, qs, ks, vs);
  } else {
    err = allow_smem(fwd_tf32, kT32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(H, (Tq + kT32BQ - 1) / kT32BQ * chunks, B);
    fwd_tf32<<<grid, kT32Threads, kT32Smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, Tq, Tk,
        D, causal, scale_log2, qs, ks, vs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) through their element strides
// (sb, st, sh; the head axis contiguous, every stride and pointer 16-byte
// aligned); o (B, Tq, H, D) contiguous in q's type; lse (B, H, Tq) f32.
// dtype: 0 float32, 1 bfloat16; D: a multiple of 128. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for another D), or
// minus a CUresult when a tensor map is refused.
extern "C" int veles_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Tq,
                               int Tk, int D, int causal, int dtype,
                               float scale, long long qsb, long long qst,
                               long long qsh, long long ksb, long long kst,
                               long long ksh, long long vsb, long long vst,
                               long long vsh, void* stream) {
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  if (D <= 0 || D % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, o, lse, B, H, Tq, Tk, D, causal, dtype, scale, qs, ks,
             vs, static_cast<cudaStream_t>(stream));
}
