// K8 and K9: the flash-attention backward. K8 computes dK and dV, K9 dQ,
// both from q, k, v, the output gradient dO, the forward's logsumexp and
// di = rowsum(O * dO) (a plain reduction between the forward and these
// kernels, as JAX computes it outside its kernels).
//
// Replaces: _flash_attention_dkv_kernel via _flash_attention_bwd_dkv (K8,
// jax/experimental/pallas/ops/tpu/flash_attention.py:796-1144, pallas_call
// :1121) and _flash_attention_dq_kernel via _flash_attention_bwd_dq (K9,
// :1146-1480, pallas_call :1456): the custom VJP's backward (:245-318),
// run wherever a gradient passes through veles_tpu/ops/attention.py's
// flash route: every train minibatch of the long-context training tier, at
// (1, 8192, 8, 128) bf16. The dS output K9's TPU kernel also writes serves
// only the attention bias, which no caller passes: it is not computed.
//
// What bounds them on the H100: operations. With P = exp(s - lse) and dS =
// P (dP - di) / sqrt(D), K8 runs four products over the visible (query,
// key) pairs (S, dP = dO V^T, dV = P^T dO, dK = dS^T Q) and K9 three (S,
// dP, dQ = dS K), 2 D operations a pair each: at (1, 8192, 8, 128) causal
// 275 GFLOP (0.278 ms at 989 TFLOP/s) and 206 GFLOP (0.208 ms), against
// 84 MB and 67 MB of operands, statistics and gradients (0.025 and 0.020
// ms at 3.35 TB/s).
//
// Design (a simple first version, like K7's: no TMA, no wgmma, no
// pipelining), bf16 operands on the tensor cores (mma.sync m16n8k16, f32
// accumulators; flash_tiles.cuh):
// - K8: one block of four warps per (64-key tile, head, row), 16 keys a
//   warp, its dK and dV accumulators in registers. It walks the 32-query
//   tiles of Q and dO (staged through shared memory with their logsumexp
//   and di) from the block's diagonal on: the causal tiles above it hold
//   no visible pair and are skipped. It recomputes S^T = K Q^T and dP^T =
//   V dO^T, forms P^T and dS^T in registers and feeds them, rounded to
//   bf16 as the Pallas kernel rounds them (:900, :918), straight into dV
//   += P^T dO and dK += dS^T Q as A fragments.
// - K9: one block per (64-query tile, head, row), 16 queries a warp with
//   their Q and dO fragments and the dQ accumulator in registers, walking
//   the 32-key K/V tiles up to the diagonal: S, dP, dS (rounded to bf16,
//   :1258), dQ += dS K.
// - Ragged T is masked, not padded: rows past T load as zero, pairs past
//   T and above the diagonal get P = 0, rows past T are not stored. The
//   grids run the longest causal walks first.
// - Head widths: dkv_kernel and dq_kernel hold whole 128-wide rows (their
//   Q, dO or K, V fragments and accumulators in registers). Every other
//   multiple of 128 runs dkv_wide / dq_wide: a grid axis over 128-wide
//   output chunks (flash_tiles.cuh), each block summing S and dP over the
//   full width in 128-wide steps through shared memory (the operand
//   tiles reloaded a chunk at a time) and accumulating only its chunk of
//   dK and dV, or of dQ.

#include "flash_tiles.cuh"

using namespace flash_tiles;

namespace {

constexpr int kKB = 64;  // K8: keys a block, 16 a warp
constexpr int kQI = 32;  // K8: queries an inner tile
constexpr int kQB = 64;  // K9: queries a block, 16 a warp
constexpr int kKI = 32;  // K9: keys an inner tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
               int Tk, int causal, float scale, Strides qs, Strides ks,
               Strides vs, Strides dos) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [kKB][LD]
  bf16* sv = sk + kKB * LD;                      // [kKB][LD]
  bf16* sq = sv + kKB * LD;                      // [kQI][LD]
  bf16* sdo = sq + kQI * LD;                     // [kQI][LD]
  float* slse = reinterpret_cast<float*>(sdo + kQI * LD);  // [kQI], log2
  float* sdi = slse + kQI;                                 // [kQI]

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kKB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wk = warp * 16;  // the warp's first key in the tile
  const int key0 = k0 + wk + g, key1 = key0 + 8;
  const float scale_log2 = scale * kLog2e;

  load_rows<bf16, D, kKB, LD>(sk, k + b * ks.b + h * ks.h, ks.t, k0, Tk);
  load_rows<bf16, D, kKB, LD>(sv, v + b * vs.b + h * vs.h, vs.t, k0, Tk);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* di_b = di + ((long long)b * H + h) * Tq;
  const int q_begin = causal ? (k0 / kQI) * kQI : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += kQI) {
    __syncthreads();  // the previous tile has been read
    load_rows<bf16, D, kQI, LD>(sq, qb, qs.t, q0, Tq);
    load_rows<bf16, D, kQI, LD>(sdo, dob, dos.t, q0, Tq);
    for (int i = threadIdx.x; i < kQI; i += kThreads) {
      const bool in = q0 + i < Tq;
      slse[i] = in ? lse_b[q0 + i] * kLog2e : 0.f;
      sdi[i] = in ? di_b[q0 + i] : 0.f;
    }
    __syncthreads();
    if (causal && q0 + kQI - 1 < k0 + wk) continue;  // all before the keys

    float st[kQI / 8][4], dpt[kQI / 8][4];  // S^T, dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < kQI / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, sk, LD, wk, kk * 16);
      load_a(av, sv, LD, wk, kk * 16);
#pragma unroll
      for (int j = 0; j < kQI / 8; ++j) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, sq, LD, j * 8, kk * 16);
        mma(st[j], ak, b0, b1);
        load_b_rows(b0, b1, sdo, LD, j * 8, kk * 16);
        mma(dpt[j], av, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < kQI / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * c + (e & 1), qry = q0 + qi;
        const int key = e < 2 ? key0 : key1;
        const bool on = qry < Tq && key < Tk && (!causal || key <= qry);
        const float p = on ? exp2f(st[j][e] * scale_log2 - slse[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sdi[qi]) * scale;
      }
    }
#pragma unroll
    for (int t = 0; t < kQI / 16; ++t) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, st[2 * t], st[2 * t + 1]);    // P^T rounded to bf16
      c_to_a(ads, dpt[2 * t], dpt[2 * t + 1]);  // dS^T rounded to bf16
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, sdo, LD, t * 16, n * 8);
        mma(dva[n], ap, b0, b1);
        load_b_cols(b0, b1, sq, LD, t * 16, n * 8);
        mma(dka[n], ads, b0, b1);
      }
    }
  }
  store_acc<D>(dk, dka, b, h, H, Tk, k0 + wk, 1.f, 1.f);
  store_acc<D>(dv, dva, b, h, H, Tk, k0 + wk, 1.f, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dq, int H, int Tq, int Tk, int causal,
              float scale, Strides qs, Strides ks, Strides vs,
              Strides dos) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kQB][LD]
  bf16* sdo = sq + kQB * LD;                     // [kQB][LD]
  bf16* sk = sdo + kQB * LD;                     // [kKI][LD]
  bf16* sv = sk + kKI * LD;                      // [kKI][LD]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int row0 = w0 + g, row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;

  load_rows<bf16, D, kQB, LD>(sq, q + b * qs.b + h * qs.h, qs.t, q0, Tq);
  load_rows<bf16, D, kQB, LD>(sdo, dout + b * dos.b + h * dos.h, dos.t, q0,
                              Tq);
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], sq, LD, warp * 16, kk * 16);
    load_a(df[kk], sdo, LD, warp * 16, kk * 16);
  }
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* di_b = di + ((long long)b * H + h) * Tq;
  const float lse0 = row0 < Tq ? lse_b[row0] * kLog2e : 0.f;
  const float lse1 = row1 < Tq ? lse_b[row1] * kLog2e : 0.f;
  const float di0 = row0 < Tq ? di_b[row0] : 0.f;
  const float di1 = row1 < Tq ? di_b[row1] : 0.f;
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int k_end = causal ? min(Tk, q0 + kQB) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kKI) {
    __syncthreads();  // the previous tile has been read
    load_rows<bf16, D, kKI, LD>(sk, kb, ks.t, k0, Tk);
    load_rows<bf16, D, kKI, LD>(sv, vb, vs.t, k0, Tk);
    __syncthreads();
    if (causal && k0 > w0 + 15) continue;  // every key past the warp's rows

    float s[kKI / 8][4], dp[kKI / 8][4];  // queries x keys
#pragma unroll
    for (int j = 0; j < kKI / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kKI / 8; ++j) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, sk, LD, j * 8, kk * 16);
        mma(s[j], qf[kk], b0, b1);
        load_b_rows(b0, b1, sv, LD, j * 8, kk * 16);
        mma(dp[j], df[kk], b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < kKI / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * c + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool on = row < Tq && key < Tk && (!causal || key <= row);
        const float p =
            on ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? di0 : di1)) * scale;  // dS
      }
    }
#pragma unroll
    for (int t = 0; t < kKI / 16; ++t) {
      uint32_t a[4];
      c_to_a(a, s[2 * t], s[2 * t + 1]);  // dS rounded to bf16
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, sk, LD, t * 16, n * 8);
        mma(dqa[n], a, b0, b1);
      }
    }
  }
  store_acc<D>(dq, dqa, b, h, H, Tq, w0, 1.f, 1.f);
}

// ---- any other multiple of 128: a chunk axis -------------------------------

__global__ void __launch_bounds__(kThreads)
    dkv_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
             int Tk, int D, int causal, float scale, Strides qs, Strides ks,
             Strides vs, Strides dos) {
  constexpr int LD = kChunk + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [kKB][LD], a chunk
  bf16* sv = sk + kKB * LD;                      // [kKB][LD], a chunk
  bf16* sq = sv + kKB * LD;                      // [kQI][LD], a chunk
  bf16* sdo = sq + kQI * LD;                     // [kQI][LD], a chunk
  bf16* sqo = sdo + kQI * LD;                    // [kQI][LD], chunk oc
  bf16* sdoo = sqo + kQI * LD;                   // [kQI][LD], chunk oc
  float* slse = reinterpret_cast<float*>(sdoo + kQI * LD);  // [kQI], log2
  float* sdi = slse + kQI;                                  // [kQI]

  const int chunks = D / kChunk;
  const int oc = blockIdx.x % chunks, k0 = blockIdx.x / chunks * kKB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wk = warp * 16;  // the warp's first key in the tile
  const int key0 = k0 + wk + g, key1 = key0 + 8;
  const float scale_log2 = scale * kLog2e;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* di_b = di + ((long long)b * H + h) * Tq;

  float dka[kChunk / 8][4], dva[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int q_begin = causal ? (k0 / kQI) * kQI : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += kQI) {
    const bool skip = causal && q0 + kQI - 1 < k0 + wk;  // all before keys
    float st[kQI / 8][4], dpt[kQI / 8][4];  // S^T, dP^T: keys x queries
#pragma unroll
    for (int j = 0; j < kQI / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    for (int dc = 0; dc < chunks; ++dc) {
      __syncthreads();  // the previous chunk (and tile) has been read
      load_rows<bf16, kChunk, kKB, LD>(sk, kb + dc * kChunk, ks.t, k0, Tk);
      load_rows<bf16, kChunk, kKB, LD>(sv, vb + dc * kChunk, vs.t, k0, Tk);
      load_rows<bf16, kChunk, kQI, LD>(sq, qb + dc * kChunk, qs.t, q0, Tq);
      load_rows<bf16, kChunk, kQI, LD>(sdo, dob + dc * kChunk, dos.t, q0,
                                       Tq);
      if (dc == 0) {
        load_rows<bf16, kChunk, kQI, LD>(sqo, qb + oc * kChunk, qs.t, q0,
                                         Tq);
        load_rows<bf16, kChunk, kQI, LD>(sdoo, dob + oc * kChunk, dos.t, q0,
                                         Tq);
        for (int i = threadIdx.x; i < kQI; i += kThreads) {
          const bool in = q0 + i < Tq;
          slse[i] = in ? lse_b[q0 + i] * kLog2e : 0.f;
          sdi[i] = in ? di_b[q0 + i] : 0.f;
        }
      }
      __syncthreads();
      if (skip) continue;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sk, LD, wk, kk * 16);
        load_a(av, sv, LD, wk, kk * 16);
#pragma unroll
        for (int j = 0; j < kQI / 8; ++j) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, sq, LD, j * 8, kk * 16);
          mma(st[j], ak, b0, b1);
          load_b_rows(b0, b1, sdo, LD, j * 8, kk * 16);
          mma(dpt[j], av, b0, b1);
        }
      }
    }
    if (skip) continue;
#pragma unroll
    for (int j = 0; j < kQI / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * c + (e & 1), qry = q0 + qi;
        const int key = e < 2 ? key0 : key1;
        const bool on = qry < Tq && key < Tk && (!causal || key <= qry);
        const float p = on ? exp2f(st[j][e] * scale_log2 - slse[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sdi[qi]) * scale;
      }
    }
#pragma unroll
    for (int t = 0; t < kQI / 16; ++t) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, st[2 * t], st[2 * t + 1]);    // P^T rounded to bf16
      c_to_a(ads, dpt[2 * t], dpt[2 * t + 1]);  // dS^T rounded to bf16
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, sdoo, LD, t * 16, n * 8);
        mma(dva[n], ap, b0, b1);
        load_b_cols(b0, b1, sqo, LD, t * 16, n * 8);
        mma(dka[n], ads, b0, b1);
      }
    }
  }
  store_chunk<kChunk>(dk, dka, b, h, H, Tk, D, oc * kChunk, k0 + wk, 1.f,
                      1.f);
  store_chunk<kChunk>(dv, dva, b, h, H, Tk, D, oc * kChunk, k0 + wk, 1.f,
                      1.f);
}

__global__ void __launch_bounds__(kThreads)
    dq_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            bf16* __restrict__ dq, int H, int Tq, int Tk, int D, int causal,
            float scale, Strides qs, Strides ks, Strides vs, Strides dos) {
  constexpr int LD = kChunk + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kQB][LD], a chunk
  bf16* sdo = sq + kQB * LD;                     // [kQB][LD], a chunk
  bf16* sk = sdo + kQB * LD;                     // [kKI][LD], a chunk
  bf16* sv = sk + kKI * LD;                      // [kKI][LD], a chunk
  bf16* sko = sv + kKI * LD;                     // [kKI][LD], chunk oc

  const int chunks = D / kChunk;
  const int oc = blockIdx.x % chunks;
  const int q0 = (gridDim.x / chunks - 1 - blockIdx.x / chunks) * kQB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int row0 = w0 + g, row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* di_b = di + ((long long)b * H + h) * Tq;
  const float lse0 = row0 < Tq ? lse_b[row0] * kLog2e : 0.f;
  const float lse1 = row1 < Tq ? lse_b[row1] * kLog2e : 0.f;
  const float di0 = row0 < Tq ? di_b[row0] : 0.f;
  const float di1 = row1 < Tq ? di_b[row1] : 0.f;
  float dqa[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const int k_end = causal ? min(Tk, q0 + kQB) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kKI) {
    const bool skip = causal && k0 > w0 + 15;  // every key past the rows
    float s[kKI / 8][4], dp[kKI / 8][4];  // queries x keys
#pragma unroll
    for (int j = 0; j < kKI / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int dc = 0; dc < chunks; ++dc) {
      __syncthreads();  // the previous chunk (and tile) has been read
      load_rows<bf16, kChunk, kQB, LD>(sq, qb + dc * kChunk, qs.t, q0, Tq);
      load_rows<bf16, kChunk, kQB, LD>(sdo, dob + dc * kChunk, dos.t, q0,
                                       Tq);
      load_rows<bf16, kChunk, kKI, LD>(sk, kb + dc * kChunk, ks.t, k0, Tk);
      load_rows<bf16, kChunk, kKI, LD>(sv, vb + dc * kChunk, vs.t, k0, Tk);
      if (dc == 0)
        load_rows<bf16, kChunk, kKI, LD>(sko, kb + oc * kChunk, ks.t, k0,
                                         Tk);
      __syncthreads();
      if (skip) continue;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t qf[4], df[4];
        load_a(qf, sq, LD, warp * 16, kk * 16);
        load_a(df, sdo, LD, warp * 16, kk * 16);
#pragma unroll
        for (int j = 0; j < kKI / 8; ++j) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, sk, LD, j * 8, kk * 16);
          mma(s[j], qf, b0, b1);
          load_b_rows(b0, b1, sv, LD, j * 8, kk * 16);
          mma(dp[j], df, b0, b1);
        }
      }
    }
    if (skip) continue;
#pragma unroll
    for (int j = 0; j < kKI / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * c + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool on = row < Tq && key < Tk && (!causal || key <= row);
        const float p =
            on ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? di0 : di1)) * scale;  // dS
      }
    }
#pragma unroll
    for (int t = 0; t < kKI / 16; ++t) {
      uint32_t a[4];
      c_to_a(a, s[2 * t], s[2 * t + 1]);  // dS rounded to bf16
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, sko, LD, t * 16, n * 8);
        mma(dqa[n], a, b0, b1);
      }
    }
  }
  store_chunk<kChunk>(dq, dqa, b, h, H, Tq, D, oc * kChunk, w0, 1.f, 1.f);
}

template <int D>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* di, void* dk, void* dv, int B,
            int H, int Tq, int Tk, int causal, float scale, Strides qs,
            Strides ks, Strides vs, Strides dos, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kKB + 2 * kQI) * (D + kPad) * sizeof(bf16)
                      + 2 * kQI * sizeof(float);
  cudaError_t err = allow_smem(dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tk + kKB - 1) / kKB, H, B);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, causal,
      scale, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* di, void* dq, int B, int H, int Tq,
           int Tk, int causal, float scale, Strides qs, Strides ks,
           Strides vs, Strides dos, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kQB + 2 * kKI) * (D + kPad) * sizeof(bf16);
  cudaError_t err = allow_smem(dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + kQB - 1) / kQB, H, B);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dq), H, Tq, Tk, causal, scale, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B, Tq, H, D), k and v (B, Tk, H, D) and dout (like q) through
// their element strides (sb, st, sh; the head axis contiguous); lse and di
// (B, H, Tq) f32; dk, dv (K8) and dq (K9) contiguous bf16 in their
// operand's shape. D: a multiple of 128. Each returns the cudaError_t of
// its launch (cudaErrorInvalidValue for another D).
extern "C" int veles_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* di, void* dk, void* dv, int B,
                               int H, int Tq, int Tk, int D, int causal,
                               float scale, long long qsb, long long qst,
                               long long qsh, long long ksb, long long kst,
                               long long ksh, long long vsb, long long vst,
                               long long vsh, long long dsb, long long dst,
                               long long dsh, void* stream) {
  Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      dos{dsb, dst, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128)
    return run_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, H, Tq, Tk, causal,
                        scale, qs, ks, vs, dos, s);
  const size_t smem = (size_t)(2 * kKB + 4 * kQI) * (kChunk + kPad) *
                          sizeof(bf16) + 2 * kQI * sizeof(float);
  cudaError_t err = allow_smem(dkv_wide, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tk + kKB - 1) / kKB * (D / kChunk), H, B);
  dkv_wide<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, Tk, D, causal,
      scale, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int veles_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* di, void* dq, int B, int H,
                              int Tq, int Tk, int D, int causal, float scale,
                              long long qsb, long long qst, long long qsh,
                              long long ksb, long long kst, long long ksh,
                              long long vsb, long long vst, long long vsh,
                              long long dsb, long long dst, long long dsh,
                              void* stream) {
  Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      dos{dsb, dst, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128)
    return run_dq<128>(q, k, v, dout, lse, di, dq, B, H, Tq, Tk, causal,
                       scale, qs, ks, vs, dos, s);
  const size_t smem =
      (size_t)(2 * kQB + 3 * kKI) * (kChunk + kPad) * sizeof(bf16);
  cudaError_t err = allow_smem(dq_wide, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + kQB - 1) / kQB * (D / kChunk), H, B);
  dq_wide<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
      static_cast<bf16*>(dq), H, Tq, Tk, D, causal, scale, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}
