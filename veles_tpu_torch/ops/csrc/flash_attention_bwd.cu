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
// ms at 3.35 TB/s). P and dS are rounded to bf16 before the products that
// take them, as the Pallas kernels round them (:900, :918, :1258); the
// sums are f32.
//
// Design at head width 128 (dkv_sm90, dq_sm90, for Hopper: TMA, mbarriers,
// wgmma; sm90.cuh), K7's pattern without the online softmax:
// - One block of three warpgroups. K8: per (128-key tile, head, row); K9:
//   per (128-query tile, head, row). Warpgroup 0 is the producer; the two
//   consumers own 64 of the block's keys (K8) or query rows (K9) each.
//   setmaxnreg moves registers inside the block's launch allocation (168
//   x 384): the producer drops to 24 so that the consumers reach 240 (24
//   x 128 + 240 x 256 = 168 x 384; a consumer asking for more waits
//   forever).
// - The producer TMA-loads the block's own pair once (K8: K and V; K9: Q
//   and dO; 2 x 32 KB) and then walks the other axis in 64-row tiles on a
//   ring (K8: three stages of Q and dO, K9: two of K and V; 32 KB a
//   stage), each stage with a full and an empty mbarrier. K8's full
//   barrier also covers the tile's 64 lse and di values, stored by the
//   producer warp's 32 threads, which all arrive on it. q, k, v and dO
//   are read in place through rank-4 tensor maps over the views' strides
//   (sm90::view_map), as K7 reads them.
// - K8 works transposed: S^T = K Q^T and dP^T = V dO^T are wgmma m64n64
//   with both operands K-major from shared memory; P^T and dS^T are built
//   on the accumulators (lse and di broadcast along the query columns),
//   rounded to bf16 and repacked in registers as A fragments; then dV +=
//   P^T dO and dK += dS^T Q are wgmma m64n128 with A from registers and
//   the same Q / dO stage read as an MN-major B through the transpose bit.
//   dV's product runs while dS^T is built. K9: S = Q K^T and dP = dO V^T
//   (m64n64, K-major), dS in registers (lse and di per row, loaded once),
//   then dQ += dS K (m64n128, K read as an MN-major B).
// - Causal walks: K8 starts at the block's diagonal query tile and K9
//   stops at its diagonal key tile; a consumer with no visible pair in a
//   diagonal tile (K8's upper one on the first query tile, K9's lower one
//   on the last key tile) skips its products but still arrives on the
//   stage's empty barrier. Only edge tiles (the diagonal, a tile past Tq
//   or Tk) are masked; TMA fills rows past T with zeros and rows past T
//   are not stored. The grids run the longest walks first.
// - Two kernels, no atomics: every output element is summed by one block
//   in a fixed order, so the results are deterministic. A fused kernel
//   adding dQ with f32 atomics would run five products where these run
//   seven, at the price of sums that depend on scheduling.
//
// Head widths past 128 (256, 384, ...) run dkv_wide / dq_wide: mma.sync
// kernels with a grid axis over 128-wide output chunks (flash_tiles.cuh),
// each block summing S and dP over the full width in 128-wide steps
// through shared memory (the operand tiles reloaded a chunk at a time) and
// accumulating only its chunk of dK and dV, or of dQ.
//
// f32 operands (a training caller whose parameters are f32: the default
// precision of the transformer step, on one process and in each rank's
// Ulysses attention, once T >= 4096) run dkv_tf32 / dq_tf32 at every
// multiple of 128, with the same lse and di and P and dS kept in f32, as
// the f32 plain versions keep them. They replace C11's f32 FMA kernels.
//
// What bounds them: operations, 4 (K8) and 3 (K9) products of 2 D a
// visible pair, at (1, 8192, 4, 128) causal 137 and 103 GFLOP: 2.05 and
// 1.54 ms at the 67 TFLOP/s of f32 FMA on the CUDA cores, 0.83 and 0.62 ms
// at 165 TFLOP/s, a third of the tensor cores' 495 TFLOP/s in TF32.
//
// Design: every product runs 3xTF32 on the tensor cores (mma.sync m16n8k8,
// TF32 operands, f32 accumulators): each f32 operand splits into hi and
// lo in registers, and a product sums lo * hi, hi * lo and hi * hi,
// 2^-22 (dP, rounded to nearest) or 2^-20 (the others, truncated) of
// relative error where one TF32 product alone keeps 2^-11
// (tests/test_torch_flash_f32_split.py shows that one misses the 1e-4 row
// rule and three meet it, either way). wgmma takes TF32
// operands from shared memory K-major only, and three of the five
// products read their B operand MN-major, so all five run on mma.sync,
// whose fragments load from padded shared memory by 32-bit loads.
// - The tensor cores round their own sums toward zero, so no sum is
//   carried in an mma's accumulator for long: a score product sums each
//   8-deep step from zero, a value product each walked tile, and those
//   parts are added in f32, rounding to nearest (rows within 4.4e-6 of
//   the f32 plain versions at (1, 8192, 4, 128) causal on an H100, where
//   carrying the sums in the mma drifted to 1.1e-4).
// - The causal first query's dS is P (dP - di) with dP = di in exact
//   arithmetic: the row holds only rounding, and the 1e-4 row rule
//   against the plain version compares two roundings of zero there. K9
//   takes that one dP as a sequential f32 FMA dot, the order in which
//   cuBLAS's f32 product summed it on the H100 the design was read on,
//   so the row is the plain version's. No API promises cuBLAS's order:
//   another cuBLAS can move the plain version's row, and the card tests
//   with it. Against float64 the row reads 4.3e-4, 7.3e-4 and 3.1e-4
//   under the row rule with this dot at (1, 8192, 4, 128), (2, 333, 2,
//   128) and (1, 4096, 2, 256), and 7.7e-4, 1.2e-4 and 1.1e-4 with the
//   3xTF32 product (tools/flash_f32_ab.py's no_first_dot).
// - One block of eight warps owns 128 keys (K8) or query rows (K9), 16 a
//   warp, and walks the other axis in tiles of 32. At head width 128 the
//   own K and V (or Q and dO, 128 KB f32) stay in shared memory for the
//   walk; the walked tiles (K8: Q, dO, their lse and di; K9: K and V) come
//   through a two-stage cp.async ring, the next tile's copies in flight
//   while the block computes on this one. 203 KB a block.
// - A warp's S^T and dP^T (K8) or S and dP (K9), 16 x 32, stay in
//   registers; P and dS are built there and feed the value products
//   (dV += P^T dO, dK += dS^T Q; dQ += dS K) as A fragments, the k order
//   inside each 8-wide step permuted to match the accumulator's layout
//   and the walked tile's B rows read in the same order.
// - Wider heads keep a chunk axis over 128-wide output columns: a walked
//   tile is one item per 128-wide chunk of S and dP, each reloading the
//   block's own chunk, then one item holding the tile's output chunk.
// - Causal walks start (K8) or stop (K9) at the block's diagonal tile, a
//   warp with no visible pair in a tile skips it, and the grids run the
//   longest walks first. No atomics: every output element is summed by
//   one warp in a fixed order, so two runs agree bit for bit.

#include "flash_tiles.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

using namespace flash_tiles;
using namespace tf32x3;

namespace {

// ---- bf16, head width 128: TMA + wgmma --------------------------------------

constexpr int kWgThreads = 384;  // producer warpgroup + two consumers
constexpr int kD = 128;          // the head width of dkv_sm90 / dq_sm90
constexpr int kOwn = 128;        // K8: keys a block; K9: query rows a block
constexpr int kWalk = 64;        // the walked tiles: K8 queries, K9 keys
// ring stages: on an H100 at (1, 8192, 8, 128) causal a third stage made
// K8 faster and K9 slower (PERF.md, the K8 and K9 findings)
constexpr int kDkvStages = 3, kDqStages = 2;
constexpr uint32_t kOwnBytes = kOwn * kD * sizeof(bf16);    // 32 KB
constexpr uint32_t kWalkBytes = kWalk * kD * sizeof(bf16);  // 16 KB
constexpr uint32_t kWalkChunk = kWalkBytes / (kD / 64);  // a 64-wide chunk
// shared memory: the block's own pair, the ring of walked pairs (K8's with
// the tile's lse and di), the barriers, and slack for the 1024-byte
// alignment
constexpr size_t kDkvSmem = 2 * kOwnBytes +
                            kDkvStages * (2 * kWalkBytes +
                                          2 * kWalk * sizeof(float)) +
                            (1 + 2 * kDkvStages) * sizeof(uint64_t) + 1024;
constexpr size_t kDqSmem = 2 * kOwnBytes + kDqStages * 2 * kWalkBytes +
                           (1 + 2 * kDqStages) * sizeof(uint64_t) + 1024;

__device__ __forceinline__ bf16* align_1024(unsigned char* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                 ~uintptr_t(1023));
}

// acc (64 x 64) = the consumer's 64 own rows (`own`, inside [kOwn][64]
// column chunks) times the walked tile's 64 rows (`walk`, [kWalk][64]
// chunks) transposed, over the head width: both K-major
__device__ __forceinline__ void score_products(float (&acc)[32],
                                               const bf16* own,
                                               const bf16* walk) {
#pragma unroll
  for (int c = 0; c < kD / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_n64<0, 0>(
          acc, sm90::desc_sw128(own + c * kOwn * 64 + kk * 16, 16, 1024),
          sm90::desc_sw128(walk + c * kWalk * 64 + kk * 16, 16, 1024),
          (c | kk) != 0);
}

// acc (64 x 128) += A (64 x kWalk, bf16 fragments in registers) times the
// walked tile (kWalk x 128, the head width contiguous: an MN-major B whose
// leading byte offset is the step between its two 64-wide column chunks)
__device__ __forceinline__ void value_products(
    float (&acc)[64], const uint32_t (&a)[kWalk / 16][4], const bf16* walk) {
#pragma unroll
  for (int t = 0; t < kWalk / 16; ++t)
    sm90::wgmma_rs_n128<1>(
        acc, a[t], sm90::desc_sw128(walk + t * 16 * 64, kWalkChunk, 1024), 1);
}

// a 64 x 64 accumulator rounded to bf16 as the A fragments of its 16-wide
// column blocks: columns 16 t .. 16 t + 15 are accumulator blocks 2 t and
// 2 t + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[kWalk / 16][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int t = 0; t < kWalk / 16; ++t) {
    a[t][0] = pack(x[8 * t], x[8 * t + 1]);
    a[t][1] = pack(x[8 * t + 2], x[8 * t + 3]);
    a[t][2] = pack(x[8 * t + 4], x[8 * t + 5]);
    a[t][3] = pack(x[8 * t + 6], x[8 * t + 7]);
  }
}

// store a consumer thread's rows row0 and row0 + 8 of a 64 x 128 f32
// accumulator as bf16 into a contiguous (B, T, H, 128) output; rows at or
// past T are skipped
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[64], int b,
                                           int h, int H, int T, int row0) {
  const int c4 = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= T) continue;
    bf16* p = out + (((long long)b * T + row) * H + h) * kD + 2 * c4;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_sm90(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap domap,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
             int Tk, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sk = align_1024(smem_raw);     // 2 chunks x [kOwn][64]
  bf16* sv = sk + kOwn * kD;           // 2 chunks x [kOwn][64]
  bf16* sq = sv + kOwn * kD;  // kDkvStages x 2 chunks x [kWalk][64]
  bf16* sdo = sq + kDkvStages * kWalk * kD;  // like sq
  float* slse = reinterpret_cast<float*>(sdo + kDkvStages * kWalk * kD);
  float* sdi = slse + kDkvStages * kWalk;  // like slse: kDkvStages x [kWalk]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sdi + kDkvStages * kWalk);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + kDkvStages;

  const int h = blockIdx.x, b = blockIdx.z, k0 = blockIdx.y * kOwn;
  const int q_begin = causal ? k0 : 0;  // the block's diagonal query tile
  const int tiles = (Tq - q_begin + kWalk - 1) / kWalk;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kvfull, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      sm90::mbar_init(&full[s], 32);    // the producer warp's threads
      sm90::mbar_init(&empty[s], 256);  // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one warp ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        sm90::mbar_expect_tx(kvfull, 2 * kOwnBytes);
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) {
          sm90::tma_load_4d(sk + c * kOwn * 64, &kmap, kvfull, 64 * c, h, k0,
                            b);
          sm90::tma_load_4d(sv + c * kOwn * 64, &vmap, kvfull, 64 * c, h, k0,
                            b);
        }
      }
      const long long rows = ((long long)b * H + h) * Tq;
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kDkvStages, q0 = q_begin + j * kWalk;
        if (j >= kDkvStages)
          sm90::mbar_wait(&empty[s], ((j / kDkvStages) - 1) & 1);
        for (int i = lane; i < kWalk; i += 32) {
          const bool in = q0 + i < Tq;
          slse[s * kWalk + i] = in ? lse[rows + q0 + i] * kLog2e : 0.f;
          sdi[s * kWalk + i] = in ? di[rows + q0 + i] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], 2 * kWalkBytes);
#pragma unroll
          for (int c = 0; c < kD / 64; ++c) {
            sm90::tma_load_4d(sq + (s * 2 + c) * kWalk * 64, &qmap, &full[s],
                              64 * c, h, q0, b);
            sm90::tma_load_4d(sdo + (s * 2 + c) * kWalk * 64, &domap,
                              &full[s], 64 * c, h, q0, b);
          }
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: keys kw .. kw + 63 ----
    sm90::reg_alloc<240>();
    const int w = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int c4 = lane & 3;
    const int kw = k0 + 64 * w;
    const int key0 = kw + 16 * warp + (lane >> 2), key1 = key0 + 8;
    const float scale_log2 = scale * kLog2e;
    float dka[64], dva[64], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
    uint32_t pf[kWalk / 16][4], dsf[kWalk / 16][4];
    const bf16* kown = sk + w * 64 * 64;
    const bf16* vown = sv + w * 64 * 64;
    sm90::mbar_wait(kvfull, 0);

    for (int j = 0; j < tiles; ++j) {
      const int s = j % kDkvStages, q0 = q_begin + j * kWalk;
      sm90::mbar_wait(&full[s], (j / kDkvStages) & 1);
      // a consumer whose keys all lie past the tile's queries skips it
      if (!(causal && q0 + kWalk - 1 < kw)) {
        const bf16* qt = sq + s * kWalk * kD;
        const bf16* dot = sdo + s * kWalk * kD;
        const float* tlse = slse + s * kWalk;
        const float* tdi = sdi + s * kWalk;
        sm90::fence_acc(st);
        sm90::fence_acc(dpt);
        sm90::wgmma_fence();
        score_products(st, kown, qt);  // S^T = K Q^T
        sm90::wgmma_commit();
        score_products(dpt, vown, dot);  // dP^T = V dO^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_acc(st);

        // P^T = exp2(s log2e / sqrt(D) - lse log2e); zero past T and
        // above the diagonal (key > query) on edge tiles
        const bool edge = q0 + kWalk > Tq || kw + 64 > Tk ||
                          (causal && kw + 63 > q0);
#pragma unroll
        for (int jj = 0; jj < kWalk / 8; ++jj) {
          const float2 l =
              *reinterpret_cast<const float2*>(tlse + 8 * jj + 2 * c4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p =
                exp2f(st[4 * jj + e] * scale_log2 - ((e & 1) ? l.y : l.x));
            if (edge) {
              const int query = q0 + 8 * jj + 2 * c4 + (e & 1);
              const int key = e < 2 ? key0 : key1;
              if (query >= Tq || key >= Tk || (causal && key > query))
                p = 0.f;
            }
            st[4 * jj + e] = p;
          }
        }
        pack_a(pf, st);  // P^T rounded to bf16
        sm90::fence_acc(dva);
        sm90::wgmma_fence();
        value_products(dva, pf, dot);  // dV += P^T dO
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // dP^T has landed; dV's product may run on
        sm90::fence_acc(dpt);

        // dS^T = P^T (dP^T - di) / sqrt(D)
#pragma unroll
        for (int jj = 0; jj < kWalk / 8; ++jj) {
          const float2 d =
              *reinterpret_cast<const float2*>(tdi + 8 * jj + 2 * c4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * jj + e] = st[4 * jj + e] *
                              (dpt[4 * jj + e] - ((e & 1) ? d.y : d.x)) *
                              scale;
        }
        pack_a(dsf, dpt);  // dS^T rounded to bf16
        sm90::fence_acc(dka);
        sm90::wgmma_fence();
        value_products(dka, dsf, qt);  // dK += dS^T Q
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(dva);
        sm90::fence_acc(dka);
      }
      sm90::mbar_arrive(&empty[s]);
    }
    store_rows(dk, dka, b, h, H, Tk, key0);
    store_rows(dv, dva, b, h, H, Tk, key0);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    dq_sm90(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap domap,
            const float* __restrict__ lse, const float* __restrict__ di,
            bf16* __restrict__ dq, int H, int Tq, int Tk, int causal,
            float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = align_1024(smem_raw);     // 2 chunks x [kOwn][64]
  bf16* sdo = sq + kOwn * kD;          // 2 chunks x [kOwn][64]
  bf16* sk = sdo + kOwn * kD;  // kDqStages x 2 chunks x [kWalk][64]
  bf16* sv = sk + kDqStages * kWalk * kD;  // like sk
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sv + kDqStages * kWalk * kD);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + kDqStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;  // longest walk first
  const int k_end = causal ? min(Tk, q0 + kOwn) : Tk;
  const int tiles = (k_end + kWalk - 1) / kWalk;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(qfull, 1);
    for (int s = 0; s < kDqStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);  // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(qfull, 2 * kOwnBytes);
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) {
        sm90::tma_load_4d(sq + c * kOwn * 64, &qmap, qfull, 64 * c, h, q0, b);
        sm90::tma_load_4d(sdo + c * kOwn * 64, &domap, qfull, 64 * c, h, q0,
                          b);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kDqStages, k0 = j * kWalk;
        if (j >= kDqStages)
          sm90::mbar_wait(&empty[s], ((j / kDqStages) - 1) & 1);
        sm90::mbar_expect_tx(&full[s], 2 * kWalkBytes);
#pragma unroll
        for (int c = 0; c < kD / 64; ++c) {
          sm90::tma_load_4d(sk + (s * 2 + c) * kWalk * 64, &kmap, &full[s],
                            64 * c, h, k0, b);
          sm90::tma_load_4d(sv + (s * 2 + c) * kWalk * 64, &vmap, &full[s],
                            64 * c, h, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: query rows rw .. rw + 63 ----
    sm90::reg_alloc<240>();
    const int w = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int c4 = lane & 3;
    const int rw = q0 + 64 * w;
    const int row0 = rw + 16 * warp + (lane >> 2), row1 = row0 + 8;
    const float scale_log2 = scale * kLog2e;
    const long long rows = ((long long)b * H + h) * Tq;
    const float lse0 = row0 < Tq ? lse[rows + row0] * kLog2e : 0.f;
    const float lse1 = row1 < Tq ? lse[rows + row1] * kLog2e : 0.f;
    const float di0 = row0 < Tq ? di[rows + row0] : 0.f;
    const float di1 = row1 < Tq ? di[rows + row1] : 0.f;
    float dqa[64], sacc[32], dpacc[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
    uint32_t dsf[kWalk / 16][4];
    const bf16* qown = sq + w * 64 * 64;
    const bf16* doown = sdo + w * 64 * 64;
    sm90::mbar_wait(qfull, 0);

    for (int j = 0; j < tiles; ++j) {
      const int s = j % kDqStages, k0 = j * kWalk;
      sm90::mbar_wait(&full[s], (j / kDqStages) & 1);
      // a consumer whose rows all lie before the tile's keys skips it
      if (!(causal && k0 > rw + 63)) {
        const bf16* kt = sk + s * kWalk * kD;
        const bf16* vt = sv + s * kWalk * kD;
        sm90::fence_acc(sacc);
        sm90::fence_acc(dpacc);
        sm90::wgmma_fence();
        score_products(sacc, qown, kt);  // S = Q K^T
        sm90::wgmma_commit();
        score_products(dpacc, doown, vt);  // dP = dO V^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_acc(sacc);

        // P = exp2(s log2e / sqrt(D) - lse log2e); zero past Tk and above
        // the diagonal on edge tiles
        const bool edge =
            k0 + kWalk > Tk || (causal && k0 + kWalk - 1 > rw);
#pragma unroll
        for (int jj = 0; jj < kWalk / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(sacc[4 * jj + e] * scale_log2 -
                            (e < 2 ? lse0 : lse1));
            if (edge) {
              const int key = k0 + 8 * jj + 2 * c4 + (e & 1);
              const int row = e < 2 ? row0 : row1;
              if (key >= Tk || (causal && key > row)) p = 0.f;
            }
            sacc[4 * jj + e] = p;
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_acc(dpacc);
        // dS = P (dP - di) / sqrt(D)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dpacc[i] = sacc[i] * (dpacc[i] - ((i & 2) ? di1 : di0)) * scale;
        pack_a(dsf, dpacc);  // dS rounded to bf16
        sm90::fence_acc(dqa);
        sm90::wgmma_fence();
        value_products(dqa, dsf, kt);  // dQ += dS K
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(dqa);
      }
      sm90::mbar_arrive(&empty[s]);
    }
    store_rows(dq, dqa, b, h, H, Tq, row0);
  }
}

// the tensor maps of q and dO (boxes of q_rows) and of k and v (k_rows)
int backward_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                  const void* v, const void* dout, int B, int H, int Tq,
                  int Tk, const Strides& qs, const Strides& ks,
                  const Strides& vs, const Strides& dos, int q_rows,
                  int k_rows) {
  int err = sm90::view_map(&maps[0], q, B, Tq, H, kD, qs.b, qs.t, qs.h,
                           q_rows);
  if (!err)
    err = sm90::view_map(&maps[1], k, B, Tk, H, kD, ks.b, ks.t, ks.h, k_rows);
  if (!err)
    err = sm90::view_map(&maps[2], v, B, Tk, H, kD, vs.b, vs.t, vs.h, k_rows);
  if (!err)
    err = sm90::view_map(&maps[3], dout, B, Tq, H, kD, dos.b, dos.t, dos.h,
                         q_rows);
  return err;
}

// ---- any other multiple of 128: mma.sync, a chunk axis ---------------------

constexpr int kKB = 64;  // dkv_wide: keys a block, 16 a warp
constexpr int kQI = 32;  // dkv_wide: queries an inner tile
constexpr int kQB = 64;  // dq_wide: queries a block, 16 a warp
constexpr int kKI = 32;  // dq_wide: keys an inner tile

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

// ---- f32, any multiple of 128: 3xTF32 on the tensor cores ----------------

// (the splits, mma3, value_tile, rows_async and store_f32: tf32x3.cuh)
constexpr int kT32Own = 128;      // K8: keys a block; K9: query rows a block
constexpr int kT32Walk = 32;      // the walked tile: K8 queries, K9 keys
constexpr int kT32N = kT32Walk / 8;  // the walked tile's 8-wide n-tiles
constexpr int kT32Tile = kT32Walk * kT32LD;  // a walked tile's floats
// a ring stage: two walked tiles (K8: Q and dO, K9: K and V) and K8's 32
// lse and 32 di values
constexpr int kT32Stage = 2 * kT32Tile + 2 * kT32Walk;
constexpr size_t kT32Smem =
    (2 * kT32Own * kT32LD + 2 * kT32Stage) * sizeof(float);

// each product's split (tf32x3.cuh's split): rounded to nearest or truncated
constexpr bool kNearestS = false, kNearestDP = true, kNearestV = false;

// x (16 x kT32Walk) += own rows [r0, r0 + 16) of `a` times the walked
// tile `b` transposed, and y likewise from `c` and `d`, over one 128-wide
// chunk: S and dP (K9), S^T and dP^T (K8), both operands K-major. Each
// 8-deep step sums from zero and adds to x and y in f32: dS takes dP -
// di, and a few ulps of drift in dP are a large error where the two
// nearly cancel (a causal row with a key or two).
__device__ __forceinline__ void score_tiles(float (&x)[kT32N][4],
                                            float (&y)[kT32N][4],
                                            const float* a, const float* b,
                                            const float* c, const float* d,
                                            int r0) {
  const int lane = threadIdx.x & 31;
  const int row = (lane >> 2) * kT32LD + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    uint32_t ah[4], al[4], ch[4], cl[4];
    load_a_split<kNearestS>(ah, al, a, r0, 8 * kk);
    load_a_split<kNearestDP>(ch, cl, c, r0, 8 * kk);
#pragma unroll
    for (int n = 0; n < kT32N; ++n) {
      const float* pb = b + 8 * n * kT32LD + row + 8 * kk;
      const float* pd = d + 8 * n * kT32LD + row + 8 * kk;
      float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
      mma3<kNearestS>(t, ah, al, pb[0], pb[4]);
      mma3<kNearestDP>(u, ch, cl, pd[0], pd[4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[n][e] += t[e];
        y[n][e] += u[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kT32Threads, 1)
    dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dk, float* __restrict__ dv, int H, int Tq,
             int Tk, int D, int causal, float scale, Strides qs, Strides ks,
             Strides vs, Strides dos) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [kT32Own][LD], a chunk
  float* sv = sk + kT32Own * kT32LD;               // [kT32Own][LD], a chunk
  float* ring = sv + kT32Own * kT32LD;  // 2 x {Q, dO tiles; lse, di}

  const int chunks = D / kChunk, per_tile = items_a_tile(chunks);
  const int h = blockIdx.x, b = blockIdx.z;
  const int oc = blockIdx.y % chunks, k0 = blockIdx.y / chunks * kT32Own;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c4 = lane & 3;
  const int wk = 16 * warp;  // the warp's first key in the block
  const int key0 = k0 + wk + (lane >> 2), key1 = key0 + 8;
  const float scale_log2 = scale * kLog2e;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* lse_b = lse + ((long long)b * H + h) * Tq;
  const float* di_b = di + ((long long)b * H + h) * Tq;

  const int q_begin = causal ? k0 : 0;  // the block's diagonal tile
  const int items = (Tq - q_begin + kT32Walk - 1) / kT32Walk * per_tile;
  // item i into stage i % 2: the walked queries' chunk of Q and dO (the
  // output chunk on a value item) and, on a value item, lse and di
  auto issue = [&](int i) {
    float* st = ring + (i % 2) * kT32Stage;
    const int q0 = q_begin + i / per_tile * kT32Walk, part = i % per_tile;
    const bool values = chunks == 1 || part == chunks;
    const int col = (values ? oc : part) * kChunk;
    rows_async<kT32Walk>(st, qb + col, qs.t, q0, Tq);
    rows_async<kT32Walk>(st + kT32Tile, dob + col, dos.t, q0, Tq);
    if (values && threadIdx.x < 2 * kT32Walk) {
      const int r = threadIdx.x % kT32Walk;
      const float* src = threadIdx.x < kT32Walk ? lse_b : di_b;
      float* dst = st + 2 * kT32Tile + threadIdx.x;
      if (q0 + r < Tq)
        int8_tile::cp_async<4>(dst, src + q0 + r);
      else
        *dst = 0.f;
    }
  };

  float dka[kChunk / 8][4], dva[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  float st[kT32N][4], dpt[kT32N][4];  // S^T, dP^T: keys x queries

  if (chunks == 1) {  // the block's keys stay for the whole walk
    rows_async<kT32Own>(sk, kb, ks.t, k0, Tk);
    rows_async<kT32Own>(sv, vb, vs.t, k0, Tk);
  }
  issue(0);
  int8_tile::cp_async_commit();
  if (items > 1) issue(1);
  int8_tile::cp_async_commit();
  for (int i = 0; i < items; ++i) {
    const float* stage = ring + (i % 2) * kT32Stage;
    const int q0 = q_begin + i / per_tile * kT32Walk, part = i % per_tile;
    const bool values = chunks == 1 || part == chunks;
    if (chunks > 1 && part < chunks) {  // the own keys' chunk `part`
      rows_async<kT32Own>(sk, kb + part * kChunk, ks.t, k0, Tk);
      rows_async<kT32Own>(sv, vb + part * kChunk, vs.t, k0, Tk);
      int8_tile::cp_async_commit();
      int8_tile::cp_async_wait<0>();
    } else {
      int8_tile::cp_async_wait<1>();
    }
    __syncthreads();  // item i (and the own chunk) has landed everywhere
    // a warp whose keys all lie past the tile's queries skips it
    if (!(causal && q0 + kT32Walk - 1 < k0 + wk)) {
      if (part == 0) {
#pragma unroll
        for (int n = 0; n < kT32N; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      }
      if (part < chunks)  // S^T = K Q^T, dP^T = V dO^T
        score_tiles(st, dpt, sk, stage, sv, stage + kT32Tile, wk);
      if (values) {
        // P^T = exp(s / sqrt(D) - lse), dS^T = P^T (dP^T - di) / sqrt(D),
        // zero past T and above the diagonal (key > query)
        const float* tlse = stage + 2 * kT32Tile;
        const float* tdi = tlse + kT32Walk;
#pragma unroll
        for (int n = 0; n < kT32N; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * n + 2 * c4 + (e & 1), query = q0 + qi;
            const int key = e < 2 ? key0 : key1;
            const bool on = query < Tq && key < Tk &&
                            !(causal && key > query);
            const float p =
                on ? exp2f(st[n][e] * scale_log2 - tlse[qi] * kLog2e) : 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - tdi[qi]) * scale;
          }
        value_tile<kNearestV>(dva, st, stage + kT32Tile);  // dV += P^T dO
        value_tile<kNearestV>(dka, dpt, stage);            // dK += dS^T Q
      }
    }
    __syncthreads();  // every warp is done with item i's stage
    if (i + 2 < items) issue(i + 2);
    int8_tile::cp_async_commit();
  }
  store_f32(dk, dka, b, h, H, Tk, D, oc * kChunk, k0 + wk);
  store_f32(dv, dva, b, h, H, Tk, D, oc * kChunk, k0 + wk);
}

__global__ void __launch_bounds__(kT32Threads, 1)
    dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dq, int H, int Tq, int Tk, int D, int causal,
            float scale, Strides qs, Strides ks, Strides vs, Strides dos) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kT32Own][LD], a chunk
  float* sdo = sq + kT32Own * kT32LD;              // [kT32Own][LD], a chunk
  float* ring = sdo + kT32Own * kT32LD;  // 2 x {K, V tiles}

  const int chunks = D / kChunk, per_tile = items_a_tile(chunks);
  const int h = blockIdx.x, b = blockIdx.z;
  const int oc = blockIdx.y % chunks;
  // longest walk first
  const int q0 = (gridDim.y / chunks - 1 - blockIdx.y / chunks) * kT32Own;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c4 = lane & 3;
  const int wq = 16 * warp;  // the warp's first row in the block
  const int row0 = q0 + wq + (lane >> 2), row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const long long rows = ((long long)b * H + h) * Tq;
  const float lse0 = row0 < Tq ? lse[rows + row0] * kLog2e : 0.f;
  const float lse1 = row1 < Tq ? lse[rows + row1] * kLog2e : 0.f;
  const float di0 = row0 < Tq ? di[rows + row0] : 0.f;
  const float di1 = row1 < Tq ? di[rows + row1] : 0.f;

  const int k_end = causal ? min(Tk, q0 + kT32Own) : Tk;
  const int items = (k_end + kT32Walk - 1) / kT32Walk * per_tile;
  // item i into stage i % 2: the walked keys' chunk of K and V, or on a
  // value item of a wide head K's output chunk alone
  auto issue = [&](int i) {
    float* st = ring + (i % 2) * kT32Stage;
    const int k0 = i / per_tile * kT32Walk, part = i % per_tile;
    const int col = (part == chunks ? oc : part) * kChunk;
    rows_async<kT32Walk>(st, kb + col, ks.t, k0, Tk);
    if (part < chunks)
      rows_async<kT32Walk>(st + kT32Tile, vb + col, vs.t, k0, Tk);
  };

  float dqa[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  float s[kT32N][4], dp[kT32N][4];  // queries x keys

  if (chunks == 1) {  // the block's rows stay for the whole walk
    rows_async<kT32Own>(sq, qb, qs.t, q0, Tq);
    rows_async<kT32Own>(sdo, dob, dos.t, q0, Tq);
  }
  issue(0);
  int8_tile::cp_async_commit();
  if (items > 1) issue(1);
  int8_tile::cp_async_commit();
  for (int i = 0; i < items; ++i) {
    const float* stage = ring + (i % 2) * kT32Stage;
    const int k0 = i / per_tile * kT32Walk, part = i % per_tile;
    if (chunks > 1 && part < chunks) {  // the own rows' chunk `part`
      rows_async<kT32Own>(sq, qb + part * kChunk, qs.t, q0, Tq);
      rows_async<kT32Own>(sdo, dob + part * kChunk, dos.t, q0, Tq);
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
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      if (part < chunks)  // S = Q K^T, dP = dO V^T
        score_tiles(s, dp, sq, stage, sdo, stage + kT32Tile, wq);
      if (chunks == 1 || part == chunks) {
        // The causal first query sees one key, itself: its dS is P (dP -
        // di) with dP = di in exact arithmetic, so the row holds nothing
        // but the rounding of that difference, and its dQ that rounding
        // times K. That one dot product is taken here in f32 FMA, d in
        // order, as cuBLAS's f32 product took it on the H100 (see the
        // note at the top), so the row is the plain version's and not a
        // second rounding of zero.
        if (causal && q0 == 0 && k0 == 0 && threadIdx.x == 0) {
          float dot = 0.f;
          for (int x = 0; x < D; ++x) dot = fmaf(dob[x], vb[x], dot);
          dp[0][0] = dot;
        }
        // dS = P (dP - di) / sqrt(D), P = exp(s / sqrt(D) - lse), zero
        // past Tk and above the diagonal
#pragma unroll
        for (int n = 0; n < kT32N; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * c4 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool on = key < Tk && !(causal && key > row);
            const float p =
                on ? exp2f(s[n][e] * scale_log2 - (e < 2 ? lse0 : lse1))
                   : 0.f;
            s[n][e] = p * (dp[n][e] - (e < 2 ? di0 : di1)) * scale;
          }
        value_tile<kNearestV>(dqa, s, stage);  // dQ += dS K
      }
    }
    __syncthreads();  // every warp is done with item i's stage
    if (i + 2 < items) issue(i + 2);
    int8_tile::cp_async_commit();
  }
  store_f32(dq, dqa, b, h, H, Tq, D, oc * kChunk, q0 + wq);
}

int run_dkv_sm90(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* di,
                 void* dk, void* dv, int B, int H, int Tq, int Tk, int causal,
                 float scale, const Strides& qs, const Strides& ks,
                 const Strides& vs, const Strides& dos, cudaStream_t stream) {
  CUtensorMap maps[4];
  const int err = backward_maps(maps, q, k, v, dout, B, H, Tq, Tk, qs, ks, vs,
                                dos, kWalk, kOwn);
  if (err) return err;
  const cudaError_t cerr = allow_smem(dkv_sm90, kDkvSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  dim3 grid(H, (Tk + kOwn - 1) / kOwn, B);
  dkv_sm90<<<grid, kWgThreads, kDkvSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int run_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dq, int B, int H,
                int Tq, int Tk, int causal, float scale, const Strides& qs,
                const Strides& ks, const Strides& vs, const Strides& dos,
                cudaStream_t stream) {
  CUtensorMap maps[4];
  const int err = backward_maps(maps, q, k, v, dout, B, H, Tq, Tk, qs, ks, vs,
                                dos, kOwn, kWalk);
  if (err) return err;
  const cudaError_t cerr = allow_smem(dq_sm90, kDqSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  dim3 grid(H, (Tq + kOwn - 1) / kOwn, B);
  dq_sm90<<<grid, kWgThreads, kDqSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dq), H,
      Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) and dout (like q), all of one
// type (dtype: 0 float32, 1 bfloat16), through their element strides (sb,
// st, sh; the head axis contiguous, every stride and pointer 16-byte
// aligned); lse and di (B, H, Tq) f32; dk, dv (K8) and dq (K9) contiguous
// in their operand's shape and type. D: a multiple of 128. Each returns
// the cudaError_t of its launch (cudaErrorInvalidValue for another D or
// type), or minus a CUresult when a tensor map is refused.
extern "C" int veles_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* di, void* dk, void* dv, int B,
                               int H, int Tq, int Tk, int D, int causal,
                               int dtype, float scale, long long qsb,
                               long long qst,
                               long long qsh, long long ksb, long long kst,
                               long long ksh, long long vsb, long long vst,
                               long long vsh, long long dsb, long long dst,
                               long long dsh, void* stream) {
  Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      dos{dsb, dst, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % kChunk || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    cudaError_t err = allow_smem(dkv_tf32, kT32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(H, (Tk + kT32Own - 1) / kT32Own * (D / kChunk), B);
    dkv_tf32<<<grid, kT32Threads, kT32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        di, static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk, D,
        causal, scale, qs, ks, vs, dos);
    return static_cast<int>(cudaGetLastError());
  }
  if (D == kD)
    return run_dkv_sm90(q, k, v, dout, lse, di, dk, dv, B, H, Tq, Tk, causal,
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
                              int Tq, int Tk, int D, int causal, int dtype,
                              float scale, long long qsb, long long qst,
                              long long qsh,
                              long long ksb, long long kst, long long ksh,
                              long long vsb, long long vst, long long vsh,
                              long long dsb, long long dst, long long dsh,
                              void* stream) {
  Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      dos{dsb, dst, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % kChunk || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    cudaError_t err = allow_smem(dq_tf32, kT32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(H, (Tq + kT32Own - 1) / kT32Own * (D / kChunk), B);
    dq_tf32<<<grid, kT32Threads, kT32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        di, static_cast<float*>(dq), H, Tq, Tk, D, causal, scale, qs, ks,
        vs, dos);
    return static_cast<int>(cudaGetLastError());
  }
  if (D == kD)
    return run_dq_sm90(q, k, v, dout, lse, di, dq, B, H, Tq, Tk, causal,
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
