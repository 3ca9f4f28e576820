// The bf16 mainloop for Hopper shared by K5 and K6: C = epi(A @ B) with
// bf16 operands, an f32 accumulator and an f32 or bf16 output. K5
// (gemm.cu) runs it with EPI_NONE; K6 (dense_epilogue.cu) with a bias and
// one of the five activations (epilogue.cuh). f32 operands stay on
// gemm_tiles.cuh's true-f32 tile.
//
// What bounds it on the H100: operations. The wide MLP's weight gradient
// x.T @ err (m 784, k 4096, n 4096, K5) and its hidden layer's forward x @
// w (m 4096, k 784, n 4096, K6) are 26.3 GFLOP each, 0.0266 ms at the
// bf16 tensor-core rate, against 43 MB (K5) or 80 MB (K6: a 67 MB f32
// output, 0.020 ms of stores) of operands and output.
//
// Design:
// - One block of three warpgroups per BM x BN output tile (BM 128, BN 256
//   or 128, chosen on the host: see pick_bn). Warpgroup 0 is the producer:
//   one elected thread walks the K tiles (BK 64) and keeps a ring of
//   STAGES shared-memory stages filled with TMA loads, each stage guarded
//   by a full and an empty mbarrier. Warpgroups 1 and 2 are consumers,
//   64 rows of the tile each: per stage they issue BK / 16 wgmma m64nBNk16
//   products from shared-memory descriptors into registers, keep one
//   stage's products in flight while releasing the one before, and never
//   touch the operands with their own loads. setmaxnreg moves registers
//   from the producer to the consumers (BN 256 holds 128 f32 accumulators
//   a thread).
// - Both layouts are read in place, as the tensors lie: A (m, k) with k
//   contiguous is K-major (a [BM][64] box a stage), A with m contiguous
//   (x.T of a row-major x, the weight gradient) is MN-major (two [64 k][64
//   m] boxes) and read through the transpose bit; likewise B (k, n) with n
//   contiguous is MN-major (BN / 64 boxes of [64 k][64 n]) and B with k
//   contiguous (w.T, grad_x) is K-major (one [BN][64] box). All boxes are
//   128-byte swizzled; sm90.cuh gives the descriptors' offsets.
// - Ragged edges: TMA fills the rows, columns and K steps past the tensor
//   with zeros (which add nothing to a sum: k = 784 is 12.25 K tiles) and
//   the epilogue masks its stores past m and n. The epilogue writes each
//   thread's accumulator pairs straight to device memory (f32 or bf16);
//   K6's adds the pair's two bias values (one float2 read per column
//   pair, shared by the thread's two rows) and applies the activation
//   first, so the pre-activation never reaches device memory.
// - What TMA refuses (a base or leading stride that is not 16-byte
//   aligned) the wrapper copies into an aligned buffer first
//   (ops/gemm.py).

#pragma once

#include "epilogue.cuh"
#include "sm90.cuh"

namespace gemm_sm90 {

using bf16 = __nv_bfloat16;
using namespace epilogue;

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // producer warpgroup + two consumers

template <int BN>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * (BM * BK + BK * BN) * sizeof(bf16) +
         2 * STAGES * sizeof(uint64_t) + 1024;  // + alignment slack
}

__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool both, bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b,
                                           bool both, bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (both) p[1] = __float2bfloat16(b);
  }
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 256)
    sm90::wgmma_ss_n256<TA, TB>(acc, da, db, 1);
  else
    sm90::wgmma_ss_n128<TA, TB>(acc, da, db, 1);
}

// A_MN: A is m-contiguous; B_MN: B is n-contiguous (else each is
// k-contiguous). map_a / map_b: the operands' tensor maps (see run).
// EPI: EPI_NONE, or an activation applied after adding bias[col].
template <int BN, bool A_MN, bool B_MN, typename OutT, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16_sm90(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   OutT* __restrict__ c, const float* __restrict__ bias,
                   int m, int n, int k, long long ldc) {
  constexpr int A_TILE = BM * BK;  // elements a stage
  constexpr int B_TILE = BK * BN;
  constexpr uint32_t STAGE_BYTES = (A_TILE + B_TILE) * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sb = sa + STAGES * A_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_TILE);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);  // every consumer thread arrives
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) sm90::mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        sm90::mbar_expect_tx(&full[s], STAGE_BYTES);
        const int k0 = kt * BK;
        bf16* a_dst = sa + s * A_TILE;
        bf16* b_dst = sb + s * B_TILE;
        if (A_MN) {
          sm90::tma_load_2d(a_dst, &map_a, &full[s], m0, k0);
          sm90::tma_load_2d(a_dst + 64 * BK, &map_a, &full[s], m0 + 64, k0);
        } else {
          sm90::tma_load_2d(a_dst, &map_a, &full[s], k0, m0);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_2d(b_dst + j * 64 * BK, &map_b, &full[s],
                              n0 + 64 * j, k0);
        } else {
          sm90::tma_load_2d(b_dst, &map_b, &full[s], k0, n0);
        }
      }
    }
  } else {
    // ---- consumers: rows 64 w .. 64 w + 63 of the tile ----
    sm90::reg_alloc<232>();
    const int w = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % STAGES;
      sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
      const bf16* a_t = sa + s * A_TILE + w * 64 * BK;  // the warpgroup's rows
      const bf16* b_t = sb + s * B_TILE;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da =
            A_MN ? sm90::desc_sw128(a_t + kk * 16 * 64, 64 * BK * 2, 1024)
                 : sm90::desc_sw128(a_t + kk * 16, 16, 1024);
        const uint64_t db =
            B_MN ? sm90::desc_sw128(b_t + kk * 16 * 64, 64 * BK * 2, 1024)
                 : sm90::desc_sw128(b_t + kk * 16, 16, 1024);
        mma<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
      }
      sm90::wgmma_commit();
      sm90::fence_acc(acc);
      // the previous stage's products are done: release it
      sm90::wgmma_wait<1>();
      if (kt > 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);

    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row0 = m0 + w * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    const bool even = (ldc % 2) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= n) continue;
      const bool both = col + 1 < n;
      float b0 = 0.f, b1 = 0.f;
      if constexpr (EPI != EPI_NONE) {
        if (both) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
          b0 = bb.x;
          b1 = bb.y;
        } else {
          b0 = __ldg(bias + col);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if constexpr (EPI != EPI_NONE) {
          v0 = activate<EPI>(v0 + b0);
          v1 = activate<EPI>(v1 + b1);
        }
        if (row < m)
          store_pair(c + row * ldc + col, v0, v1, both, both && even);
      }
    }
  }
}

// The output tile width: the fewer waves over the card's SMs times the
// tile's width (the time a wave takes grows with it), BN 256 on a tie.
inline int pick_bn(int m, int n, int sms) {
  const long long rows = (m + BM - 1) / BM;
  const long long w256 = (rows * ((n + 255) / 256) + sms - 1) / sms * 256;
  const long long w128 = (rows * ((n + 127) / 128) + sms - 1) / sms * 128;
  return w256 <= w128 ? 256 : 128;
}

template <int BN, bool A_MN, bool B_MN, typename OutT, int EPI>
inline int launch_tile(const CUtensorMap& ma, const CUtensorMap& mb, OutT* c,
                       const float* bias, int m, int n, int k, long long ldc,
                       int device, cudaStream_t stream) {
  auto kernel = gemm_bf16_sm90<BN, A_MN, B_MN, OutT, EPI>;
  const size_t smem = smem_bytes<BN>();
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int err = opt_in.ensure(kernel, static_cast<int>(smem), device);
  if (err) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(ma, mb, c, bias, m, n, k, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename OutT, int EPI>
inline int launch_bn(bool a_mn, bool b_mn, const CUtensorMap& ma,
                     const CUtensorMap& mb, OutT* c, const float* bias,
                     int m, int n, int k, long long ldc, int device,
                     cudaStream_t s) {
  if (a_mn && b_mn)
    return launch_tile<BN, true, true, OutT, EPI>(ma, mb, c, bias, m, n, k,
                                                  ldc, device, s);
  if (a_mn)
    return launch_tile<BN, true, false, OutT, EPI>(ma, mb, c, bias, m, n, k,
                                                   ldc, device, s);
  if (b_mn)
    return launch_tile<BN, false, true, OutT, EPI>(ma, mb, c, bias, m, n, k,
                                                   ldc, device, s);
  return launch_tile<BN, false, false, OutT, EPI>(ma, mb, c, bias, m, n, k,
                                                  ldc, device, s);
}

// A (m, k) and B (k, n) bf16 at a and b, each read in place through its
// leading stride (elements; 16-byte aligned, as the pointers): a_mn /
// b_mn say the m (n) axis is the contiguous one. Returns the cudaError_t
// of the launch, or minus a CUresult when a tensor map is refused. EPI
// other than EPI_NONE adds bias (n f32 values) and applies the activation.
template <typename OutT, int EPI = EPI_NONE>
inline int run(const void* a, const void* b, OutT* c, int m, int n, int k,
               long long lda, bool a_mn, long long ldb, bool b_mn,
               long long ldc, cudaStream_t stream,
               const float* bias = nullptr) {
  int device = 0;
  cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const int bn = pick_bn(m, n, sm90::sm_count(device));
  CUtensorMap ma, mb;
  // a tensor map lists its dimensions innermost (contiguous) first
  const uint64_t a_dims[2] = {static_cast<uint64_t>(a_mn ? m : k),
                              static_cast<uint64_t>(a_mn ? k : m)};
  const uint64_t a_stride[1] = {static_cast<uint64_t>(lda) * 2};
  const uint32_t a_box[2] = {64, a_mn ? 64u : static_cast<uint32_t>(BM)};
  int err = sm90::encode_map(&ma, a, 2, a_dims, a_stride, a_box);
  if (err) return err;
  const uint64_t b_dims[2] = {static_cast<uint64_t>(b_mn ? n : k),
                              static_cast<uint64_t>(b_mn ? k : n)};
  const uint64_t b_stride[1] = {static_cast<uint64_t>(ldb) * 2};
  const uint32_t b_box[2] = {64, b_mn ? 64u : static_cast<uint32_t>(bn)};
  err = sm90::encode_map(&mb, b, 2, b_dims, b_stride, b_box);
  if (err) return err;
  if (bn == 256)
    return launch_bn<256, OutT, EPI>(a_mn, b_mn, ma, mb, c, bias, m, n, k,
                                     ldc, device, stream);
  return launch_bn<128, OutT, EPI>(a_mn, b_mn, ma, mb, c, bias, m, n, k, ldc,
                                   device, stream);
}

}  // namespace gemm_sm90
