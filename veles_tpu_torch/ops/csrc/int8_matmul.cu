// K2: the W8A16 product out = (x @ q) * scale, the dequantization fused in.
//
// Replaces: veles_tpu/ops/quant.py _matvec_kernel / _pallas_int8_matmul
// (quant.py:63-91), which int8_matmul runs on the TPU for products of at
// most 256 rows (quant.py:104-149): every decode-step projection and the
// vocab head of the int8 serving tiers, and prefills of up to 256 rows.
//
// What bounds it on the H100: bytes. Each int8 weight is read once from
// device memory and used M times (M = 8 slots while decoding); the K*N
// weight bytes dwarf x (M*K) and out (M*N), and 2*M*K*N operations stay
// far below the ~295 operations per byte where compute would take over.
// One decode step's 17 products move 84 MB: 0.0256 ms at 3.35 TB/s.
//
// Design:
// - The plan (ops/quant._int8_plan, computed in Python so the CPU tests
//   hold it): 128-column tiles, and K cut into `splits` slices of whole
//   16-row mma steps, so that a decode product fills the card with at
//   least one block per SM (two where the shape allows; the vocab head's
//   256 tiles need no split) and every weight byte is read by exactly one
//   block. Block (tile, split) walks its K slice in stages of 64 rows.
// - Bytes in flight: a ring of STAGES stages (2 to 8, as many as 160 KB
//   hold), all but one in flight, filled by 16-byte cp.async copies from
//   all 256 threads: the int8 weight tile [64 k][128 n] and x [16 MT
//   rows][64 k]. Rows past the slice, K or M and columns past N are
//   zero-filled by the copy (src-size 0), so a ragged edge adds nothing.
//   Each stage's chunks are XOR-swizzled by row (16-byte chunk c of row r
//   at c ^ (r % 8)), so the reads below hit 32 banks. (A TMA load of the
//   weight tile would cost the host a tensor map a launch, for bytes that
//   cp.async already keeps in flight.)
// - bf16 x on tensor cores: mma.sync m16n8k16 (bf16, f32 accumulators),
//   x the A operand through ldmatrix, its rows padded to 16 x MT (MT, the
//   row tiles, a power of two from ceil(M / 16)). The weights widen in
//   registers straight into B fragments: a thread reads four 32-bit words
//   (4 columns of rows 2t, 2t+1, 2t+8, 2t+9), pairs them along k with two
//   byte permutes, and widens each byte exactly through the f32 magic
//   number 2^23 + (q + 128) (one permute and one subtraction a value; the
//   top halves of two such floats are two exact bf16 values, one permute
//   a pair). A warp's four n8 products take columns 4g + j of its 32, so
//   each thread ends with 8 adjacent columns of a row and stores them as
//   one vector. Every block loops over all its row tiles against each
//   weight stage, so each weight byte leaves device memory once a call.
//   Warps 0-3 and 4-7 take the same 32-column groups and split the row
//   tiles between them, or, at one row tile (M <= 16), the k steps (their
//   sums meet in shared memory at the end).
// - f32 x stays true f32 on the CUDA cores (never TF32: the f32 agreement
//   runs compare token streams against the CPU), with the same plan and
//   ring: a lane owns 4 columns, a warp every eighth row.
// - The split-K sum is deterministic and in this one launch: each split
//   writes its f32 partials to a workspace the wrapper keeps; the last
//   block of a column tile to finish (a per-tile counter: one thread's
//   acquire-release atomic after a block barrier, no full fence) sums the
//   partials in split order 0..S-1, multiplies by
//   the scale, casts and stores, and resets the counter to 0 for the next
//   call. Two calls give bit-equal outputs. One split writes the output
//   straight from its registers.
// - A misaligned q or an N that is no multiple of 16 (no decode shape has
//   either) takes the byte-wise path: the same kernel with the weight
//   stage filled by masked byte loads instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"  // SmemOptIn

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BN = 128;       // columns of a tile
constexpr int BK = 64;        // K rows of a ring stage
constexpr int MAX_MT = 16;    // 256 rows of x (PALLAS_MAX_ROWS)
constexpr int SMEM_BUDGET = 160 * 1024;

constexpr int clamp_stages(int n) { return n < 2 ? 2 : (n > 8 ? 8 : n); }

template <typename T, int MT>
struct Tile {
  static constexpr int MP = 16 * MT;                  // padded rows of x
  static constexpr int XROW = BK * (int)sizeof(T);    // bytes of a stage row
  static constexpr int XCHUNKS = XROW / 16;
  static constexpr int XBYTES = MP * XROW;
  static constexpr int STAGE = XBYTES + BK * BN;      // x, then q
  static constexpr int STAGES = clamp_stages(SMEM_BUDGET / STAGE);
  static constexpr int SMEM = STAGES * STAGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte copy into shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the byte offset of 16-byte chunk c of row r in a stage whose rows are
// `row_bytes` long: chunks XOR-swizzled by the row's low three bits
__device__ __forceinline__ int swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

// the four int8 values of a word, each exactly as f32 (2^23 + (v + 128)
// minus 2^23 + 128)
__device__ __forceinline__ void widen_f32(uint32_t u, float (&f)[4]) {
  u ^= 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// the four int8 values of a word as two bf16 pairs (bytes 0, 1 and 2, 3;
// the lower byte in the lower half): the top half of an exact f32 integer
// of at most 8 significant bits is that integer in bf16
__device__ __forceinline__ void widen_bf16(uint32_t u, uint32_t& p01,
                                           uint32_t& p23) {
  float f[4];
  widen_f32(u, f);
  p01 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  p23 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// add 1 to a tile counter with release and acquire semantics at the
// device's scope; returns the old count
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// CNT (4 or 8) adjacent outputs of row m from column n on: the product
// times the scale, cast, where n + e < N; one vector store when all CNT
// fit and N keeps the row aligned.
template <int CNT, typename T>
__device__ __forceinline__ void store_out(T* out, const float* scale,
                                          const float* v, int m, int n,
                                          int N) {
  T* dst = out + (size_t)m * N + n;
  if (n + CNT <= N && N % 8 == 0) {
    float s[CNT];
#pragma unroll
    for (int e = 0; e < CNT; e += 4) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + n + e));
      s[e] = s4.x; s[e + 1] = s4.y; s[e + 2] = s4.z; s[e + 3] = s4.w;
    }
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < CNT; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(v[e] * s[e], v[e + 1] * s[e + 1],
                        v[e + 2] * s[e + 2], v[e + 3] * s[e + 3]);
    } else {
      uint32_t w[CNT / 2];
#pragma unroll
      for (int e = 0; e < CNT; e += 2) {
        __nv_bfloat162 h =
            __floats2bfloat162_rn(v[e] * s[e], v[e + 1] * s[e + 1]);
        w[e / 2] = *reinterpret_cast<uint32_t*>(&h);
      }
      if constexpr (CNT == 8)
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < CNT; ++e)
      if (n + e < N) store(dst + e, v[e] * __ldg(scale + n + e));
  }
}

// the split-K sum of 4 columns: store_out once a group, out of line (the
// reduction loop is unrolled)
template <typename T>
__device__ __noinline__ void finish(T* out, const float* scale, float4 sum,
                                    int m, int n, int N) {
  const float v[4] = {sum.x, sum.y, sum.z, sum.w};
  if (n < N) store_out<4>(out, scale, v, m, n, N);
}

// CNT adjacent f32 partials of row m at column n of the workspace
// [splits][M][np] (np: the tiles' padded width, so always aligned)
template <int CNT>
__device__ __forceinline__ void store_partial(float* ws, const float* v,
                                              int split, int m, int n,
                                              int M, int np) {
  float* dst = ws + ((size_t)split * M + m) * np + n;
#pragma unroll
  for (int e = 0; e < CNT; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
}

// Fill ring slot `st` with the stage of K rows k0 .. k0 + 63 (zeros from
// k_end on): x's rows as 16-byte cp.async chunks; q's [64][128] int8 tile
// by cp.async (VEC) or by masked byte loads (the byte-wise path).
template <typename T, int MT, bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const T* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int M, int N, long long ldx,
                                           int n0, int k0, int k_end) {
  using S = Tile<T, MT>;
  constexpr int EPC = 16 / sizeof(T);  // elements of x a chunk
  for (int i = threadIdx.x; i < S::MP * S::XCHUNKS; i += THREADS) {
    const int r = i / S::XCHUNKS, c = i % S::XCHUNKS;
    const int k = k0 + c * EPC;
    const bool ok = r < M && k < k_end;
    cp_async16(st + swz(r, c, S::XROW), ok ? x + r * ldx + k : x, ok);
  }
  unsigned char* qs = st + S::XBYTES;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < BK * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int k = k0 + r, n = n0 + 16 * c;
      const bool ok = k < k_end && n < N;  // N % 16 == 0: whole chunks
      cp_async16(qs + swz(r, c, BN), ok ? q + (size_t)k * N + n : q, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BK * (BN / 4); i += THREADS) {
      const int r = i / (BN / 4), w = i % (BN / 4);
      const int k = k0 + r, n = n0 + 4 * w;
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k < k_end && n + b < N)
          word |= (uint32_t)(uint8_t)q[(size_t)k * N + n + b] << (8 * b);
      *reinterpret_cast<uint32_t*>(qs + swz(r, w >> 2, BN) + ((w & 3) << 2)) =
          word;
    }
  }
}

// bf16 x: the warp's accumulators over its row tiles (see the note).
template <int MT>
struct Bf16Core {
  static constexpr bool KSPLIT = MT == 1;
  static constexpr int MTW = MT == 1 ? 1 : MT / 2;  // row tiles a warp
  float acc[MTW][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void stage(const unsigned char* st, int nk) {
    using S = Tile<bf16, MT>;
    const unsigned char* qs = st + S::XBYTES;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cg = warp & 3, mg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int qc = 2 * cg + (g >> 2), qw = (g & 3) << 2;
    const int steps = (nk + 15) >> 4;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk >= steps) break;
      if (KSPLIT && (kk & 1) != mg) continue;
      const unsigned char* rows = qs + kk * 16 * BN;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
          rows + swz(2 * t, qc, BN) + qw);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
          rows + swz(2 * t + 1, qc, BN) + qw);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(
          rows + swz(2 * t + 8, qc, BN) + qw);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(
          rows + swz(2 * t + 9, qc, BN) + qw);
      // b[j]: column 4g + j of the warp's 32, rows (2t, 2t+1) and
      // (2t+8, 2t+9) of the k step
      uint32_t b[4][2];
      widen_bf16(__byte_perm(w0, w1, 0x5140), b[0][0], b[1][0]);
      widen_bf16(__byte_perm(w0, w1, 0x7362), b[2][0], b[3][0]);
      widen_bf16(__byte_perm(w2, w3, 0x5140), b[0][1], b[1][1]);
      widen_bf16(__byte_perm(w2, w3, 0x7362), b[2][1], b[3][1]);
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        const int row = (KSPLIT ? 0 : mg + 2 * i) * 16 + (lane & 15);
        uint32_t a[4];
        ldmatrix_x4(a, st + swz(row, 2 * kk + (lane >> 4), S::XROW));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // the k-split halves meet (MT == 1); the ring is drained and every
  // thread past its last read of it
  __device__ __forceinline__ bool meet(unsigned char* smem) {
    if constexpr (!KSPLIT) return true;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* red = reinterpret_cast<float*>(smem) + ((warp & 3) * 32 + lane) * 16;
    if (warp >= 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[4 * j + e] = acc[0][j][e];
    }
    __syncthreads();
    if (warp >= 4) return false;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] += red[4 * j + e];
    return true;
  }

  // each row of the warp's tiles: 8 adjacent columns from 32 cg + 8 t
  template <typename Emit>
  __device__ __forceinline__ void emit(int M, Emit&& out) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cg = warp & 3, mg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int r0 = (KSPLIT ? 0 : mg + 2 * i) * 16 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = r0 + 8 * half;
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[i][j][2 * half];
          v[4 + j] = acc[i][j][2 * half + 1];
        }
        if (m < M) out(v, m, 32 * cg + 8 * t);
      }
    }
  }
};

// f32 x: lane l owns columns 4l .. 4l+3, warp w rows w, w + 8, ...
template <int MT>
struct F32Core {
  static constexpr int RW = 2 * MT;  // rows a warp
  float acc[RW][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  __device__ __forceinline__ void stage(const unsigned char* st, int nk) {
    using S = Tile<float, MT>;
    const unsigned char* qs = st + S::XBYTES;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      float w[4];
      widen_f32(*reinterpret_cast<const uint32_t*>(
                    qs + swz(k, lane >> 2, BN) + ((lane & 3) << 2)),
                w);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int m = warp + 8 * i;  // the warp reads one value: broadcast
        const float xv = *reinterpret_cast<const float*>(
            st + swz(m, k >> 2, S::XROW) + ((k & 3) << 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(xv, w[e], acc[i][e]);
      }
    }
  }

  __device__ __forceinline__ bool meet(unsigned char*) { return true; }

  template <typename Emit>
  __device__ __forceinline__ void emit(int M, Emit&& out) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int m = warp + 8 * i;
      if (m < M) out(acc[i], m, 4 * lane);
    }
  }
};

template <typename T, int MT>
using Core = std::conditional_t<sizeof(T) == 2, Bf16Core<MT>, F32Core<MT>>;

// Block (tile, split): columns 128 tile.., K rows split * slice ..
// Up to 32 rows (decoding), two blocks share an SM (at most 128 registers a
// thread), so a plan's blocks past the SM count do not wait for a second
// wave.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS, MT <= 2 ? 2 : 1)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, T* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int M, int K, int N, long long ldx, int slice) {
  using S = Tile<T, MT>;
  constexpr int CNT = sizeof(T) == 2 ? 8 : 4;  // adjacent outputs a row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;

  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * BN, np = gridDim.x * BN;
  const int k_begin = split * slice;
  const int k_end = min(K, k_begin + slice);
  const int nst = (k_end - k_begin + BK - 1) / BK;

#pragma unroll 1  // one copy of the stage's code: it runs once, cold
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < nst)
      load_stage<T, MT, VEC>(smem + s * S::STAGE, x, q, M, N, ldx, n0,
                             k_begin + s * BK, k_end);
    cp_async_commit();
  }
  Core<T, MT> core;
  core.zero();
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // stage it has landed; slot it - 1 is free
    const int nx = it + S::STAGES - 1;
    if (nx < nst)
      load_stage<T, MT, VEC>(smem + (nx % S::STAGES) * S::STAGE, x, q, M, N,
                             ldx, n0, k_begin + nx * BK, k_end);
    cp_async_commit();
    const int k0 = k_begin + it * BK;
    core.stage(smem + (it % S::STAGES) * S::STAGE, min(BK, k_end - k0));
  }
  cp_async_wait<0>();
  __syncthreads();
  const bool owns = core.meet(smem);

  if (splits == 1) {
    if (owns)
      core.emit(M, [&](const float* v, int m, int c) {
        store_out<CNT>(out, scale, v, m, n0 + c, N);
      });
    return;
  }
  if (owns)
    core.emit(M, [&](const float* v, int m, int c) {
      store_partial<CNT>(ws, v, split, m, n0 + c, M, np);
    });
  // the block's partials are ordered before thread 0's release (the
  // barrier), and the last block's reads after its acquire (the barrier)
  __syncthreads();
  if (threadIdx.x == 0) last = arrive(&counters[tile]) == splits - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: the partials in split order, then the scale.
  // A thread's (group, split) items run group by group, splits in order,
  // RED loads issued before any is added: a few L2 round trips a call,
  // whether there are many splits (decoding) or many rows (prefill)
  constexpr int RED = 8;
  const int groups = M * (BN / 4);  // 4-column groups of the tile
  const int items =
      (groups - (int)threadIdx.x + THREADS - 1) / THREADS * splits;
  const size_t split_stride = (size_t)M * np;
  int group = threadIdx.x, split_of = 0;  // item b's group and split
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < items; b += RED) {
    float4 p[RED];
    int g = group, s = split_of;
#pragma unroll
    for (int u = 0; u < RED; ++u) {
      if (b + u < items)
        p[u] = __ldcg(reinterpret_cast<const float4*>(
            ws + s * split_stride + (size_t)(g / (BN / 4)) * np + n0 +
            4 * (g % (BN / 4))));
      if (++s == splits) {
        s = 0;
        g += THREADS;
      }
    }
#pragma unroll
    for (int u = 0; u < RED; ++u) {
      if (b + u < items) {
        if (split_of == 0) v[0] = v[1] = v[2] = v[3] = 0.f;
        v[0] += p[u].x; v[1] += p[u].y; v[2] += p[u].z; v[3] += p[u].w;
        if (split_of == splits - 1)
          finish(out, scale, make_float4(v[0], v[1], v[2], v[3]),
                 group / (BN / 4), n0 + 4 * (group % (BN / 4)), N);
      }
      if (++split_of == splits) {
        split_of = 0;
        group += THREADS;
      }
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <typename T, int MT, bool VEC>
int launch(const void* x, const void* q, const float* scale, void* out,
           float* ws, int* counters, int M, int K, int N, long long ldx,
           int slice, int splits, cudaStream_t stream) {
  using S = Tile<T, MT>;
  auto kernel = int8_matmul_kernel<T, MT, VEC>;
  static sm90::SmemOptIn opt_in;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = opt_in.ensure(kernel, S::SMEM, device);
  if (refused) return refused;
  const dim3 grid((N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, S::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), scale,
      static_cast<T*>(out), ws, counters, M, K, N, ldx, slice);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_rows(const void* x, const void* q, const float* scale, void* out,
                float* ws, int* counters, int M, int K, int N, long long ldx,
                int slice, int splits, cudaStream_t s) {
  const int mt = (M + 15) / 16;
  if (mt <= 1)
    return launch<T, 1, VEC>(x, q, scale, out, ws, counters, M, K, N, ldx,
                             slice, splits, s);
  if (mt <= 2)
    return launch<T, 2, VEC>(x, q, scale, out, ws, counters, M, K, N, ldx,
                             slice, splits, s);
  if (mt <= 4)
    return launch<T, 4, VEC>(x, q, scale, out, ws, counters, M, K, N, ldx,
                             slice, splits, s);
  if (mt <= 8)
    return launch<T, 8, VEC>(x, q, scale, out, ws, counters, M, K, N, ldx,
                             slice, splits, s);
  return launch<T, MAX_MT, VEC>(x, q, scale, out, ws, counters, M, K, N, ldx,
                                slice, splits, s);
}

}  // namespace

// x (M, K) with rows ldx elements apart (a multiple of 16 bytes, the pad
// zeroed) and out (M, N) contiguous, in one type (dtype 0 = float32, 1 =
// bfloat16); q (K, N) int8 row-major; scale (N,) float32, 16-byte
// aligned. The plan: `splits` slices of `slice` K rows (a multiple of
// 16); with splits > 1, ws holds splits x M x (128 * tiles) f32 and
// counters one zeroed int per 128-column tile (left zeroed). vec: q is
// 16-byte aligned and N % 16 == 0 (else the byte-wise path). Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int veles_int8_matmul(const void* x, const void* q,
                                 const void* scale, void* out, void* ws,
                                 void* counters, int M, int K, int N,
                                 long long ldx, int dtype, int vec,
                                 int slice, int splits, void* stream) {
  if (M < 1 || M > 16 * MAX_MT || K < 1 || N < 1 || slice < 16 ||
      slice % 16 || splits < 1 || (long long)slice * (splits - 1) >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  float* wp = static_cast<float*>(ws);
  int* cp = static_cast<int*>(counters);
  if (dtype == 0)
    return vec ? launch_rows<float, true>(x, q, sp, out, wp, cp, M, K, N,
                                          ldx, slice, splits, s)
               : launch_rows<float, false>(x, q, sp, out, wp, cp, M, K, N,
                                           ldx, slice, splits, s);
  if (dtype == 1)
    return vec ? launch_rows<bf16, true>(x, q, sp, out, wp, cp, M, K, N, ldx,
                                         slice, splits, s)
               : launch_rows<bf16, false>(x, q, sp, out, wp, cp, M, K, N,
                                          ldx, slice, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
