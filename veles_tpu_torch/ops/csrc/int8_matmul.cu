// W8A16 product out = (x @ q) * scale with the dequantization fused in.
//
// Replaces: veles_tpu/ops/quant.py _matvec_kernel / _pallas_int8_matmul
// (quant.py:63-91), which int8_matmul runs on the TPU for products of at
// most 256 rows (quant.py:104-149): every decode-step projection and the
// vocab head of the int8 serving tier.
//
// What bounds it on the H100: bytes. In the decode regime (M = slots <= 256)
// each int8 weight is read once from device memory and used M times; the
// K*N weight bytes dwarf x (M*K) and out (M*N), and 2*M*K*N operations stay
// far below the ~295 operations per byte at which compute would take over.
//
// Design: a block owns 64 output columns and 4 rows of x. Its 256 threads
// read the weights along N as 16-byte vectors: 4 lanes cover the 64 columns
// of one K row (one 64-byte segment), so a warp reads 8 K rows per load and
// the block 64. The int8 values widen to f32 in registers and accumulate
// x[m, k] * q[k, n] in f32; x's current chunk of K sits in shared memory as
// f32. The K sum is split over the block's 64 lane groups and meets through
// warp shuffles and then shared memory; the per-column scale and the cast to
// x's type are applied once, at the end. Any M, K and N are taken: the ragged
// row and column edges are masked, and an N that is not a multiple of 16
// (or a misaligned q) takes a byte-wise load instead of the vector one.
// Simple first: no tensor cores, no cp.async/TMA pipelining, no split-K
// across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                  // int8 columns per thread (16 bytes)
constexpr int kLanesN = 4;                // lanes along N in a warp
constexpr int kLanesK = 32 / kLanesN;     // lanes along K in a warp
constexpr int kBlockN = kVec * kLanesN;   // 64 columns per block
constexpr int kSlicesK = kWarps * kLanesK;  // 64 K slices per block
constexpr int kBlockM = 4;                // rows of x per block
constexpr int kChunkK = 512;              // K extent of the x tile in smem

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int K, int N, int vec_ok) {
  __shared__ float xs[kBlockM][kChunkK];
  __shared__ float red[kWarps][kBlockM][kBlockN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ln = lane % kLanesN;
  const int lk = lane / kLanesN;
  const int slice = warp * kLanesK + lk;
  const int n0 = blockIdx.x * kBlockN + ln * kVec;
  const int m0 = blockIdx.y * kBlockM;

  float acc[kBlockM][kVec];
#pragma unroll
  for (int m = 0; m < kBlockM; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kc = min(kChunkK, K - k0);
    __syncthreads();  // the previous chunk of xs is consumed
    for (int i = tid; i < kBlockM * kChunkK; i += kThreads) {
      const int m = i / kChunkK;
      const int k = i % kChunkK;
      xs[m][k] = (m0 + m < M && k < kc)
                     ? to_f32(x[(size_t)(m0 + m) * K + k0 + k])
                     : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
      for (int k = slice; k < kc; k += kSlicesK) {
        const int8_t* row = q + (size_t)(k0 + k) * N + n0;
        float w[kVec];
        if (vec_ok) {  // N % 16 == 0 and q 16-byte aligned: n0 + 16 <= N
          const int4 raw = __ldg(reinterpret_cast<const int4*>(row));
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int j = 0; j < kVec; ++j) w[j] = (float)b[j];
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            w[j] = (n0 + j < N) ? (float)row[j] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kBlockM; ++m) {
          const float xv = xs[m][k];
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        }
      }
    }
  }

  // sum the 8 K lanes of each warp (lane bits 2..4), then the 8 warps
#pragma unroll
  for (int m = 0; m < kBlockM; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lk == 0) {
#pragma unroll
    for (int m = 0; m < kBlockM; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][m][ln * kVec + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < kBlockM * kBlockN; i += kThreads) {
    const int m = i / kBlockN;
    const int c = i % kBlockN;
    const int n = blockIdx.x * kBlockN + c;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
      store(out + (size_t)(m0 + m) * N + n, s * scale[n]);
    }
  }
}

}  // namespace

// x (M, K) and out (M, N) in one type (dtype 0 = float32, 1 = bfloat16),
// q (K, N) int8 row-major, scale (N,) float32; all contiguous. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int veles_int8_matmul(const void* x, const void* q,
                                 const void* scale, void* out, int M, int K,
                                 int N, int dtype, int vec_ok, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  if (dtype == 0) {
    int8_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), qp, sp, static_cast<float*>(out), M, K,
        N, vec_ok);
  } else if (dtype == 1) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp,
        static_cast<__nv_bfloat16*>(out), M, K, N, vec_ok);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
