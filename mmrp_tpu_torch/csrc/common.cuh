// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// Every GEMM inside a kernel is a WMMA bf16 16x16x16 tile product with f32
// accumulation (mma.sync on the tensor cores). B operands are nn.Linear
// weights, (out_features, in_features) row-major, which is a column-major
// (in, out) matrix: element (k, n) of B sits at w[n * ldb + k]. That lets the
// kernels read weight tiles straight from global memory (L2-resident at
// these sizes) without a transpose.
//
// WMMA requires 256-bit aligned tile pointers and leading dimensions that
// are multiples of 8 (bf16) or 4 (f32) elements: every shared-memory buffer
// below is padded by 8 bf16 / 4 f32 elements per row and starts on a
// 128-byte boundary, and the Python wrappers refuse weights whose data
// pointer is not 32-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

namespace mmrp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;  // 8 warps per block in every kernel
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tanh-form GELU, jax.nn.gelu's default: x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// acc += A[16 x K] @ B[K x 16]; A row-major (lda), B column-major (ldb).
__device__ __forceinline__ void mma_bcol(FragAcc& acc, const bf16* a, int lda,
                                         const bf16* b, int ldb, int K) {
  FragA fa;
  FragBCol fb;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, b + k, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// acc += A[16 x K] @ B[K x 16]; A row-major (lda), B row-major (ldb).
__device__ __forceinline__ void mma_brow(FragAcc& acc, const bf16* a, int lda,
                                         const bf16* b, int ldb, int K) {
  FragA fa;
  FragBRow fb;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, b + (size_t)k * ldb, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// Two-pass LayerNorm statistics of one row held by one warp: each lane reads
// its own columns c = lane, lane + 32, ... through `get(c)`.
template <typename Get>
__device__ __forceinline__ void row_stats(Get get, int n, float eps, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += get(c);
  mean = warp_sum(s) / (float)n;
  float q = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = get(c) - mean;
    q += d * d;
  }
  rstd = rsqrtf(warp_sum(q) / (float)n + eps);
}

// The MLP core of K2 (ln_mlp.cu) and of the whole Swin block (swin_block.cu),
// on a tile of kMlpRows rows: acc (f32, ld lda) += gelu_tanh(z W1^T + b1) W2^T
// over hidden columns [n_begin, n_end), walked in chunks of kMlpChunk: FC1
// chunk (one 16-wide tile per warp) -> bias + GELU in f32 -> bf16 chunk in
// shared memory -> FC2 accumulated onto acc. The hidden activation never
// leaves shared memory. z is bf16 (ld ldz); hf and hs are the chunk's f32 and
// bf16 staging tiles. W1 (Hd, C) and W2 (C, Hd) are nn.Linear weights.
constexpr int kMlpRows = 16;
constexpr int kMlpChunk = 128;
static_assert(kMlpChunk == kWarps * 16, "one FC1 tile per warp");

struct MlpSmem {
  size_t z, acc, hf, hs, total;
};

// Shared-memory layout of one kMlpRows-row MLP tile at width C.
__host__ __device__ inline MlpSmem mlp_smem(int C) {
  MlpSmem s;
  size_t off = 0;
  s.z = off;
  off += align128((size_t)kMlpRows * (C + 8) * sizeof(bf16));
  s.acc = off;
  off += align128((size_t)kMlpRows * (C + 4) * sizeof(float));
  s.hf = off;
  off += align128((size_t)kMlpRows * (kMlpChunk + 4) * sizeof(float));
  s.hs = off;
  off += align128((size_t)kMlpRows * (kMlpChunk + 8) * sizeof(bf16));
  s.total = off;
  return s;
}

__device__ inline void mlp_hidden_chunks(const bf16* z, int ldz, float* acc, int lda, float* hf,
                                         bf16* hs, const bf16* w1, const bf16* b1,
                                         const bf16* w2, int C, int Hd, int n_begin,
                                         int n_end) {
  const int warp = threadIdx.x >> 5;
  for (int n0 = n_begin; n0 < n_end; n0 += kMlpChunk) {
    {  // FC1 chunk: warp w computes hidden columns [n0 + 16w, n0 + 16w + 16)
      FragAcc h;
      wmma::fill_fragment(h, 0.f);
      mma_bcol(h, z, ldz, w1 + (size_t)(n0 + warp * 16) * C, C, C);
      wmma::store_matrix_sync(hf + warp * 16, h, kMlpChunk + 4, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kMlpRows * kMlpChunk; i += kThreads) {
      const int r = i / kMlpChunk, c = i % kMlpChunk;
      hs[(size_t)r * (kMlpChunk + 8) + c] =
          to_bf(gelu_tanh(hf[(size_t)r * (kMlpChunk + 4) + c] + to_f(b1[n0 + c])));
    }
    __syncthreads();
    // FC2: acc[:, 16t:16t+16] += hidden chunk @ W2^T[chunk, 16t:16t+16]
    for (int t = warp; t < C / 16; t += kWarps) {
      FragAcc o;
      wmma::load_matrix_sync(o, acc + t * 16, lda, wmma::mem_row_major);
      mma_bcol(o, hs, kMlpChunk + 8, w2 + (size_t)t * 16 * Hd + n0, Hd, kMlpChunk);
      wmma::store_matrix_sync(acc + t * 16, o, lda, wmma::mem_row_major);
    }
    __syncthreads();
  }
}

// Shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use on sm_90

}  // namespace mmrp
