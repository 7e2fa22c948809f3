// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// The GEMMs of the training core (wattn_core.cu) are WMMA bf16 16x16x16 tile
// products with f32 accumulation (mma.sync on the tensor cores); the
// projections, the Swin attention half and the MLPs run on wgmma
// (gemm_sm90.cuh, attention.cuh, mlp_sm90.cuh), the attention tiles on
// mma.sync (attn_tile.cuh), and the per-row int8 MLP epilogue on int8
// mma.sync (mma_s8 below). B operands are nn.Linear weights, (out_features,
// in_features) row-major, which is a column-major (in, out) matrix: element
// (k, n) of B sits at w[n * ldb + k].
//
// WMMA requires 256-bit aligned tile pointers and leading dimensions that
// are multiples of 8 (bf16) or 4 (f32) elements: the Python wrappers refuse
// tensors whose data pointer is not 32-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace mmrp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;  // 8 warps a block: wattn_core's, block_mlp_q8_kernel
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

// Row of a (B, H, W, C) map that holds token t of window g (windows row-major
// per image, g / nW the image, tokens row-major in the ws x ws window), moved
// by (roll_h, roll_w) with wrap-around as jnp.roll(y, (roll_h, roll_w), (1, 2))
// moves it. Rolls are taken in [0, H) and [0, W).
__host__ __device__ inline size_t map_row(int g, int t, int nW, int H, int W, int ws,
                                          int roll_h, int roll_w) {
  const int b = g / nW, w = g % nW, nWw = W / ws;
  int i = (w / nWw) * ws + t / ws, j = (w % nWw) * ws + t % ws;
  i += roll_h;
  if (i >= H) i -= H;
  j += roll_w;
  if (j >= W) j -= W;
  return ((size_t)b * H + i) * W + j;
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

// ---------------------------------------------------------------------------
// W8A8: the int8 bodies of the TPU kernels (fused_attention.py:_qdot,
// fused_swin_block.py:_static_gemm). Weights arrive quantized per output
// channel (ops/quant.py), nn.Linear layout (N, K) int8 + f32 scales (N,);
// activations are quantized here, per row or with a static scale, and the
// products run on the int8 tensor cores (mma.sync m16n8k32, s32 sums: exact).

// Host-side operands of one W8A8 launch (ops/_build.py::QuantArgs).
struct QuantArgs {
  int mode;          // kQuantOff, kQuantDyn or kQuantStatic
  const void* w[4];  // int8 (N, K) weights in GEMM order
  const void* s[4];  // f32 (N,) per-output-channel scales
  float act[4];      // static activation scale sa per GEMM, 0 = per-row scales
  float inv[4];      // f32(1 / sa), the reciprocal taken in f64 on the host
};

enum QuantMode { kQuantOff = 0, kQuantDyn = 1, kQuantStatic = 2 };

// The dequantization of one int32 sum, in each TPU kernel's order:
// _qdot computes acc * sx * sw, _static_gemm acc * sw * s. __fmul_rn is never
// contracted into an FMA with the bias add that follows, so each product
// rounds as the separate PyTorch ops of the plain versions do.
__device__ __forceinline__ float dequant(int acc, float sx, float sw, int mode) {
  const float a = __int2float_rn(acc);
  return mode == kQuantDyn ? __fmul_rn(__fmul_rn(a, sx), sw) : __fmul_rn(__fmul_rn(a, sw), sx);
}

// One activation: rint (ties to even, as jnp.round) of x / s, or of x * inv
// for a static scale, clipped to [-127, 127].
__device__ __forceinline__ signed char quant1(float x, float s, float inv) {
  const float q = inv > 0.f ? rintf(x * inv) : rintf(x / s);
  return (signed char)__float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
}

// The scale of a row held by one warp (per-row: max(amax, 1e-8) / 127, as
// quant.py) or the static one; every lane returns it.
template <typename Get>
__device__ __forceinline__ float row_scale(Get get, int n, float sa, float inv) {
  if (inv > 0.f) return sa;
  const int lane = threadIdx.x & 31;
  float m = 0.f;
  for (int c = lane; c < n; c += 32) m = fmaxf(m, fabsf(get(c)));
  return fmaxf(warp_max(m), 1e-8f) / 127.f;
}

// Quantize bf16 row[0, n) in place with scale s (or inv), one warp: int8
// element c lands on byte c of the row, so the int8 row keeps the bf16 row's
// start and a leading dimension of twice its bf16 one. Each step reads 32
// elements and then writes 32 bytes, which cover bf16 elements the step or
// an earlier one has read.
__device__ inline void quantize_row_inplace(bf16* row, int n, float s, float inv) {
  const int lane = threadIdx.x & 31;
  signed char* q = reinterpret_cast<signed char*>(row);
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < n ? to_f(row[c]) : 0.f;
    __syncwarp();
    if (c < n) q[c] = quant1(v, s, inv);
    __syncwarp();
  }
}

// acc[16 x 8] (s32, mma fragment) += A[16 x K] . B[K x 8]: A int8 row-major
// (lda bytes, 4-byte aligned rows), B the int8 nn.Linear rows n0..n0+7
// ((k, n) at b[n * ldb + k]); K a multiple of 32. Fragment c_i of lane
// (g = lane / 4, t = lane % 4) is element (g + 8 (i / 2), 2 t + i % 2).
__device__ __forceinline__ void mma_s8(int acc[4], const signed char* a, int lda,
                                       const signed char* b, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const signed char* a0 = a + (size_t)g * lda + 4 * t;
  const signed char* a1 = a0 + (size_t)8 * lda;
  const signed char* b0 = b + (size_t)g * ldb + 4 * t;
  for (int k = 0; k < K; k += 32) {
    const unsigned A0 = *reinterpret_cast<const unsigned*>(a0 + k);
    const unsigned A1 = *reinterpret_cast<const unsigned*>(a1 + k);
    const unsigned A2 = *reinterpret_cast<const unsigned*>(a0 + k + 16);
    const unsigned A3 = *reinterpret_cast<const unsigned*>(a1 + k + 16);
    const unsigned B0 = __ldg(reinterpret_cast<const unsigned*>(b0 + k));
    const unsigned B1 = __ldg(reinterpret_cast<const unsigned*>(b0 + k + 16));
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(A0), "r"(A1), "r"(A2), "r"(A3), "r"(B0), "r"(B1));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (cp.async), in groups.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The SM count of the current device, into *sms.
__host__ inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use on sm_90

}  // namespace mmrp
