// Shared device helpers for the port's Hopper kernels (sm_90a).
//
// The projections, the Swin attention half and the MLPs run on wgmma
// (gemm_sm90.cuh, attention.cuh, mlp_sm90.cuh), bf16 and int8; the attention
// tiles and the training core's products on mma.sync (attn_tile.cuh,
// wattn_core.cu). B operands are nn.Linear weights, (out_features,
// in_features) row-major, which is a column-major (in, out) matrix: element
// (k, n) of B sits at w[n * ldb + k].
//
// Rows move in 16-byte pieces (cp.async, uint4): the Python wrappers refuse
// tensors whose data pointer is not 32-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace mmrp {

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------------------
// W8A8: the int8 bodies of the TPU kernels (fused_attention.py:_qdot,
// fused_swin_block.py:_static_gemm). Weights arrive quantized per output
// channel (ops/quant.py), nn.Linear layout (N, K) int8 + f32 scales (N,);
// activations are quantized in the kernels, per row or with a static scale,
// and the products run on the int8 tensor cores (wgmma s8, s32 sums: exact).

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
