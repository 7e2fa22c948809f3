// K1 — fused Swin window attention for Hopper (sm_90a).
//
// Replaces mmrp_tpu/ops/fused_window_attention.py:fused_window_attention_windows
// (Pallas _kernel / _pallas_impl, pallas_call at :152): for every 7x7 window
// of the partitioned, pre-rolled feature map, out = x + proj(softmax(q k^T *
// d^-1/2 + bias_full) v) with q/k/v = LN(x) @ W_qkv + b_qkv.
//
// What bounds it on the H100: the qkv and proj GEMMs, 8 C^2 FLOPs per token
// at C = 96 .. 1024, against 196 C for the 49 x 49 scores and P.V: the
// tensor cores, fed from L2 by the weight stream. The TPU kernel's point was
// to keep qkv and the scores out of HBM; so does this one. Two launches, both
// on wgmma (attention.cuh):
//   window_attn_wgmma  per window (and split of its head groups): the rows
//     staged and LayerNorm'ed once, q/k/v of each 128-column head group on
//     wgmma with the weights streamed through a cp.async ring, the scores,
//     softmax and P.V of each head in registers (attn_tile.cuh); the C-wide
//     context (bf16, as the TPU kernel casts it) is the one intermediate in
//     device memory;
//   k1_proj_wgmma      per 64 rows x 128 columns: context @ W_o^T + b_o [+ x]
//     in f32, rounded once.
#include "attention.cuh"

using namespace mmrp;

extern "C" {

// xw (B, nW, N, C) bf16; ln f32 (C); w_qkv (3C, C) bf16 rows [q | k | v];
// b_qkv (3C); w_proj (C, C); b_proj (C); bias_full (nW, heads, N, N) f32;
// ctx (round16(B*nW*N), C) bf16 scratch; out like xw.
int mmrp_window_attention(const void* xw, const void* ln_s, const void* ln_b, const void* w_qkv,
                          const void* b_qkv, const void* w_proj, const void* b_proj,
                          const void* bias_full, void* ctx, void* out, int B, int nW, int N,
                          int C, int heads, int include_residual, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C % heads) return (int)cudaErrorInvalidValue;

  AttnParams a{};
  a.x = static_cast<const bf16*>(xw);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.w = static_cast<const unsigned char*>(w_qkv);
  a.b = static_cast<const bf16*>(b_qkv);
  a.bias = static_cast<const float*>(bias_full);
  a.ctx = static_cast<bf16*>(ctx);
  a.G = B * nW;
  a.N = N;
  a.C = C;
  a.heads = heads;
  a.nW = nW;
  a.scale = (float)(1.0 / sqrt((double)(C / heads)));
  a.eps = eps;
  cudaError_t e = launch_attention<false>(a, st);
  if (e != cudaSuccess) return (int)e;

  ProjParams q{};
  q.ctx = a.ctx;
  q.wo = static_cast<const bf16*>(w_proj);
  q.bo = static_cast<const bf16*>(b_proj);
  q.x = a.x;
  q.out = static_cast<bf16*>(out);
  q.M = B * nW * N;
  q.C = C;
  q.residual = include_residual;
  return (int)launch_proj(q, st);
}

// The launch geometry of window_attn_wgmma, for the tests to hold the Python
// copies (ops/fused_window_attention.py::attn_splits / attention_smem) to:
// blocks per window over `windows` windows of width C on sms SMs, and the
// shared memory of a block at width C and head dim D (0: no layout fits).
int mmrp_attn_splits(int windows, int C, int sms) { return attn_splits(windows, C, sms); }
int mmrp_attention_smem(int C, int D) {
  const size_t smem = attn_layout(C, D).total;
  return smem <= kMaxSmem ? (int)smem : 0;
}

// Message of a code returned by any entry of this library.
const char* mmrp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
