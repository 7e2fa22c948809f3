// K1 — fused Swin window attention for Hopper (sm_90a).
//
// Replaces mmrp_tpu/ops/fused_window_attention.py:fused_window_attention_windows
// (Pallas _kernel / _pallas_impl): for every 7x7 window of the partitioned,
// pre-rolled feature map, out = x + proj(softmax(q k^T * d^-1/2 + bias_full) v)
// with q/k/v = LN(x) @ W_qkv + b_qkv.
//
// What bounds it on the H100: at the Swin-B stages the qkv and proj GEMMs
// (8 C^2 flops per token) dominate, with C = 128..1024; the 49 x 49 scores per
// window and head are small. The TPU kernel's point was to keep qkv and the
// scores out of HBM; so does this one. Design:
//   - one block per (window, head): 64 blocks per image at stage 1, and still
//     B * 32 blocks at stage 4, where one window holds the whole image;
//   - the window's 49 rows are LayerNorm'ed into shared memory once per block
//     (64 x (C + 8) bf16, 132 KB at C = 1024) and this head's q/k/v are
//     computed from there, so the window's full qkv (64 x 3072 bf16 at
//     stage 4) never has to fit anywhere;
//   - scores, softmax and P.V stay in shared memory; the C-wide context is
//     written to device memory once, and proj_epilogue (attention.cuh) adds
//     the projection, bias and residual.
// GEMMs are WMMA bf16 tiles with f32 accumulation; LN and softmax are f32.
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
  const bf16* w = static_cast<const bf16*>(w_qkv);
  const bf16* b = static_cast<const bf16*>(b_qkv);

  AttnParams a{};
  a.x = static_cast<const bf16*>(xw);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.wq = w;
  a.wk = w + (size_t)C * C;
  a.wv = w + (size_t)2 * C * C;
  a.bq = b;
  a.bk = b + C;
  a.bv = b + 2 * C;
  a.bias = static_cast<const float*>(bias_full);
  a.ctx = static_cast<bf16*>(ctx);
  a.G = B * nW;
  a.N = N;
  a.C = C;
  a.heads = heads;
  a.nW = nW;
  a.scale = (float)(1.0 / sqrt((double)(C / heads)));
  a.eps = eps;
  cudaError_t e = launch_attention(a, st);
  if (e != cudaSuccess) return (int)e;

  EpiParams q{};
  q.ctx = a.ctx;
  q.wo = static_cast<const bf16*>(w_proj);
  q.bo = static_cast<const bf16*>(b_proj);
  q.x = a.x;
  q.out = static_cast<bf16*>(out);
  q.M = B * nW * N;
  q.C = C;
  q.residual = include_residual;
  e = launch_epilogue(q, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Message of a code returned by any entry of this library.
const char* mmrp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
