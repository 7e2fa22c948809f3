// K3 — fused sequence attention for Hopper (sm_90a).
//
// Replaces mmrp_tpu/ops/fused_attention.py:299 (the pallas_call of
// fused_attention: _kernel / _pallas_impl, with its in-kernel W8A8 _qdot):
//   ln_mode "pre":  y = [x +] alpha * proj(attn(LN(x + pos)))
//   ln_mode "post": y = LN(x + pos + alpha * proj(attn(x + pos)))
//   ln_mode "none": y = [x +] alpha * proj(attn(x + pos))
// with an optional cross input kv (keys/values from kv instead of x), an
// additive (B, Nk) key mask, and the residual taken from x + pos or from raw x.
// It carries the 12 BERT layers (post) and every attention of the fusion
// stack: the enhancers (pre + pos + alpha + raw residual), the cross
// attentions (post, cross kv) and the self-attention (pre + pos).
//
// What bounds it on the H100: the four C x C projections (C = 768 / 1024) at
// 49..64 tokens per sequence; attention itself is <= 64 x 64 per head. The TPU
// kernel kept q/k/v, scores and the projection input in VMEM; here one block
// per (sequence, head) keeps the staged rows, this head's q/k/v, the scores
// and the probabilities in shared memory (about 213 KB at C = 1024, d = 128),
// writes the C-wide context once, and proj_epilogue (attention.cuh) applies
// projection, alpha, residual and post-LN in f32. Token counts up to 64 are
// taken as they come (51, 49, 13, 9): no padding to 8 as the TPU needed.
//
// W8A8 (quant->mode == kQuantDyn, the JAX quant=True): the four projections
// take int8 weights per output channel (quantized once per weight by the
// caller, which computes what the TPU kernel's per-program quantization
// computes) and quantize their bf16 inputs per row in the kernel: the staged
// (LN'ed) rows in attention_kernel's shared memory, in place, and the context
// rows in proj_epilogue. The products run on the int8 tensor cores
// (mma.sync m16n8k32, s32 sums) and are dequantized as acc * sx * sw in f32,
// as _qdot does. At BERT widths that halves the weight bytes; the attention
// phase and the per-row scales are unchanged work.
#include "attention.cuh"

using namespace mmrp;

extern "C" {

// x (B, Nq, C) bf16; kv (B, Nk, C) or null; key_mask (B, Nk) f32 or null;
// pos (Nq, C) or null; alpha f32 scalar or null; ln (C) f32;
// w* (C, C) bf16 nn.Linear weights, b* (C); ctx (round16(B*Nq), C) scratch;
// out like x. ln_mode: 0 none, 1 pre, 2 post. quant: null, or a QuantArgs
// (common.cuh) whose w/s are the int8 wq, wk, wv, wo and their scales (the
// bf16 weight pointers are then unused).
int mmrp_seq_attention(const void* x, const void* kv, const void* key_mask, const void* pos,
                       const void* alpha, const void* ln_s, const void* ln_b, const void* wq,
                       const void* bq, const void* wk, const void* bk, const void* wv,
                       const void* bv, const void* wo, const void* bo, void* ctx, void* out,
                       int B, int Nq, int Nk, int C, int heads, int ln_mode,
                       int include_residual, int residual_from_raw, float eps,
                       const void* quant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads < 1 || C % heads || ln_mode < 0 || ln_mode > 2) return (int)cudaErrorInvalidValue;
  const QuantArgs* qa = static_cast<const QuantArgs*>(quant);
  if (qa && qa->mode != kQuantOff && qa->mode != kQuantDyn) return (int)cudaErrorInvalidValue;
  const int qmode = qa ? qa->mode : kQuantOff;

  AttnParams a{};
  a.x = static_cast<const bf16*>(x);
  a.kv = static_cast<const bf16*>(kv);
  a.pos = static_cast<const bf16*>(pos);
  a.ln_s = static_cast<const float*>(ln_s);
  a.ln_b = static_cast<const float*>(ln_b);
  a.wq = static_cast<const bf16*>(wq);
  a.wk = static_cast<const bf16*>(wk);
  a.wv = static_cast<const bf16*>(wv);
  a.bq = static_cast<const bf16*>(bq);
  a.bk = static_cast<const bf16*>(bk);
  a.bv = static_cast<const bf16*>(bv);
  a.key_mask = static_cast<const float*>(key_mask);
  a.ctx = static_cast<bf16*>(ctx);
  a.G = B;
  a.Nq = Nq;
  a.Nk = Nk;
  a.C = C;
  a.heads = heads;
  a.nW = 1;
  a.scale = (float)(1.0 / sqrt((double)(C / heads)));
  a.eps = eps;
  a.ln_pre = ln_mode == 1;
  a.qmode = qmode;
  if (qmode) {
    a.wq8 = static_cast<const signed char*>(qa->w[0]);
    a.wk8 = static_cast<const signed char*>(qa->w[1]);
    a.wv8 = static_cast<const signed char*>(qa->w[2]);
    a.swq = static_cast<const float*>(qa->s[0]);
    a.swk = static_cast<const float*>(qa->s[1]);
    a.swv = static_cast<const float*>(qa->s[2]);
  }
  cudaError_t e = launch_attention(a, st);
  if (e != cudaSuccess) return (int)e;

  EpiParams q{};
  q.ctx = a.ctx;
  q.wo = static_cast<const bf16*>(wo);
  q.bo = static_cast<const bf16*>(bo);
  q.x = a.x;
  q.pos = a.pos;
  q.alpha = static_cast<const float*>(alpha);
  q.ln_s = a.ln_s;
  q.ln_b = a.ln_b;
  q.out = static_cast<bf16*>(out);
  q.M = B * Nq;
  q.C = C;
  q.Nq = Nq;
  q.eps = eps;
  q.mode = ln_mode == 2          ? kPostLN
           : !include_residual   ? kProjOnly
           : residual_from_raw   ? kResidualRaw
                                 : kResidualBase;
  q.qmode = qmode;
  if (qmode) {
    q.wo8 = static_cast<const signed char*>(qa->w[3]);
    q.swo = static_cast<const float*>(qa->s[3]);
  }
  e = launch_epilogue(q, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
