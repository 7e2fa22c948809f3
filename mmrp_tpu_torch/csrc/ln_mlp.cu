// K2 — fused LayerNorm + MLP + residual for Hopper (sm_90a).
//
// Replaces mmrp_tpu/ops/fused_mlp.py:fused_ln_mlp_residual (Pallas _kernel /
// _pallas_impl):
//   pre-LN  (Swin, fusion FFN): out = [x +] FC2(gelu_tanh(FC1(LN x)))
//   post-LN (BERT form):        out = LN(x + FC2(gelu_tanh(FC1 x)))
//
// What bounds it on the H100: the two GEMMs (4 C Hd flops per row) at
// C = 128 / 256 (Swin stages 1-2, M = B * 3136 / B * 784 rows) and C = 1024,
// Hd = 4096 (fusion FFN, M = B * 51 rows). The TPU kernel's point was that the
// 4C-wide hidden activation, the widest tensor of the block, never goes to
// HBM; the same holds here. Design: one block per 16 rows. The block stages
// LN(x) in shared memory, then walks the hidden dimension in chunks of 128:
// FC1 chunk -> bias + GELU in f32 -> bf16 chunk in shared memory -> FC2
// accumulated into a 16 x C f32 tile kept in shared memory (64 KB at
// C = 1024, where a whole-row hidden would not fit). Weights are read as WMMA
// tiles straight from L2. The epilogue adds bias and residual (or the
// post-LN) in f32 and writes the output once. The hidden loop
// (mlp_hidden_chunks, common.cuh) is shared with the whole Swin block.
#include "common.cuh"

using namespace mmrp;

namespace {

constexpr int kRows = kMlpRows;  // rows per block

struct MlpParams {
  const bf16* x;      // (M, C)
  const float* ln_s;  // (C,)
  const float* ln_b;
  const bf16* w1;     // (Hd, C) nn.Linear weight
  const bf16* b1;     // (Hd,)
  const bf16* w2;     // (C, Hd)
  const bf16* b2;     // (C,)
  bf16* out;          // (M, C)
  int M, C, Hd;
  float eps;
  int post_ln, residual;
};

__global__ void __launch_bounds__(kThreads) ln_mlp_kernel(MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpSmem L = mlp_smem(p.C);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.z);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  const int ldx = p.C + 8, lda = p.C + 4;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // FC1 input: LN(x) (pre) or x (post); rows past M are zero
  for (int lr = warp; lr < kRows; lr += kWarps) {
    bf16* dst = xs + (size_t)lr * ldx;
    const int r = row0 + lr;
    if (r >= p.M) {
      for (int c = lane; c < p.C; c += 32) dst[c] = to_bf(0.f);
      continue;
    }
    const bf16* xr = p.x + (size_t)r * p.C;
    if (p.post_ln) {
      for (int c = lane; c < p.C; c += 32) dst[c] = xr[c];
    } else {
      float mean, rstd;
      row_stats([&](int c) { return to_f(xr[c]); }, p.C, p.eps, mean, rstd);
      for (int c = lane; c < p.C; c += 32)
        dst[c] = to_bf((to_f(xr[c]) - mean) * rstd * p.ln_s[c] + p.ln_b[c]);
    }
  }
  for (int i = threadIdx.x; i < kRows * lda; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  mlp_hidden_chunks(xs, ldx, acc, lda, hf, hs, p.w1, p.b1, p.w2, p.C, p.Hd, 0, p.Hd);

  for (int lr = warp; lr < kRows; lr += kWarps) {
    const int r = row0 + lr;
    if (r >= p.M) continue;
    float* a = acc + (size_t)lr * lda;
    const bf16* xr = p.x + (size_t)r * p.C;
    bf16* o = p.out + (size_t)r * p.C;
    if (p.post_ln) {
      for (int c = lane; c < p.C; c += 32) a[c] = (to_f(xr[c]) + a[c]) + to_f(p.b2[c]);
      float mean, rstd;
      row_stats([&](int c) { return a[c]; }, p.C, p.eps, mean, rstd);
      for (int c = lane; c < p.C; c += 32)
        o[c] = to_bf((a[c] - mean) * rstd * p.ln_s[c] + p.ln_b[c]);
    } else {
      for (int c = lane; c < p.C; c += 32) {
        float y = a[c] + to_f(p.b2[c]);
        if (p.residual) y = to_f(xr[c]) + y;
        o[c] = to_bf(y);
      }
    }
  }
}

}  // namespace

extern "C" {

// x (M, C) bf16; ln (C) f32; w1 (Hd, C), b1 (Hd), w2 (C, Hd), b2 (C) bf16; out (M, C).
int mmrp_ln_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                const void* b1, const void* w2, const void* b2, void* out, int M, int C, int Hd,
                int post_ln, int include_residual, float eps, void* stream) {
  if (M < 1 || C % 16 || Hd % kMlpChunk) return (int)cudaErrorInvalidValue;
  MlpParams p{};
  p.x = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.C = C;
  p.Hd = Hd;
  p.eps = eps;
  p.post_ln = post_ln;
  p.residual = include_residual;
  const size_t smem = mlp_smem(C).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(ln_mlp_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ln_mlp_kernel<<<(M + kRows - 1) / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
