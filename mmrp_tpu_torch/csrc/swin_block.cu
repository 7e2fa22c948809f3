// Whole Swin block for Hopper (sm_90a): one kernel family for the four
// flavors of the TPU whole-block kernel.
//
// Replaces (pallas_call lines)
//   mmrp_tpu/ops/fused_swin_block.py:435 fused_swin_block_windows  (windows in, windows out)
//   mmrp_tpu/ops/fused_swin_block.py:484 fused_swin_block_raw      (map in, map out)
//   mmrp_tpu/ops/fused_swin_pair.py:384  fused_swin_block_chain    (map in, rolled map out)
//   mmrp_tpu/ops/fused_swin_pair.py:197  fused_swin_block_pair     (two chain steps)
// in bf16 and in their W8A8 forms (_block_body's quant: the dynamic _qdot of
// windows and raw, the _static_gemm of windows, pair and chain): with a
// QuantArgs the qkv GEMM runs int8 in attention_kernel on the LN0 rows it
// holds, and block_mlp_q8_kernel (below) runs proj, FC1 and FC2 in int8.
// which all compute, per ws x ws window of the (pre-rolled) map,
//   y   = x + proj(softmax(q k^T * d^-1/2 + bias_full) v),  q/k/v = LN0(x) W_qkv + b_qkv
//   out = y + W2 gelu_tanh(W1 LN1(y) + b1) + b2
// with y kept in f32 between the halves and rounded once at the end
// (_block_body, fused_swin_block.py:144). The flavors differ only in where a
// window's rows come from and where they go; here that is index arithmetic
// (map_row, attention.cuh), so no roll, partition or reverse copy of the map
// exists. The pair's shifted block reads rows of up to four windows of the
// first block's output, so it needs a barrier across the whole map: two
// launches of this kernel family, the map between them in L2.
//
// What bounds it on the H100: at Swin-B 224 px, batch 8, each block is about
// 10 GFLOP of GEMMs (8 C^2 + 16 C^2 flops per token for qkv/proj and the MLP,
// over 6272 / 1568 / 392 tokens at C = 256 / 512 / 1024), about 10 us at the
// 989 TFLOP/s bf16 peak; its weights are 1.6 / 6.3 / 25.2 MB (0.5 / 1.9 /
// 7.5 us at 3.35 TB/s). So every flavor is compute-bound. Design, two
// launches per block:
//   attention_kernel (attention.cuh, K1's attention phase) — one block per
//     (window, head), LN0 rows gathered from the map into shared memory, this
//     head's q/k/v, scores and softmax in shared memory; the C-wide context
//     (bf16, as the TPU kernel casts it) is the one intermediate in memory;
//   block_mlp_kernel — a cluster of S blocks per 16 window-ordered rows:
//     proj + bias + the gathered residual into an f32 tile, LN1 of it to
//     bf16, then the hidden dimension in chunks of 128 (FC1 -> bias + GELU in
//     f32 -> bf16 chunk -> FC2 accumulated onto the f32 tile), and
//     bf16(tile + b2) scattered to the destination rows. The 4C-wide hidden
//     never leaves shared memory. At C = 1024 a block uses 111,616 bytes.
// GEMMs are WMMA bf16 tiles with f32 accumulation, weights read from L2.
// M / 16 row tiles are few at the late stages (25 at stage 4, batch 8: the
// occupancy trap of K2 at the fusion FFN), so the host gives each row tile a
// cluster of S = 1..8 blocks, enough to put about four blocks on every SM:
// rank q computes proj columns [q C/S, (q+1) C/S) and hidden chunks
// [q Hd/S, (q+1) Hd/S); the blocks exchange proj columns and reduce their FC2
// partial sums (in rank order) through distributed shared memory.
#include <cooperative_groups.h>

#include "attention.cuh"

namespace mmrp {
// the same anonymous namespace as attention.cuh's: a second one at global
// scope makes the names nvcc generates for the kernel stubs ambiguous
namespace {

namespace cg = cooperative_groups;

constexpr int kRows = kMlpRows;  // rows per epilogue block

struct BlockParams {
  const bf16* x;       // block input: (B * nW * N, C) windows, or the (B, H, W, C) map
  const bf16* ctx;     // (round16(M), C) attention context, window order
  const bf16* wproj;   // (C, C) nn.Linear weight
  const bf16* bproj;   // (C,)
  const float* ln1_s;  // (C,)
  const float* ln1_b;
  const bf16* w1;      // (Hd, C)
  const bf16* b1;      // (Hd,)
  const bf16* w2;      // (C, Hd)
  const bf16* b2;      // (C,)
  bf16* out;           // like x
  int M, C, Hd, N, nW;
  int map_h, map_w, ws, roll_h, roll_w;  // map_h == 0: rows in window order, no roll
  float eps;
  // W8A8 (block_mlp_q8_kernel): int8 weights + per-output-channel scales of
  // proj / FC1 / FC2, and each GEMM's static activation scale (inv > 0) or
  // per-row scales (act = inv = 0)
  int qmode;
  const signed char *wproj8, *w18, *w28;
  const float *sproj, *s1, *s2;
  float act[3], inv[3];
};

__device__ inline size_t block_row(const BlockParams& p, int r, bool dst) {
  if (!p.map_h) return (size_t)r;
  return map_row(r / p.N, r % p.N, p.nW, p.map_h, p.map_w, p.ws, dst ? p.roll_h : 0,
                 dst ? p.roll_w : 0);
}

__global__ void __launch_bounds__(kThreads) block_mlp_kernel(BlockParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const MlpSmem L = mlp_smem(p.C);
  float* acc = reinterpret_cast<float*>(smem + L.acc);  // f32 y, then y + FC2
  bf16* z = reinterpret_cast<bf16*>(smem + L.z);        // bf16 LN1(y)
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  const int lda = p.C + 4, ldz = p.C + 8;
  const int row0 = (blockIdx.x / S) * kRows;
  const int cols = p.C / S, c0 = rank * cols;  // this rank's proj and output columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // proj, this rank's columns: acc[:, c0 + 16t ...] = ctx[rows] @ Wproj^T
  for (int t = warp; t < cols / 16; t += kWarps) {
    FragAcc a;
    wmma::fill_fragment(a, 0.f);
    mma_bcol(a, p.ctx + (size_t)row0 * p.C, p.C, p.wproj + (size_t)(c0 + t * 16) * p.C, p.C,
             p.C);
    wmma::store_matrix_sync(acc + c0 + t * 16, a, lda, wmma::mem_row_major);
  }
  if (S > 1) {  // the other ranks' columns, from their shared memory
    cluster.sync();
    for (int q = 1; q < S; ++q) {
      const int src = (rank + q) % S;
      const float* racc = cluster.map_shared_rank(acc, src);
      for (int i = threadIdx.x; i < kRows * cols; i += kThreads) {
        const size_t at = (size_t)(i / cols) * lda + src * cols + i % cols;
        acc[at] = racc[at];
      }
    }
    cluster.sync();  // every rank has its rows whole before any rank overwrites its own
  } else {
    __syncthreads();
  }

  // y = x + (proj + b_proj) in f32, kept in acc; z = bf16(LN1(y)). One warp per row.
  for (int lr = warp; lr < kRows; lr += kWarps) {
    const int r = row0 + lr;
    float* a = acc + (size_t)lr * lda;
    bf16* zr = z + (size_t)lr * ldz;
    if (r >= p.M) {
      for (int c = lane; c < p.C; c += 32) {
        a[c] = 0.f;
        zr[c] = to_bf(0.f);
      }
      continue;
    }
    const bf16* xr = p.x + block_row(p, r, false) * p.C;
    for (int c = lane; c < p.C; c += 32) a[c] = to_f(xr[c]) + (a[c] + to_f(p.bproj[c]));
    float mean, rstd;
    row_stats([&](int c) { return a[c]; }, p.C, p.eps, mean, rstd);
    for (int c = lane; c < p.C; c += 32) {
      zr[c] = to_bf((a[c] - mean) * rstd * p.ln1_s[c] + p.ln1_b[c]);
      if (rank) a[c] = 0.f;  // rank 0 accumulates onto y, the others from zero
    }
  }
  __syncthreads();

  const int span = p.Hd / S;  // this rank's hidden columns
  mlp_hidden_chunks(z, ldz, acc, lda, hf, hs, p.w1, p.b1, p.w2, p.C, p.Hd, rank * span,
                    (rank + 1) * span);
  if (S > 1) cluster.sync();  // every rank's partial sums are complete

  // out = bf16(y + FC2 + b2) on this rank's columns, the ranks' partial sums
  // added in rank order, scattered to the destination rows
  for (int lr = warp; lr < kRows; lr += kWarps) {
    const int r = row0 + lr;
    if (r >= p.M) continue;
    bf16* o = p.out + block_row(p, r, true) * p.C;
    for (int c = c0 + lane; c < c0 + cols; c += 32) {
      float v = 0.f;
      for (int q = 0; q < S; ++q)
        v += (S > 1 ? cluster.map_shared_rank(acc, q) : acc)[(size_t)lr * lda + c];
      o[c] = to_bf(v + to_f(p.b2[c]));
    }
  }
  if (S > 1) cluster.sync();  // no rank leaves while another still reads its shared memory
}

// Blocks per row tile: the largest power of two up to 8 that keeps the grid
// within about four blocks per SM and divides both the proj column tiles and
// the hidden chunks.
inline int cluster_size(int row_tiles, int C, int Hd) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int S = 1;
  while (S < 8 && row_tiles * 2 * S <= 4 * sms && (C / 16) % (2 * S) == 0 &&
         (Hd / kMlpChunk) % (2 * S) == 0)
    S *= 2;
  return S;
}

// ---------------------------------------------------------------------------
// The int8 epilogue: _block_body with quant (the dynamic _qdot, or
// _static_gemm with static or per-row activation scales) on a 16-row tile.
// The one real difference from the bf16 epilogue is FC2's input: a per-row
// scale of gelu(FC1) needs the abs-max over the whole hidden row (Hd = 4C)
// before any FC2 product, and no block holds that row. So each rank keeps
// its bf16 hidden slice (16 x Hd / S) whole in shared memory, the ranks
// exchange their partial row maxima through distributed shared memory, each
// quantizes its slice in place, and each rank then computes FC2 for its own
// output columns over all S slices, reading the other ranks' int8 slices
// through distributed shared memory. The int32 sums are exact, so the order
// of the slices does not matter; y stays f32 and the block rounds once.
struct MlpQ8Smem {
  size_t a8, acc, z, hs, rs, total;
};

// At C = 1024 the slice needs S >= 2 (S = 1: 246 KB).
__host__ __device__ inline MlpQ8Smem mlp_q8_smem(int C, int span) {
  MlpQ8Smem s;
  size_t off = 0;
  s.a8 = off;  // int8 context rows
  off += align128((size_t)kRows * (C + 16));
  s.acc = off;  // f32 y
  off += align128((size_t)kRows * (C + 4) * sizeof(float));
  s.z = off;  // bf16 LN1(y), then int8 in place
  off += align128((size_t)kRows * (C + 8) * sizeof(bf16));
  s.hs = off;  // bf16 gelu(FC1) slice, then int8 in place
  off += align128((size_t)kRows * (span + 8) * sizeof(bf16));
  s.rs = off;  // row scales: context, z, partial |h| max, h
  off += 4 * kRows * sizeof(float);
  s.total = off;
  return s;
}

__global__ void __launch_bounds__(kThreads) block_mlp_q8_kernel(BlockParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int span = p.Hd / S, h0 = rank * span;  // this rank's hidden columns
  const MlpQ8Smem L = mlp_q8_smem(p.C, span);
  signed char* a8 = reinterpret_cast<signed char*>(smem + L.a8);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  bf16* z = reinterpret_cast<bf16*>(smem + L.z);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  const int lda = p.C + 4, ldz = p.C + 8, ldh = span + 8, lda8 = p.C + 16;
  const int row0 = (blockIdx.x / S) * kRows;
  const int cols = p.C / S, c0 = rank * cols;  // this rank's proj and output columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // the context rows in int8 (rows past M quantize to 0)
  for (int lr = warp; lr < kRows; lr += kWarps) {
    const bool live = row0 + lr < p.M;
    const bf16* src = p.ctx + (size_t)(row0 + lr) * p.C;
    const float s = row_scale([&](int c) { return live ? to_f(src[c]) : 0.f; }, p.C,
                              p.act[0], p.inv[0]);
    for (int c = lane; c < p.C; c += 32)
      a8[(size_t)lr * lda8 + c] = live ? quant1(to_f(src[c]), s, p.inv[0]) : (signed char)0;
    if (lane == 0) rs[lr] = s;
  }
  __syncthreads();
  // proj, this rank's columns, dequantized into acc
  for (int n0 = c0 + warp * 8; n0 < c0 + cols; n0 += kWarps * 8) {
    int d[4] = {0, 0, 0, 0};
    mma_s8(d, a8, lda8, p.wproj8 + (size_t)n0 * p.C, p.C, p.C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i >> 1) * 8, n = n0 + 2 * t + (i & 1);
      acc[(size_t)r * lda + n] = dequant(d[i], rs[r], p.sproj[n], p.qmode);
    }
  }
  if (S > 1) {  // the other ranks' columns, from their shared memory
    cluster.sync();
    for (int q = 1; q < S; ++q) {
      const int src = (rank + q) % S;
      const float* racc = cluster.map_shared_rank(acc, src);
      for (int i = threadIdx.x; i < kRows * cols; i += kThreads) {
        const size_t at = (size_t)(i / cols) * lda + src * cols + i % cols;
        acc[at] = racc[at];
      }
    }
    cluster.sync();
  } else {
    __syncthreads();
  }

  // y = x + (proj + b_proj) in f32; z = bf16(LN1(y)), then quantized in place
  for (int lr = warp; lr < kRows; lr += kWarps) {
    const int r = row0 + lr;
    float* a = acc + (size_t)lr * lda;
    bf16* zr = z + (size_t)lr * ldz;
    if (r >= p.M) {
      for (int c = lane; c < p.C; c += 32) {
        a[c] = 0.f;
        zr[c] = to_bf(0.f);
      }
    } else {
      const bf16* xr = p.x + block_row(p, r, false) * p.C;
      for (int c = lane; c < p.C; c += 32) a[c] = to_f(xr[c]) + (a[c] + to_f(p.bproj[c]));
      float mean, rstd;
      row_stats([&](int c) { return a[c]; }, p.C, p.eps, mean, rstd);
      for (int c = lane; c < p.C; c += 32)
        zr[c] = to_bf((a[c] - mean) * rstd * p.ln1_s[c] + p.ln1_b[c]);
    }
    __syncwarp();
    const float s = row_scale([&](int c) { return to_f(zr[c]); }, p.C, p.act[1], p.inv[1]);
    quantize_row_inplace(zr, p.C, s, p.inv[1]);
    if (lane == 0) rs[kRows + lr] = s;
  }
  __syncthreads();

  // FC1 on this rank's hidden columns: + b1, GELU in f32, bf16 into the slice
  const signed char* z8 = reinterpret_cast<const signed char*>(z);
  for (int j0 = warp * 8; j0 < span; j0 += kWarps * 8) {
    int d[4] = {0, 0, 0, 0};
    mma_s8(d, z8, 2 * ldz, p.w18 + (size_t)(h0 + j0) * p.C, p.C, p.C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i >> 1) * 8, j = j0 + 2 * t + (i & 1), n = h0 + j;
      hs[(size_t)r * ldh + j] =
          to_bf(gelu_tanh(dequant(d[i], rs[kRows + r], p.s1[n], p.qmode) + to_f(p.b1[n])));
    }
  }
  __syncthreads();

  // the hidden rows' scales: static, or the abs-max over every rank's slice
  float* hmax = rs + 2 * kRows;
  float* hsc = rs + 3 * kRows;
  if (p.inv[2] > 0.f) {
    if (threadIdx.x < kRows) hsc[threadIdx.x] = p.act[2];
  } else {
    for (int lr = warp; lr < kRows; lr += kWarps) {
      float m = 0.f;
      for (int j = lane; j < span; j += 32) m = fmaxf(m, fabsf(to_f(hs[(size_t)lr * ldh + j])));
      m = warp_max(m);
      if (lane == 0) hmax[lr] = m;
    }
    if (S > 1) cluster.sync(); else __syncthreads();
    if (threadIdx.x < kRows) {
      float m = 0.f;
      for (int q = 0; q < S; ++q)
        m = fmaxf(m, (S > 1 ? cluster.map_shared_rank(hmax, q) : hmax)[threadIdx.x]);
      hsc[threadIdx.x] = fmaxf(m, 1e-8f) / 127.f;
    }
  }
  __syncthreads();
  for (int lr = warp; lr < kRows; lr += kWarps)
    quantize_row_inplace(hs + (size_t)lr * ldh, span, hsc[lr], p.inv[2]);
  if (S > 1) cluster.sync(); else __syncthreads();  // every slice is int8 before FC2 reads it

  // FC2 on this rank's output columns over the whole hidden row (rank q's
  // slice holds hidden columns [q span, (q + 1) span)); out = bf16(y + (FC2 + b2))
  for (int n0 = c0 + warp * 8; n0 < c0 + cols; n0 += kWarps * 8) {
    int d[4] = {0, 0, 0, 0};
    for (int q = 0; q < S; ++q) {
      const bf16* hq = S > 1 ? cluster.map_shared_rank(hs, q) : hs;
      mma_s8(d, reinterpret_cast<const signed char*>(hq), 2 * ldh,
             p.w28 + (size_t)n0 * p.Hd + (size_t)q * span, p.Hd, span);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + (i >> 1) * 8, n = n0 + 2 * t + (i & 1);
      if (row0 + r < p.M)
        p.out[block_row(p, row0 + r, true) * p.C + n] =
            to_bf(acc[(size_t)r * lda + n] +
                  (dequant(d[i], hsc[r], p.s2[n], p.qmode) + to_f(p.b2[n])));
    }
  }
  if (S > 1) cluster.sync();  // no rank leaves while another still reads its shared memory
}

// Blocks per row tile of the int8 epilogue: the fewest whose hidden slice
// fits in shared memory, then more up to 8 as cluster_size grows them; each
// rank's output columns a multiple of 8 and its slice of 32. 0: no fit.
inline int cluster_size_q8(int row_tiles, int C, int Hd) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto ok = [&](int S) { return (C / 8) % S == 0 && (Hd / 32) % S == 0; };
  int S = 1;
  while (S <= 8 && (!ok(S) || mlp_q8_smem(C, Hd / S).total > kMaxSmem)) S *= 2;
  if (S > 8) return 0;
  while (S < 8 && row_tiles * 2 * S <= 4 * sms && ok(2 * S)) S *= 2;
  return S;
}

}  // namespace
}  // namespace mmrp

using namespace mmrp;

extern "C" {

// x: (B, nW, N, C) windows when map_h == 0, else the (B, map_h, map_w, C) map
// in this block's (rolled) frame, windows ws x ws, N = ws * ws. out like x;
// with a map, out is the block's output rolled by (roll, roll). ln f32 (C);
// w_qkv (3C, C), b_qkv (3C), w_proj (C, C), b_proj (C), w1 (Hd, C), b1 (Hd),
// w2 (C, Hd), b2 (C) bf16; bias (nW, heads, N, N) f32; ctx (round16(B*nW*N), C)
// bf16 scratch. out must not overlap x. quant: null, or a QuantArgs
// (common.cuh) whose w/s are the int8 qkv / proj / FC1 / FC2 weights and
// their scales and whose act/inv are the four GEMMs' static activation
// scales (0: per row); the bf16 weight pointers are then unused.
int mmrp_swin_block(const void* x, const void* ln0_s, const void* ln0_b, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, const void* ln1_s,
                    const void* ln1_b, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* bias, void* ctx, void* out, int B, int nW, int N,
                    int C, int heads, int Hd, int map_h, int map_w, int ws, int roll, float eps,
                    const void* quant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantArgs* qa = static_cast<const QuantArgs*>(quant);
  const int qmode = qa ? qa->mode : kQuantOff;
  if (B < 1 || nW < 1 || heads < 1 || C % heads || C % 16 || Hd % kMlpChunk || qmode < 0 ||
      qmode > kQuantStatic || (qmode && C % 32))
    return (int)cudaErrorInvalidValue;
  if (map_h && (ws < 1 || map_h % ws || map_w % ws || N != ws * ws ||
                nW != (map_h / ws) * (map_w / ws)))
    return (int)cudaErrorInvalidValue;
  const bf16* w = static_cast<const bf16*>(w_qkv);
  const bf16* b = static_cast<const bf16*>(b_qkv);

  AttnParams a{};
  a.x = static_cast<const bf16*>(x);
  a.ln_s = static_cast<const float*>(ln0_s);
  a.ln_b = static_cast<const float*>(ln0_b);
  a.wq = w;
  a.wk = w + (size_t)C * C;
  a.wv = w + (size_t)2 * C * C;
  a.bq = b;
  a.bk = b + C;
  a.bv = b + 2 * C;
  a.bias = static_cast<const float*>(bias);
  a.ctx = static_cast<bf16*>(ctx);
  a.G = B * nW;
  a.N = N;
  a.C = C;
  a.heads = heads;
  a.nW = nW;
  a.scale = (float)(1.0 / sqrt((double)(C / heads)));
  a.eps = eps;
  a.map_h = map_h;
  a.map_w = map_w;
  a.ws = ws;
  a.qmode = qmode;
  if (qmode) {
    const signed char* w8 = static_cast<const signed char*>(qa->w[0]);
    const float* s8 = static_cast<const float*>(qa->s[0]);
    a.wq8 = w8;
    a.wk8 = w8 + (size_t)C * C;
    a.wv8 = w8 + (size_t)2 * C * C;
    a.swq = s8;
    a.swk = s8 + C;
    a.swv = s8 + 2 * C;
    a.act_s = qa->act[0];
    a.act_inv = qa->inv[0];
  }
  cudaError_t e = launch_attention(a, st);
  if (e != cudaSuccess) return (int)e;

  BlockParams p{};
  p.x = a.x;
  p.ctx = a.ctx;
  p.wproj = static_cast<const bf16*>(w_proj);
  p.bproj = static_cast<const bf16*>(b_proj);
  p.ln1_s = static_cast<const float*>(ln1_s);
  p.ln1_b = static_cast<const float*>(ln1_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.out = static_cast<bf16*>(out);
  p.M = B * nW * N;
  p.C = C;
  p.Hd = Hd;
  p.N = N;
  p.nW = nW;
  p.map_h = map_h;
  p.map_w = map_w;
  p.ws = ws;
  if (map_h) {
    p.roll_h = ((roll % map_h) + map_h) % map_h;
    p.roll_w = ((roll % map_w) + map_w) % map_w;
  }
  p.eps = eps;
  p.qmode = qmode;
  const int row_tiles = (p.M + kRows - 1) / kRows;
  int S;
  size_t smem;
  if (qmode) {
    p.wproj8 = static_cast<const signed char*>(qa->w[1]);
    p.w18 = static_cast<const signed char*>(qa->w[2]);
    p.w28 = static_cast<const signed char*>(qa->w[3]);
    p.sproj = static_cast<const float*>(qa->s[1]);
    p.s1 = static_cast<const float*>(qa->s[2]);
    p.s2 = static_cast<const float*>(qa->s[3]);
    for (int i = 0; i < 3; ++i) {
      p.act[i] = qa->act[i + 1];
      p.inv[i] = qa->inv[i + 1];
    }
    S = cluster_size_q8(row_tiles, C, Hd);
    if (!S) return (int)cudaErrorInvalidValue;
    smem = mlp_q8_smem(C, Hd / S).total;
    e = allow_smem(block_mlp_q8_kernel, smem);
  } else {
    smem = mlp_smem(C).total;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    S = cluster_size(row_tiles, C, Hd);
    e = allow_smem(block_mlp_kernel, smem);
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = qmode ? cudaLaunchKernelEx(&cfg, block_mlp_q8_kernel, p)
            : cudaLaunchKernelEx(&cfg, block_mlp_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
