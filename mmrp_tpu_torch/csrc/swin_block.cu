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
// QuantArgs the qkv GEMM runs int8 in window_attn_wgmma on the LN0 rows it
// holds, and the MLP launch runs proj, FC1 and FC2 in int8. They all compute,
// per ws x ws window of the (pre-rolled) map,
//   y   = x + proj(softmax(q k^T * d^-1/2 + bias_full) v),  q/k/v = LN0(x) W_qkv + b_qkv
//   out = y + W2 gelu_tanh(W1 LN1(y) + b1) + b2
// with y kept in f32 between the halves and rounded once at the end
// (_block_body, fused_swin_block.py:144). The flavors differ only in where a
// window's rows come from and where they go; here that is index arithmetic
// (map_row, common.cuh), so no roll, partition or reverse copy of the map
// exists. The pair's shifted block reads rows of up to four windows of the
// first block's output, so it needs a barrier across the whole map: two
// launches of this kernel family, the map between them in L2.
//
// What bounds it on the H100: at Swin-B 224 px, batch 8, each block is about
// 10 GFLOP of GEMMs (8 C^2 + 16 C^2 flops per token for qkv/proj and the MLP,
// over 6272 / 1568 / 392 tokens at C = 256 / 512 / 1024), about 10 us at the
// 989 TFLOP/s bf16 peak; its weights are 1.6 / 6.3 / 25.2 MB (0.5 / 1.9 /
// 7.5 us at 3.35 TB/s). So every flavor is compute-bound, and two thirds of
// the FLOPs are the MLP's. Design, two launches per block:
//   window_attn_wgmma (attention.cuh, K1's attention launch) — one block per
//     window and split of its head groups: LN0 rows gathered from the map by
//     cp.async and LayerNorm'ed in shared memory once, q/k/v of each 128-column
//     head group on wgmma with the weights streamed through a ring, scores,
//     softmax and P.V in registers; the C-wide context (bf16, as the TPU
//     kernel casts it) is the one intermediate in memory;
//   block_mlp_kernel — the MLP half on wgmma (mlp_sm90.cuh): a cluster of S
//     blocks, one warpgroup each, per 64 window-ordered rows, S splitting the
//     hidden dimension. Rank q computes proj column tiles q, q + S, ... on
//     wgmma (the context rows and Wproj streamed through the ring), adds
//     b_proj and the gathered residual into y in f32 (an f32 scratch, so
//     y is rounded once, at the end); after a cluster barrier each rank
//     LayerNorms its 64 / S rows of y into bf16 LN1(y) (a bf16 scratch); after
//     another, mlp_sm90.cuh's FC1 -> GELU -> on-chip hidden slice -> FC2 with
//     the ranks' partial sums added in rank order, and each rank writes
//     bf16(y + FC2 + b2) of its rows to their destination rows. The scratch
//     rows stay in L2; the 4C-wide hidden never leaves the chip.
// The static W8A8 form with calibrated activation scales runs the same
// kernel in int8 (the context and LN1(y) quantized as they are written to
// the scratch, the hidden as it leaves FC1). The forms that need a row's
// scale first (per-row static scales, the dynamic _qdot) run
// block_mlp_q8_kernel: a cluster of S blocks per 16 rows on int8 mma.sync,
// described below.
#include <cooperative_groups.h>

#include "attention.cuh"
#include "mlp_sm90.cuh"

namespace mmrp {
// the same anonymous namespace as attention.cuh's: a second one at global
// scope makes the names nvcc generates for the kernel stubs ambiguous
namespace {

namespace cg = cooperative_groups;

constexpr int kRows = 16;  // rows per block of the int8 per-row epilogue

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
  float* y;            // (M, C) f32 scratch: x + proj + b_proj
  unsigned char* z;    // (M, C) scratch: bf16 LN1(y), or its int8 form
  signed char* ctx8;   // (M, C) scratch: the int8 context (static W8A8)
  int M, C, Hd, N, nW;
  int map_h, map_w, ws, roll_h, roll_w;  // map_h == 0: rows in window order, no roll
  float eps;
  // W8A8: int8 weights + per-output-channel scales of proj / FC1 / FC2, and
  // each GEMM's static activation scale (inv > 0) or per-row scales (act =
  // inv = 0)
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

// The MLP half of the block on one 64-row tile and one cluster rank; Q8: the
// static W8A8 form with static activation scales for proj, FC1 and FC2;
// kPart: C % 128 != 0 (mlp_sm90.cuh::stream_tiles).
template <bool Q8, bool kPart>
__global__ void __launch_bounds__(kGemmThreads, 1) block_mlp_kernel(BlockParams p) {
  using Acc = typename std::conditional<Q8, int, float>::type;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = (int)cgm::this_cluster().num_blocks(), rank = (int)cgm::this_cluster().block_rank();
  const int span = p.Hd / S;
  const int row0 = (blockIdx.x / S) * kTileM, rows = min(kTileM, p.M - row0);
  const int R = kTileM / S, r0 = rank * R, live = max(0, min(R, rows - r0));
  const MlpLayout L = mlp_layout(span, (size_t)R * p.C * 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int esize = Q8 ? 1 : 2, C = p.C;
  float* yb = reinterpret_cast<float*>(base + L.rows);  // this rank's rows of y

  if (Q8) {  // this rank's context rows in int8, with the proj input's static scale
    const bf16* cs = reinterpret_cast<const bf16*>(yb);  // staged in the rows' buffer first
    stage_rows(base + L.rows,
               reinterpret_cast<const unsigned char*>(p.ctx + (size_t)(row0 + r0) * C),
               (size_t)C * 2, live, C * 2);
    for (int i = threadIdx.x; i < live * (C / 8); i += kGemmThreads) {
      const int lr = i / (C / 8), pc = i % (C / 8);
      const uint4 raw = *reinterpret_cast<const uint4*>(cs + (size_t)lr * C + pc * 8);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      __align__(8) signed char q8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) q8[e] = quant1(to_f(v[e]), p.act[0], p.inv[0]);
      *reinterpret_cast<uint2*>(p.ctx8 + (size_t)(row0 + r0 + lr) * C + pc * 8) =
          *reinterpret_cast<uint2*>(q8);
    }
    cluster_or_block_sync(S);
  }

  // proj column tiles rank, rank + S, ...: y = x + (ctx Wproj^T + b_proj), f32
  {
    const unsigned char* a = Q8 ? reinterpret_cast<const unsigned char*>(p.ctx8 + (size_t)row0 * C)
                                : reinterpret_cast<const unsigned char*>(p.ctx + (size_t)row0 * C);
    const unsigned char* w = Q8 ? reinterpret_cast<const unsigned char*>(p.wproj8)
                                : reinterpret_cast<const unsigned char*>(p.wproj);
    const size_t ld = (size_t)C * esize;
    const int ntiles = (C + kTileN - 1) / kTileN;
    const int tiles = (ntiles - rank + S - 1) / S;  // tiles rank, rank + S, ...
    Acc acc[64];
    stream_tiles<true, kPart>(
        acc, base + L.ring, a, ld, rows, tiles, w, ld, C,
        [&](int t) { return (rank + t * S) * kTileN; }, C * esize, [&](int t, Acc(&acc)[64]) {
          const int n0 = (rank + t * S) * kTileN;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            if (r >= rows) continue;
            const bf16* xr = p.x + block_row(p, row0 + r, false) * C;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int c = n0 + j * 8 + 2 * tq;
              if (kPart && c >= C) continue;  // past C in the last tile
              float v0 = (float)acc[4 * j + 2 * h], v1 = (float)acc[4 * j + 2 * h + 1];
              if (Q8) {
                v0 = dequant((int)acc[4 * j + 2 * h], p.act[0], p.sproj[c], kQuantStatic);
                v1 = dequant((int)acc[4 * j + 2 * h + 1], p.act[0], p.sproj[c + 1],
                             kQuantStatic);
              }
              const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xr + c);
              *reinterpret_cast<float2*>(p.y + (size_t)(row0 + r) * C + c) =
                  make_float2(to_f(xv.x) + (v0 + to_f(p.bproj[c])),
                              to_f(xv.y) + (v1 + to_f(p.bproj[c + 1])));
            }
          }
        });
  }
  cluster_or_block_sync(S);  // every column of the tile's y is written

  // this rank's rows of y, staged (they are also the residual of the end), and
  // LN1(y) of them in bf16 (Q8: then int8 with FC1's input scale)
  stage_rows(base + L.rows, reinterpret_cast<const unsigned char*>(p.y + (size_t)(row0 + r0) * C),
             (size_t)C * 4, live, C * 4);
  for (int lr = warp; lr < live; lr += kGemmThreads / 32) {
    const float* yr = yb + (size_t)lr * C;
    float v[8][4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pc = lane + 32 * i;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pc < C / 4) f = *reinterpret_cast<const float4*>(yr + pc * 4);
      v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
      s += (f.x + f.y) + (f.z + f.w);
    }
    const float mean = warp_sum(s) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < C / 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) q += (v[i][e] - mean) * (v[i][e] - mean);
      }
    const float rstd = rsqrtf(warp_sum(q) / (float)C + p.eps);
    const size_t zrow = (size_t)(row0 + r0 + lr) * C;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c0 = (lane + 32 * i) * 4;
      if (c0 >= C) continue;
      float zf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        zf[e] = to_f(to_bf((v[i][e] - mean) * rstd * p.ln1_s[c0 + e] + p.ln1_b[c0 + e]));
      if (Q8) {
        char4 q8 = make_char4(quant1(zf[0], p.act[1], p.inv[1]), quant1(zf[1], p.act[1], p.inv[1]),
                              quant1(zf[2], p.act[1], p.inv[1]), quant1(zf[3], p.act[1], p.inv[1]));
        *reinterpret_cast<char4*>(p.z + zrow + c0) = q8;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p.z + (zrow + c0) * 2) =
            __floats2bfloat162_rn(zf[0], zf[1]);
        *reinterpret_cast<__nv_bfloat162*>(p.z + (zrow + c0 + 2) * 2) =
            __floats2bfloat162_rn(zf[2], zf[3]);
      }
    }
  }
  cluster_or_block_sync(S);  // the tile's LN1 rows are in the scratch before FC1 streams them

  MlpTile t{};
  t.a = p.z + (size_t)row0 * C * esize;
  t.lda = (size_t)C * esize;
  t.rows = rows;
  t.w1 = Q8 ? reinterpret_cast<const unsigned char*>(p.w18)
            : reinterpret_cast<const unsigned char*>(p.w1);
  t.b1 = p.b1;
  t.w2 = Q8 ? reinterpret_cast<const unsigned char*>(p.w28)
            : reinterpret_cast<const unsigned char*>(p.w2);
  t.s1 = p.s1;
  t.s2 = p.s2;
  t.sa1 = p.act[1];
  t.sa2 = p.act[2];
  t.inv2 = p.inv[2];
  t.C = C;
  t.Hd = p.Hd;
  t.span = span;
  t.h0 = rank * span;
  mlp_tile<Q8, kPart>(t, base + L.h, base + L.ring, reinterpret_cast<float*>(base + L.red), S, rank,
               [&](int r, int c, const float (&f)[4]) {
                 const float4 y = *reinterpret_cast<const float4*>(yb + (size_t)(r - r0) * C + c);
                 __align__(8) bf16 o[4];
                 o[0] = to_bf(y.x + (f[0] + to_f(p.b2[c])));
                 o[1] = to_bf(y.y + (f[1] + to_f(p.b2[c + 1])));
                 o[2] = to_bf(y.z + (f[2] + to_f(p.b2[c + 2])));
                 o[3] = to_bf(y.w + (f[3] + to_f(p.b2[c + 3])));
                 *reinterpret_cast<uint2*>(p.out + block_row(p, row0 + r, true) * C + c) =
                     *reinterpret_cast<uint2*>(o);
               });
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

// Blocks per row tile of the int8 per-row epilogue: the fewest whose hidden
// slice fits in shared memory, then twice as many up to 8 while the grid stays
// within about four blocks per SM; each rank's output columns a multiple of 8
// and its slice of 32. 0: no fit.
inline int cluster_size_q8(int row_tiles, int C, int Hd, int sms) {
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
// bf16 scratch; scratch 7 M C bytes (M = B nW N: y in f32, LN1(y), the int8
// context), used by block_mlp_kernel. out must not overlap x. quant: null, or
// a QuantArgs (common.cuh) whose w/s are the int8 qkv / proj / FC1 / FC2
// weights and their scales and whose act/inv are the four GEMMs' static
// activation scales (0: per row); the bf16 weight pointers are then unused.
// bf16 and static W8A8 with every scale static take C % 16 == 0 (int8: 32),
// C <= 1024 and Hd that mlp_cluster_size splits; the per-row forms C % 32 ==
// 0 and Hd % 128 == 0 with a slice cluster_size_q8 fits (block_mlp_q8_kernel).
int mmrp_swin_block(const void* x, const void* ln0_s, const void* ln0_b, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, const void* ln1_s,
                    const void* ln1_b, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* bias, void* ctx, void* scratch, void* out, int B,
                    int nW, int N, int C, int heads, int Hd, int map_h, int map_w, int ws,
                    int roll, float eps, const void* quant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantArgs* qa = static_cast<const QuantArgs*>(quant);
  const int qmode = qa ? qa->mode : kQuantOff;
  // the wgmma epilogue: bf16, or static W8A8 whose proj, FC1 and FC2 inputs all have static scales
  const bool wg = qmode == kQuantOff ||
                  (qmode == kQuantStatic && qa->inv[1] > 0.f && qa->inv[2] > 0.f && qa->inv[3] > 0.f);
  if (B < 1 || nW < 1 || heads < 1 || C % heads || C % 16 || Hd % kTileN || qmode < 0 ||
      qmode > kQuantStatic || (qmode && C % 32) || (wg && C > 8 * kTileN))
    return (int)cudaErrorInvalidValue;
  if (map_h && (ws < 1 || map_h % ws || map_w % ws || N != ws * ws ||
                nW != (map_h / ws) * (map_w / ws)))
    return (int)cudaErrorInvalidValue;
  AttnParams a{};
  a.x = static_cast<const bf16*>(x);
  a.ln_s = static_cast<const float*>(ln0_s);
  a.ln_b = static_cast<const float*>(ln0_b);
  a.w = static_cast<const unsigned char*>(qmode ? qa->w[0] : w_qkv);
  a.sw = qmode ? static_cast<const float*>(qa->s[0]) : nullptr;
  a.b = static_cast<const bf16*>(b_qkv);
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
    a.act_s = qa->act[0];
    a.act_inv = qa->inv[0];
  }
  cudaError_t e = launch_attention<true>(a, st);
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
  }
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  p.y = reinterpret_cast<float*>(sc);
  p.z = sc + (size_t)p.M * C * 4;
  p.ctx8 = reinterpret_cast<signed char*>(p.z + (size_t)p.M * C * 2);
  const int rows = wg ? kTileM : kRows, row_tiles = (p.M + rows - 1) / rows;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int S = wg ? mlp_cluster_size(row_tiles, Hd, (size_t)C * 4, sms)
                   : cluster_size_q8(row_tiles, C, Hd, sms);
  if (!S || (wg && !scratch)) return (int)cudaErrorInvalidValue;
  const size_t smem = wg ? mlp_layout(Hd / S, (size_t)(kTileM / S) * C * 4).total
                         : mlp_q8_smem(C, Hd / S).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool part = C % kTileN != 0;
  const void* kernel =
      !wg                  ? (const void*)block_mlp_q8_kernel
      : qmode == kQuantOff ? (part ? (const void*)block_mlp_kernel<false, true>
                                   : (const void*)block_mlp_kernel<false, false>)
                           : (part ? (const void*)block_mlp_kernel<true, true>
                                   : (const void*)block_mlp_kernel<true, false>);
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * S);
  cfg.blockDim = dim3(wg ? kGemmThreads : kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  void* args[] = {&p};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster size of block_mlp_q8_kernel (cluster_size_q8) for row_tiles
// tiles of 16 rows on sms SMs; 0: no fit. The tests hold the Python copy to it.
int mmrp_mlp_q8_cluster(int row_tiles, int C, int Hd, int sms) {
  return cluster_size_q8(row_tiles, C, Hd, sms);
}

}  // extern "C"
