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
// The W8A8 forms run the same kernel in int8: the context and LN1(y)
// quantized as they are written to the scratch, with the calibrated static
// scales of _static_gemm, or (kRow: the dynamic _qdot, or _static_gemm
// without them) with each row's own scale, which the rank that quantizes the
// row keeps in shared memory and every rank of the cluster gathers through
// distributed shared memory before the GEMM that dequantizes with it; the
// hidden activation's row scales are mlp_sm90.cuh's.
#include "attention.cuh"
#include "mlp_sm90.cuh"

namespace mmrp {
// the same anonymous namespace as attention.cuh's: a second one at global
// scope makes the names nvcc generates for the kernel stubs ambiguous
namespace {

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
  signed char* ctx8;   // (M, C) scratch: the int8 context (W8A8)
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

// Every tile row's scale in scale slot `which` of this rank's partial-sum
// tile (mlp_sm90.cuh::scale_slot), each rank having written those of its own
// 64 / S rows there before a cluster barrier: the other ranks' copied in.
__device__ inline void gather_row_scales(float* red, int which, int S, int rank) {
  const int R = kTileM / S;
  if (S > 1)
    for (int r = threadIdx.x; r < kTileM; r += kGemmThreads)
      if (r / R != rank)
        *scale_slot(red, which, r) =
            *scale_slot(cgm::this_cluster().map_shared_rank(red, r / R), which, r);
  __syncthreads();
}

// The MLP half of the block on one 64-row tile and one cluster rank. Q8: the
// W8A8 forms, with the static activation scales of proj, FC1 and FC2, or
// (kRow) per-row scales; kPart: C % 128 != 0 (mlp_sm90.cuh::stream_tiles).
template <bool Q8, bool kRow, bool kPart>
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
  float* red = reinterpret_cast<float*>(base + L.red);  // kRow: the row scales' slots
  constexpr float kZeroRowScale = 1e-8f / 127.f;        // an all-zero row's (rows past M)

  if (Q8) {  // this rank's context rows in int8: proj's static input scale, or each row's
    const bf16* cs = reinterpret_cast<const bf16*>(yb);  // staged in the rows' buffer first
    stage_rows(base + L.rows,
               reinterpret_cast<const unsigned char*>(p.ctx + (size_t)(row0 + r0) * C),
               (size_t)C * 2, live, C * 2);
    auto put8 = [&](int lr, int pc, const uint4& raw, float sx, float inv) {
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      __align__(8) signed char q8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) q8[e] = quant1(to_f(v[e]), sx, inv);
      *reinterpret_cast<uint2*>(p.ctx8 + (size_t)(row0 + r0 + lr) * C + pc * 8) =
          *reinterpret_cast<uint2*>(q8);
    };
    if (!kRow) {  // the static scale: 8 values a thread at a time
      for (int i = threadIdx.x; i < live * (C / 8); i += kGemmThreads) {
        const int lr = i / (C / 8), pc = i % (C / 8);
        put8(lr, pc, *reinterpret_cast<const uint4*>(cs + (size_t)lr * C + pc * 8), p.act[0],
             p.inv[0]);
      }
    }
    for (int lr = warp; kRow && lr < live; lr += kGemmThreads / 32) {  // a row on a warp
      uint4 raw[kMaxRowChunks];
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxRowChunks; ++i) {
        const int pc = lane + 32 * i;
        raw[i] = make_uint4(0u, 0u, 0u, 0u);
        if (pc < C / 8) raw[i] = *reinterpret_cast<const uint4*>(cs + (size_t)lr * C + pc * 8);
        const bf16* v = reinterpret_cast<const bf16*>(&raw[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(to_f(v[e])));
      }
      const float sx = fmaxf(warp_max(m), 1e-8f) / 127.f;
#pragma unroll
      for (int i = 0; i < kMaxRowChunks; ++i)
        if (lane + 32 * i < C / 8) put8(lr, lane + 32 * i, raw[i], sx, 0.f);
      if (lane == 0) *scale_slot(red, 0, r0 + lr) = sx;
    }
    if (kRow)
      for (int lr = live + threadIdx.x; lr < R; lr += kGemmThreads)
        *scale_slot(red, 0, r0 + lr) = kZeroRowScale;
    cluster_or_block_sync(S);
    if (kRow) gather_row_scales(red, 0, S, rank);
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
                const float sx = kRow ? *scale_slot(red, 0, r) : p.act[0];
                const int mode = kRow ? p.qmode : kQuantStatic;
                v0 = dequant((int)acc[4 * j + 2 * h], sx, p.sproj[c], mode);
                v1 = dequant((int)acc[4 * j + 2 * h + 1], sx, p.sproj[c + 1], mode);
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
  // LN1(y) of them in bf16 (Q8: then int8 with FC1's input scale, or the row's)
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
    auto put4 = [&](int i, float sz, float inv) {  // v[i] to the scratch
      const int c0 = (lane + 32 * i) * 4;
      if (Q8) {
        char4 q8 = make_char4(quant1(v[i][0], sz, inv), quant1(v[i][1], sz, inv),
                              quant1(v[i][2], sz, inv), quant1(v[i][3], sz, inv));
        *reinterpret_cast<char4*>(p.z + zrow + c0) = q8;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p.z + (zrow + c0) * 2) =
            __floats2bfloat162_rn(v[i][0], v[i][1]);
        *reinterpret_cast<__nv_bfloat162*>(p.z + (zrow + c0 + 2) * 2) =
            __floats2bfloat162_rn(v[i][2], v[i][3]);
      }
    };
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c0 = (lane + 32 * i) * 4;
      if (c0 >= C) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[i][e] = to_f(to_bf((v[i][e] - mean) * rstd * p.ln1_s[c0 + e] + p.ln1_b[c0 + e]));
        m = fmaxf(m, fabsf(v[i][e]));
      }
      if (!kRow) put4(i, p.act[1], p.inv[1]);  // a static scale: stored as it is made
    }
    // kRow: the row's scale, then the row
    const float sz = kRow ? fmaxf(warp_max(m), 1e-8f) / 127.f : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (kRow && (lane + 32 * i) * 4 < C) put4(i, sz, 0.f);
    if (kRow && lane == 0) *scale_slot(red, 1, r0 + lr) = sz;
  }
  if (kRow)
    for (int lr = live + threadIdx.x; lr < R; lr += kGemmThreads)
      *scale_slot(red, 1, r0 + lr) = kZeroRowScale;
  cluster_or_block_sync(S);  // the tile's LN1 rows are in the scratch before FC1 streams them
  if (kRow) gather_row_scales(red, 1, S, rank);

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
  t.qmode = p.qmode;
  t.C = C;
  t.Hd = p.Hd;
  t.span = span;
  t.h0 = rank * span;
  mlp_tile<Q8, kRow, kPart>(t, base + L.h, base + L.ring, red, S, rank,
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
// activation scales (0: per row; proj, FC1 and FC2 all static or all per
// row); the bf16 weight pointers are then unused. C % 16 == 0 (int8: 32),
// C <= 1024 and Hd that mlp_cluster_size splits.
int mmrp_swin_block(const void* x, const void* ln0_s, const void* ln0_b, const void* w_qkv,
                    const void* b_qkv, const void* w_proj, const void* b_proj, const void* ln1_s,
                    const void* ln1_b, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* bias, void* ctx, void* scratch, void* out, int B,
                    int nW, int N, int C, int heads, int Hd, int map_h, int map_w, int ws,
                    int roll, float eps, const void* quant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantArgs* qa = static_cast<const QuantArgs*>(quant);
  const int qmode = qa ? qa->mode : kQuantOff;
  // the MLP launch's form: bf16, W8A8 with the static scales of proj, FC1 and
  // FC2, or W8A8 with per-row scales (the dynamic form, or static ones without)
  const int statics = qmode == kQuantStatic
                          ? (qa->inv[1] > 0.f) + (qa->inv[2] > 0.f) + (qa->inv[3] > 0.f) : 0;
  const int form = qmode == kQuantOff ? 0 : statics == 3 ? 1 : 2;
  if (B < 1 || nW < 1 || heads < 1 || C % heads || C % 16 || Hd % kTileN || qmode < 0 ||
      qmode > kQuantStatic || (qmode && C % 32) || C > 8 * kTileN || statics % 3 || !scratch)
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
  const int row_tiles = (p.M + kTileM - 1) / kTileM;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int S = mlp_cluster_size(row_tiles, Hd, (size_t)C * 4, sms);
  if (!S) return (int)cudaErrorInvalidValue;
  const size_t smem = mlp_layout(Hd / S, (size_t)(kTileM / S) * C * 4).total;
  const void* const kernels[3][2] = {
      {(const void*)block_mlp_kernel<false, false, false>,
       (const void*)block_mlp_kernel<false, false, true>},
      {(const void*)block_mlp_kernel<true, false, false>,
       (const void*)block_mlp_kernel<true, false, true>},
      {(const void*)block_mlp_kernel<true, true, false>,
       (const void*)block_mlp_kernel<true, true, true>}};
  const void* kernel = kernels[form][C % kTileN != 0];
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * S);
  cfg.blockDim = dim3(kGemmThreads);
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

}  // extern "C"
