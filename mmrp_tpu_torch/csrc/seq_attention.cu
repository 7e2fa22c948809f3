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
// attentions (post, cross kv) and the self-attention (pre + pos), at any
// token count up to the model's 512 positions.
//
// What bounds it on the H100: the four C x C projections (8 C^2 FLOPs per
// token, C = 768 / 1024) against 4 Nk C FLOPs per token of attention: the
// tensor cores at every text length. The TPU kernel kept a sequence's rows,
// q/k/v and scores in VMEM; a block's 227 KB holds neither a 512-token
// sequence's q/k/v nor its 512 x 512 scores, so the work is three launches
// whose intermediates (q/k/v and the context, bf16) stay in L2 at serving
// sizes:
//   qkv_kernel   per 64 rows and 1-4 tiles of 128 output columns: the rows
//                staged once in shared memory (x + pos, LayerNorm'ed for
//                "pre"; for W8A8 quantized per row there), each tile's weight
//                rows streamed through a cp.async ring into wgmma
//                (gemm_sm90.cuh); + bias in f32, rounded to bf16, written
//                head-major (B, heads, N, d);
//   attn_kernel  per (64 queries, head, sequence): attn_tile.cuh, key tiles
//                of 64 double-buffered by cp.async, online softmax in
//                registers; the context written (B * Nq, C), bf16;
//   out_kernel   per 64 rows x 128 columns of the output projection, on the
//                same GEMM: + bias, * alpha, + residual in f32, and for
//                "post" the LayerNorm, whose row statistics a cluster of
//                C / 128 blocks (one per column slice) sums through
//                distributed shared memory; rounded to bf16 once.
// W8A8 (quant->mode == kQuantDyn, the JAX quant=True): the four projections
// take int8 weights per output channel (quantized once per weight by the
// caller, the numbers the TPU kernel's per-program quantization gives) and
// quantize their bf16 inputs per row as they are staged; the products are
// wgmma s8 with s32 sums, dequantized as acc * sx * sw in f32 (_qdot's
// order), then the bias. The attention tile is the bf16 one.
//
// The packed form (mmrp_seq_attention_packed, bf16 only; template R): a
// side's sequences lie back to back in its rows, sequence b in rows
// off[b] .. off[b + 1] - 1 of an int32 (B + 1) offset table, so a batch of
// reports runs its valid tokens and no padding. A side without a table is
// regular: b * N .. (b + 1) * N - 1. The two GEMM launches are row-wise and
// change only where a row reads its position (pos[qpos[row]]) and where it
// writes q/k/v (head-major over the rows, (heads, M, D)); the attention
// launch walks (64-query tile, head, sequence) over the sequence's own rows
// and its own key tiles, so it needs no key mask: a padded row's exact-zero
// softmax weight is a row that is not there. A valid row's numbers are the
// padded form's: no GEMM row depends on another row.
#include <cooperative_groups.h>

#include <type_traits>

#include "attn_tile.cuh"
#include "gemm_sm90.cuh"

namespace cg = cooperative_groups;

namespace mmrp {
namespace {

enum EpiMode { kProjOnly = 0, kResidualBase = 1, kResidualRaw = 2, kPostLN = 3 };
constexpr int kMaxTokens = 512;

struct QkvParams {
  const bf16* x;       // (Mq, C): B * Nq rows, or packed
  const bf16* kv;      // (Mk, C) or null: k and v from x
  const bf16* pos;     // (Nq, C) or null
  const int* qpos;     // packed: (Mq,) each x row's position in its sequence, or null
  const float* ln_s;   // (C,) pre-LN, read when ln_pre
  const float* ln_b;
  const unsigned char* w[3];  // q, k, v weights (C, C): bf16, or int8 (the Q8 kernel)
  const float* sw[3];         // int8 per-output-channel scales
  const bf16* b[3];           // (C,) biases
  bf16* dst[3];               // q (B, heads, Nq, d), k and v (B, heads, Nk, d); packed (heads, M, d)
  int B, Nq, Nk, Mq, Mk, C, heads, ln_pre;
  int jobs0, groups0, groups1;  // x-side blocks; column groups of the x side and of kv
  int tiles0, tiles1, per;      // column tiles of each side; tiles a group walks
  float eps;
};

// One block per (64 rows, a group of up to p.per 128-column tiles of q | k |
// v): the rows are staged once and the group's tiles walked over them.
template <bool Q8, bool R>
__global__ void __launch_bounds__(kGemmThreads) qkv_kernel(QkvParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* a = align1024(smem_raw);
  const int esize = Q8 ? 1 : 2, kchunks = p.C * esize / 128;
  unsigned char* ring = a + (size_t)p.C * 2 / 128 * kChunkA;
  float* rs = reinterpret_cast<float*>(ring + kStages * kChunkW);

  int job = blockIdx.x, tile0, tiles, M;
  const bool xside = job < p.jobs0;
  if (xside) {
    tile0 = (job % p.groups0) * p.per;
    tiles = p.tiles0;
    job /= p.groups0;
    M = p.Mq;
  } else {
    job -= p.jobs0;
    tile0 = (job % p.groups1) * p.per;
    tiles = p.tiles1;
    job /= p.groups1;
    M = p.Mk;
  }
  const int tile_end = min(tiles, tile0 + p.per);
  const int col_base = xside ? 0 : p.C;  // kv's tiles are k's and v's columns
  const int row0 = job * kTileM;
  const size_t ldw = (size_t)p.C * esize;
  auto weights = [&](int tile) {
    const int col0 = col_base + tile * kTileN;
    return p.w[col0 / p.C] + (size_t)(col0 % p.C) * ldw;
  };

  const int rows = min(kTileM, M - row0);
  const bf16* src = xside ? p.x : p.kv;
  stage_a<Q8>(
      a, ring, rs, rows, p.C, [&](int r) { return src + (size_t)(row0 + r) * p.C; },
      [&](int r) {
        const int row = row0 + r;
        return p.pos + (size_t)(R && p.qpos ? p.qpos[row] : row % p.Nq) * p.C;
      },
      xside && p.pos,
      p.ln_s, p.ln_b, p.eps, xside && p.ln_pre, weights(tile0), ldw, kchunks);

  using Acc = typename std::conditional<Q8, int, float>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int D = p.C / p.heads;
  for (int tile = tile0; tile < tile_end; ++tile) {
    const int col0 = col_base + tile * kTileN, which = col0 / p.C, n0 = col0 % p.C;
    const unsigned char* w = weights(tile);
    if (tile > tile0) gemm_prologue(smem_u32(ring), w, ldw, kchunks);
    Acc acc[64];
    gemm_mainloop(acc, smem_u32(a), smem_u32(ring), w, ldw, kchunks);
    const int N = which ? p.Nk : p.Nq;
    const bf16* bias = p.b[which];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = warp * 16 + g + 8 * h, r = row0 + rl;
      if (r >= M) continue;
      // head-major over the rows: (B, heads, N, D), or (heads, M, D) packed
      const size_t base = R ? (size_t)r * D : ((size_t)(r / N) * p.heads * N + r % N) * D;
      const size_t head_stride = R ? (size_t)M * D : (size_t)N * D;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = n0 + j * 8 + 2 * t, head = c / D, d = c % D;
        float v0, v1;
        if (Q8) {
          v0 = dequant((int)acc[4 * j + 2 * h], rs[rl], p.sw[which][c], kQuantDyn);
          v1 = dequant((int)acc[4 * j + 2 * h + 1], rs[rl], p.sw[which][c + 1], kQuantDyn);
        } else {
          v0 = (float)acc[4 * j + 2 * h];
          v1 = (float)acc[4 * j + 2 * h + 1];
        }
        v0 += to_f(bias[c]);
        v1 += to_f(bias[c + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p.dst[which] + base + head * head_stride + d) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

struct AttnTileParams {
  const bf16* q;         // (B, heads, Nq, D); packed (heads, Mq, D)
  const bf16* k;         // (B, heads, Nk, D); packed (heads, Mk, D)
  const bf16* v;
  const float* key_mask; // (B, Nk) additive, or null
  const int* q_off;      // packed: (B + 1) row offsets of the queries' sequences, or null
  const int* k_off;      // packed: the same of the keys'
  bf16* ctx;             // (B * Nq, C) or packed (Mq, C), head h in columns [h D, h D + D)
  int heads, Nq, Nk, Mq, Mk, C;
  float scale;
};

// One block per (64 queries, head, sequence); key tiles double-buffered.
// Packed (R): Nq / Nk are a side's longest sequence, or its regular length
// where it has no offsets; a tile past its sequence's queries returns.
template <int D, bool R>
__global__ void __launch_bounds__(128) attn_kernel(AttnTileParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = TileLd<D>;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kbuf = reinterpret_cast<bf16*>(smem + L::kBytes);
  bf16* vbuf = reinterpret_cast<bf16*>(smem + 3 * L::kBytes);
  constexpr int kTileElems = kTileRows * L::kLd;
  const int q0 = blockIdx.x * kTileRows, head = blockIdx.y, b = blockIdx.z;
  int nq = p.Nq, nk = p.Nk;
  size_t qrow, krow;  // the sequence's first query and key row
  const bf16 *qg, *kg, *vg;
  if (R) {
    qrow = p.q_off ? p.q_off[b] : (size_t)b * p.Nq;
    krow = p.k_off ? p.k_off[b] : (size_t)b * p.Nk;
    if (p.q_off) nq = p.q_off[b + 1] - (int)qrow;
    if (p.k_off) nk = p.k_off[b + 1] - (int)krow;
    if (q0 >= nq) return;
    qg = p.q + ((size_t)head * p.Mq + qrow + q0) * D;
    kg = p.k + ((size_t)head * p.Mk + krow) * D;
    vg = p.v + ((size_t)head * p.Mk + krow) * D;
  } else {
    const size_t bh = (size_t)b * p.heads + head;
    qrow = (size_t)b * p.Nq;
    qg = p.q + (bh * p.Nq + q0) * D;
    kg = p.k + bh * p.Nk * D;
    vg = p.v + bh * p.Nk * D;
  }
  const float* mrow = !R && p.key_mask ? p.key_mask + (size_t)b * p.Nk : nullptr;
  const int tiles = (nk + kTileRows - 1) / kTileRows;

  auto load_kv = [&](int j) {
    const int k0 = j * kTileRows, n = min(kTileRows, nk - k0);
    tile_rows_async<D>(kbuf + (j & 1) * kTileElems, n,
                       [&](int r) { return kg + (size_t)(k0 + r) * D; });
    tile_rows_async<D>(vbuf + (j & 1) * kTileElems, n,
                       [&](int r) { return vg + (size_t)(k0 + r) * D; });
  };
  tile_rows_async<D>(qs, min(kTileRows, nq - q0), [&](int r) { return qg + (size_t)r * D; });
  load_kv(0);
  cp_async_commit();

  TileState<D> st;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_kv(j + 1);  // into the buffer that tile j - 1 freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) tile_begin(st, qs);
    tile_step(st, kbuf + (j & 1) * kTileElems, vbuf + (j & 1) * kTileElems, j * kTileRows, nk,
              p.scale, [&](int, int key) { return mrow ? mrow[key] : 0.f; });
    __syncthreads();
  }
  tile_finish(st, [&](int r, int c, float v0, float v1) {
    if (q0 + r < nq)
      *reinterpret_cast<__nv_bfloat162*>(p.ctx + (qrow + q0 + r) * p.C + head * D + c) =
          __floats2bfloat162_rn(v0, v1);
  });
}

struct OutParams {
  const bf16* ctx;     // (M, C)
  const unsigned char* wo;  // (C, C): bf16, or int8 (the Q8 kernel)
  const float* swo;
  const bf16* bo;      // (C,)
  const bf16* x;       // (M, C) residual source
  const bf16* pos;     // (Nq, C) or null: base = x + pos[r % Nq], packed pos[qpos[r]]
  const int* qpos;     // packed: (M,) each row's position in its sequence, or null
  const float* alpha;  // device scalar, or null
  const float* ln_s;   // (C,) post-LN
  const float* ln_b;
  bf16* out;           // (M, C)
  int M, C, Nq, mode;
  float eps;
};

// One block per (128 output columns, 64 rows); for kPostLN the C / 128
// column blocks of a row block form a cluster.
template <bool Q8, bool R>
__global__ void __launch_bounds__(kGemmThreads) out_kernel(OutParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* a = align1024(smem_raw);
  const int esize = Q8 ? 1 : 2, kchunks = p.C * esize / 128;
  unsigned char* ring = a + (size_t)p.C * 2 / 128 * kChunkA;
  float* rs = reinterpret_cast<float*>(ring + kStages * kChunkW);
  float* red = rs + kTileM;  // [2][64] per-row partial sums of this column slice

  const int n0 = blockIdx.x * kTileN, row0 = blockIdx.y * kTileM;
  const size_t ldw = (size_t)p.C * esize;
  const unsigned char* w = p.wo + (size_t)n0 * ldw;
  stage_a<Q8>(
      a, ring, rs, min(kTileM, p.M - row0), p.C,
      [&](int r) { return p.ctx + (size_t)(row0 + r) * p.C; },
      [](int) -> const bf16* { return nullptr; }, false, nullptr, nullptr, 0.f, false, w, ldw,
      kchunks);
  using Acc = typename std::conditional<Q8, int, float>::type;
  Acc acc[64];
  gemm_mainloop(acc, smem_u32(a), smem_u32(ring), w, ldw, kchunks);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float alpha = p.alpha ? *p.alpha : 1.f;
  float y[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = warp * 16 + g + 8 * h, r = row0 + rl;
    const bool live = r < p.M;
    const bf16* xr = p.x + (size_t)(live ? r : 0) * p.C;
    const int rr = live ? r : 0;
    const bf16* pr = p.pos ? p.pos + (size_t)(R && p.qpos ? p.qpos[rr] : rr % p.Nq) * p.C
                           : nullptr;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + j * 8 + 2 * t + e;
        float v = Q8 ? dequant((int)acc[4 * j + 2 * h + e], rs[rl], p.swo[c], kQuantDyn)
                     : (float)acc[4 * j + 2 * h + e];
        v = (v + to_f(p.bo[c])) * alpha;
        if (live) {
          const float raw = to_f(xr[c]);
          if (p.mode == kResidualBase || p.mode == kPostLN) {
            v = (pr ? raw + to_f(pr[c]) : raw) + v;
          } else if (p.mode == kResidualRaw) {
            v = raw + v;
          }
        } else {
          v = 0.f;
        }
        y[h][2 * j + e] = v;
      }
    }
  }

  if (p.mode == kPostLN) {
    // row statistics over all C columns: each block sums its 128, the quad
    // of lanes holding a row reduces them, and the cluster's blocks add
    // their partial sums through distributed shared memory (two passes)
    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks();
    float mean[2], rstd[2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float v = pass ? y[h][i] - mean[h] : y[h][i];
          s += pass ? v * v : v;
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) red[pass * kTileM + warp * 16 + g + 8 * h] = s;
      }
      cluster.sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = pass * kTileM + warp * 16 + g + 8 * h;
        float s = 0.f;
        for (int q = 0; q < S; ++q) s += cluster.map_shared_rank(red, q)[rl];
        if (pass)
          rstd[h] = rsqrtf(s / (float)p.C + p.eps);
        else
          mean[h] = s / (float)p.C;
      }
    }
    cluster.sync();  // no block leaves while another still reads its shared memory
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = n0 + (i >> 1) * 8 + 2 * t + (i & 1);
        y[h][i] = (y[h][i] - mean[h]) * rstd[h] * p.ln_s[c] + p.ln_b[c];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + g + 8 * h;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)r * p.C + n0 + j * 8 + 2 * t) =
          __floats2bfloat162_rn(y[h][2 * j], y[h][2 * j + 1]);
  }
}

template <int D, bool R>
cudaError_t launch_attn(const AttnTileParams& p, int B, cudaStream_t st) {
  const size_t smem = 5 * TileLd<D>::kBytes;
  cudaError_t e = allow_smem(attn_kernel<D, R>, smem);
  if (e != cudaSuccess) return e;
  attn_kernel<D, R><<<dim3((p.Nq + kTileRows - 1) / kTileRows, p.heads, B), 128, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool Q8, bool R>
cudaError_t launch_proj(const QkvParams& q, int blocks, cudaStream_t st) {
  const size_t smem = gemm_smem(q.C, 0);
  cudaError_t e = allow_smem(qkv_kernel<Q8, R>, smem);
  if (e != cudaSuccess) return e;
  qkv_kernel<Q8, R><<<blocks, kGemmThreads, smem, st>>>(q);
  return cudaGetLastError();
}

template <bool Q8, bool R>
cudaError_t launch_out(const OutParams& o, cudaStream_t st) {
  const size_t smem = gemm_smem(o.C, 2 * kTileM * sizeof(float));
  cudaError_t e = allow_smem(out_kernel<Q8, R>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(o.C / kTileN, (o.M + kTileM - 1) / kTileM);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = o.mode == kPostLN ? o.C / kTileN : 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, out_kernel<Q8, R>, o);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The three launches of one call, padded (R false: B sequences of Nq query
// and Nk key rows) or packed (R true: Mq query and Mk key rows, a side's
// sequences by its offsets, Nq / Nk its longest; bf16 only).
template <bool R>
int seq_attention(const void* x, const void* kv, const void* key_mask, const void* pos,
                  const void* alpha, const void* ln_s, const void* ln_b, const void* wq,
                  const void* bq, const void* wk, const void* bk, const void* wv,
                  const void* bv, const void* wo, const void* bo, void* qkv, void* ctx,
                  void* out, const void* q_off, const void* k_off, const void* qpos, int B,
                  int Mq, int Mk, int Nq, int Nk, int C, int heads, int ln_mode,
                  int include_residual, int residual_from_raw, float eps, const void* quant,
                  cudaStream_t st) {
  const int D = heads > 0 ? C / heads : 0;
  if (B < 1 || heads < 1 || C % heads || C % kTileN || C > 8 * kTileN || ln_mode < 0 ||
      ln_mode > 2 || Nq < 1 || Nq > kMaxTokens || Nk < 1 || Nk > kMaxTokens || Mq < 1 ||
      Mk < 1 || (!kv && Mk != Mq) || (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const QuantArgs* qa = static_cast<const QuantArgs*>(quant);
  if (qa && qa->mode != kQuantOff && qa->mode != kQuantDyn) return (int)cudaErrorInvalidValue;
  const bool q8 = qa && qa->mode == kQuantDyn;

  QkvParams q{};
  q.x = static_cast<const bf16*>(x);
  q.kv = static_cast<const bf16*>(kv);
  q.pos = static_cast<const bf16*>(pos);
  q.qpos = static_cast<const int*>(qpos);
  q.ln_s = static_cast<const float*>(ln_s);
  q.ln_b = static_cast<const float*>(ln_b);
  const void* w3[3] = {wq, wk, wv};
  const void* b3[3] = {bq, bk, bv};
  for (int i = 0; i < 3; ++i) {
    q.w[i] = static_cast<const unsigned char*>(q8 ? qa->w[i] : w3[i]);
    q.sw[i] = q8 ? static_cast<const float*>(qa->s[i]) : nullptr;
    q.b[i] = static_cast<const bf16*>(b3[i]);
  }
  bf16* scratch = static_cast<bf16*>(qkv);
  q.dst[0] = scratch;
  q.dst[1] = scratch + (size_t)Mq * C;
  q.dst[2] = q.dst[1] + (size_t)Mk * C;
  q.B = B, q.Nq = Nq, q.Nk = Nk, q.Mq = Mq, q.Mk = Mk, q.C = C, q.heads = heads;
  q.ln_pre = ln_mode == 1;
  q.eps = eps;
  // column tiles per block: one while the blocks are few, more (reusing the
  // staged rows) once there are over two waves of 132 SMs at one tile each
  const int tiles = C / kTileN, rb0 = (Mq + kTileM - 1) / kTileM;
  const int rb1 = kv ? (Mk + kTileM - 1) / kTileM : 0;
  q.tiles0 = kv ? tiles : 3 * tiles;
  q.tiles1 = 2 * tiles;
  q.per = max(1, min(4, (rb0 * q.tiles0 + rb1 * q.tiles1) / 264));
  q.groups0 = (q.tiles0 + q.per - 1) / q.per;
  q.groups1 = (q.tiles1 + q.per - 1) / q.per;
  q.jobs0 = rb0 * q.groups0;
  const int jobs = q.jobs0 + rb1 * q.groups1;

  OutParams o{};
  o.ctx = static_cast<const bf16*>(ctx);
  o.wo = static_cast<const unsigned char*>(q8 ? qa->w[3] : wo);
  o.swo = q8 ? static_cast<const float*>(qa->s[3]) : nullptr;
  o.bo = static_cast<const bf16*>(bo);
  o.x = q.x;
  o.pos = q.pos;
  o.qpos = q.qpos;
  o.alpha = static_cast<const float*>(alpha);
  o.ln_s = q.ln_s;
  o.ln_b = q.ln_b;
  o.out = static_cast<bf16*>(out);
  o.M = Mq;
  o.C = C;
  o.Nq = Nq;
  o.eps = eps;
  o.mode = ln_mode == 2          ? kPostLN
           : !include_residual   ? kProjOnly
           : residual_from_raw   ? kResidualRaw
                                 : kResidualBase;

  cudaError_t e;
  if constexpr (R) {
    e = launch_proj<false, true>(q, jobs, st);
  } else {
    e = q8 ? launch_proj<true, false>(q, jobs, st) : launch_proj<false, false>(q, jobs, st);
  }
  if (e != cudaSuccess) return (int)e;

  AttnTileParams t{};
  t.q = q.dst[0];
  t.k = q.dst[1];
  t.v = q.dst[2];
  t.key_mask = static_cast<const float*>(key_mask);
  t.q_off = static_cast<const int*>(q_off);
  t.k_off = static_cast<const int*>(k_off);
  t.ctx = static_cast<bf16*>(ctx);
  t.heads = heads, t.Nq = Nq, t.Nk = Nk, t.Mq = Mq, t.Mk = Mk, t.C = C;
  t.scale = (float)(1.0 / sqrt((double)D));
  switch (D) {
    case 32: e = launch_attn<32, R>(t, B, st); break;
    case 64: e = launch_attn<64, R>(t, B, st); break;
    default: e = launch_attn<128, R>(t, B, st); break;
  }
  if (e != cudaSuccess) return (int)e;
  if constexpr (R) {
    e = launch_out<false, true>(o, st);
  } else {
    e = q8 ? launch_out<true, false>(o, st) : launch_out<false, false>(o, st);
  }
  return (int)e;
}

}  // namespace
}  // namespace mmrp

using namespace mmrp;

extern "C" {

// x (B, Nq, C) bf16; kv (B, Nk, C) or null; key_mask (B, Nk) f32 or null;
// pos (Nq, C) or null; alpha f32 scalar or null; ln (C) f32; w* (C, C) bf16
// nn.Linear weights, b* (C); qkv a bf16 scratch of B (Nq + 2 Nk) C elements
// (q, then k, then v, head-major); ctx a (B Nq, C) bf16 scratch; out like x.
// ln_mode: 0 none, 1 pre, 2 post. quant: null, or a QuantArgs (common.cuh)
// whose w/s are the int8 wq, wk, wv, wo and their scales (the bf16 weight
// pointers are then unused). C % 128 == 0, C <= 1024, head dim 32 / 64 /
// 128, 1 <= Nq, Nk <= 512.
int mmrp_seq_attention(const void* x, const void* kv, const void* key_mask, const void* pos,
                       const void* alpha, const void* ln_s, const void* ln_b, const void* wq,
                       const void* bq, const void* wk, const void* bk, const void* wv,
                       const void* bv, const void* wo, const void* bo, void* qkv, void* ctx,
                       void* out, int B, int Nq, int Nk, int C, int heads, int ln_mode,
                       int include_residual, int residual_from_raw, float eps,
                       const void* quant, void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1) return (int)cudaErrorInvalidValue;
  return seq_attention<false>(x, kv, key_mask, pos, alpha, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo,
                              bo, qkv, ctx, out, nullptr, nullptr, nullptr, B, B * Nq, B * Nk,
                              Nq, Nk, C, heads, ln_mode, include_residual, residual_from_raw,
                              eps, quant, static_cast<cudaStream_t>(stream));
}

// The packed form, bf16: x (Mq, C), the B query sequences back to back by
// the int32 (B + 1) offsets q_off, or B * Nq regular rows where q_off is
// null; kv (Mk, C) likewise by k_off, or null (k and v from x: k_off is
// q_off, Mk = Mq). Nq / Nk: a side's longest sequence (1 to 512), or its
// regular length. qpos (Mq,) int32: each x row's position in its sequence,
// the row of pos (Nq, C) it adds, or null (row % Nq). No key mask: a
// sequence's keys are its own rows. qkv a bf16 scratch of (Mq + 2 Mk) C
// elements, ctx (Mq, C), out like x.
int mmrp_seq_attention_packed(const void* x, const void* kv, const void* pos, const void* alpha,
                              const void* ln_s, const void* ln_b, const void* wq, const void* bq,
                              const void* wk, const void* bk, const void* wv, const void* bv,
                              const void* wo, const void* bo, void* qkv, void* ctx, void* out,
                              const void* q_off, const void* k_off, const void* qpos, int B,
                              int Mq, int Mk, int Nq, int Nk, int C, int heads, int ln_mode,
                              int include_residual, int residual_from_raw, float eps,
                              void* stream) {
  return seq_attention<true>(x, kv, nullptr, pos, alpha, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo,
                             bo, qkv, ctx, out, q_off, k_off, qpos, B, Mq, Mk, Nq, Nk, C, heads,
                             ln_mode, include_residual, residual_from_raw, eps, nullptr,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
