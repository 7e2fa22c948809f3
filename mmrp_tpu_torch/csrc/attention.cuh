// The attention half of the Swin block for Hopper (sm_90a), on warpgroup MMA:
// K1 (window_attention.cu) and the whole-block kernel (swin_block.cu).
//
// Replaces the attention half of the TPU kernels (pallas_call lines)
//   mmrp_tpu/ops/fused_window_attention.py:152  (_kernel, :40)
//   mmrp_tpu/ops/fused_swin_block.py:435, :484  (_block_body, :144)
//   mmrp_tpu/ops/fused_swin_pair.py:197, :384
// which compute, per ws x ws window of the (pre-rolled) map,
//   ctx = softmax(q k^T * d^-1/2 + bias_full) v,  q/k/v = LN0(x) W_qkv + b_qkv
// with q, k, v, p and ctx rounded to bf16 (the W8A8 forms: the qkv GEMM on
// int8 LN0 rows and int8 weights), and K1's projection out = [x +] ctx W_o^T + b_o.
//
// What bounds it on the H100: the qkv GEMM, 6 C^2 FLOPs per token against
// 196 C for the 49 x 49 scores and P.V; at Swin-B's 2/2/18/2 blocks (C 128 ..
// 1024) about 8 GFLOP per image: the tensor cores, as long as each weight byte
// brought from L2 serves enough rows (a 64-row window tile: 64 FLOPs a byte).
// Measured (PERF.md), the weight stream is not what limits it: with one
// warpgroup an SM, each block's LayerNorm, epilogues and per-head softmax run
// as latency-bound chains beside nothing else, so the design shortens and
// overlaps those chains: several LayerNorm rows a warp at once (ln_rows), the
// affine loaded once a warp, a tile's bias before its products, the additive
// terms before the scores, and two blocks an SM where they fit. Two launches:
//   window_attn_wgmma  one block (one warpgroup) per window and split of its
//     head groups:
//     - the window's rows (N <= 64; in window order, or gathered from the map
//       by map_row) are staged once by cp.async in gemm_sm90.cuh's
//       128-byte-swizzled K-major layout, LayerNorm'ed in place once per
//       block (ln_rows), and for W8A8 quantized there (a static scale, or
//       per-row scales into rs); pad rows are zero and never stored;
//     - per head group (128 columns: 4 heads of 32, 2 of 64 or 1 of 128) the
//       group's rows of W_k, W_v and W_q stream through a cp.async ring (3
//       slots of 16 KB; up to 8 measured no faster) into wgmma m64n128k16
//       (bf16) or m64n128k32 (s8, dequantized as common.cuh's dequant), one
//       pipeline over all the tiles of the block, so the next tile's weights
//       load while a tile's epilogue and the group's attention run;
//     - the k and v sums get their bias in registers and go to bf16 64 x
//       (D + 8) tiles in attn_tile.cuh's layout; the q sums stay in registers,
//       rounded to bf16 and packed as the mma.sync A fragments the attention
//       tile multiplies (row 16 w + l / 4 [+ 8] of a wgmma accumulator is the
//       same row of warp w's fragment);
//     - each head runs attn_tile.cuh's tile on one key tile (N <= 64) with
//       bias_full[g % nW, head] as the additive term and keys >= N excluded,
//       p normalized before P.V and rounded to bf16 as the plain version
//       rounds it, and its context goes straight to the head's columns of ctx.
//     The host splits a window's head groups over the fewest blocks that give
//     windows x splits >= the SM count (attn_splits), each block a contiguous
//     range of groups: the rows are staged and LayerNorm'ed once per split,
//     not once per head.
//   k1_proj_wgmma  K1's projection per 64 rows x 128 output columns on
//     mlp_sm90.cuh's streamed wgmma (the context rows and W_o together
//     through one ring); bias and residual added in f32 and rounded once.
// C need not be a multiple of 128 (Swin-T / S stages 1-2: 96, 192; C 64):
// with kPart the last K chunk is zero past C and the last head group holds
// fewer heads. Shared memory (attn_layout): the staged rows (64 x C bf16,
// 128 KB at C = 1024), the ring, one group's k and v tiles (34-40 KB) and 64
// row scales; at C <= 192 two blocks fit an SM, so one block's LayerNorm,
// epilogues and attention overlap the other's products (measured: 1.7x).
#pragma once

#include <type_traits>

#include "attn_tile.cuh"
#include "mlp_sm90.cuh"

namespace mmrp {
namespace {  // internal linkage: each translation unit instantiates its own copy

constexpr int kAttnSlots = 3;  // weight chunks in the ring, one in flight ahead
constexpr int kLnPieces = 4;  // pieces of 8 a lane holds of a LayerNorm row (ln_rows)
constexpr int kAttnMaxC = 32 * 8 * kLnPieces;  // a row on one warp: 1024

struct AttnParams {
  const bf16* x;            // (G * N, C) rows, or the (B, map_h, map_w, C) map
  const float* ln_s;        // (C,) pre-LN affine
  const float* ln_b;
  const unsigned char* w;   // (3C, C) W_qkv rows [q | k | v]: bf16, or int8 (qmode)
  const float* sw;          // int8: (3C,) per-output-channel scales
  const bf16* b;            // (3C,) b_qkv
  const float* bias;        // (nW, heads, N, N) additive, window = g % nW
  bf16* ctx;                // (G * N, C): head h writes columns [h D, h D + D)
  int G, N, C, heads, nW, splits;
  float scale, eps;
  int map_h, map_w, ws;     // map_h > 0: rows gathered from the map
  // W8A8 (qmode != kQuantOff): the staged rows are quantized with the static
  // scale act_s (act_inv = f32(1 / act_s) > 0) or per row
  int qmode;
  float act_s, act_inv;
};

// Dynamic shared memory of window_attn_wgmma from its 1024-aligned base: the
// staged rows (64 x C bf16 in 8 KB chunks, the int8 form in their first
// bytes), the ring of weight chunks, the k and v tiles of one head group
// (64 x (D + 8) bf16 per head), the 64 row scales, and the base's alignment:
// 108 KB at C 128 (two blocks an SM), 222 KB at C 1024.
// ops/fused_window_attention.py::attention_smem is its copy.
struct AttnLayout {
  size_t ring, kv, rs, total;
};
__host__ __device__ inline AttnLayout attn_layout(int C, int D) {
  AttnLayout L;
  L.ring = (size_t)((C * 2 + 127) / 128) * kChunkA;
  L.kv = L.ring + (size_t)kAttnSlots * kChunkW;
  L.rs = L.kv + (size_t)2 * (kTileN / D) * kTileM * (D + 8) * sizeof(bf16);
  L.total = L.rs + kTileM * sizeof(float) + 1024;
  return L;
}
// Blocks per window: the fewest splits of the C / 128 head groups with
// windows x splits >= sms, at most one per group.
__host__ __device__ inline int attn_splits(int windows, int C, int sms) {
  const int groups = (C + kTileN - 1) / kTileN;
  int s = 1;
  while (s < groups && (long long)windows * s < sms) ++s;
  return s;
}

// LN0 of the staged rows in place [then int8, with the static scale or per
// row into rs]. A row is held by L lanes, the fewest (a power of two) with at
// most kLnPieces pieces of 8 each, so a warp normalizes 32 / L rows at once (8
// at C 128, 1 at C 1024) and their latency-bound chains overlap: each row's
// statistics reduce over its own lanes (two passes in f32), the affine is
// loaded once a warp. As gemm_sm90.cuh::transform_row, the int8 row keeps the
// bf16 row's footprint, so the row's lanes read it whole before any writes.
template <bool Q8>
__device__ inline void ln_rows(unsigned char* a, float* rs, const AttnParams& p) {
  const int C = p.C, pieces = C / 8, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int L = 1;
  while (L * kLnPieces < pieces) L <<= 1;
  const int sub = lane & (L - 1), rows_w = 32 / L;
  auto group_sum = [&](float v) {
    for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  float gs[kLnPieces][8], gb[kLnPieces][8];
#pragma unroll
  for (int i = 0; i < kLnPieces; ++i) {
    const int c0 = (sub + L * i) * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f), b4 = s4;
      if (c0 < C) {
        s4 = *reinterpret_cast<const float4*>(p.ln_s + c0 + 4 * h);
        b4 = *reinterpret_cast<const float4*>(p.ln_b + c0 + 4 * h);
      }
      gs[i][4 * h] = s4.x, gs[i][4 * h + 1] = s4.y, gs[i][4 * h + 2] = s4.z, gs[i][4 * h + 3] = s4.w;
      gb[i][4 * h] = b4.x, gb[i][4 * h + 1] = b4.y, gb[i][4 * h + 2] = b4.z, gb[i][4 * h + 3] = b4.w;
    }
  }
  const int step = kGemmThreads / 32 * rows_w;
  for (int r0 = 0; r0 < p.N; r0 += step) {  // every lane takes part in each pass's shuffles
    const int r = r0 + warp * rows_w + lane / L;
    const bool live = r < p.N;
    float v[kLnPieces][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPieces; ++i) {
      const int pc = sub + L * i;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (live && pc < pieces) raw = *reinterpret_cast<const uint4*>(a + swz(r, pc * 16, kChunkA));
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = to_f(xv[e]);
        sum += v[i][e];
      }
    }
    const float mean = group_sum(sum) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPieces; ++i)
      if (sub + L * i < pieces) {
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (v[i][e] - mean) * (v[i][e] - mean);
      }
    const float rstd = rsqrtf(group_sum(q) / (float)C + p.eps);
#pragma unroll
    for (int i = 0; i < kLnPieces; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[i][e] = to_f(to_bf((v[i][e] - mean) * rstd * gs[i][e] + gb[i][e]));
    __syncwarp();  // the row's lanes have read it before any lane overwrites it
    if (Q8) {
      float sc = p.act_s;
      if (!(p.act_inv > 0.f)) {  // per-row scale: max(amax, 1e-8) / 127, as quant.py
        float m = 0.f;
#pragma unroll
        for (int i = 0; i < kLnPieces; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[i][e]));
        for (int o = 1; o < L; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        sc = fmaxf(m, 1e-8f) / 127.f;
      }
#pragma unroll
      for (int i = 0; i < kLnPieces; ++i) {
        const int pc = sub + L * i;
        if (live && pc < pieces) {
          __align__(8) signed char q8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) q8[e] = quant1(v[i][e], sc, p.act_inv);
          *reinterpret_cast<uint2*>(a + swz(r, pc * 8, kChunkA)) = *reinterpret_cast<uint2*>(q8);
        }
      }
      if (live && sub == 0) rs[r] = sc;
    } else {
#pragma unroll
      for (int i = 0; i < kLnPieces; ++i) {
        const int pc = sub + L * i;
        if (live && pc < pieces) {
          __align__(16) bf16 b8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b8[e] = to_bf(v[i][e]);
          *reinterpret_cast<uint4*>(a + swz(r, pc * 16, kChunkA)) = *reinterpret_cast<uint4*>(b8);
        }
      }
    }
  }
}

// Q8: W8A8 (int8 rows and weights, s32 sums); kPart: C % 128 != 0.
template <int D, bool Q8, bool kPart>
__global__ void __launch_bounds__(kGemmThreads, 1) window_attn_wgmma(AttnParams p) {
  using Acc = typename std::conditional<Q8, int, float>::type;
  constexpr int kHeads = kTileN / D;                 // heads per group
  constexpr int kTileElems = kTileRows * TileLd<D>::kLd;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* a = align1024(smem_raw);
  const int C = p.C, N = p.N, g = blockIdx.x;
  const AttnLayout L = attn_layout(C, D);
  unsigned char* ring = a + L.ring;
  bf16* kv = reinterpret_cast<bf16*>(a + L.kv);  // k tiles of the group's heads, then v tiles
  float* rs = reinterpret_cast<float*>(a + L.rs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;

  const int groups = (C + kTileN - 1) / kTileN;
  const int grp0 = blockIdx.y * groups / p.splits, grp1 = (blockIdx.y + 1) * groups / p.splits;
  const int esize = Q8 ? 1 : 2, kbytes = C * esize, kchunks = (kbytes + 127) / 128;
  const size_t ldw = (size_t)C * esize;
  const int tiles = (grp1 - grp0) * 3, total = tiles * kchunks;
  // tile t: head group grp0 + t / 3, part t % 3 = k, v, q (W_qkv rows C, 2C, 0 on)
  auto w_row = [&](int t) {
    const int part = t % 3;
    return (part == 2 ? 0 : (part + 1) * C) + (grp0 + t / 3) * kTileN;
  };
  auto load = [&](int i) {
    const int t = i / kchunks, n0 = w_row(t), live = C - (n0 % C);
    load_w_part<kPart>(ring + (i % kAttnSlots) * kChunkW, p.w + (size_t)n0 * ldw, ldw,
                       i % kchunks, live, kbytes);
  };

  // the window's rows, raw, by cp.async; pad rows and the tail of the last
  // 128-byte chunk of each row zero
  {
    const int pieces = C / 8, pieces_pad = (C + 63) / 64 * 8;
    const bf16* xg = p.x + (size_t)g * N * C;
    for (int i = threadIdx.x; i < kTileM * pieces_pad; i += kGemmThreads) {
      const int r = i / pieces_pad, pc = i % pieces_pad;
      unsigned char* dst = a + swz(r, pc * 16, kChunkA);
      if (r < N && pc < pieces) {
        const bf16* src = p.map_h ? p.x + map_row(g, r, p.nW, p.map_h, p.map_w, p.ws, 0, 0) * C
                                  : xg + (size_t)r * C;
        cp_async16(smem_u32(dst), src + pc * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (threadIdx.x < kTileM) rs[threadIdx.x] = 0.f;  // pad rows dequantize to 0
  }
  cp_async_commit();
  for (int s = 0; s < kAttnSlots - 2; ++s) {  // the first weight chunks, one group each
    if (s < total) load(s);
    cp_async_commit();
  }
  cp_async_wait<kAttnSlots - 2>();  // the rows, not the weights
  __syncthreads();
  ln_rows<Q8>(a, rs, p);
  // (the first chunk's fence and barrier publish the rows to wgmma)

  Acc acc[64];
  for (int t = 0; t < tiles; ++t) {
    // the tile's bias (and int8 scales) of this thread's columns, loaded
    // behind the products; columns past C (kPart) get 0
    const int part = t % 3, n0 = w_row(t), c0 = n0 % C;
    float2 bcol[16], scol[Q8 ? 16 : 1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = j * 8 + 2 * tq, n = n0 + c;
      const bool live = !kPart || c0 + c < C;
      const __nv_bfloat162 b2 = live ? *reinterpret_cast<const __nv_bfloat162*>(p.b + n)
                                     : __floats2bfloat162_rn(0.f, 0.f);
      bcol[j] = make_float2(to_f(b2.x), to_f(b2.y));
      if (Q8) scol[j] = live ? *reinterpret_cast<const float2*>(p.sw + n) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0;
    fence_regs(acc);
    for (int kc = 0; kc < kchunks; ++kc) {
      const int i = t * kchunks + kc;
      cp_async_wait<kAttnSlots - 3>();  // this thread's copies of chunk i have landed
      fence_proxy_async();         // and its shared-memory stores are visible to wgmma
      __syncthreads();             // everyone's; chunk i - 2's products are complete
      if (i + kAttnSlots - 2 < total) load(i + kAttnSlots - 2);
      cp_async_commit();
      const uint32_t wa = smem_u32(a) + kc * kChunkA;
      const uint32_t wb = smem_u32(ring + (i % kAttnSlots) * kChunkW);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_tile(acc, wgmma_desc(wa + ks * 32), wgmma_desc(wb + ks * 32));
      wgmma_commit();
      wgmma_wait<1>();  // chunk i - 1's products are complete; chunk i's may run on
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: bias (W8A8: dequantized first), bf16; k and v to their tiles,
    // q packed as this warp's A fragments
    uint32_t qf[32];  // qf[2 j + h]: row 16 warp + gq + 8 h, columns 8 j + 2 tq, + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = j * 8 + 2 * tq;
        float v0 = 0.f, v1 = 0.f;
        if (!kPart || c0 + c < C) {  // past C: a head slot of the last group left empty
          if (Q8) {
            v0 = dequant((int)acc[4 * j + 2 * h], rs[r], scol[j].x, p.qmode);
            v1 = dequant((int)acc[4 * j + 2 * h + 1], rs[r], scol[j].y, p.qmode);
          } else {
            v0 = (float)acc[4 * j + 2 * h];
            v1 = (float)acc[4 * j + 2 * h + 1];
          }
          v0 += bcol[j].x;
          v1 += bcol[j].y;
        }
        if (part == 2) {
          qf[2 * j + h] = pack_bf16(v0, v1);
        } else {
          bf16* tile = kv + (part * kHeads + j * 8 / D) * kTileElems;
          *reinterpret_cast<__nv_bfloat162*>(tile + r * TileLd<D>::kLd + (j * 8) % D + 2 * tq) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    if (part != 2) continue;

    // the group's heads: k and v tiles were published by the q tile's barriers
    const int grp = grp0 + t / 3, live = min(kHeads, (C - grp * kTileN) / D);
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= live) break;
      const int head = grp * kHeads + hh;
      TileState<D> st;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int j0 = hh * D / 8 + 2 * ks;
        st.qf[ks][0] = qf[2 * j0];
        st.qf[ks][1] = qf[2 * j0 + 1];
        st.qf[ks][2] = qf[2 * j0 + 2];
        st.qf[ks][3] = qf[2 * j0 + 3];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
      st.m[0] = st.m[1] = -INFINITY;
      st.l[0] = st.l[1] = 0.f;
      const float* bm = p.bias + ((size_t)(g % p.nW) * p.heads + head) * N * N;
      tile_step(
          st, kv + hh * kTileElems, kv + (kHeads + hh) * kTileElems, 0, N, p.scale,
          [&](int r, int key) { return r < N ? bm[r * N + key] : 0.f; }, true);
      // the one key tile's o is the context (p normalized before P.V)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + gq + 8 * h;
        if (r >= N) continue;
        bf16* dst = p.ctx + ((size_t)g * N + r) * C + head * D + 2 * tq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(st.o[j][2 * h], st.o[j][2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();
}

template <int D, bool Q8, bool kPart>
inline cudaError_t launch_attn_t(const AttnParams& p, size_t smem, cudaStream_t st) {
  const cudaError_t e = allow_smem(window_attn_wgmma<D, Q8, kPart>, smem);
  if (e != cudaSuccess) return e;
  window_attn_wgmma<D, Q8, kPart><<<dim3(p.G, p.splits), kGemmThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D, bool Q8>
inline cudaError_t launch_attn_q(const AttnParams& p, size_t smem, cudaStream_t st) {
  if (p.C % kTileN == 0) return launch_attn_t<D, Q8, false>(p, smem, st);
  // a partial last chunk: never at D = 128, where C = heads * 128
  return D == 128 ? cudaErrorInvalidValue : launch_attn_t<D, Q8, (D < 128)>(p, smem, st);
}

template <int D, bool kInt8>
inline cudaError_t launch_attn_d(const AttnParams& p, size_t smem, cudaStream_t st) {
  if (p.qmode == kQuantOff) return launch_attn_q<D, false>(p, smem, st);
  if constexpr (kInt8) return launch_attn_q<D, true>(p, smem, st);
  return cudaErrorInvalidValue;
}

// ctx of every window: p.splits is set here. Head dims 32
// (every Swin stage), 64 and 128; 1 <= N <= 64; C % 16 == 0 (int8: 32), C <=
// 1024. kInt8: the W8A8 forms are compiled (the whole block); K1 is bf16 only.
template <bool kInt8>
inline cudaError_t launch_attention(AttnParams& p, cudaStream_t st) {
  if (p.G < 1 || p.N < 1 || p.N > kTileM || p.heads < 1 || p.C % p.heads || p.C % 16 ||
      p.C > kAttnMaxC || (p.qmode != kQuantOff && p.C % 32))
    return cudaErrorInvalidValue;
  const int D = p.C / p.heads;
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  const size_t smem = attn_layout(p.C, D).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  p.splits = attn_splits(p.G, p.C, sms);
  switch (D) {
    case 32: return launch_attn_d<32, kInt8>(p, smem, st);
    case 64: return launch_attn_d<64, kInt8>(p, smem, st);
    default: return launch_attn_d<128, kInt8>(p, smem, st);
  }
}

struct ProjParams {
  const bf16* ctx;  // (M, C)
  const bf16* wo;   // (C, C) nn.Linear weight
  const bf16* bo;   // (C,)
  const bf16* x;    // (M, C) residual
  bf16* out;        // (M, C)
  int M, C, residual;
};

// out = bf16([x +] (ctx W_o^T + b_o)) for 64 rows (blockIdx.x) and 128 output
// columns (blockIdx.y); kPart: C % 128 != 0 (mlp_sm90.cuh::stream_tiles).
template <bool kPart>
__global__ void __launch_bounds__(kGemmThreads) k1_proj_wgmma(ProjParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int row0 = blockIdx.x * kTileM, rows = min(kTileM, p.M - row0), n0 = blockIdx.y * kTileN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const size_t ld = (size_t)p.C * 2;
  float acc[64];
  stream_tiles<true, kPart>(
      acc, ring, reinterpret_cast<const unsigned char*>(p.ctx + (size_t)row0 * p.C), ld, rows, 1,
      reinterpret_cast<const unsigned char*>(p.wo), ld, p.C, [&](int) { return n0; }, p.C * 2,
      [&](int, float(&acc)[64]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + gq + 8 * h;
          if (r >= rows) continue;
          const bf16* xr = p.x + (size_t)(row0 + r) * p.C;
          bf16* o = p.out + (size_t)(row0 + r) * p.C;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = n0 + j * 8 + 2 * tq;
            if (kPart && c >= p.C) continue;  // past C in the last tile
            float y0 = acc[4 * j + 2 * h] + to_f(p.bo[c]);
            float y1 = acc[4 * j + 2 * h + 1] + to_f(p.bo[c + 1]);
            if (p.residual) {
              const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xr + c);
              y0 = to_f(xv.x) + y0;
              y1 = to_f(xv.y) + y1;
            }
            *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(y0, y1);
          }
        }
      });
}

inline cudaError_t launch_proj(const ProjParams& p, cudaStream_t st) {
  if (p.M < 1 || p.C % 16) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kRingBytes + 1024;
  const bool part = p.C % kTileN != 0;
  const void* kernel = part ? (const void*)k1_proj_wgmma<true> : (const void*)k1_proj_wgmma<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + kTileM - 1) / kTileM, (p.C + kTileN - 1) / kTileN);
  if (part)
    k1_proj_wgmma<true><<<grid, kGemmThreads, smem, st>>>(p);
  else
    k1_proj_wgmma<false><<<grid, kGemmThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmrp
