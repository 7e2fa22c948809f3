// The MLP half of the port's Hopper kernels (sm_90a) on warpgroup MMA: K2
// (ln_mlp.cu) and the whole Swin block's epilogue (swin_block.cu). The TPU
// kernels it serves (mmrp_tpu/ops/fused_mlp.py:_kernel,
// mmrp_tpu/ops/fused_swin_block.py:_block_body) compute
//   FC2(bf16(gelu_tanh(FC1(A) + b1)))
// with the 4C-wide hidden activation kept on chip; so does this.
//
// What bounds it on the H100: 4 C Hd FLOPs per row, the tensor cores, as long
// as each weight byte brought from L2 serves enough rows. Design, per 64-row
// tile (the wgmma M) and one warpgroup per block:
//   - a cluster of S blocks splits the hidden dimension: rank q owns hidden
//     columns [q span, (q + 1) span), span = Hd / S <= 512, so its slice of
//     the hidden activation (64 x span bf16, 64 KB at most) stays in shared
//     memory whole;
//   - FC1: for each 128 hidden columns, A (the tile's rows, K = C, from device
//     memory, where the caller has just written it) and the W1 rows stream
//     together through a 4-slot cp.async ring into wgmma m64n128k16, one
//     pipeline over all of the rank's columns, two chunks ahead; the f32
//     sums stay in registers, get b1 and tanh-GELU there, and go to the hidden
//     slice as bf16 in the 128-byte-swizzled K-major layout wgmma reads: the
//     hidden slice is FC2's A operand as it stands, and nothing of it leaves
//     the chip;
//   - FC2: for each 128 output columns, the slice against the W2 rows through
//     the ring (6 weight chunks, four ahead); the rank's partial sums (f32, or
//     s32 in W8A8) go to a shared tile, and after a cluster barrier each rank
//     adds all S partial tiles, in rank order (deterministic, no atomics),
//     for its own 64 / S rows through distributed shared memory and hands the
//     sum to the caller's epilogue (bias, residual, LayerNorm or store).
// The host picks the smallest S whose span and shared memory fit, then
// doubles it while the grid stays within one block per SM, so that the 7 row
// tiles of the fusion FFN or of Swin stage 4 still fill 56 SMs. C need not be
// a multiple of 128 (Swin-T / S stages 1-2: 96, 192): FC1's last K chunk and
// FC2's last output tile are zero past C, so C % 16 == 0 (bf16) or C % 32 ==
// 0 (int8: whole 32-byte k-steps) and C <= 1024 (the callers' row loops).
//
// W8A8 with static activation scales (_static_gemm: a calibrated abs-max sa
// per GEMM input): A arrives as int8, FC1 is wgmma s8 m64n128k32 with s32
// sums dequantized acc * sw * sa (common.cuh::dequant), the GELU output is
// rounded to bf16 and quantized with the FC2 input's scale as it leaves the
// registers, FC2 runs in s8, and the ranks add their exact s32 partial sums
// before one dequantization.
//
// W8A8 with per-row activation scales (kRow: the dynamic _qdot, or
// _static_gemm without sa), s = max(|row|, 1e-8) / 127 and round(v / s): A
// arrives as int8 with its 64 row scales, which FC1's epilogue dequantizes
// with. FC2's input is a row of the whole Hd-wide hidden activation, which
// no rank holds, so FC1's epilogue writes its slice in bf16 and keeps each
// row's running |h| maximum in registers (a row's columns lie on the four
// lanes of a quad); the ranks exchange their 64 partial maxima through
// distributed shared memory at one cluster barrier, and each quantizes its
// slice in place, one 128-column int8 chunk at a time in ascending order
// (int8 chunk k covers bf16 chunks 2k and 2k + 1 and lands on bf16 chunk k,
// which chunk k / 2 <= k has read). FC2 then runs in s8 as above and
// dequantizes the exact s32 sum once with the row's scale.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace mmrp {
namespace {

namespace cgm = cooperative_groups;

constexpr int kSpanMax = 512;              // hidden columns a rank keeps on chip
constexpr int kSlot = kChunkA + kChunkW;   // a streamed-GEMM ring slot: A chunk + weight chunk
constexpr int kRingBytes = 4 * kSlot;      // the ring: 4 such slots, or 6 weight chunks
constexpr int kRedLd = kTileN + 4;         // row stride (4-byte words) of the partial-sum tile

// FC2's partial sums fill the first kTileN words of each row of the
// partial-sum tile; the per-row int8 forms keep two scales of each tile row
// in its padding: word kTileN + which of row r.
static_assert(kRedLd >= kTileN + 2, "scale_slot needs two padding words a row");
__device__ __forceinline__ float* scale_slot(float* red, int which, int r) {
  return red + r * kRedLd + kTileN + which;
}

// Dynamic shared memory of an MLP block from its 1024-aligned base: the
// hidden slice (64 x span bf16, or int8 in its first half), the ring, the
// partial-sum tile, and the caller's copy of its rank's rows (row_bytes).
struct MlpLayout {
  size_t h, ring, red, rows, total;
};
__host__ __device__ inline MlpLayout mlp_layout(int span, size_t row_bytes) {
  MlpLayout L;
  L.h = 0;
  L.ring = (size_t)span * 2 / 128 * kChunkA;
  L.red = L.ring + (size_t)kRingBytes;
  L.rows = L.red + (size_t)kTileM * kRedLd * 4;
  L.total = L.rows + row_bytes + 1024;  // + the alignment of the base
  return L;
}

// Rows [row0 + r0, row0 + r0 + n) of a row-major matrix (row_bytes each, a
// multiple of 16, ld bytes apart) into dst in shared memory, all in flight at
// once by cp.async; returns with them landed and visible to the block.
__device__ inline void stage_rows(unsigned char* dst, const unsigned char* src, size_t ld,
                                  int n, int row_bytes) {
  const int pieces = row_bytes / 16;
  for (int i = threadIdx.x; i < n * pieces; i += kGemmThreads) {
    const int r = i / pieces, pc = i % pieces;
    cp_async16(smem_u32(dst + (size_t)r * row_bytes + pc * 16), src + (size_t)r * ld + pc * 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Cluster size of a launch over row_tiles tiles of 64 rows on a card of sms
// SMs, each rank staging row_bytes of each of its 64 / S rows: the fewest
// ranks whose hidden slice (span = Hd / S <= kSpanMax, a multiple of 128) and
// layout fit one block, then twice as many while the grid stays within one
// block per SM. 0: no fit. ops/fused_mlp.py::mlp_cluster_size is its copy.
inline int mlp_cluster_size(int row_tiles, int Hd, size_t row_bytes, int sms) {
  auto fits = [&](int S) {
    return Hd % (S * kTileN) == 0 && Hd / S <= kSpanMax &&
           mlp_layout(Hd / S, (size_t)(kTileM / S) * row_bytes).total <= kMaxSmem;
  };
  int S = 1;
  while (S <= 8 && !fits(S)) S *= 2;
  if (S > 8) return 0;
  while (S < 8 && fits(2 * S) && row_tiles * 2 * S <= sms) S *= 2;
  return S;
}

// A chunk kc (bytes [128 kc, 128 kc + 128) of rows 0..63, lda bytes apart) into
// a ring slot; rows >= rows and, with kPart, bytes >= kbytes are zero. 4
// 16-byte pieces a thread.
template <bool kPart>
__device__ __forceinline__ void load_a_chunk(unsigned char* dst, const unsigned char* a,
                                             size_t lda, int rows, int kc, int kbytes) {
#pragma unroll
  for (int j = 0; j < kChunkA / 16 / kGemmThreads; ++j) {
    const int i = threadIdx.x + j * kGemmThreads, r = i >> 3, piece = i & 7;
    const int k = kc * 128 + piece * 16;
    unsigned char* d = dst + r * 128 + ((piece ^ (r & 7)) << 4);
    if (r < rows && (!kPart || k < kbytes))
      cp_async16(smem_u32(d), a + (size_t)r * lda + k);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Weight chunk kc of 128 nn.Linear rows (ldw bytes apart) into a ring slot;
// with kPart (a width C that is not a multiple of 128: the last K chunk and
// the last output tile are partial) rows >= live and bytes >= kbytes are zero.
template <bool kPart>
__device__ __forceinline__ void load_w_part(unsigned char* dst, const unsigned char* w,
                                            size_t ldw, int kc, int live, int kbytes) {
#pragma unroll
  for (int j = 0; j < kChunkW / 16 / kGemmThreads; ++j) {
    const int i = threadIdx.x + j * kGemmThreads, n = i >> 3, piece = i & 7;
    const int k = kc * 128 + piece * 16;
    unsigned char* d = dst + n * 128 + ((piece ^ (n & 7)) << 4);
    if (!kPart || (n < live && k < kbytes))
      cp_async16(smem_u32(d), w + (size_t)n * ldw + k);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// For each of `tiles` weight tiles t (the 128 nn.Linear rows from row n0_of(t)
// of w, ldw bytes apart; rows past wrows are zero): acc[64 x 128] = A . W_t^T
// over the kbytes bytes of K (a multiple of 32; the last 128-byte chunk is
// zero past them), then epi(t, acc). The weights stream from device memory
// through the ring; A either streams beside them (kStreamA: the 64 rows from
// a, lda bytes apart, zero past `rows`; 4 slots of 24 KB) or lies in shared
// memory (a: its chunks, 8 KB apart, in the swizzled layout; 6 slots of 16
// KB). One continuous pipeline over all the tiles' chunks keeps kSlots - 2
// chunks in flight ahead of the one multiplied and one wgmma group behind it,
// so the next tile's first chunks load while a tile's epilogue runs. Starts
// and ends with no copy in flight; epi is called by all threads. kPart: the
// loads check the bounds (only a C % 128 != 0 needs it; the full-tile form
// keeps them out of the loop).
template <bool kStreamA, bool kPart, typename Acc, typename NOf, typename Epi>
__device__ inline void stream_tiles(Acc (&acc)[64], unsigned char* ring, const unsigned char* a,
                                    size_t lda, int rows, int tiles, const unsigned char* w,
                                    size_t ldw, int wrows, NOf n0_of, int kbytes, Epi epi) {
  constexpr int kSlotBytes = kStreamA ? kSlot : kChunkW;
  constexpr int kSlots = kRingBytes / kSlotBytes;
  const int kchunks = (kbytes + 127) / 128, total = tiles * kchunks;
  auto load = [&](int i) {
    unsigned char* slot = ring + (i % kSlots) * kSlotBytes;
    const int kc = i % kchunks, n0 = n0_of(i / kchunks);
    if (kStreamA) {
      load_a_chunk<kPart>(slot, a, lda, rows, kc, kbytes);
      slot += kChunkA;
    }
    load_w_part<kPart>(slot, w + (size_t)n0 * ldw, ldw, kc, wrows - n0, kbytes);
  };
#pragma unroll
  for (int s = 0; s < kSlots - 2; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  // the accumulators are touched only outside the chunk loop (zeroed before,
  // read after a full wait), so the compiler inserts no wait of its own
  // between a chunk's products and the next chunk's copies
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0;
    fence_regs(acc);
    for (int kc = 0; kc < kchunks; ++kc) {
      const int i = t * kchunks + kc;
      cp_async_wait<kSlots - 3>();  // this thread's copies of chunk i have landed
      fence_proxy_async();          // and its shared-memory stores are visible to wgmma
      __syncthreads();              // everyone's; chunk i - 2's products are complete
      if (i + kSlots - 2 < total) load(i + kSlots - 2);
      cp_async_commit();
      const uint32_t slot = smem_u32(ring + (i % kSlots) * kSlotBytes);
      const uint32_t wa = kStreamA ? slot : smem_u32(a) + kc * kChunkA;
      const uint32_t wb = kStreamA ? slot + kChunkA : slot;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_tile(acc, wgmma_desc(wa + ks * 32), wgmma_desc(wb + ks * 32));
      wgmma_commit();
      wgmma_wait<1>();  // chunk i - 1's products are complete; chunk i's may run on
    }
    wgmma_wait<0>();
    fence_regs(acc);
    epi(t, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// two f32 (or s32) sums stored as one 8-byte word
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<int> {
  using type = int2;
};
template <typename T>
using Acc2 = typename Pair<T>::type;
__device__ __forceinline__ float2 make2(float a, float b) { return make_float2(a, b); }
__device__ __forceinline__ int2 make2(int a, int b) { return make_int2(a, b); }

__device__ __forceinline__ void cluster_or_block_sync(int S) {
  if (S > 1)
    cgm::this_cluster().sync();
  else
    __syncthreads();
}

// The MLP operands of one 64-row tile on one cluster rank.
struct MlpTile {
  const unsigned char* a;  // the tile's first row of FC1's input (bf16, or int8 for Q8)
  size_t lda;              // bytes between rows
  int rows;                // live rows of the tile (the rest are zero)
  const unsigned char* w1; // (Hd, C) nn.Linear weight: bf16, or int8
  const bf16* b1;          // (Hd,)
  const unsigned char* w2; // (C, Hd)
  const float* s1;         // Q8: per-output-channel weight scales of FC1, FC2
  const float* s2;
  float sa1;               // Q8: FC1's input scale, FC2's input scale and f32(1 / it)
  float sa2, inv2;
  int qmode;               // kRow: kQuantDyn or kQuantStatic (the order of dequant's products)
  int C, Hd, span, h0;     // h0: this rank's first hidden column
};

// The rank's hidden slice, then FC2 and the cluster's sum; fin(r, c, v) gets
// the sum v[0..3] (f32, W8A8 dequantized) of output columns c .. c + 3 of the
// tile's row r, for each of this rank's rows r in [rank 64 / S, (rank + 1)
// 64 / S) and every c < C. All 128 threads call it; rows >= t.rows are
// skipped. kRow: per-row activation scales, FC1's input's in scale slot 1 of
// red (every tile row, finite); slot 0 is free and ends as this rank's
// partial |h| maxima, slot 1 as FC2's input's scales. kPart: C % 128 != 0
// (stream_tiles).
template <bool Q8, bool kRow, bool kPart, typename Fin>
__device__ inline void mlp_tile(const MlpTile& t, unsigned char* hs, unsigned char* ring,
                                float* red, int S, int rank, Fin fin) {
  static_assert(Q8 || !kRow, "per-row scales are a W8A8 form");
  using Acc = typename std::conditional<Q8, int, float>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int esize = Q8 ? 1 : 2;
  Acc acc[64];
  float hmax[2] = {0.f, 0.f};  // kRow: |h| maxima of this thread's rows warp 16 + g (+ 8)

  // FC1 over this rank's hidden columns, 128 at a time, into the slice
  stream_tiles<true, kPart>(
      acc, ring, t.a, t.lda, t.rows, t.span / kTileN, t.w1, (size_t)t.C * esize, t.Hd,
      [&](int j) { return t.h0 + j * kTileN; }, t.C * esize, [&](int jt, Acc(&acc)[64]) {
        const int j0 = jt * kTileN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          const float sx = kRow ? *scale_slot(red, 1, r) : t.sa1;
          const int mode = kRow ? t.qmode : kQuantStatic;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = j0 + j * 8 + 2 * tq, n = t.h0 + c;
            float v0, v1;
            if (Q8) {
              v0 = dequant((int)acc[4 * j + 2 * h], sx, t.s1[n], mode);
              v1 = dequant((int)acc[4 * j + 2 * h + 1], sx, t.s1[n + 1], mode);
            } else {
              v0 = (float)acc[4 * j + 2 * h];
              v1 = (float)acc[4 * j + 2 * h + 1];
            }
            v0 = gelu_tanh(v0 + to_f(t.b1[n]));
            v1 = gelu_tanh(v1 + to_f(t.b1[n + 1]));
            // static: bf16 first, as the TPU kernel casts it, then int8 with FC2's scale
            if (Q8 && !kRow) {
              const char2 q = make_char2(quant1(to_f(to_bf(v0)), t.sa2, t.inv2),
                                         quant1(to_f(to_bf(v1)), t.sa2, t.inv2));
              *reinterpret_cast<char2*>(hs + swz(r, c, kChunkA)) = q;
            } else {
              const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(hs + swz(r, c * 2, kChunkA)) = hv;
              if (kRow) hmax[h] = fmaxf(hmax[h], fmaxf(fabsf(to_f(hv.x)), fabsf(to_f(hv.y))));
            }
          }
        }
      });

  if (kRow) {  // FC2's input scales: each row's |h| maximum over every rank's slice
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hmax[h] = fmaxf(hmax[h], __shfl_xor_sync(0xffffffffu, hmax[h], 1));
      hmax[h] = fmaxf(hmax[h], __shfl_xor_sync(0xffffffffu, hmax[h], 2));
      if (tq == 0) *scale_slot(red, 0, warp * 16 + g + 8 * h) = hmax[h];
    }
    cluster_or_block_sync(S);  // every rank's partial maxima are written
    if (threadIdx.x < kTileM) {
      float m = 0.f;
      for (int q = 0; q < S; ++q)
        m = fmaxf(m, *scale_slot(S > 1 ? cgm::this_cluster().map_shared_rank(red, q) : red, 0,
                                 threadIdx.x));
      *scale_slot(red, 1, threadIdx.x) = fmaxf(m, 1e-8f) / 127.f;
    }
    __syncthreads();
    // the slice to int8 in place, 128 columns (16 bytes a piece) at a time
    for (int k = 0; k < t.span / kTileN; ++k) {
      uint4 q[kChunkA / 16 / kGemmThreads];
#pragma unroll
      for (int j = 0; j < kChunkA / 16 / kGemmThreads; ++j) {
        const int i = threadIdx.x + j * kGemmThreads, r = i >> 3, c = k * kTileN + (i & 7) * 16;
        const float s = *scale_slot(red, 1, r);
        const uint4 lo = *reinterpret_cast<const uint4*>(hs + swz(r, c * 2, kChunkA));
        const uint4 hi = *reinterpret_cast<const uint4*>(hs + swz(r, c * 2 + 16, kChunkA));
        const bf16* lv = reinterpret_cast<const bf16*>(&lo);
        const bf16* hv = reinterpret_cast<const bf16*>(&hi);
        __align__(16) signed char q8[16];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          q8[e] = quant1(to_f(lv[e]), s, 0.f);
          q8[8 + e] = quant1(to_f(hv[e]), s, 0.f);
        }
        q[j] = *reinterpret_cast<const uint4*>(q8);
      }
      __syncthreads();  // int8 chunk k overwrites bf16 chunk k: every thread has read it
#pragma unroll
      for (int j = 0; j < kChunkA / 16 / kGemmThreads; ++j) {
        const int i = threadIdx.x + j * kGemmThreads, r = i >> 3, c = k * kTileN + (i & 7) * 16;
        *reinterpret_cast<uint4*>(hs + swz(r, c, kChunkA)) = q[j];
      }
    }
  }
  // (the pipeline fences the slice's stores into wgmma's view before its first product)

  // FC2 of the slice for each 128 output columns; the partial sums of every
  // rank added in rank order, for this rank's rows, as each tile's epilogue
  const int R = kTileM / S, r0 = rank * R;
  const size_t ldw2 = (size_t)t.Hd * esize;
  stream_tiles<false, kPart>(
      acc, ring, hs, 0, kTileM, (t.C + kTileN - 1) / kTileN, t.w2 + (size_t)t.h0 * esize, ldw2,
      t.C, [&](int n) { return n * kTileN; }, t.span * esize, [&](int nt, Acc(&acc)[64]) {
        const int n0 = nt * kTileN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<Acc2<Acc>*>(red + r * kRedLd + j * 8 + 2 * tq) =
                make2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        cluster_or_block_sync(S);  // every rank's partial tile is complete
        for (int i = threadIdx.x; i < R * (kTileN / 4); i += kGemmThreads) {
          const int r = r0 + i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
          if (kPart && n0 + c >= t.C) continue;  // past C in the last tile
          Acc s4[4] = {0, 0, 0, 0};
          for (int q = 0; q < S; ++q) {  // in rank order
            const float* rq = S > 1 ? cgm::this_cluster().map_shared_rank(red, q) : red;
            const uint4 u = *reinterpret_cast<const uint4*>(rq + r * kRedLd + c);
            const Acc* pv = reinterpret_cast<const Acc*>(&u);
#pragma unroll
            for (int e = 0; e < 4; ++e) s4[e] += pv[e];
          }
          if (r >= t.rows) continue;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = kRow ? dequant((int)s4[e], *scale_slot(red, 1, r), t.s2[n0 + c + e], t.qmode)
                 : Q8   ? dequant((int)s4[e], t.sa2, t.s2[n0 + c + e], kQuantStatic)
                        : (float)s4[e];
          fin(r, n0 + c, v);
        }
        cluster_or_block_sync(S);  // no rank rewrites its tile while another still reads it
      });
}

}  // namespace
}  // namespace mmrp
