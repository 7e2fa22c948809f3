// One attention tile for Hopper (sm_90a), shared by K3 (seq_attention.cu),
// W (wattn_core.cu) and the Swin attention half (attention.cuh):
// softmax(q k^T * scale + add) v for a 64-query tile, streamed over key tiles
// of 64 with an online softmax.
//
// A warpgroup (4 warps) owns the tile, 16 query rows a warp. The q rows are
// read once into mma.sync fragments (ldmatrix); each key tile's scores
// (16 x 64 a warp), their softmax and P.V stay in registers: mma.sync
// m16n8k16 bf16 with f32 sums, K through ldmatrix, V through ldmatrix.trans.
// Per key tile the running row max m and sum l are carried as in
// FlashAttention: s = acc * scale + add(row, key) in f32, m' = max(m, max s),
// o <- o * exp(m - m'), p = exp(s - m'), l <- l * exp(m - m') + sum p, o += p v.
//
// The two places where such a tile can look right and be wrong:
//   - keys at or past nk in the last tile are excluded (s = -inf, p = 0), not
//     given a large negative additive term: a fully masked row (every key's
//     add -1e9) then averages exactly its nk values, as attention_plain does;
//   - the rounding of P: attention_plain rounds the normalized p to bf16
//     before P.V; here the unnormalized p = exp(s - m') is rounded to bf16
//     for the product, l sums the unrounded f32 p, and o / l is rounded once
//     at the end. Both keep p to a bf16 ulp, so an output differs from the
//     plain version's by a few bf16 ulps of its magnitude. Where a row has
//     one key tile (tile_step's `only`: the Swin windows, N <= 64), p is
//     normalized first and rounded as the plain version rounds it, which the
//     int8 forms need: their context is quantized again downstream, and a
//     context an ulp off lands on the other side of an int8 step.
//
// Shared-memory tiles are 64 rows of D bf16 with rows D + 8 elements apart
// (ldmatrix row addresses then fall in distinct banks); tile_rows_async fills
// one with cp.async, rows past the count zeroed.
#pragma once

#include "common.cuh"

namespace mmrp {
namespace {  // internal linkage, as attention.cuh

constexpr int kTileRows = 64;  // queries per tile, and keys per key tile

template <int D>
struct TileLd {
  static constexpr int kLd = D + 8;                                   // elements per smem row
  static constexpr size_t kBytes = (size_t)kTileRows * kLd * sizeof(bf16);  // one 64 x D tile
};

// dst rows r < n <- the D bf16 at src(r) (cp.async, 16 bytes a copy); rows
// [n, 64) <- 0. Any number of threads; the caller commits and waits.
template <int D, typename Src>
__device__ inline void tile_rows_async(bf16* dst, int n, Src src) {
  constexpr int kPieces = D / 8;
  for (int i = threadIdx.x; i < kTileRows * kPieces; i += blockDim.x) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    bf16* d = dst + r * TileLd<D>::kLd + c;
    if (r < n) {
      cp_async16(smem_u32(d), src(r) + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = smem_u32(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = smem_u32(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c[16 x 8] (f32) += a[16 x 16] . b[16 x 8] (bf16 fragments)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The running state of one warp's 16 query rows. Fragment of lane l (g = l / 4,
// t = l % 4): o[j][2 h + e] is row g + 8 h, column 8 j + 2 t + e; m[h], l[h]
// belong to row g + 8 h (l is this lane's partial sum until tile_finish).
template <int D>
struct TileState {
  uint32_t qf[D / 16][4];
  float o[D / 8][4];
  float m[2], l[2];
};

// q fragments of this warp's rows from the q tile; o, m, l reset.
template <int D>
__device__ inline void tile_begin(TileState<D>& st, const bf16* qs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* row = qs + (warp * 16 + (lane & 15)) * TileLd<D>::kLd + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldsm_x4(st.qf[ks], row + ks * 16);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// One key tile: keys key0 .. key0 + 63 (k and v tiles ks, vs); key0 < nk.
// add(r, key) is the additive term of tile row r (0..63) and key. only: the
// row's only key tile (nk <= 64), whose p is then normalized before P.V and
// rounded to bf16 as attention_plain rounds p = e / sum e (here e times the
// rounded reciprocal of the sum, within an f32 ulp of the quotient); st.o is
// then the context itself (tile_finish does not apply).
template <int D, typename Add>
__device__ inline void tile_step(TileState<D>& st, const bf16* ks, const bf16* vs, int key0,
                                 int nk, float scale, Add add, bool only = false) {
  constexpr int kLd = TileLd<D>::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the additive terms first, every load in flight at once behind the products
  float addv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + j * 8 + 2 * t + (i & 1), r = warp * 16 + g + (i >> 1) * 8;
      addv[j][i] = key < nk ? add(r, key) : 0.f;
    }
  }
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // scores: B fragments from the row-major k tile, two 8-key tiles an ldmatrix
  const bf16* krow = ks + ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, krow + np * 16 * kLd + kk * 16);
      mma16816(s[2 * np], st.qf[kk], b[0], b[1]);
      mma16816(s[2 * np + 1], st.qf[kk], b[2], b[3]);
    }
  }
  // scale, add, exclude keys >= nk; row maxima over the quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + j * 8 + 2 * t + (i & 1);
      s[j][i] = key < nk ? __fadd_rn(__fmul_rn(s[j][i], scale), addv[j][i]) : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);  // finite: key0 < nk
    const float corr = expf(st.m[h] - m_new);   // 0 on the first tile
    st.m[h] = m_new;
    st.l[h] *= corr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      st.o[j][2 * h] *= corr;
      st.o[j][2 * h + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - st.m[i >> 1]);  // exactly 0 for excluded keys
      st.l[i >> 1] += s[j][i];
    }
  }
  if (only) {  // the row's sum over the quad, then p = e / sum (by its reciprocal)
    float rl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
      st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
      rl[h] = __frcp_rn(st.l[h]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= rl[i >> 1];
  }
  // o += bf16(p) v: the score fragments of two 8-key tiles are one A fragment
  const bf16* vrow = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + kk * 16 * kLd + dp * 16);
      mma16816(st.o[2 * dp], a, b[0], b[1]);
      mma16816(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// o / l of this warp's rows: store(r, c, v0, v1) for tile row r (0..63) and
// columns c, c + 1.
template <int D, typename Store>
__device__ inline void tile_finish(TileState<D>& st, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store(warp * 16 + g + 8 * h, j * 8 + 2 * t, st.o[j][2 * h] * inv, st.o[j][2 * h + 1] * inv);
  }
}

}  // namespace
}  // namespace mmrp
