// Attention phase and projection epilogue of K1 (window_attention.cu); the
// whole-block Swin kernel (swin_block.cu) runs the same attention phase.
//
// The TPU kernel computes, per 7x7 Swin window: LN(x) -> q/k/v ->
// softmax(q k^T * s + bias) v -> out projection [+ residual]. Here that is
// two launches of hand-written device code:
//
//   attention_kernel   one block per (window, head). The window's rows (at
//                      most 64) are staged in shared memory, LayerNorm'ed
//                      there, and this head's q/k/v (64 x D each), the scores
//                      and the probabilities never leave shared memory. It
//                      writes the C-wide per-head context to device memory
//                      once: the one intermediate of this design.
//   proj_epilogue      one block per 16 rows: context @ W_o^T + b_o [+ x] in
//                      f32.
//
// Ragged token counts (49-token windows, 9 in tests) are handled in the
// kernel: rows past the count are zero-filled, keys past the count get
// probability exactly 0, and pad query rows are never stored.
//
// The whole-block Swin kernel (swin_block.cu) runs the same attention phase on
// the raw (B, H, W, C) map: AttnParams.map_h > 0 makes group g window g % nW of
// image g / nW, and its rows are gathered from the map by index arithmetic
// (map_row), so no partitioned copy of the map exists.
#pragma once

#include "common.cuh"

namespace mmrp {
namespace {  // internal linkage: each translation unit instantiates its own copy

struct AttnParams {
  const bf16* x;         // (G * N, C) rows
  const float* ln_s;     // (C,) pre-LN affine
  const float* ln_b;
  const bf16* wq;        // (C, C) nn.Linear weights: rows [h*D, h*D + D) are head h
  const bf16* wk;
  const bf16* wv;
  const bf16* bq;
  const bf16* bk;
  const bf16* bv;
  const float* bias;     // (nW, heads, N, N) additive, window = g % nW
  bf16* ctx;             // (G * N, C): head h writes columns [h*D, h*D + D)
  int G, N, C, heads, nW;
  float scale, eps;
  int map_h, map_w, ws;  // map_h > 0: rows gathered from a (B, map_h, map_w, C) map
  // W8A8 (qmode != kQuantOff): int8 (C, C) weights and (C,) scales replace
  // wq/wk/wv; the staged rows are quantized per row, or with the static
  // scale act_s (act_inv = f32(1 / act_s) > 0)
  int qmode;
  const signed char *wq8, *wk8, *wv8;
  const float *swq, *swk, *swv;
  float act_s, act_inv;
};

// Row of a (B, H, W, C) map that holds token t of window g (windows row-major
// per image, g / nW the image, tokens row-major in the ws x ws window), moved
// by (roll_h, roll_w) with wrap-around as jnp.roll(y, (roll_h, roll_w), (1, 2))
// moves it. Rolls are taken in [0, H) and [0, W).
__host__ __device__ inline size_t map_row(int g, int t, int nW, int H, int W, int ws,
                                          int roll_h, int roll_w) {
  const int b = g / nW, w = g % nW, nWw = W / ws;
  int i = (w / nWw) * ws + t / ws, j = (w % nWw) * ws + t % ws;
  i += roll_h;
  if (i >= H) i -= H;
  j += roll_w;
  if (j >= W) j -= W;
  return ((size_t)b * H + i) * W + j;
}

struct AttnSmem {
  size_t buf, q, k, v, work, rs, total;
};

// Shared-memory layout of attention_kernel; the host sizes the launch with it.
template <int D>
__host__ __device__ inline AttnSmem attn_smem(int N, int C) {
  const int npq = round16(N), npk = npq, npm = npq;
  AttnSmem s;
  size_t off = 0;
  s.buf = off;  // staged rows (bf16); later reused as the f32 P.V output
  const size_t buf_bytes = (size_t)npm * (C + 8) * sizeof(bf16);
  const size_t out_bytes = (size_t)npq * (D + 4) * sizeof(float);
  off += align128(buf_bytes > out_bytes ? buf_bytes : out_bytes);
  s.q = off;
  off += align128((size_t)npq * (D + 8) * sizeof(bf16));
  s.k = off;
  off += align128((size_t)npk * (D + 8) * sizeof(bf16));
  s.v = off;
  off += align128((size_t)npk * (D + 8) * sizeof(bf16));
  s.work = off;  // f32 projection scratch, later the scores + bf16 probabilities
  const size_t proj_bytes = (size_t)npm * (D + 4) * sizeof(float);
  const size_t soft_bytes = align128((size_t)npq * (npk + 4) * sizeof(float)) +
                            (size_t)npq * (npk + 8) * sizeof(bf16);
  off += align128(proj_bytes > soft_bytes ? proj_bytes : soft_bytes);
  s.rs = off;  // int8 forms: the staged rows' activation scales
  off += align128((size_t)npm * sizeof(float));
  s.total = off;
  return s;
}

// buf rows [0, rows) <- bf16(LN(row r)) in f32, row r at src(r); rows
// [rows, rows_pad) <- 0. One warp per row.
template <typename RowSrc>
__device__ inline void load_rows(bf16* buf, int ldb, RowSrc src, int rows, int rows_pad, int C,
                                 const float* ln_s, const float* ln_b, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows_pad; r += kWarps) {
    bf16* dst = buf + (size_t)r * ldb;
    if (r >= rows) {
      for (int c = lane; c < C; c += 32) dst[c] = to_bf(0.f);
      continue;
    }
    const bf16* s = src(r);
    for (int c = lane; c < C; c += 32) dst[c] = s[c];
    float mean, rstd;
    row_stats([&](int c) { return to_f(dst[c]); }, C, eps, mean, rstd);
    for (int c = lane; c < C; c += 32)
      dst[c] = to_bf((to_f(dst[c]) - mean) * rstd * ln_s[c] + ln_b[c]);
  }
}

// dst[r][c] = bf16(buf[r] . w[head*D + c] + b[head*D + c]), r < rows_pad, c < D.
template <int D>
__device__ inline void project_head(bf16* dst, const bf16* buf, int ldb, int rows_pad,
                                    const bf16* w, const bf16* b, int C, int head,
                                    float* scratch) {
  const int warp = threadIdx.x >> 5;
  constexpr int nt = D / 16;
  const int tiles = (rows_pad / 16) * nt;
  for (int t = warp; t < tiles; t += kWarps) {
    const int mi = t / nt, ni = t % nt;
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    mma_bcol(acc, buf + (size_t)mi * 16 * ldb, ldb, w + (size_t)(head * D + ni * 16) * C, C, C);
    wmma::store_matrix_sync(scratch + (size_t)mi * 16 * (D + 4) + ni * 16, acc, D + 4,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows_pad * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[(size_t)r * (D + 8) + c] = to_bf(scratch[(size_t)r * (D + 4) + c] + to_f(b[head * D + c]));
  }
  __syncthreads();
}

// The int8 form: dst[r][c] = bf16(dequant(a[r] . w8[head*D + c]) + b[head*D + c])
// on rows quantized in place (a, lda bytes) with row scales rs. The sums stay
// in the mma fragments and are dequantized from there.
template <int D>
__device__ inline void project_head_q8(bf16* dst, const signed char* a, int lda, int rows_pad,
                                       const signed char* w, const float* sw, const bf16* b,
                                       int C, int head, const float* rs, int mode) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int nt = D / 8;
  const int tiles = (rows_pad / 16) * nt;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int mi = tile / nt, c0 = (tile % nt) * 8, n0 = head * D + c0;
    int acc[4] = {0, 0, 0, 0};
    mma_s8(acc, a + (size_t)mi * 16 * lda, lda, w + (size_t)n0 * C, C, C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mi * 16 + g + (i >> 1) * 8, c = c0 + 2 * t + (i & 1);
      dst[(size_t)r * (D + 8) + c] =
          to_bf(dequant(acc[i], rs[r], sw[head * D + c], mode) + to_f(b[head * D + c]));
    }
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_kernel(AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.x, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npq = round16(p.N), npk = npq;
  const AttnSmem L = attn_smem<D>(p.N, p.C);
  bf16* buf = reinterpret_cast<bf16*>(smem + L.buf);
  float* ostage = reinterpret_cast<float*>(smem + L.buf);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.v);
  float* scratch = reinterpret_cast<float*>(smem + L.work);
  float* ss = scratch;
  bf16* ps = reinterpret_cast<bf16*>(smem + L.work +
                                     align128((size_t)npq * (npk + 4) * sizeof(float)));
  const int ldb = p.C + 8;
  // int8 forms: the staged bf16 rows quantized in place (2 ldb bytes per row)
  const bool q8 = p.qmode != kQuantOff;
  const signed char* buf8 = reinterpret_cast<const signed char*>(buf);
  float* rs = reinterpret_cast<float*>(smem + L.rs);

  // q, k, v from the LayerNorm'ed rows
  const bf16* xg = p.x + (size_t)g * p.N * p.C;
  load_rows(
      buf, ldb,
      [&](int r) {
        return p.map_h ? p.x + map_row(g, r, p.nW, p.map_h, p.map_w, p.ws, 0, 0) * p.C
                       : xg + (size_t)r * p.C;
      },
      p.N, npq, p.C, p.ln_s, p.ln_b, p.eps);
  __syncthreads();
  if (q8) {
    quantize_rows(buf, ldb, npq, p.C, p.act_s, p.act_inv, rs);
    project_head_q8<D>(qs, buf8, 2 * ldb, npq, p.wq8, p.swq, p.bq, p.C, head, rs, p.qmode);
    project_head_q8<D>(ks, buf8, 2 * ldb, npk, p.wk8, p.swk, p.bk, p.C, head, rs, p.qmode);
    project_head_q8<D>(vs, buf8, 2 * ldb, npk, p.wv8, p.swv, p.bv, p.C, head, rs, p.qmode);
  } else {
    project_head<D>(qs, buf, ldb, npq, p.wq, p.bq, p.C, head, scratch);
    project_head<D>(ks, buf, ldb, npk, p.wk, p.bk, p.C, head, scratch);
    project_head<D>(vs, buf, ldb, npk, p.wv, p.bv, p.C, head, scratch);
  }

  // scores = q k^T (f32), k read column-major straight from its row-major tile
  {
    const int nkt = npk / 16;
    const int tiles = (npq / 16) * nkt;
    for (int t = warp; t < tiles; t += kWarps) {
      const int mi = t / nkt, ni = t % nkt;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      mma_bcol(acc, qs + (size_t)mi * 16 * (D + 8), D + 8, ks + (size_t)ni * 16 * (D + 8), D + 8,
               D);
      wmma::store_matrix_sync(ss + (size_t)mi * 16 * (npk + 4) + ni * 16, acc, npk + 4,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // softmax in f32, one warp per query row; pad keys get exactly 0
  {
    const float* bmat = p.bias + ((size_t)(g % p.nW) * p.heads + head) * p.N * p.N;
    for (int r = warp; r < npq; r += kWarps) {
      bf16* prow = ps + (size_t)r * (npk + 8);
      if (r >= p.N) {
        for (int c = lane; c < npk; c += 32) prow[c] = to_bf(0.f);
        continue;
      }
      float v[2];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        float s = -INFINITY;
        if (c < p.N) s = ss[(size_t)r * (npk + 4) + c] * p.scale + bmat[(size_t)r * p.N + c];
        v[i] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < p.N ? expf(v[i] - m) : 0.f;
        sum += v[i];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        if (c < npk) prow[c] = to_bf(v[i] / sum);
      }
    }
  }
  __syncthreads();

  // context = p v, staged in f32 over the (now free) row buffer
  {
    constexpr int nt = D / 16;
    const int tiles = (npq / 16) * nt;
    for (int t = warp; t < tiles; t += kWarps) {
      const int mi = t / nt, ni = t % nt;
      FragAcc acc;
      wmma::fill_fragment(acc, 0.f);
      mma_brow(acc, ps + (size_t)mi * 16 * (npk + 8), npk + 8, vs + ni * 16, D + 8, npk);
      wmma::store_matrix_sync(ostage + (size_t)mi * 16 * (D + 4) + ni * 16, acc, D + 4,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.N * D; i += kThreads) {
    const int r = i / D, c = i % D;
    p.ctx[((size_t)g * p.N + r) * p.C + head * D + c] = to_bf(ostage[(size_t)r * (D + 4) + c]);
  }
}

struct EpiParams {
  const bf16* ctx;     // (round16(M), C); rows >= M only feed rows that are never stored
  const bf16* wo;      // (C, C) nn.Linear weight
  const bf16* bo;      // (C,)
  const bf16* x;       // (M, C) residual
  bf16* out;           // (M, C)
  int M, C, residual;
};

// [16][C + 4] f32 sums
__host__ __device__ inline size_t epi_smem(int C) {
  return align128((size_t)16 * (C + 4) * sizeof(float));
}

__global__ void __launch_bounds__(kThreads) proj_epilogue_kernel(EpiParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);  // [16][C + 4]
  const int ld = p.C + 4;
  const int row0 = blockIdx.x * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < p.C / 16; t += kWarps) {
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    mma_bcol(acc, p.ctx + (size_t)row0 * p.C, p.C, p.wo + (size_t)t * 16 * p.C, p.C, p.C);
    wmma::store_matrix_sync(acc_s + t * 16, acc, ld, wmma::mem_row_major);
  }
  __syncthreads();
  for (int lr = warp; lr < 16; lr += kWarps) {
    const int r = row0 + lr;
    if (r >= p.M) continue;
    const float* a = acc_s + (size_t)lr * ld;
    const bf16* xr = p.x + (size_t)r * p.C;
    bf16* o = p.out + (size_t)r * p.C;
    for (int c = lane; c < p.C; c += 32) {
      const float y = a[c] + to_f(p.bo[c]);
      o[c] = to_bf(p.residual ? to_f(xr[c]) + y : y);
    }
  }
}

template <int D>
inline cudaError_t launch_attention_d(const AttnParams& p, cudaStream_t stream) {
  const size_t smem = attn_smem<D>(p.N, p.C).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(attention_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  attention_kernel<D><<<dim3(p.G, p.heads), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims 32 (every Swin-B stage), 64 and 128.
inline cudaError_t launch_attention(const AttnParams& p, cudaStream_t stream) {
  if (p.G < 1 || p.N < 1 || p.N > 64 || p.heads < 1 || p.C % p.heads || p.C % 16 ||
      (p.qmode != kQuantOff && p.C % 32))
    return cudaErrorInvalidValue;
  switch (p.C / p.heads) {
    case 32: return launch_attention_d<32>(p, stream);
    case 64: return launch_attention_d<64>(p, stream);
    case 128: return launch_attention_d<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline cudaError_t launch_epilogue(const EpiParams& p, cudaStream_t stream) {
  if (p.M < 1 || p.C % 16) return cudaErrorInvalidValue;
  const size_t smem = epi_smem(p.C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(proj_epilogue_kernel, smem);
  if (e != cudaSuccess) return e;
  proj_epilogue_kernel<<<(p.M + 15) / 16, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmrp
