// C-F / C-B — the raw-layout Swin window-attention core, forward and backward,
// and W — head-major window attention, for Hopper (sm_90a).
//
// C-F replaces mmrp_tpu/ops/wattn_core.py:_fwd_kernel (window_attention_core's
// forward): on the raw (B, H, W, 3C) qkv map, per 7x7 window of the map rolled
// by -shift and per head, out = softmax(q k^T * scale + bias[w, h]) v, written
// back to the rows the roll by +shift puts them in. C-B replaces _bwd_kernel:
// it recomputes P from the saved qkv and returns dqkv in the raw layout and
// dbias[w, h] = sum over images of dS (unscaled, f32). W replaces
// mmrp_tpu/ops/window_attention.py:_wattn_kernel (window_attention_pallas): the
// same per-window softmax attention on head-major (B, G, N, d) q/k/v with a
// (G, N, N) additive bias.
//
// What bounds them on the H100: bytes. Per window and head the work is two (or,
// backward, five) 64 x 64 x d products at d = 32, so against each byte read
// (qkv, dO, bias) there are only ~10 FLOPs: far below the ~295 FLOP/byte at
// which the tensor cores would be the limit. The TPU kernels' point was to
// never store the roll, the window partition or the probabilities in device
// memory; so is this design's:
//   - one block per (window, head) gathers its 49 q/k/v (and dO) rows straight
//     from the raw map at their rolled positions (map_row, attention.cuh), 64
//     bytes per row and head, and scatters its result rows the same way: no
//     rolled or partitioned copy of the map exists in either direction, and
//     every output element is written exactly once;
//   - tokens are zero-padded 49 -> 64 in shared memory, pad keys get
//     probability exactly 0; scores, P, dP and dS never leave shared memory;
//   - the products are WMMA bf16 16x16x16 tiles with f32 accumulation, at the
//     rounding points of the TPU kernels: P rounded to bf16 before P.V and
//     P^T.dO, dS * scale rounded to bf16 before dQ and dK;
//   - dbias is a sum over the images, which the TPU carried in a resident
//     accumulator over its sequential grid. Blocks here run in no order, and
//     the sum must be the same bit for bit from run to run, so there are no
//     float atomics: a backward block owns one (window, head) and a chunk of
//     images, loops over them and keeps its dS sum in registers, then writes
//     it to a per-chunk f32 slot; a second launch adds the chunks in order.
//     The wrapper picks the chunk so that there are ~1024 blocks.
#include <type_traits>

#include "attention.cuh"

namespace mmrp {
// the same anonymous namespace as attention.cuh's: a second one at global
// scope makes the kernel registration stub's namespace name ambiguous
namespace {

constexpr int kNp = 64;          // tokens per window (or sequence), padded
constexpr int kD = 32;           // head dim: 32 at every Swin-B and Swin-T stage
constexpr int kLdS = kNp + 4;    // f32 64 x 64 tiles
constexpr int kLdP = kNp + 8;    // bf16 64 x 64 tiles
constexpr int kAcc = kNp * kNp / kThreads;  // dbias elements a thread owns

template <int D>
struct Smem {
  static constexpr int kLdT = D + 8;  // bf16 64 x D tiles (q, k, v, dO)
  static constexpr int kLdO = D + 4;  // f32 64 x D staging of a product
  static constexpr size_t tile = align128((size_t)kNp * kLdT * sizeof(bf16));
  static constexpr size_t s32 = align128((size_t)kNp * kLdS * sizeof(float));
  static constexpr size_t p16 = align128((size_t)kNp * kLdP * sizeof(bf16));
  static constexpr size_t o32 = align128((size_t)kNp * kLdO * sizeof(float));
  static constexpr size_t fwd = 3 * tile + s32 + p16 + o32;
  static constexpr size_t bwd = 4 * tile + 2 * s32 + p16 + o32;
};

struct CoreParams {
  const bf16* qkv;    // (B, H, W, 3C), [q | k | v], heads contiguous in each
  const float* bias;  // (nW, heads, N, N)
  const bf16* dout;   // (B, H, W, C), backward only
  bf16* out;          // forward: (B, H, W, C); backward: dqkv (B, H, W, 3C)
  float* dbias;       // backward: (chunks, nW, heads, N, N)
  int B, H, W, C, heads, ws, shift, nW, bc;
  float scale;
};

// dst rows r < n <- the D bf16 at src(r), rows [n, 64) <- 0; 16-byte copies.
template <int D, typename Src>
__device__ inline void load_tile(bf16* dst, int n, Src src) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kNp * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = *reinterpret_cast<const uint4*>(src(r) + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::kLdT + c * 8) = v;
  }
}

// dst(r)[0, D) <- bf16(src row r), rows r < n; 16-byte stores.
template <int D, typename Dst>
__device__ inline void store_tile(const float* src, int n, Dst dst) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const float* s = src + r * Smem<D>::kLdO + c * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = to_bf(s[j]);
    *reinterpret_cast<uint4*>(dst(r) + c * 8) = *reinterpret_cast<const uint4*>(v);
  }
}

// c (64 x ncols, f32, ldc) = A (64 x K) . B (K x ncols). kATrans: A is given as
// its transpose, row-major (K x 64, lda); kBTrans: B is given as its transpose,
// row-major (ncols x K, ldb). One 16 x 16 output tile per warp at a time.
template <bool kATrans, bool kBTrans>
__device__ inline void gemm64(float* c, int ldc, int ncols, const bf16* a, int lda,
                              const bf16* b, int ldb, int K) {
  using LA = typename std::conditional<kATrans, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<kBTrans, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int nt = ncols / 16, tiles = (kNp / 16) * nt;
  for (int t = warp; t < tiles; t += kWarps) {
    const int mi = t / nt, ni = t % nt;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      const bf16* pa = kATrans ? a + (size_t)k * lda + mi * 16 : a + (size_t)mi * 16 * lda + k;
      const bf16* pb = kBTrans ? b + (size_t)ni * 16 * ldb + k : b + (size_t)k * ldb + ni * 16;
      wmma::load_matrix_sync(fa, pa, lda);
      wmma::load_matrix_sync(fb, pb, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + (size_t)mi * 16 * ldc + ni * 16, acc, ldc, wmma::mem_row_major);
  }
}

// Rows r < n of the f32 scores s: softmax over c < n of s * scale + bias(r, c),
// in f32, one warp per row. pb <- bf16(P); p32 (may alias s, or null) <- P.
// Pad rows and columns get 0.
template <typename Bias>
__device__ inline void softmax64(float* s, float* p32, bf16* pb, int n, float scale, Bias bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kNp; r += kWarps) {
    bf16* prow = pb + r * kLdP;
    float* frow = p32 ? p32 + r * kLdS : nullptr;
    if (r >= n) {
      for (int c = lane; c < kNp; c += 32) {
        prow[c] = to_bf(0.f);
        if (frow) frow[c] = 0.f;
      }
      continue;
    }
    float v[2];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < n ? s[r * kLdS + c] * scale + bias(r, c) : -INFINITY;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < n ? expf(v[i] - m) : 0.f;
      sum += v[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      const float pv = v[i] / sum;
      prow[c] = to_bf(pv);
      if (frow) frow[c] = pv;
    }
  }
}

// The softmax VJP, rows r < n: dS = P * (dP - rowsum(dP * P)) in f32, in place
// over dp; dsb <- bf16(dS * scale). Pads 0.
__device__ inline void softmax_bwd64(const float* p, float* dp, bf16* dsb, int n, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kNp; r += kWarps) {
    float pv[2], dv[2];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      const bool in = r < n && c < n;
      pv[i] = in ? p[r * kLdS + c] : 0.f;
      dv[i] = in ? dp[r * kLdS + c] : 0.f;
      dot += pv[i] * dv[i];
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      const float ds = pv[i] * (dv[i] - dot);  // 0 on pads: pv is 0 there
      dp[r * kLdS + c] = ds;
      dsb[r * kLdP + c] = to_bf(ds * scale);
    }
  }
}

// softmax(q k^T * scale + bias) v of one (window or sequence, head): q, k, v
// rows from qsrc / ksrc / vsrc (n <= 64 of them), the result rows to dst.
template <int D, typename QSrc, typename KSrc, typename VSrc, typename Bias, typename Dst>
__device__ inline void attend(unsigned char* smem, int n, float scale, QSrc qsrc, KSrc ksrc,
                              VSrc vsrc, Bias bias, Dst dst) {
  using L = Smem<D>;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::tile);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 3 * L::tile);
  bf16* pb = reinterpret_cast<bf16*>(smem + 3 * L::tile + L::s32);
  float* os = reinterpret_cast<float*>(smem + 3 * L::tile + L::s32 + L::p16);
  load_tile<D>(qs, n, qsrc);
  load_tile<D>(ks, n, ksrc);
  load_tile<D>(vs, n, vsrc);
  __syncthreads();
  gemm64<false, true>(ss, kLdS, kNp, qs, L::kLdT, ks, L::kLdT, D);
  __syncthreads();
  softmax64(ss, nullptr, pb, n, scale, bias);
  __syncthreads();
  gemm64<false, false>(os, L::kLdO, D, pb, kLdP, vs, L::kLdT, kNp);
  __syncthreads();
  store_tile<D>(os, n, dst);
}

// C-F: one block per (image * nW + window, head).
template <int D>
__global__ void __launch_bounds__(kThreads) core_fwd_kernel(CoreParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.x, head = blockIdx.y, n = p.ws * p.ws;
  const int C3 = 3 * p.C;
  auto row = [&](int t) { return map_row(g, t, p.nW, p.H, p.W, p.ws, p.shift, p.shift); };
  const float* bmat = p.bias + ((size_t)(g % p.nW) * p.heads + head) * n * n;
  attend<D>(
      smem, n, p.scale, [&](int t) { return p.qkv + row(t) * C3 + head * D; },
      [&](int t) { return p.qkv + row(t) * C3 + p.C + head * D; },
      [&](int t) { return p.qkv + row(t) * C3 + 2 * p.C + head * D; },
      [&](int r, int c) { return bmat[r * n + c]; },
      [&](int t) { return p.out + row(t) * p.C + head * D; });
}

// C-B: one block per (window, head, chunk of bc images).
template <int D>
__global__ void __launch_bounds__(kThreads) core_bwd_kernel(CoreParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<D>;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::tile);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * L::tile);
  bf16* dos = reinterpret_cast<bf16*>(smem + 3 * L::tile);
  float* ss = reinterpret_cast<float*>(smem + 4 * L::tile);            // S, then P (f32)
  float* dps = reinterpret_cast<float*>(smem + 4 * L::tile + L::s32);  // dP, then dS
  bf16* pb = reinterpret_cast<bf16*>(smem + 4 * L::tile + 2 * L::s32); // bf16 P, then dS*scale
  float* os = reinterpret_cast<float*>(smem + 4 * L::tile + 2 * L::s32 + L::p16);
  const int w = blockIdx.x, head = blockIdx.y, chunk = blockIdx.z;
  const int n = p.ws * p.ws, nn = n * n;
  const int C = p.C, C3 = 3 * C;
  const float* bmat = p.bias + ((size_t)w * p.heads + head) * nn;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int b_end = min(p.B, (chunk + 1) * p.bc);
  for (int b = chunk * p.bc; b < b_end; ++b) {
    const int g = b * p.nW + w;
    auto row = [&](int t) { return map_row(g, t, p.nW, p.H, p.W, p.ws, p.shift, p.shift); };
    load_tile<D>(qs, n, [&](int t) { return p.qkv + row(t) * C3 + head * D; });
    load_tile<D>(ks, n, [&](int t) { return p.qkv + row(t) * C3 + C + head * D; });
    load_tile<D>(vs, n, [&](int t) { return p.qkv + row(t) * C3 + 2 * C + head * D; });
    load_tile<D>(dos, n, [&](int t) { return p.dout + row(t) * C + head * D; });
    __syncthreads();
    gemm64<false, true>(ss, kLdS, kNp, qs, L::kLdT, ks, L::kLdT, D);  // S = q k^T
    __syncthreads();
    softmax64(ss, ss, pb, n, p.scale, [&](int r, int c) { return bmat[r * n + c]; });
    __syncthreads();
    gemm64<true, false>(os, L::kLdO, D, pb, kLdP, dos, L::kLdT, kNp);   // dV = pb^T dO
    gemm64<false, true>(dps, kLdS, kNp, dos, L::kLdT, vs, L::kLdT, D);  // dP = dO v^T
    __syncthreads();
    store_tile<D>(os, n, [&](int t) { return p.out + row(t) * C3 + 2 * C + head * D; });
    softmax_bwd64(ss, dps, pb, n, p.scale);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < nn) acc[i] += dps[(e / n) * kLdS + e % n];
    }
    gemm64<false, false>(os, L::kLdO, D, pb, kLdP, ks, L::kLdT, kNp);  // dQ = dsb k
    __syncthreads();
    store_tile<D>(os, n, [&](int t) { return p.out + row(t) * C3 + head * D; });
    __syncthreads();
    gemm64<true, false>(os, L::kLdO, D, pb, kLdP, qs, L::kLdT, kNp);  // dK = dsb^T q
    __syncthreads();
    store_tile<D>(os, n, [&](int t) { return p.out + row(t) * C3 + C + head * D; });
    __syncthreads();
  }
  float* dst = p.dbias + ((size_t)chunk * p.nW * p.heads + (size_t)w * p.heads + head) * nn;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < nn) dst[e] = acc[i];
  }
}

// out[i] = sum over c of part[c * n + i], c in order.
__global__ void sum_chunks_kernel(const float* part, float* out, int chunks, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
    out[i] = s;
  }
}

struct HeadsParams {
  const bf16* q;      // (B, G, N, D)
  const bf16* k;
  const bf16* v;
  const float* bias;  // (G, N, N)
  bf16* out;          // (B, G, N, D)
  int G, N;
  float scale;
};

// W: one block per (b, g).
template <int D>
__global__ void __launch_bounds__(kThreads) heads_kernel(HeadsParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * p.N * D;
  const float* bmat = p.bias + (size_t)(blockIdx.x % p.G) * p.N * p.N;
  attend<D>(
      smem, p.N, p.scale, [&](int t) { return p.q + base + (size_t)t * D; },
      [&](int t) { return p.k + base + (size_t)t * D; },
      [&](int t) { return p.v + base + (size_t)t * D; },
      [&](int r, int c) { return bmat[r * p.N + c]; },
      [&](int t) { return p.out + base + (size_t)t * D; });
}

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, const Params& p) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool core_shape_ok(int B, int H, int W, int C, int heads, int ws, int shift) {
  return B >= 1 && heads >= 1 && ws >= 1 && ws * ws <= kNp && H % ws == 0 && W % ws == 0 &&
         H >= ws && W >= ws && C == kD * heads && shift >= 0 && shift < ws;
}

}  // namespace
}  // namespace mmrp

using namespace mmrp;

extern "C" {

// qkv (B, H, W, 3C) bf16; bias (nW, heads, ws^2, ws^2) f32; out (B, H, W, C) bf16.
int mmrp_wattn_core_fwd(const void* qkv, const void* bias, void* out, int B, int H, int W, int C,
                        int heads, int ws, int shift, float scale, void* stream) {
  if (!core_shape_ok(B, H, W, C, heads, ws, shift)) return (int)cudaErrorInvalidValue;
  CoreParams p{};
  p.qkv = static_cast<const bf16*>(qkv);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.B = B, p.H = H, p.W = W, p.C = C, p.heads = heads, p.ws = ws, p.shift = shift;
  p.nW = (H / ws) * (W / ws);
  p.scale = scale;
  const dim3 grid(B * p.nW, heads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch(core_fwd_kernel<kD>, grid, Smem<kD>::fwd, st, p);
}

// dout (B, H, W, C) bf16 -> dqkv (B, H, W, 3C) bf16 and dbias (nW, heads, N, N)
// f32. images_per_block images per backward block; with more than one chunk,
// partial is a (chunks, nW, heads, N, N) f32 scratch, else it may be null.
int mmrp_wattn_core_bwd(const void* qkv, const void* bias, const void* dout, void* dqkv,
                        void* dbias, void* partial, int B, int H, int W, int C, int heads,
                        int ws, int shift, int images_per_block, float scale, void* stream) {
  if (!core_shape_ok(B, H, W, C, heads, ws, shift) || images_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (B + images_per_block - 1) / images_per_block;
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  CoreParams p{};
  p.qkv = static_cast<const bf16*>(qkv);
  p.bias = static_cast<const float*>(bias);
  p.dout = static_cast<const bf16*>(dout);
  p.out = static_cast<bf16*>(dqkv);
  p.dbias = static_cast<float*>(chunks > 1 ? partial : dbias);
  p.B = B, p.H = H, p.W = W, p.C = C, p.heads = heads, p.ws = ws, p.shift = shift;
  p.nW = (H / ws) * (W / ws);
  p.bc = images_per_block;
  p.scale = scale;
  const dim3 grid(p.nW, heads, chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch(core_bwd_kernel<kD>, grid, Smem<kD>::bwd, st, p);
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const size_t n = (size_t)p.nW * heads * ws * ws * ws * ws;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  sum_chunks_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(partial),
                                                 static_cast<float*>(dbias), chunks, n);
  return (int)cudaGetLastError();
}

// q, k, v, out (B, G, N, D) bf16; bias2 (G, N, N) f32; N <= 64.
int mmrp_window_attention_heads(const void* q, const void* k, const void* v, const void* bias2,
                                void* out, int B, int G, int N, int D, float scale,
                                void* stream) {
  if (B < 1 || G < 1 || N < 1 || N > kNp || D != kD) return (int)cudaErrorInvalidValue;
  HeadsParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = static_cast<const float*>(bias2);
  p.out = static_cast<bf16*>(out);
  p.G = G, p.N = N, p.scale = scale;
  const dim3 grid(B * G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch(heads_kernel<kD>, grid, Smem<kD>::fwd, st, p);
}

}  // extern "C"
