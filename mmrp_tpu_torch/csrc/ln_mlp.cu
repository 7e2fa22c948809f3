// K2 — fused LayerNorm + MLP + residual for Hopper (sm_90a).
//
// Replaces mmrp_tpu/ops/fused_mlp.py:fused_ln_mlp_residual (Pallas _kernel /
// _pallas_impl, pallas_call at fused_mlp.py:181):
//   pre-LN  (Swin, fusion FFN): out = [x +] FC2(gelu_tanh(FC1(LN x)))
//   post-LN (BERT form):        out = LN(x + FC2(gelu_tanh(FC1 x)))
//
// What bounds it on the H100: the two GEMMs, 4 C Hd FLOPs per row: Swin stage
// 1 (C 128, Hd 512, B * 3136 rows) and the fusion FFN (C 1024, Hd 4096, B * 51
// rows), both the tensor cores'. The TPU kernel's point was that the 4C-wide
// hidden activation never goes to HBM; the same holds here. Design: one
// cluster of S blocks (one warpgroup each) per 64 rows, the MLP of
// mlp_sm90.cuh (wgmma, the hidden slice of each rank on chip, partial sums
// added across the cluster in rank order). Before it, each rank stages its
// 64 / S rows of x in shared memory (cp.async, all in flight at once),
// LayerNorms them in f32 (two passes) and writes bf16(LN x) to a scratch the
// wrapper gives, which FC1 streams back from L2 with the weights; the post-LN
// form streams x itself. After it, each rank adds b2 and the staged residual
// to its rows, or keeps x + FC2 + b2 in an f32 scratch and LayerNorms the
// rows there.
#include "mlp_sm90.cuh"

namespace mmrp {
// the anonymous namespace of the headers' helpers (one per translation unit)
namespace {

struct MlpParams {
  const bf16* x;      // (M, C)
  const float* ln_s;  // (C,)
  const float* ln_b;
  const bf16* w1;     // (Hd, C) nn.Linear weight
  const bf16* b1;     // (Hd,)
  const bf16* w2;     // (C, Hd)
  const bf16* b2;     // (C,)
  bf16* z;            // (M, C) scratch: bf16(LN x), pre-LN
  float* v;           // (M, C) scratch: x + FC2 + b2, post-LN
  bf16* out;          // (M, C)
  int M, C, Hd;
  float eps;
  int post_ln, residual;
};

// One warp LayerNorms one row of C <= 1024 values held 8 to a lane-piece:
// two passes in f32; returns the normalized values in v.
__device__ inline void ln_row(float (&v)[4][8], int C, const float* ln_s, const float* ln_b,
                              float eps) {
  const int lane = threadIdx.x & 31, pieces = C / 8;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[i][e];
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < pieces) {
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[i][e] - mean) * (v[i][e] - mean);
    }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c0 = (lane + 32 * i) * 8;
    if (c0 < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = (v[i][e] - mean) * rstd * ln_s[c0 + e] + ln_b[c0 + e];
    }
  }
}

// kPart: C % 128 != 0 (mlp_sm90.cuh::stream_tiles)
template <bool kPart>
__global__ void __launch_bounds__(kGemmThreads, 1) ln_mlp_kernel(MlpParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int S = (int)cgm::this_cluster().num_blocks(), rank = (int)cgm::this_cluster().block_rank();
  const int span = p.Hd / S;
  const int row0 = (blockIdx.x / S) * kTileM, rows = min(kTileM, p.M - row0);
  const int R = kTileM / S, r0 = rank * R, live = max(0, min(R, rows - r0));
  const MlpLayout L = mlp_layout(span, (size_t)R * p.C * 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, pieces = p.C / 8;
  // this rank's rows of x, for the LayerNorm and the residual
  const bf16* xs = reinterpret_cast<const bf16*>(base + L.rows);
  stage_rows(base + L.rows, reinterpret_cast<const unsigned char*>(p.x + (size_t)(row0 + r0) * p.C),
             (size_t)p.C * 2, live, p.C * 2);

  if (!p.post_ln) {  // this rank's rows of bf16(LN x), into the scratch FC1 reads
    for (int lr = warp; lr < live; lr += kGemmThreads / 32) {
      const bf16* xr = xs + (size_t)lr * p.C;
      float v[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pc = lane + 32 * i;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (pc < pieces) raw = *reinterpret_cast<const uint4*>(xr + pc * 8);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = to_f(xv[e]);
      }
      ln_row(v, p.C, p.ln_s, p.ln_b, p.eps);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pc = lane + 32 * i;
        if (pc < pieces) {
          __align__(16) bf16 b8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b8[e] = to_bf(v[i][e]);
          *reinterpret_cast<uint4*>(p.z + (size_t)(row0 + r0 + lr) * p.C + pc * 8) =
              *reinterpret_cast<uint4*>(b8);
        }
      }
    }
    cluster_or_block_sync(S);  // the tile's rows are in the scratch before any rank streams them
  }

  MlpTile t{};
  t.a = reinterpret_cast<const unsigned char*>((p.post_ln ? p.x : p.z) + (size_t)row0 * p.C);
  t.lda = (size_t)p.C * 2;
  t.rows = rows;
  t.w1 = reinterpret_cast<const unsigned char*>(p.w1);
  t.b1 = p.b1;
  t.w2 = reinterpret_cast<const unsigned char*>(p.w2);
  t.C = p.C;
  t.Hd = p.Hd;
  t.span = span;
  t.h0 = rank * span;
  mlp_tile<false, false, kPart>(t, base + L.h, base + L.ring, reinterpret_cast<float*>(base + L.red), S, rank,
                  [&](int r, int c, const float (&f)[4]) {
                    const size_t at = (size_t)(row0 + r) * p.C + c;
                    const uint2 xraw =
                        *reinterpret_cast<const uint2*>(xs + (size_t)(r - r0) * p.C + c);
                    const bf16* xv = reinterpret_cast<const bf16*>(&xraw);
                    if (p.post_ln) {
                      float4 o;
                      o.x = (to_f(xv[0]) + f[0]) + to_f(p.b2[c]);
                      o.y = (to_f(xv[1]) + f[1]) + to_f(p.b2[c + 1]);
                      o.z = (to_f(xv[2]) + f[2]) + to_f(p.b2[c + 2]);
                      o.w = (to_f(xv[3]) + f[3]) + to_f(p.b2[c + 3]);
                      *reinterpret_cast<float4*>(p.v + at) = o;
                      return;
                    }
                    __align__(8) bf16 o[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      const float y = f[e] + to_f(p.b2[c + e]);
                      o[e] = to_bf(p.residual ? to_f(xv[e]) + y : y);
                    }
                    *reinterpret_cast<uint2*>(p.out + at) = *reinterpret_cast<uint2*>(o);
                  });

  if (p.post_ln) {  // LN over this rank's rows of x + FC2 + b2 (all written by this block)
    __syncthreads();
    for (int r = r0 + warp; r < r0 + live; r += kGemmThreads / 32) {
      const float* vr = p.v + (size_t)(row0 + r) * p.C;
      float v[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pc = lane + 32 * i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
          if (pc < pieces) f = __ldcg(reinterpret_cast<const float4*>(vr + pc * 8 + 4 * h));
          v[i][4 * h] = f.x;
          v[i][4 * h + 1] = f.y;
          v[i][4 * h + 2] = f.z;
          v[i][4 * h + 3] = f.w;
        }
      }
      ln_row(v, p.C, p.ln_s, p.ln_b, p.eps);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pc = lane + 32 * i;
        if (pc < pieces) {
          __align__(16) bf16 b8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b8[e] = to_bf(v[i][e]);
          *reinterpret_cast<uint4*>(p.out + (size_t)(row0 + r) * p.C + pc * 8) =
              *reinterpret_cast<uint4*>(b8);
        }
      }
    }
  }
}

}  // namespace
}  // namespace mmrp

using namespace mmrp;

extern "C" {

// x (M, C) bf16; ln (C) f32; w1 (Hd, C), b1 (Hd), w2 (C, Hd), b2 (C) bf16;
// z (M, C) bf16 scratch (pre-LN), v (M, C) f32 scratch (post-LN), out (M, C).
// C % 16 == 0, C <= 1024; Hd a multiple of 128 that a cluster of at most 8
// splits into slices of at most 512 whose layout fits (mlp_cluster_size).
int mmrp_ln_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                const void* b1, const void* w2, const void* b2, void* z, void* v, void* out,
                int M, int C, int Hd, int post_ln, int include_residual, float eps,
                void* stream) {
  if (M < 1 || C < 16 || C % 16 || C > 8 * kTileN || Hd % kTileN)
    return (int)cudaErrorInvalidValue;
  MlpParams p{};
  p.x = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.z = static_cast<bf16*>(z);
  p.v = static_cast<float*>(v);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.C = C;
  p.Hd = Hd;
  p.eps = eps;
  p.post_ln = post_ln;
  p.residual = include_residual;
  if ((post_ln && !p.v) || (!post_ln && !p.z)) return (int)cudaErrorInvalidValue;
  const int row_tiles = (M + kTileM - 1) / kTileM;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int S = mlp_cluster_size(row_tiles, Hd, (size_t)C * 2, sms);
  if (!S) return (int)cudaErrorInvalidValue;
  const size_t smem = mlp_layout(Hd / S, (size_t)(kTileM / S) * C * 2).total;
  void (*kernel)(MlpParams) = &ln_mlp_kernel<false>;
  if (C % kTileN) kernel = &ln_mlp_kernel<true>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * S);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster size mlp_cluster_size picks for row_tiles tiles of 64 rows, a
// hidden width Hd and row_bytes staged per row (K2: 2 C, the Swin block's
// epilogue: 4 C) on sms SMs; 0: no fit. The tests hold the Python copy to it.
int mmrp_mlp_cluster(int row_tiles, int Hd, int row_bytes, int sms) {
  return mlp_cluster_size(row_tiles, Hd, (size_t)row_bytes, sms);
}

}  // extern "C"
