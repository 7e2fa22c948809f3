// A 64 x 128 tile GEMM for Hopper (sm_90a) on warpgroup MMA (wgmma): the
// projections of K3 (seq_attention.cu), bf16 and W8A8, and the layout and
// instructions of the Swin attention half (attention.cuh) and the MLP half
// (mlp_sm90.cuh).
//
// One warpgroup (128 threads) owns a 64-row block of the GEMM input, staged
// once in shared memory by cp.async (then LayerNorm'ed, added to pos or
// quantized there in place by stage_a), and walks the K dimension of one or
// more 128-row blocks of nn.Linear weights through a ring of kStages
// shared-memory tiles that cp.async keeps two chunks ahead of the tensor
// cores, one group of wgmma in flight behind them. The sums stay in
// registers (f32 for bf16, s32 for int8) until the caller's epilogue.
//
// Shared-memory layout (both operands K-major, as wgmma's 128-byte swizzle
// wants them): a "chunk" is 128 bytes of K (64 bf16 or 128 int8) by R rows,
// row r at r * 128 bytes, its 16-byte piece j at piece j ^ (r % 8); 8-row
// groups are 1024 bytes apart (the descriptor's stride), and every chunk
// starts on a 1024-byte boundary. A wgmma k-step reads 32 bytes of a chunk
// (16 bf16 or 32 int8), so the two element types share the layout, the ring
// and the descriptors, and differ only in the instruction.
//
// The copies are cp.async (16 bytes a thread) rather than TMA: no tensor map
// has to be encoded through the driver API, and the library stays a plain
// runtime-API object that nvcc links without -lcuda.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mmrp {
namespace {  // internal linkage, as attention.cuh

constexpr int kGemmThreads = 128;            // one warpgroup
constexpr int kTileM = 64, kTileN = 128;     // rows of A and of the weights per block
constexpr int kStages = 4;                   // weight chunks in the ring
constexpr int kChunkA = kTileM * 128;        // bytes of one A chunk (8 KB)
constexpr int kChunkW = kTileN * 128;        // bytes of one weight chunk (16 KB)
constexpr int kMaxRowChunks = 4;             // 8-element pieces a lane stages per row: C <= 1024

// Byte offset of byte `byte` of row r in a chunked, swizzled tile of R rows
// whose chunks are chunk_bytes apart.
__device__ __forceinline__ uint32_t swz(int r, int byte, int chunk_bytes) {
  const int kc = byte >> 7, w = byte & 127;
  return (uint32_t)(kc * chunk_bytes + r * 128 + ((((w >> 4) ^ (r & 7))) << 4) + (w & 15));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 1024 bytes
// between 8-row groups (the leading offset is unused in this mode).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// generic-proxy writes (st.shared, cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the async MMA
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define MMRP_WG_F(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MMRP_WG_R(i)                                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define MMRP_WG_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (f32) += A[64 x 16] . B[16 x 128], both bf16 from shared memory.
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MMRP_WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MMRP_WG_F(0), MMRP_WG_F(8), MMRP_WG_F(16), MMRP_WG_F(24), MMRP_WG_F(32), MMRP_WG_F(40),
        MMRP_WG_F(48), MMRP_WG_F(56)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] (s32) += A[64 x 32] . B[32 x 128], both int8 from shared memory.
__device__ __forceinline__ void wgmma_tile(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " MMRP_WG_D64 ", %64, %65, p;\n}\n"
      : MMRP_WG_R(0), MMRP_WG_R(8), MMRP_WG_R(16), MMRP_WG_R(24), MMRP_WG_R(32), MMRP_WG_R(40),
        MMRP_WG_R(48), MMRP_WG_R(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef MMRP_WG_F
#undef MMRP_WG_R
#undef MMRP_WG_D64

// Weight chunk kc (bytes [128 kc, 128 kc + 128) of 128 rows, ldw bytes apart)
// into ring slot dst; 8 16-byte copies a thread.
__device__ __forceinline__ void load_w_chunk(uint32_t dst, const unsigned char* w, size_t ldw,
                                             int kc) {
#pragma unroll
  for (int j = 0; j < kChunkW / 16 / kGemmThreads; ++j) {
    const int i = threadIdx.x + j * kGemmThreads, n = i >> 3, piece = i & 7;
    cp_async16(dst + n * 128 + ((piece ^ (n & 7)) << 4), w + (size_t)n * ldw + kc * 128 + piece * 16);
  }
}

// Weight chunks 0 .. kStages - 3 in flight, one cp.async group each. The
// main loop keeps kStages - 2 chunks ahead of the one it multiplies, and one
// group of wgmma in flight, so a ring slot is refilled two chunks after its
// products were issued and one after they were waited for.
__device__ __forceinline__ void gemm_prologue(uint32_t ring, const unsigned char* w, size_t ldw,
                                              int kchunks) {
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < kchunks) load_w_chunk(ring + s * kChunkW, w, ldw, s);
    cp_async_commit();
  }
}

using RowAffine = float[kMaxRowChunks][8];  // a lane's share of a LayerNorm affine

// The LayerNorm scale (or bias) of the pieces a lane rewrites in transform_row
// (lane + 32 i), loaded once a warp; 32-byte aligned f32 (C,).
__device__ inline void load_affine(RowAffine& g, const float* src, int C) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int c0 = (lane + 32 * i) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (c0 < C) {
      lo = *reinterpret_cast<const float4*>(src + c0);
      hi = *reinterpret_cast<const float4*>(src + c0 + 4);
    }
    g[i][0] = lo.x, g[i][1] = lo.y, g[i][2] = lo.z, g[i][3] = lo.w;
    g[i][4] = hi.x, g[i][5] = hi.y, g[i][6] = hi.z, g[i][7] = hi.w;
  }
}

// One row of the staged block, rewritten in place by one warp: the bf16 row
// (already in A) [+ the pos row p], LayerNorm'ed in f32 with the affine gs, gb
// (load_affine) and rounded to bf16 when ln (K3's x + pos and LN(x + pos), as
// the TPU kernel casts them); with Q8 quantized per row, int8 = rint(v / s),
// s = max(amax, 1e-8) / 127 (rs[r] <- s), as _qdot's activations are. The
// int8 row keeps the bf16 row's footprint (piece j of 16 bytes of bf16 at the
// address of bytes [16 j, 16 j + 16); int8 byte c at the address of byte c),
// so every lane reads its whole row before any lane writes.
template <bool Q8>
__device__ inline void transform_row(unsigned char* a, float* rs, int r, int C, const bf16* p,
                                     const RowAffine& gs, const RowAffine& gb, float eps,
                                     bool ln) {
  const int lane = threadIdx.x & 31, pieces = C / 8;
  float v[kMaxRowChunks][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxRowChunks; ++i) {
    const int pc = lane + 32 * i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u), praw = raw;
    if (pc < pieces) {
      raw = *reinterpret_cast<const uint4*>(a + swz(r, pc * 16, kChunkA));
      if (p) praw = *reinterpret_cast<const uint4*>(p + pc * 8);
    }
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    const bf16* pv = reinterpret_cast<const bf16*>(&praw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[i][e] = p ? to_f(to_bf(to_f(xv[e]) + to_f(pv[e]))) : to_f(xv[e]);
      sum += v[i][e];
    }
  }
  if (ln) {  // two-pass statistics over the row, as row_stats
    const float mean = warp_sum(sum) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i)
      if (lane + 32 * i < pieces) {
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (v[i][e] - mean) * (v[i][e] - mean);
      }
    const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      const int c0 = (lane + 32 * i) * 8;
      if (c0 < C) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[i][e] = to_f(to_bf((v[i][e] - mean) * rstd * gs[i][e] + gb[i][e]));
      }
    }
  }
  __syncwarp();  // the whole row is in registers before it is overwritten
  if (Q8) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[i][e]));
    const float sc = fmaxf(warp_max(m), 1e-8f) / 127.f;
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      const int pc = lane + 32 * i;
      if (pc < pieces) {
        __align__(8) signed char q8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) q8[e] = quant1(v[i][e], sc, 0.f);
        *reinterpret_cast<uint2*>(a + swz(r, pc * 8, kChunkA)) = *reinterpret_cast<uint2*>(q8);
      }
    }
    if (lane == 0) rs[r] = sc;
  } else {
#pragma unroll
    for (int i = 0; i < kMaxRowChunks; ++i) {
      const int pc = lane + 32 * i;
      if (pc < pieces) {
        __align__(16) bf16 b8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) b8[e] = to_bf(v[i][e]);
        *reinterpret_cast<uint4*>(a + swz(r, pc * 16, kChunkA)) = *reinterpret_cast<uint4*>(b8);
      }
    }
  }
}

// The 64-row block of A staged once, and the first weight chunks of the
// block's first column tile put in flight. Row r < rows is copied raw from
// src(r) with cp.async (bf16, 16 bytes a thread, every copy of the block in
// flight at once); rows >= rows are 0. Where the rows need a pass (pos(r)
// added, ln, or Q8), each warp then rewrites its rows in place
// (transform_row). The pos rows are staged too, 32 at a time, in the weight
// ring, whose chunks are then put in flight after the pass; otherwise they
// are put in flight before it. C % 128 == 0, C <= 32 * 8 * kMaxRowChunks.
template <bool Q8, typename Src, typename Pos>
__device__ inline void stage_a(unsigned char* a, unsigned char* ring, float* rs, int rows, int C,
                               Src src, Pos pos, bool has_pos, const float* ln_s,
                               const float* ln_b, float eps, bool ln, const unsigned char* w,
                               size_t ldw, int kchunks) {
  const int warp = threadIdx.x >> 5, pieces = C / 8;
  RowAffine gs, gb;
  if (ln) {
    load_affine(gs, ln_s, C);
    load_affine(gb, ln_b, C);
  }
  for (int i = threadIdx.x; i < kTileM * pieces; i += kGemmThreads) {
    const int r = i / pieces, pc = i % pieces;
    unsigned char* dst = a + swz(r, pc * 16, kChunkA);
    if (r < rows)
      cp_async16(smem_u32(dst), src(r) + pc * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  if (!has_pos) {
    gemm_prologue(smem_u32(ring), w, ldw, kchunks);
    if (!(ln || Q8)) return;  // A is used as copied; the main loop waits for it
    cp_async_wait<kStages - 2>();  // the rows, not the weights
    __syncthreads();
    for (int r = warp; r < rows; r += kGemmThreads / 32)
      transform_row<Q8>(a, rs, r, C, nullptr, gs, gb, eps, ln);
    return;
  }
  constexpr int kHalf = kTileM / 2;
  for (int r0 = 0; r0 < rows; r0 += kHalf) {
    const int n = min(kHalf, rows - r0);
    for (int i = threadIdx.x; i < n * pieces; i += kGemmThreads) {
      const int r = i / pieces, pc = i % pieces;
      cp_async16(smem_u32(ring + (size_t)r * C * 2 + pc * 16), pos(r0 + r) + pc * 8);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = r0 + warp; r < r0 + n; r += kGemmThreads / 32)
      transform_row<Q8>(a, rs, r, C,
                        reinterpret_cast<const bf16*>(ring + (size_t)(r - r0) * C * 2), gs, gb,
                        eps, ln);
    __syncthreads();  // the pos rows are read before the ring is refilled
  }
  gemm_prologue(smem_u32(ring), w, ldw, kchunks);
}

// acc[64 x 128] = A (staged, chunks at a) . W^T over kchunks chunks of K, the
// weights' chunks streamed through the ring (gemm_prologue issued first, and
// no cp.async group committed after it but A's own). Fragment of thread t
// (warp w = t / 32, lane l): acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h,
// column 8 j + 2 (l % 4) + e. Ends with every copy and product complete.
template <typename Acc>
__device__ inline void gemm_mainloop(Acc (&acc)[64], uint32_t a, uint32_t ring,
                                     const unsigned char* w, size_t ldw, int kchunks) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fence_regs(acc);
  for (int kc = 0; kc < kchunks; ++kc) {
    cp_async_wait<kStages - 3>();  // this thread's copies of chunk kc (and of A) have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; chunk kc - 2's products are complete
    const int next = kc + kStages - 2;
    if (next < kchunks) load_w_chunk(ring + (next % kStages) * kChunkW, w, ldw, next);
    cp_async_commit();
    const uint32_t wa = a + kc * kChunkA, wb = ring + (kc % kStages) * kChunkW;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_tile(acc, wgmma_desc(wa + ks * 32), wgmma_desc(wb + ks * 32));
    wgmma_commit();
    wgmma_wait<1>();  // chunk kc - 1's products are complete; chunk kc's may run on
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before a next tile refills it
}

// Dynamic shared memory of a GEMM block: A (64 x C bf16, also holding the
// int8 form), the ring, 64 row scales and `extra` bytes, from a 1024-aligned
// base.
__host__ __device__ inline size_t gemm_smem(int C, size_t extra) {
  return 1024 + (size_t)C * 2 / 128 * kChunkA + (size_t)kStages * kChunkW +
         kTileM * sizeof(float) + extra;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

}  // namespace
}  // namespace mmrp
