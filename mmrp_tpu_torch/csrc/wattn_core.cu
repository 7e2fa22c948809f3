// C-F / C-B — the raw-layout Swin window-attention core, forward and backward,
// and W — head-major window attention, for Hopper (sm_90a).
//
// C-F (core_fwd_ring) replaces mmrp_tpu/ops/wattn_core.py:_fwd_kernel
// (window_attention_core's forward, pallas_call at :260): on the raw
// (B, H, W, 3C) qkv map, per 7x7 window of the map rolled by -shift and per
// head, out = softmax(q k^T * scale + bias[w, h]) v, written back to the rows
// the roll by +shift puts them in. C-B (core_bwd_ring) replaces _bwd_kernel
// (pallas_call at :283): it recomputes P from the saved qkv and returns dqkv
// in the raw layout and dbias[w, h] = sum over images of dS (unscaled, f32).
// W (heads_kernel) replaces mmrp_tpu/ops/window_attention.py:_wattn_kernel
// (window_attention_pallas): the same per-window softmax attention on
// head-major (B, G, N, d) q/k/v with a (G, N, N) additive bias, on K3's
// attention tile (attn_tile.cuh: scores and softmax in registers, the bias
// tile read once per head-window).
//
// What bounds C-F and C-B on the H100: bytes. C-F reads 3C and writes C bf16
// per token, C-B reads 3C + C and writes 3C. Per window and head the work is
// two (backward: five) 64 x 64 x 32 products, ~10 FLOPs per byte, far below
// the ~295 at which the tensor cores would be the limit. Measured, the first
// limit is the SM's own issue of copies, address arithmetic, softmax and
// barriers, so the design keeps copies in flight behind compute and blocks
// independent of each other:
//   - a block is one warpgroup on one head, its 64-row tile 16 query rows a
//     warp, and 4 blocks share an SM; a work item is (image, window, head).
//     A head's row of q, k, v (and dO) is 64 contiguous bytes, gathered at
//     its rolled position (the divisions of common.cuh::map_row taken once a
//     thread) by cp.async, 16 bytes a thread, into a ring of 3 (C-F) or 2
//     (C-B) stages: the next items' rows are in flight while one computes.
//     (A block of four warpgroups on a head group's 256-byte rows moved in
//     lockstep through its barriers and measured slower; 64-byte pieces cost
//     nothing against 256-byte rows. Per-row bulk copies were slower to
//     issue than cp.async.) Results are staged in the warp's own rows of a
//     free tile and written back as 64-byte rows: no rolled or partitioned
//     copy of the map exists in either direction;
//   - tiles are compact: the window's rows only, 64 bytes each, 16-byte
//     chunks swizzled against bank conflicts; rows past the window read one
//     zero row. That leaves room for four blocks an SM and the bias in
//     shared memory;
//   - the products are mma.sync m16n8k16 bf16 with f32 sums, on 7 key tiles
//     of 8 for a 7 x 7 window. Both kernels share S = q k^T and P =
//     softmax(S scale + bias) in registers, in f32, normalized, then rounded
//     to bf16 as the plain version rounds it (the attention tile's `only`
//     step of attn_tile.cuh, with ex2 for exp). C-F's context P.V takes P as
//     its A operand from registers. C-F walks (window, head) runs of images
//     with the head's bias in shared memory;
//   - C-B keeps dP and dS in registers too: dS = P (dP - rowsum(dP P)),
//     dQ = bf16(dS scale) k with dS as the A operand. dV = bf16(P)^T dO and
//     dK = bf16(dS scale)^T q sum over all 64 query rows: bf16 P and dS
//     scale are staged in two 64 x 64 tiles, read transposed by
//     ldmatrix.trans after one barrier. The rounding points are the TPU
//     kernels': P and dS scale rounded to bf16 before their products, dbias
//     summed from the unrounded f32 dS;
//   - dbias sums dS over the images, with no float atomics (the same bits
//     every run) and no scratch in device memory: the blocks of one (window,
//     head) form a cluster of up to 8 ranks, each walking a run of images
//     with its dS sums in registers (fixed ownership, images in order); at
//     the end the ranks add the partials in rank order through distributed
//     shared memory, each rank a slice of dbias, in one launch. The host asks
//     the card how many clusters of each size it holds at once and takes the
//     ranks with the fewest waves (core_plan).
// Head dim 32 only (every Swin-B, -T and -S stage), windows of at most 64
// tokens.
#include <cooperative_groups.h>

#include "attn_tile.cuh"

namespace mmrp {
// the same anonymous namespace as attn_tile.cuh's: a second one at global
// scope makes the kernel registration stub's namespace name ambiguous
namespace {

namespace cgc = cooperative_groups;

constexpr int kD = 32;                            // head dim
constexpr int kCoreThreads = 128;                 // one warpgroup: a head's 64-row tile
constexpr int kBlocksPerSm = 4;                   // 4 x 128 threads x 128 registers
constexpr int kLdP = kTileRows + 8;               // C-B's P and dS tiles: 64 x 64 bf16
constexpr int kPElems = kTileRows * kLdP;
constexpr int kFwdStages = 3, kBwdStages = 2;     // ring stages
constexpr int kMaxRanks = 8;                      // portable cluster size
constexpr int kMaxN7 = 49;                        // the largest window (ws^2) on 7 key tiles
constexpr size_t kZeroRow = 128;                  // the row that rows past the window read
constexpr size_t kPartBytes = (size_t)kTileRows * kTileRows * sizeof(float);  // dbias sums
// shared memory a block may take for kBlocksPerSm of them to fit an SM (228 KB,
// less 1 KB the system keeps a block)
constexpr size_t kBlockSmem = 233472 / kBlocksPerSm - 1024;

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of a block for windows of n tokens. Both kernels keep a ring
// of compact head tiles (the window's n rows only, 64 bytes each, the 16-byte
// chunk c of row r at c ^ ((r >> 1) & 3), so that ldmatrix's 8 rows hit 8
// distinct bank groups; rows past n read the zero row) and the zero row. C-F:
// a ring of q, k, v, then the head's bias [n][n] f32. C-B: a ring of q, k, v,
// dO, the P and dS tiles and, where n <= kMaxN7, the bias (else it is read
// from device memory); the dbias sums reuse it all at the end.
__host__ __device__ constexpr size_t fwd_smem(int n) {
  return (size_t)kFwdStages * 3 * n * kD * sizeof(bf16) + kZeroRow +
         (size_t)n * n * sizeof(float);
}
__host__ __device__ constexpr size_t bwd_ring(int n) {
  return (size_t)kBwdStages * 4 * n * kD * sizeof(bf16);
}
__host__ __device__ constexpr size_t bwd_smem(int n) {
  return cmax(bwd_ring(n) + 2 * kPElems * sizeof(bf16) + kZeroRow +
                  (n <= kMaxN7 ? (size_t)n * n * sizeof(float) : 0),
              kPartBytes);
}
static_assert(fwd_smem(kTileRows) <= kBlockSmem && bwd_smem(kMaxN7) <= kBlockSmem &&
                  bwd_smem(kTileRows) <= kBlockSmem,
              "kBlocksPerSm blocks share an SM at every window size");

// The grids of one call (ops/wattn_core.py::core_plan is the copy). pairs =
// nW x heads. C-F: the B x pairs items, walked by fwd_blocks persistent blocks
// (kBlocksPerSm an SM), block k the items [k items / fwd_blocks, (k + 1) items
// / fwd_blocks). C-B: a cluster of `ranks` blocks per pair, rank q the images
// [q per_rank, min(B, (q + 1) per_rank)). fit[r - 1]: clusters of r blocks the
// card holds at once; the ranks are those (1 to 8, at most B) with the fewest
// waves of clusters x images a rank, the fewest ranks among equals.
struct CorePlan {
  int pairs, fwd_blocks, ranks, per_rank;
};

inline CorePlan core_plan(int B, int nW, int heads, int sms, const int* fit) {
  CorePlan c;
  c.pairs = nW * heads;
  const long long items = (long long)B * c.pairs;
  const long long slots = (long long)kBlocksPerSm * (sms > 1 ? sms : 1);
  c.fwd_blocks = (int)(items < slots ? items : slots);
  long long best = -1;
  c.ranks = 1;
  for (int R = 1; fit && R <= kMaxRanks && R <= B; ++R) {
    if (fit[R - 1] < 1) continue;
    const long long cost =
        (long long)((c.pairs + fit[R - 1] - 1) / fit[R - 1]) * ((B + R - 1) / R);
    if (best < 0 || cost < best) best = cost, c.ranks = R;
  }
  c.per_rank = (B + c.ranks - 1) / c.ranks;
  return c;
}

struct CoreParams {
  const bf16* qkv;    // (B, H, W, 3C), [q | k | v], heads contiguous in each
  const float* bias;  // (nW, heads, n, n)
  const bf16* dout;   // (B, H, W, C), backward only
  bf16* out;          // forward: (B, H, W, C); backward: dqkv (B, H, W, 3C)
  float* dbias;       // backward: (nW, heads, n, n)
  int B, H, W, C, heads, ws, shift, nW, n, ranks, per_rank;
  float scale;
};

// Where a thread's rows of a window lie in the map (common.cuh::map_row with
// the divisions taken once): token t of the window at (di, dj) = (t / ws,
// t % ws) from its origin, the window's corner rolled by -shift; a row wraps
// at most once.
struct WinRow {
  int di, dj;
};
__device__ inline WinRow win_row(const CoreParams& p, int t) { return {t / p.ws, t % p.ws}; }

struct Origin {
  size_t img;  // the image's first row
  int i0, j0;
};
__device__ inline Origin origin_of(const CoreParams& p, int b, int w) {
  const int nWw = p.W / p.ws;
  return {(size_t)b * p.H * p.W, (w / nWw) * p.ws + p.shift, (w % nWw) * p.ws + p.shift};
}

// The forward's items in order, (image b, pair = window x heads + head) of
// item j, one item at a time: the divisions once a block and once a pair.
struct ItemCursor {
  int b, pair;
  Origin o;
  __device__ ItemCursor(const CoreParams& p, int item) : b(item % p.B) { to_pair(p, item / p.B); }
  __device__ void to_pair(const CoreParams& p, int pr) {
    pair = pr;
    o = origin_of(p, b, pr / p.heads);
  }
  __device__ void next(const CoreParams& p) {
    if (++b < p.B) {
      o.img += (size_t)p.H * p.W;
    } else {
      b = 0;
      to_pair(p, pair + 1);
    }
  }
};

__device__ inline size_t map_at(const CoreParams& p, const Origin& o, const WinRow& r) {
  int i = o.i0 + r.di, j = o.j0 + r.dj;
  if (i >= p.H) i -= p.H;
  if (j >= p.W) j -= p.W;
  return o.img + (size_t)i * p.W + j;
}

// A block's pipeline: item j's rows land in stage j % kStages while items
// j + 1 .. j + kStages - 1 are in flight (cp.async, each thread its own
// 16-byte pieces). fetch(j, stage) issues item j's copies; body(j, stage)
// computes item j and writes its results.
template <int kStages, typename Fetch, typename Body>
__device__ inline void ring_walk(int count, Fetch fetch, Body body) {
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < count) fetch(j, j);
    cp_async_commit();
  }
  for (int j = 0; j < count; ++j) {
    if (j + kStages - 1 < count) fetch(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // item j's group of copies has landed
    __syncthreads();
    body(j, j % kStages);
    __syncthreads();  // the stage is read out before it is refilled
  }
  cp_async_wait<0>();
}

// A compact head tile: rows < n, swizzled chunks; rows >= n read the zero row.
struct CTile {
  const bf16* base;
  const bf16* zero;
  int n;
  __device__ static int at(int r, int c) { return r * kD + ((c ^ ((r >> 1) & 3)) << 3); }
};

// A window's rows of kParts head tiles (q, k, v from qkv, then dO) of one
// image into a ring stage by cp.async: thread i copies 16-byte piece i % 4
// of rows i / 4 and i / 4 + 32 (lr: those rows' places in the window).
template <int kParts>
__device__ inline void load_rows(bf16* stage, const CoreParams& p, const Origin& o, int head,
                                 const WinRow (&lr)[2]) {
  const int piece = threadIdx.x % 4, t0 = threadIdx.x / 4, tile = p.n * kD;
  const size_t C3 = 3 * (size_t)p.C, col = (size_t)head * kD + piece * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 32 * h;
    if (t >= p.n) continue;
    const size_t row = map_at(p, o, lr[h]);
    const bf16* src[4] = {p.qkv + row * C3 + col, p.qkv + row * C3 + p.C + col,
                          p.qkv + row * C3 + 2 * p.C + col, p.dout + row * p.C + col};
#pragma unroll
    for (int part = 0; part < kParts; ++part)
      cp_async16(smem_u32(stage + part * tile + CTile::at(t, piece)), src[part]);
  }
}

// The warp of a block (one warpgroup): tile rows [16 w, 16 w + 16).
__device__ inline int warp_id() { return threadIdx.x >> 5; }

// This thread's rows of a warp's 16-row fragment: r0 = 16 warp + g and r0 + 8.
__device__ inline int frag_row() { return warp_id() * 16 + ((threadIdx.x & 31) >> 2); }

// Row offsets (elements of dst) of this thread's fragment rows, -1 past n.
__device__ inline void frag_offsets(long long (&off)[2], const CoreParams& p, const Origin& o,
                                    const WinRow (&fr)[2], int ld) {
  const int r0 = frag_row();
#pragma unroll
  for (int h = 0; h < 2; ++h) off[h] = r0 + 8 * h < p.n ? (long long)map_at(p, o, fr[h]) * ld : -1;
}

// This warp's 16 x 32 f32 fragment (rows r0, r0 + 8; columns 8 j + 2 t) to
// the map in bf16, row h at dst + off[h] (none where off is -1, past n): staged
// in the warp's own rows of a tile, then written as whole 64-byte rows, a
// 16-byte piece a lane. Only this warp reads or writes those rows meanwhile.
__device__ inline void write_rows(bf16* dst, const long long (&off)[2], const float (&f)[4][4],
                                  bf16* tile) {
  const int lane = threadIdx.x & 31, r0 = frag_row(), c = 2 * (lane & 3);
  __syncwarp();  // the warp is done with those rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (off[h] < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tile + CTile::at(r0 + 8 * h, j) + c) =
          __floats2bfloat162_rn(f[j][2 * h], f[j][2 * h + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (off[h] >= 0)
      *reinterpret_cast<uint4*>(dst + off[h] + (lane & 3) * 8) =
          *reinterpret_cast<const uint4*>(tile + CTile::at(r0 + 8 * h, lane & 3));
}

// One head's bias [n][n] f32 into shared memory.
__device__ inline void load_bias(float* dst, const CoreParams& p, int pair) {
  const int nn = p.n * p.n;
  const float* src = p.bias + (size_t)pair * nn;  // pair = w heads + head
  for (int i = threadIdx.x; i < nn; i += kCoreThreads) dst[i] = __ldg(src + i);
}

// A lane's ldmatrix addresses into a compact tile: rows r + 16 k (k = 0..3),
// 16-byte chunks c + 2 kk (kk = 0, 1). A row block of 16 keeps the swizzle,
// and chunk c + 2 is chunk c's address +-32 bytes, so an address is one add
// (or the zero row, past n).
struct LaneRows {
  uint32_t a0, zero;  // shared addresses of (r, c) and of the zero row
  int d, lim;         // +-32; n - r
  __device__ LaneRows(const CTile& x, int r, int c) {
    const int sw = (r >> 1) & 3;
    a0 = smem_u32(x.base) + r * kD * (int)sizeof(bf16) + ((c ^ sw) << 4);
    zero = smem_u32(x.zero);
    d = sw & 2 ? -32 : 32;
    lim = x.n - r;
  }
  __device__ uint32_t at(int k, int kk) const {
    return 16 * k < lim ? a0 + k * 16 * kD * (int)sizeof(bf16) + kk * d : zero;
  }
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A fragments (16 x 32) of this warp's 16 rows of a tile.
__device__ inline void load_a(uint32_t (&a)[2][4], const CTile& x) {
  const int lane = threadIdx.x & 31;
  const LaneRows l(x, (lane & 15), lane >> 4);
  ldsm4(a[0], l.at(warp_id(), 0));
  ldsm4(a[1], l.at(warp_id(), 1));
}

// s (16 x 8 kJ a warp) += A (16 x 32, fragments a) . X^T (the key index of s
// is X's row; keys past 8 kJ are not computed: for kJ odd, the last load's
// second 8 rows are past the window and go unused).
template <int kJ>
__device__ inline void mma_abt(float (&s)[kJ][4], const uint32_t (&a)[2][4], const CTile& x) {
  const int lane = threadIdx.x & 31;
  const LaneRows l(x, (lane & 7) + (lane >> 4) * 8, (lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int np = 0; np < (kJ + 1) / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, l.at(np, kk));
      mma16816(s[2 * np], a[kk], b[0], b[1]);
      if (2 * np + 1 < kJ) mma16816(s[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// o (16 x 32) += A . X for k-step kk: A the 16 x 16 fragment a (columns
// 16 kk ..), X rows 16 kk .. of a tile, by ldmatrix.trans; l: the lane's rows
// of X (mma_ab_rows).
__device__ inline void mma_ab_step(float (&o)[4][4], const uint32_t (&a)[4], const LaneRows& l,
                                   int kk) {
#pragma unroll
  for (int dp = 0; dp < 2; ++dp) {
    uint32_t b[4];
    ldsm4_t(b, l.at(kk, dp));
    mma16816(o[2 * dp], a, b[0], b[1]);
    mma16816(o[2 * dp + 1], a, b[2], b[3]);
  }
}
__device__ inline LaneRows mma_ab_rows(const CTile& x) {
  const int lane = threadIdx.x & 31;
  return LaneRows(x, (lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4);
}

// o (16 x 32: this warp's 16 keys) = Y^T . X, Y the block's 64 x 64 bf16
// P / dS tile (rows: queries, columns: keys), X a tile (rows: queries): A =
// Y^T by ldmatrix.trans.
__device__ inline void mma_atb(float (&o)[4][4], const bf16* y, const CTile& x) {
  const int lane = threadIdx.x & 31;
  const bf16* col =
      y + ((lane & 7) + ((lane >> 4) & 1) * 8) * kLdP + warp_id() * 16 + ((lane >> 3) & 1) * 8;
  const LaneRows l = mma_ab_rows(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    ldsm_x4_t(a, col + kk * 16 * kLdP);
    mma_ab_step(o, a, l, kk);
  }
}

// e^x for x <= 0 (0 at -inf) by ex2.approx of x log2(e): within 2^-21 of
// expf, far inside the bf16 rounding of P that follows.
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// S = q k^T of this warp's 16 rows, then in place P = softmax(S scale + bias)
// in f32, normalized (e times the reciprocal of the row's sum, within 2 f32
// ulps of the quotient); rows >= n: 0. bh: the head's (n, n) bias.
template <int kJ>
__device__ inline void softmax_rows(float (&s)[kJ][4], const CTile& qs, const CTile& ks,
                                    const float* bh, float scale) {
  const int n = qs.n, t = threadIdx.x & 3, r0 = frag_row();
  {
    uint32_t qf[2][4];
    load_a(qf, qs);
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<kJ>(s, qf, ks);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 8 * j + 2 * t + (i & 1), r = r0 + 8 * (i >> 1);
      const float add = r < n && key < n ? bh[r * n + key] : 0.f;
      s[j][i] = key < n ? __fadd_rn(__fmul_rn(s[j][i], scale), add) : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = exp_neg(s[j][i] - mx[i >> 1]);  // 0 past n
      sum[i >> 1] += s[j][i];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sum[h] = r0 + 8 * h < n ? __frcp_rn(sum[h]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = __fmul_rn(s[j][i], sum[i >> 1]);
}

// The A fragments of bf16(x) (16 rows x 8 kJ keys) for the 16-key k-steps of
// a product, zero past the kJ key tiles.
template <int kJ>
__device__ inline void a_fragments(uint32_t (&a)[(kJ + 1) / 2][4], const float (&x)[kJ][4]) {
#pragma unroll
  for (int kk = 0; kk < (kJ + 1) / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = 2 * kk + 1 < kJ ? pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]) : 0u;
    a[kk][3] = 2 * kk + 1 < kJ ? pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]) : 0u;
  }
}

// o (16 x 32) = A . X over the kJ key tiles: A from a_fragments, X a tile
// (rows: keys).
template <int kJ>
__device__ inline void mma_ab(float (&o)[4][4], const uint32_t (&a)[(kJ + 1) / 2][4],
                              const CTile& x) {
  const LaneRows l = mma_ab_rows(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < (kJ + 1) / 2; ++kk) mma_ab_step(o, a[kk], l, kk);
}

// C-F: persistent blocks, kBlocksPerSm an SM, each over its run of items:
// (window, head) pairs, images inside, so a run keeps one head's bias in
// shared memory. Per item: S, P (normalized, then rounded to bf16 as the plain
// version rounds it) and the context P.V in registers, the context staged in
// the warp's own q rows and written as 64-byte rows. kJ: 8-key tiles that
// hold the n keys.
template <int kJ>
__global__ void __launch_bounds__(kCoreThreads, kBlocksPerSm) core_fwd_ring(CoreParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = p.n, tile = n * kD, stage_elems = 3 * tile;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  unsigned char* after = smem + (size_t)kFwdStages * stage_elems * sizeof(bf16);
  const bf16* zero = reinterpret_cast<const bf16*>(after);
  float* bias = reinterpret_cast<float*>(after + kZeroRow);
  const long long items = (long long)p.B * p.nW * p.heads;
  const int first = (int)(blockIdx.x * items / gridDim.x);
  const int count = (int)((blockIdx.x + 1) * items / gridDim.x) - first;
  const WinRow lr[2] = {win_row(p, threadIdx.x / 4), win_row(p, threadIdx.x / 4 + 32)};
  const WinRow fr[2] = {win_row(p, frag_row()), win_row(p, frag_row() + 8)};
  if (threadIdx.x < kZeroRow / 16)
    reinterpret_cast<uint4*>(after)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  int pair = -1;  // whose bias is in shared memory
  ItemCursor fc(p, first), bc(p, first);  // the next item to fetch, to compute
  ring_walk<kFwdStages>(
      count,
      [&](int, int s) {
        load_rows<3>(ring + s * stage_elems, p, fc.o, fc.pair % p.heads, lr);
        fc.next(p);
      },
      [&](int, int s) {
        if (bc.pair != pair) {  // the same for every thread of the block
          pair = bc.pair;
          load_bias(bias, p, pair);
          __syncthreads();
        }
        bf16* q = ring + s * stage_elems;
        float sp[kJ][4];
        softmax_rows<kJ>(sp, CTile{q, zero, n}, CTile{q + tile, zero, n}, bias, p.scale);
        uint32_t pa[(kJ + 1) / 2][4];
        a_fragments<kJ>(pa, sp);
        float o[4][4];
        mma_ab<kJ>(o, pa, CTile{q + 2 * tile, zero, n});  // P.V
        long long off[2];
        frag_offsets(off, p, bc.o, fr, p.C);
        write_rows(p.out + (pair % p.heads) * kD, off, o, q);
        bc.next(p);
      });
}

// One image of a C-B block: q, k, v, dO tiles, pb the P tile and ds the dS
// tile, bh the head's (n, n) bias (in shared memory for kJ 7, else in device
// memory); acc += this warp's fragment of dS. kJ: 8-key tiles that hold the n
// keys (7 for the 49 of a 7 x 7 window: 12 registers fewer for each of S, dP
// and the sums). dQ, dK, dV go to dst + off[h] (the head's columns of dqkv's
// q part; -1 past n), staged in the warp's rows of the v and k tiles. One
// barrier: P and dS scale are both staged before dV and dK read them
// transposed.
template <int kJ>
__device__ inline void head_bwd(float (&acc)[kJ][4], const CTile& qs, const CTile& ks,
                                const CTile& vs, const CTile& dos, bf16* pb, bf16* ds,
                                const float* bh, float scale, bf16* dst,
                                const long long (&off)[2], int C) {
  constexpr int kK = (kJ + 1) / 2;  // 16-key steps
  const int t = threadIdx.x & 3, r0 = frag_row();
  float s[kJ][4];
  softmax_rows<kJ>(s, qs, ks, bh, scale);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(pb + (r0 + 8 * h) * kLdP + 8 * j + 2 * t) =
          pack_bf16(s[j][2 * h], s[j][2 * h + 1]);
  // dP = dO v^T; dS = P (dP - rowsum(dP P)) in f32, summed into acc; the A
  // fragments of bf16(dS scale), staged in ds too
  uint32_t da[kK][4];
  {
    float dp[kJ][4];
    uint32_t df[2][4];
    load_a(df, dos);
#pragma unroll
    for (int j = 0; j < kJ; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_abt<kJ>(dp, df, vs);
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dot[i >> 1] += dp[j][i] * s[j][i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 1);
      dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 2);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = __fmul_rn(s[j][i], __fsub_rn(dp[j][i], dot[i >> 1]));
        acc[j][i] += d;
        dp[j][i] = __fmul_rn(d, scale);
      }
    }
    a_fragments<kJ>(da, dp);
  }
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(ds + (r0 + 8 * h) * kLdP + 16 * kk + 2 * t) = da[kk][h];
      if (2 * kk + 1 < kJ)
        *reinterpret_cast<uint32_t*>(ds + (r0 + 8 * h) * kLdP + 16 * kk + 8 + 2 * t) =
            da[kk][2 + h];
    }
  }
  float o[4][4];
  mma_ab<kJ>(o, da, ks);  // dQ = bf16(dS scale) k
  __syncthreads();  // P and dS scale are staged; every warp is done with v and k
  bf16* v = const_cast<bf16*>(vs.base);
  write_rows(dst, off, o, v);
  mma_atb(o, pb, dos);  // dV = bf16(P)^T dO
  write_rows(dst + 2 * C, off, o, const_cast<bf16*>(ks.base));
  mma_atb(o, ds, qs);  // dK = bf16(dS scale)^T q
  write_rows(dst + C, off, o, v);
}

__device__ __forceinline__ void ranks_sync(int ranks) {
  if (ranks > 1)
    cgc::this_cluster().sync();
  else
    __syncthreads();
}

// C-B: a cluster of p.ranks blocks per (window, head) pair, rank q walking the
// images of its run on a ring of q, k, v, dO tiles, its dS sums in registers;
// then the ranks add their partials in rank order, each writing its slice of
// dbias.
template <int kJ>
__global__ void __launch_bounds__(kCoreThreads, kBlocksPerSm) core_bwd_ring(CoreParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = p.n, tile = n * kD, stage_elems = 4 * tile;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  unsigned char* after = smem + bwd_ring(n);
  bf16* pb = reinterpret_cast<bf16*>(after);
  const bf16* zero = reinterpret_cast<const bf16*>(after + 2 * kPElems * sizeof(bf16));
  float* bias_s = reinterpret_cast<float*>(after + 2 * kPElems * sizeof(bf16) + kZeroRow);
  const int R = p.ranks, rank = R > 1 ? (int)cgc::this_cluster().block_rank() : 0;
  const int pair = blockIdx.x / R, head = pair % p.heads;
  const int b0 = rank * p.per_rank, count = max(0, min(p.B - b0, p.per_rank));
  // the bias in shared memory where the host gave room for it (kJ 7: n <= kMaxN7)
  constexpr bool kBiasSmem = kJ == 7;
  const float* bh = kBiasSmem ? bias_s : p.bias + (size_t)pair * n * n;
  // the P and dS tiles (their columns past 8 kJ stay 0) and the zero row
  for (int i = threadIdx.x; i < (int)((2 * kPElems * sizeof(bf16) + kZeroRow) / 16);
       i += kCoreThreads)
    reinterpret_cast<uint4*>(after)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (kBiasSmem) load_bias(bias_s, p, pair);
  const WinRow lr[2] = {win_row(p, threadIdx.x / 4), win_row(p, threadIdx.x / 4 + 32)};
  const WinRow fr[2] = {win_row(p, frag_row()), win_row(p, frag_row() + 8)};
  const Origin o0 = origin_of(p, b0, pair / p.heads);  // the rank's first image
  float acc[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  ring_walk<kBwdStages>(
      count,
      [&](int j, int s) {
        Origin o = o0;
        o.img += (size_t)j * p.H * p.W;
        load_rows<4>(ring + s * stage_elems, p, o, head, lr);
      },
      [&](int j, int s) {
        const bf16* st = ring + s * stage_elems;
        Origin o = o0;
        o.img += (size_t)j * p.H * p.W;
        long long off[2];
        frag_offsets(off, p, o, fr, 3 * p.C);
        head_bwd<kJ>(acc, CTile{st, zero, n}, CTile{st + tile, zero, n},
                     CTile{st + 2 * tile, zero, n}, CTile{st + 3 * tile, zero, n}, pb,
                     pb + kPElems, bh, p.scale, p.out + (size_t)head * kD, off, p.C);
      });
  // this rank's dS sums, 64 x 64, over the shared memory (no copy is in flight)
  float* part = reinterpret_cast<float*>(smem);
  __syncthreads();
  {
    const int r0 = frag_row(), c = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (r0 + 8 * h) * kTileRows + 8 * j + c) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
  ranks_sync(R);  // every rank's partials are written
  const int nn = n * n;
  for (int e = rank * kCoreThreads + threadIdx.x; e < nn; e += R * kCoreThreads) {
    const int r = e / n, c = e - r * n, off = r * kTileRows + c;
    float sum = 0.f;
    for (int q = 0; q < R; ++q)  // in rank order
      sum += (R > 1 ? cgc::this_cluster().map_shared_rank(part, q) : part)[off];
    p.dbias[(size_t)pair * nn + e] = sum;
  }
  ranks_sync(R);  // no rank leaves while another still reads its partials
}

struct HeadsParams {
  const bf16* q;      // (B, G, N, D)
  const bf16* k;
  const bf16* v;
  const float* bias;  // (G, N, N)
  bf16* out;          // (B, G, N, D)
  int B, G, N;
  float scale;
};

constexpr int kLdBias = kTileRows + 8;  // f32 bias tile rows
constexpr size_t kHeadsSmem =
    (size_t)kTileRows * kLdBias * sizeof(float) + 6 * TileLd<kD>::kBytes;

// W: one block per head-window g, on the attention tile (attn_tile.cuh). Its
// (N x N) bias is read into shared memory once, and the block walks the
// images b over it; image b + 1's q/k/v are in flight (cp.async) while b's
// are attended. (Splitting the images into runs, more blocks that each read
// the bias, measured no faster on an H100.)
__global__ void __launch_bounds__(128) heads_kernel(HeadsParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = TileLd<kD>;
  constexpr int kTileElems = kTileRows * L::kLd;
  float* bias = reinterpret_cast<float*>(smem);
  bf16* buf = reinterpret_cast<bf16*>(smem + (size_t)kTileRows * kLdBias * sizeof(float));
  const int g = blockIdx.x, N = p.N;
  auto load = [&](int b) {
    const size_t base = ((size_t)b * p.G + g) * N * kD;
    const bf16* src[3] = {p.q + base, p.k + base, p.v + base};
    for (int i = 0; i < 3; ++i)
      tile_rows_async<kD>(buf + ((b & 1) * 3 + i) * kTileElems, N,
                          [&](int r) { return src[i] + (size_t)r * kD; });
  };
  load(0);
  cp_async_commit();
  const float* bg = p.bias + (size_t)g * N * N;
  for (int i = threadIdx.x; i < kTileRows * kTileRows; i += blockDim.x) {
    const int r = i / kTileRows, c = i % kTileRows;
    bias[r * kLdBias + c] = r < N && c < N ? bg[r * N + c] : 0.f;
  }
  for (int b = 0; b < p.B; ++b) {
    if (b + 1 < p.B) {
      load(b + 1);  // into the buffers image b - 1 freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tiles = buf + (b & 1) * 3 * kTileElems;
    TileState<kD> st;
    tile_begin(st, tiles);
    tile_step(st, tiles + kTileElems, tiles + 2 * kTileElems, 0, N, p.scale,
              [&](int r, int c) { return bias[r * kLdBias + c]; });
    bf16* og = p.out + ((size_t)b * p.G + g) * N * kD;
    tile_finish(st, [&](int r, int c, float v0, float v1) {
      if (r < N)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r * kD + c) = __floats2bfloat162_rn(v0, v1);
    });
    __syncthreads();
  }
}

bool core_shape_ok(int B, int H, int W, int C, int heads, int ws, int shift) {
  return B >= 1 && heads >= 1 && ws >= 1 && ws * ws <= kTileRows && H % ws == 0 &&
         W % ws == 0 && H >= ws && W >= ws && C == kD * heads && shift >= 0 && shift < ws;
}

CoreParams core_params(const void* qkv, const void* bias, int B, int H, int W, int C, int heads,
                       int ws, int shift, float scale) {
  CoreParams p{};
  p.qkv = static_cast<const bf16*>(qkv);
  p.bias = static_cast<const float*>(bias);
  p.B = B, p.H = H, p.W = W, p.C = C, p.heads = heads, p.ws = ws, p.shift = shift;
  p.nW = (H / ws) * (W / ws);
  p.n = ws * ws;
  p.scale = scale;
  return p;
}

using CoreKernel = void (*)(CoreParams);

// kJ: 7 key tiles of 8 hold the 49 tokens of a 7 x 7 window; 8 hold 64.
CoreKernel fwd_kernel(int n) { return n <= kMaxN7 ? &core_fwd_ring<7> : &core_fwd_ring<8>; }
CoreKernel bwd_kernel(int n) { return n <= kMaxN7 ? &core_bwd_ring<7> : &core_bwd_ring<8>; }

// A launch of `blocks` C-B blocks in clusters of `ranks` (cfg refers to
// attr, so both live as long as the launch or the query).
void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int blocks, int ranks,
                    size_t smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kCoreThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Clusters of 1 to 8 C-B blocks for windows of n tokens that the current
// card holds at once (cudaOccupancyMaxActiveClusters), asked once per device
// and n, when the kernel is also allowed its shared memory.
cudaError_t cluster_fit(int n, int (&fit)[kMaxRanks]) {
  static int cache[16][kTileRows + 1][kMaxRanks];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  int* c = cache[dev][n];
  if (!c[0]) {
    const CoreKernel kernel = bwd_kernel(n);
    e = allow_smem(kernel, bwd_smem(n));
    for (int r = 1; e == cudaSuccess && r <= kMaxRanks; ++r) {
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      cluster_config(cfg, attr, r, r, bwd_smem(n), nullptr);
      e = cudaOccupancyMaxActiveClusters(&c[r - 1], (void*)kernel, &cfg);
    }
    if (e != cudaSuccess) {
      c[0] = 0;
      return e;
    }
  }
  for (int i = 0; i < kMaxRanks; ++i) fit[i] = c[i];
  return cudaSuccess;
}

}  // namespace
}  // namespace mmrp

using namespace mmrp;

extern "C" {

// qkv (B, H, W, 3C) bf16; bias (nW, heads, ws^2, ws^2) f32; out (B, H, W, C) bf16.
int mmrp_wattn_core_fwd(const void* qkv, const void* bias, void* out, int B, int H, int W, int C,
                        int heads, int ws, int shift, float scale, void* stream) {
  if (!core_shape_ok(B, H, W, C, heads, ws, shift)) return (int)cudaErrorInvalidValue;
  CoreParams p = core_params(qkv, bias, B, H, W, C, heads, ws, shift, scale);
  p.out = static_cast<bf16*>(out);
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const CorePlan plan = core_plan(B, p.nW, heads, sms, nullptr);
  const size_t smem = fwd_smem(p.n);
  const CoreKernel kernel = fwd_kernel(p.n);
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<plan.fwd_blocks, kCoreThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// dout (B, H, W, C) bf16 -> dqkv (B, H, W, 3C) bf16 and dbias (nW, heads, N, N)
// f32, in one launch.
int mmrp_wattn_core_bwd(const void* qkv, const void* bias, const void* dout, void* dqkv,
                        void* dbias, int B, int H, int W, int C, int heads, int ws, int shift,
                        float scale, void* stream) {
  if (!core_shape_ok(B, H, W, C, heads, ws, shift)) return (int)cudaErrorInvalidValue;
  CoreParams p = core_params(qkv, bias, B, H, W, C, heads, ws, shift, scale);
  p.dout = static_cast<const bf16*>(dout);
  p.out = static_cast<bf16*>(dqkv);
  p.dbias = static_cast<float*>(dbias);
  int sms = 0, fit[kMaxRanks];
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  e = cluster_fit(p.n, fit);  // which has also allowed the kernel its shared memory
  if (e != cudaSuccess) return (int)e;
  const CorePlan plan = core_plan(B, p.nW, heads, sms, fit);
  p.ranks = plan.ranks;
  p.per_rank = plan.per_rank;
  const CoreKernel kernel = bwd_kernel(p.n);
  const size_t smem = bwd_smem(p.n);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, plan.pairs * plan.ranks, plan.ranks, smem,
                 static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The host's sizing of a call with windows of ws on sms SMs, where the card
// holds fit[r - 1] clusters of r C-B blocks at once (r = 1 .. 8); one field by
// `what`: 0 forward blocks, 1 backward cluster ranks, 2 images per rank, 3 and
// 4 the forward's and the backward's shared memory a block. The tests hold
// ops/wattn_core.py::core_plan to it.
int mmrp_core_plan(int B, int nW, int heads, int ws, int sms, const int* fit, int what) {
  const CorePlan c = core_plan(B, nW, heads, sms, fit);
  switch (what) {
    case 0: return c.fwd_blocks;
    case 1: return c.ranks;
    case 2: return c.per_rank;
    case 3: return (int)fwd_smem(ws * ws);
    case 4: return (int)bwd_smem(ws * ws);
    default: return -1;
  }
}

// Clusters of `ranks` C-B blocks (1 .. 8), windows of ws, that this card holds
// at once; negative: a CUDA error.
int mmrp_core_fit(int ws, int ranks) {
  int fit[kMaxRanks];
  if (ws < 1 || ws * ws > kTileRows || ranks < 1 || ranks > kMaxRanks) return -1;
  const cudaError_t e = cluster_fit(ws * ws, fit);
  return e == cudaSuccess ? fit[ranks - 1] : -(int)e;
}

// q, k, v, out (B, G, N, D) bf16; bias2 (G, N, N) f32; N <= 64.
int mmrp_window_attention_heads(const void* q, const void* k, const void* v, const void* bias2,
                                void* out, int B, int G, int N, int D, float scale,
                                void* stream) {
  if (B < 1 || G < 1 || N < 1 || N > kTileRows || D != kD) return (int)cudaErrorInvalidValue;
  HeadsParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.bias = static_cast<const float*>(bias2);
  p.out = static_cast<bf16*>(out);
  p.B = B, p.G = G, p.N = N, p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = allow_smem(heads_kernel, kHeadsSmem);
  if (e != cudaSuccess) return (int)e;
  heads_kernel<<<G, 128, kHeadsSmem, st>>>(p);  // one warpgroup: the tile's 4 x 16 rows
  return (int)cudaGetLastError();
}

}  // extern "C"
