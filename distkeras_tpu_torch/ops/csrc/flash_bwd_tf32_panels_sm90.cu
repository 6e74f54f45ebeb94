// Flash-attention backward in f32 on Hopper's tensor cores (sm_90a) past
// head dim 256, every product as 3xTF32: K2 (dQ) and K3 (dK, dV) at any
// head dim above 256, in output panels.  Called from flash_bwd.cu's C
// interface (dkt_flash_bwd_dq, dkt_flash_bwd_dkv) for dtype 0; up to 256
// f32 runs flash_bwd_tf32_sm90.cu, and bf16 runs flash_bwd_sm90.cu and
// flash_bwd_panels_sm90.cu.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2,
// :169) and _bwd_dkv_kernel (K3, :200), whose BlockSpecs span any head
// dim, under the f32 branch of _dot/_dot_t (precision HIGHEST: exact f32
// products).  Same function: with P = exp(scale * Q K^T - L) under the
// causal mask k_pos <= q_pos (a select: a masked entry is exactly 0),
// dP = dO V^T and dS = scale * P o (dP - D),
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// in f32.  Each output has one writer and the reference's order (dQ over
// key tiles, dK and dV over query tiles), no atomics.  Causal needs
// Tq == Tk; non-causal takes Tq != Tk; any T (rows past T read as zeros
// and are masked) and any Dh past 256 (columns past Dh read as zeros and
// are never stored), on unpadded rows.
//
// What bounds them on this card: at B*H = 128, T = 512, causal, K2 does
// 6 * Dh and K3 8 * Dh FLOPs per unmasked (q, k) pair, at Dh 320 32.3 and
// 43.0 GFLOP: 0.1956 and 0.2608 ms at the 3xTF32 rate of 165 TFLOP/s
// (Dh 512: 0.3130 and 0.4173).  Their bytes (Q, K, V, dO and L, D read
// once, the gradients written once) take 0.125 and 0.150 ms at Dh 320 at
// 3.35 TB/s.  So the operations bound both, as at Dh 129-256.
//
// Design: flash_bwd_tf32_sm90.cu's Dh 129-256 kernels (eight warps, each
// product formed once, P or dS handed between warps through shared
// memory behind a named barrier, the 3xTF32 sums of tf32.cuh) carried
// past 256 in output panels, as flash_bwd_panels_sm90.cu carries the bf16
// ones.  A block owns one panel of kPanel = 512 columns of its outputs
// and a 32-row tile; the grid holds (panel, tile, batch*head) with a
// tile's panels side by side.  Its eight warps are two groups of four,
// each group on 16 of the tile's rows.  In a group, warps 0 and 1 form S
// (K3: S^T) over all of Dh for one half (16 columns) of the tile's keys
// (K3: queries) each, then P; warps 2 and 3 form dP (dP^T) for the same
// halves, take P's half from 0 or 1 and form dS.  Every warp then takes
// the group's whole P or dS from shared memory and holds the outputs of
// its share of the panel (K3: warps 0 and 1 dV, 2 and 3 dK, each over
// 256 columns, 128 accumulator registers a thread; K2: each warp dQ over
// 128, 64 registers).  So up to Dh 512 every product is formed once per
// tile (K2 3 * Dh and K3 4 * Dh multiply-adds a pair); past 512 S and dP
// are formed again in each panel.
//
// A 32-row f32 tile at stride Dh + 4 does not fit resident beside a ring
// (66 KB at Dh 512), so nothing is: a block walks a fixed sequence of
// ring items, per tile of its loop first the kChunk = 128-column chunks
// of Dh (32 rows of each of the four inputs at stride 132, 66 KB) over
// which S and dP accumulate, carried across the chunks in pairs of
// k-steps as tf32.cuh's s_pairs sums them and stopping at the last pair
// below Dh, then the panel's columns of the second products' B (K2: 512
// columns of K; K3: 256 of dO and of Q an item; a warp takes 128 columns
// of one), skipping columns past Dh.  Every panel's block sums the same
// chunks in the same order, so every panel holds the same P and dS.  The
// ring has kStages = 3 stages, loaded by every thread with cp.async
// (16-byte where Dh % 4 == 0, else 4-byte) two items ahead, one commit
// group an item and one __syncthreads: at item i each thread waits for
// its group of item i, the barrier makes the item visible and frees the
// stage of item i - 1, and the block loads item i + 2 into it.  Shared
// memory (210,944 bytes and 624 or 112 static) and registers are the
// same at every Dh, so any Dh past 256 runs; the values every thread of a
// block shares (the item sequence, its pointers and bounds: Plan) are
// read from shared memory where they are used, which took K3 from 148
// bytes of spills at 255 registers to none.
//
// Tried beside it on an H100 80GB HBM3 at 700 W (kernel_ab.py, B*H 128,
// T 512, causal, each against the then-current tree in turns, Dh 320 /
// 512, device ms; every variant bit-identical to the design it was held
// against):
//   - 256-column panels (the bf16 panels' shape): a block on 64 rows, warps
//     w and w + 4 sharing 16, each forming S and dP for its whole panel, so
//     K2 does 5 * Dh and K3 6 * Dh multiply-adds a pair: K2 2.15 / 3.29,
//     K3 3.05 / 4.59, against 1.71 / 2.41 and 2.05 / 3.18 for S and dP
//     formed once (then on 64-column chunks, six stages).
//   - K2's warps each forming S and dP for 8 keys: 4-7% slower than the
//     split of S and dP between warps that K3 uses.
//   - the next item found by dividing its index by the items of a tile:
//     4-6% slower than a cursor.  64-column chunks through six stages:
//     K2 2.17 and K3 3.08 ms at Dh 512 against 2.05 and 2.71, as fast at
//     320; diagnosed there with the products removed (loads alone, K3
//     1.55 ms) and with the loads removed (products alone, 1.86 ms) against
//     3.20 whole: the loads and the products barely overlap, and each item
//     costs every thread a barrier and its copies' addresses.
//   - S's pairs unrolled 8 or 2 at a time in place of 4, 64-column
//     product chunks in place of 32: no faster.
//
// Measured on an H100 80GB HBM3 at 700.00 W (kernel_ab.py against the
// CUDA-core kernels it replaces, in turns, B*H 128, T 512, causal): K2
// 1.574 / 2.094 ms and K3 2.007 / 2.748 ms at Dh 320 / 512, against
// 12.61 / 13.76 and 14.59 / 15.53 on CUDA cores, SDPA's backward 2.46 /
// 3.60, the bounds 0.1956 / 0.3130 and 0.2608 / 0.4173; 242 and 254
// registers, no spills.
//
// Precision, as at Dh 129-256: the hi*hi of each pair of k-steps of S and
// dP sums from zero and is added in f32, the small terms apart over all
// of Dh; each 32-row tile's dQ, dK, dV sum from zero (12 mma deep) and
// are added in f32.  tests/test_torch_cuda.py holds both against K2 and
// K3 in float64 on inputs where one TF32 pass misses.

#include "tf32.cuh"

namespace {

using tf32::cp_commit;
using tf32::cp_wait;
using tf32::kNJ;
using tf32::load_cols;
using tf32::pair_arrive;
using tf32::pair_sync;
using tf32::product_pv;
using tf32::s_pairs;

constexpr int kThreads = 256;       // eight warps
constexpr int kPanel = 512;         // output columns of a block
constexpr int kRows = tf32::kHalf;  // rows of a tile, both sides (32)
constexpr int kChunk = 128;         // columns of an S / dP item
constexpr int kCLD = kChunk + 4;    // its row stride
// a ring stage: an S / dP item (32 rows of four inputs), or a product
// item, of which a warp takes kChunk columns (K2: 32 rows of 4 kChunk
// columns of K; K3: of 2 kChunk columns of dO and of Q)
constexpr int kStageFloats = 4 * kRows * kCLD;
constexpr int kDqCols = 4 * kChunk;
constexpr int kDkvCols = 2 * kChunk;
static_assert(kRows * (kDqCols + 4) <= kStageFloats &&
                  2 * kRows * (kDkvCols + 4) <= kStageFloats,
              "a product item fits a stage");
// the exchange: each group's P and dS (K3: P^T and dS^T), 16 x kRows by
// halves of 16 columns, as the warps' lanes hold them
constexpr int kXFloats = 2 * 2 * 16 * kRows;
// as many stages as fit one block an SM beside the exchange and 1 KB of
// static shared memory
constexpr int kStages =
    (232448 - 1024 - (int)sizeof(float) * kXFloats) /
    ((int)sizeof(float) * kStageFloats);
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * kStageFloats + kXFloats);

// A block's item sequence, block-uniform, kept in shared memory and read
// back where it is used rather than held in registers across the loops:
// per tile of the block's loop (n_tiles of them), items 0 .. nc - 1 are
// chunks c, columns [kChunk c, kChunk (c + 1)) of `a` and `b` at rows
// [a0, a0 + 32) and of `x` and `y` at the tile's rows (x0 + 32 * tile),
// in that order in the stage; items nc .. nc + np - 1 are the product
// items p, columns [p0 + PW p, + PW) of `pa` (and of `pb`, if any, after
// it) at the tile's rows, at stride PW + 4.  `la` and `lb` are the head's
// L and D rows, `ho` the head's offset in the a side's rows (and in the
// outputs').
struct Plan {
  const float *a, *b, *x, *y, *pa, *pb, *la, *lb;
  size_t ho;
  int a0, na, x0, nx, p0, dh, nc, np, n_tiles;
  bool vec;
};
static_assert(sizeof(Plan) + 2 * 2 * kRows * sizeof(float) <= 1024,
              "the static shared memory");

// the next item a thread loads: item c of tile `tile` of the loop, into
// stage `stage`
struct Cursor {
  int tile, c, stage;
};

// item `nx` into its stage, and `nx` on to the next; one commit group
// either way
template <int PW>
__device__ __forceinline__ void load_item(const Plan& pl, float* ring,
                                          Cursor& nx) {
  if (nx.tile < pl.n_tiles) {
    const int c = nx.c, x0 = pl.x0 + nx.tile * kRows;
    float* st = ring + nx.stage * kStageFloats;
    if (++nx.c == pl.nc + pl.np) nx.c = 0, ++nx.tile;
    if (++nx.stage == kStages) nx.stage = 0;
    if (c < pl.nc) {
      const int c0 = c * kChunk;
      load_cols<kChunk, kRows, kThreads>(st, pl.a, pl.a0, pl.na, c0, pl.dh,
                                         pl.vec);
      load_cols<kChunk, kRows, kThreads>(st + kRows * kCLD, pl.b, pl.a0,
                                         pl.na, c0, pl.dh, pl.vec);
      load_cols<kChunk, kRows, kThreads>(st + 2 * kRows * kCLD, pl.x, x0,
                                         pl.nx, c0, pl.dh, pl.vec);
      load_cols<kChunk, kRows, kThreads>(st + 3 * kRows * kCLD, pl.y, x0,
                                         pl.nx, c0, pl.dh, pl.vec);
    } else {
      const int c0 = pl.p0 + (c - pl.nc) * PW;
      load_cols<PW, kRows, kThreads>(st, pl.pa, x0, pl.nx, c0, pl.dh,
                                     pl.vec);
      if (pl.pb != nullptr)
        load_cols<PW, kRows, kThreads>(st + kRows * (PW + 4), pl.pb, x0,
                                       pl.nx, c0, pl.dh, pl.vec);
    }
  }
  cp_commit();
}

// waits for item i (this thread's copies, then everyone's: the barrier
// also frees the stage of item i - 1) and starts item i + kStages - 1
// (`nx`) into that stage; returns item i's stage
template <int PW>
__device__ __forceinline__ const float* acquire(const Plan& pl, float* ring,
                                                Cursor& nx, int i) {
  cp_wait<kStages - 2>();
  __syncthreads();
  load_item<PW>(pl, ring, nx);
  return ring + (i % kStages) * kStageFloats;
}

// the n8 tiles of `cols` output columns from column c0 that lie below dh
__device__ __forceinline__ int live_n8(int c0, int cols, int dh) {
  return (max(0, min(cols, dh - c0)) + 7) / 8;
}

// the k-steps of chunk ch that hold columns below dh, in whole pairs
__device__ __forceinline__ int live_ksteps(int ch, int dh) {
  return min(kChunk / 8, (dh - ch * kChunk + 15) / 16 * 2);
}

// rows r0 and r0 + 8 of a warp's outputs, kChunk columns from column
// c0 + stride * p for each product item p, into `out` (rows of dh
// columns); rows at or past n and columns at or past dh skipped
template <int NI>
__device__ __forceinline__ void store(float* out,
                                      const float (&acc)[NI][kChunk / 8][4],
                                      int r0, int n, int c0, int stride,
                                      int dh, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n) continue;
    float* row = out + (size_t)r * dh;
#pragma unroll
    for (int p = 0; p < NI; ++p)
#pragma unroll
      for (int jd = 0; jd < kChunk / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + stride * p + 8 * jd + 2 * t + e;
          if (col < dh) row[col] = acc[p][jd][2 * h + e];
        }
  }
}

// one block per (panel, 32-row tile, batch*head) of a side of t rows
inline int n_blocks(int bh, int t, int dh) {
  return (dh + kPanel - 1) / kPanel * ((t + kRows - 1) / kRows) * bh;
}

// NJ 16 x 8 accumulator pieces of a warp to or from shared memory, as its
// lanes hold them: [j][lane] from `x` (this lane's slot), four values each
template <int NJ>
__device__ __forceinline__ void put(float4* x, const float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    x[32 * j] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
}
template <int NJ>
__device__ __forceinline__ void get(float (&c)[NJ][4], const float4* x) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 v = x[32 * j];
    c[j][0] = v.x, c[j][1] = v.y, c[j][2] = v.z, c[j][3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tf32_panels_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ dvec,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int tq, int tk,
                                 int dh, int causal, float scale) {
  constexpr int kLD = kDkvCols + 4;
  constexpr int kItems = kPanel / kDkvCols;  // product items of a panel
  extern __shared__ float4 smem4[];
  // L and D of a query tile, two tiles' buffers
  __shared__ float stats[2][2][kRows];
  __shared__ Plan plan;
  float* ring = reinterpret_cast<float*>(smem4);
  // each group's P^T, then its dS^T: [group][half][j][lane]
  float4* pts = reinterpret_cast<float4*>(ring + kStages * kStageFloats);
  float4* dsts = pts + 2 * 2 * 2 * 32;
  static_assert(2 * 2 * 2 * 2 * 32 * 4 == kXFloats, "the exchange");
  const int tid = threadIdx.x;

  if (tid == 0) {
    // (panel, key tile, head), panels fastest; a head's key tiles from
    // the first (the longest causal loop) up, each looping over query
    // tiles from the diagonal on
    const int blk = blockIdx.x;
    const int n_panels = (dh + kPanel - 1) / kPanel;
    const int n_tiles = (tk + kRows - 1) / kRows;
    const int p0 = blk % n_panels * kPanel;
    const int k0 = blk / n_panels % n_tiles * kRows;
    const int bh = blk / n_panels / n_tiles;
    const int first = causal ? k0 / kRows : 0;
    const int nc = (dh + kChunk - 1) / kChunk;
    const int np = (min(kPanel, dh - p0) + kDkvCols - 1) / kDkvCols;
    const float* qb = q + (size_t)bh * tq * dh;
    const float* db = dout + (size_t)bh * tq * dh;
    const size_t ho = (size_t)bh * tk * dh;
    plan = Plan{k + ho, v + ho, qb, db, db, qb, lse + (size_t)bh * tq,
                dvec + (size_t)bh * tq, ho, k0, tk, first * kRows, tq, p0, dh,
                nc, np, (tq + kRows - 1) / kRows - first, dh % 4 == 0};
  }
  __syncthreads();
  Cursor nx{0, 0, 0};
  for (int j = 0; j < kStages - 1; ++j)
    load_item<kDkvCols>(plan, ring, nx);
  // query tile `it` of the loop's L (threads 0-31) and D (32-63)
  auto stage_stats = [&](int it) {
    if (tid >= 2 * kRows) return;
    const int r = tid % kRows, qp = plan.x0 + it * kRows + r;
    stats[it & 1][tid / kRows][r] =
        qp < tq ? (tid < kRows ? plan.la : plan.lb)[qp] : 0.f;
  };
  stage_stats(0);
  const int n_q = plan.n_tiles;

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / 4, role = warp % 4;
  const int half = role & 1;      // its queries [16 half, + 16) of S^T
  const bool forms_p = role < 2;  // S^T, P^T and dV; else dP^T, dS^T, dK
  const int m0 = 16 * grp;        // the group's keys of the tile
  float4* my_pt = pts + (2 * grp + half) * 2 * 32 + lane;
  float4* my_dst = dsts + (2 * grp + half) * 2 * 32 + lane;
  float acc[kItems][kChunk / 8][4];  // dV or dK, kChunk columns an item
#pragma unroll
  for (int p = 0; p < kItems; ++p)
#pragma unroll
    for (int jd = 0; jd < kChunk / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][jd][e] = 0.f;

  int i = 0;  // the item in hand
#pragma unroll 1
  for (int it = 0; it < n_q; ++it) {
    float c[2][4], cs[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = cs[j][e] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < plan.nc; ++ch, ++i) {
      const float* st = acquire<kDkvCols>(plan, ring, nx, i);
      // the next tile's L and D: that buffer's readers (tile it - 1) are
      // past this barrier
      if (ch == 0 && it + 1 < n_q) stage_stats(it + 1);
      // S^T = K Q^T or dP^T = V dO^T over this chunk's columns below Dh,
      // for the group's keys and this warp's half of the queries
      s_pairs<kCLD, kChunk / 8, 4, 2>(
          c, cs, st + (forms_p ? 0 : kRows * kCLD),
          st + ((forms_p ? 2 : 3) * kRows + 16 * half) * kCLD, m0, g, t,
          live_ksteps(ch, dh));
    }
    const int q0 = plan.x0 + it * kRows + 16 * half;  // this warp's queries
    const int r0 = plan.a0 + m0 + g;  // this thread's keys: r0, r0 + 8
    const float* ls = stats[it & 1][0] + 16 * half;
    const float* dls = stats[it & 1][1] + 16 * half;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];
    if (forms_p) {
      // P^T = exp(scale * S^T - L) under the mask
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + 8 * (e >> 1);
          const int col = 8 * j + 2 * t + (e & 1);
          const int qpos = q0 + col;
          const bool keep = qpos < tq && key < tk && (!causal || key <= qpos);
          c[j][e] = keep ? expf(c[j][e] * scale - ls[col]) : 0.f;
        }
      put(my_pt, c);
      pair_arrive(1 + 2 * grp + half);
    } else {
      // dS^T = scale * P^T o (dP^T - D), P^T's half from warp `half`
      pair_sync(1 + 2 * grp + half);
      float p[2][4];
      get(p, my_pt);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[j][e] = p[j][e] *
                    (c[j][e] - dls[8 * j + 2 * t + (e & 1)]) * scale;
      put(my_dst, c);
    }
    // dV += P^T dO or dK += dS^T Q over the product items' columns below
    // Dh: this warp's kChunk of each item's 2 kChunk (after the first
    // item's barrier every warp's half of P^T and dS^T is in place)
    float a[kNJ][4];  // the group's P^T or dS^T over the tile's queries
#pragma unroll
    for (int p = 0; p < kItems; ++p) {
      if (p >= plan.np) break;
      const float* st = acquire<kDkvCols>(plan, ring, nx, i++);
      if (p == 0) get(a, (forms_p ? pts : dsts) + 2 * grp * 2 * 32 + lane);
      product_pv<kDkvCols, true, 4, kChunk>(
          acc[p], a, st + (forms_p ? 0 : kRows * kLD) + kChunk * half, g, t,
          live_n8(plan.p0 + kDkvCols * p + kChunk * half, kChunk, dh));
    }
  }
  store((forms_p ? dv : dk) + plan.ho, acc, plan.a0 + m0 + g, tk,
        plan.p0 + kChunk * half, kDkvCols, dh, t);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tf32_panels_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ dvec,
                                float* __restrict__ dq, int tq, int tk,
                                int dh, int causal, float scale) {
  constexpr int kItems = kPanel / kDqCols;  // product items of a panel
  extern __shared__ float4 smem4[];
  __shared__ Plan plan;
  float* ring = reinterpret_cast<float*>(smem4);
  // each group's P, then its dS: [group][half][j][lane]
  float4* ps = reinterpret_cast<float4*>(ring + kStages * kStageFloats);
  float4* dss = ps + 2 * 2 * 2 * 32;

  if (threadIdx.x == 0) {
    // (panel, query tile, head), panels fastest; a head's query tiles
    // from the last (the longest causal loop) down, each looping over key
    // tiles up to the diagonal
    const int blk = blockIdx.x;
    const int n_panels = (dh + kPanel - 1) / kPanel;
    const int n_tiles = (tq + kRows - 1) / kRows;
    const int p0 = blk % n_panels * kPanel;
    const int q0 = (n_tiles - 1 - blk / n_panels % n_tiles) * kRows;
    const int bh = blk / n_panels / n_tiles;
    int n_k = (tk + kRows - 1) / kRows;
    if (causal) n_k = min(n_k, q0 / kRows + 1);
    const int nc = (dh + kChunk - 1) / kChunk;
    const int np = (min(kPanel, dh - p0) + kDqCols - 1) / kDqCols;
    const size_t ho = (size_t)bh * tq * dh;
    const float* kb = k + (size_t)bh * tk * dh;
    plan = Plan{q + ho, dout + ho, kb, v + (size_t)bh * tk * dh, kb, nullptr,
                lse + (size_t)bh * tq, dvec + (size_t)bh * tq, ho, q0, tq, 0,
                tk, p0, dh, nc, np, n_k, dh % 4 == 0};
  }
  __syncthreads();
  Cursor nx{0, 0, 0};
  for (int j = 0; j < kStages - 1; ++j)
    load_item<kDqCols>(plan, ring, nx);
  const int n_k = plan.n_tiles;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / 4, role = warp % 4;
  const int half = role & 1;      // its keys [16 half, + 16) of a key tile
  const bool forms_p = role < 2;  // S and P; else dP and dS
  const int m0 = 16 * grp;        // the group's rows of the tile
  const int r0 = plan.a0 + m0 + g;  // this thread's rows: r0, r0 + 8
  float4* my_p = ps + (2 * grp + half) * 2 * 32 + lane;
  float4* my_ds = dss + (2 * grp + half) * 2 * 32 + lane;
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l_row[h] = r < tq ? plan.la[r] : 0.f;
    d_row[h] = r < tq ? plan.lb[r] : 0.f;
  }
  float acc[kItems][kChunk / 8][4];  // dQ, kChunk columns an item
#pragma unroll
  for (int p = 0; p < kItems; ++p)
#pragma unroll
    for (int jd = 0; jd < kChunk / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][jd][e] = 0.f;

  int i = 0;  // the item in hand
#pragma unroll 1
  for (int it = 0; it < n_k; ++it) {
    float c[2][4], cs[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = cs[j][e] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch < plan.nc; ++ch, ++i) {
      const float* st = acquire<kDqCols>(plan, ring, nx, i);
      // S = Q K^T or dP = dO V^T over this chunk's columns below Dh, for
      // the group's rows and this warp's half of the keys
      s_pairs<kCLD, kChunk / 8, 4, 2>(
          c, cs, st + (forms_p ? 0 : kRows * kCLD),
          st + ((forms_p ? 2 : 3) * kRows + 16 * half) * kCLD, m0, g, t,
          live_ksteps(ch, dh));
    }
    const int k0 = it * kRows + 16 * half;  // this warp's keys
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];
    if (forms_p) {
      // P = exp(scale * S - L) under the mask
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1);
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const bool keep = row < tq && col < tk && (!causal || col <= row);
          c[j][e] = keep ? expf(c[j][e] * scale - l_row[e >> 1]) : 0.f;
        }
      put(my_p, c);
      pair_arrive(1 + 2 * grp + half);
    } else {
      // dS = scale * P o (dP - D), P's half from warp `half`
      pair_sync(1 + 2 * grp + half);
      float p[2][4];
      get(p, my_p);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[j][e] = p[j][e] * (c[j][e] - d_row[e >> 1]) * scale;
      put(my_ds, c);
    }
    // dQ += dS K over the product items' columns below Dh: this warp's
    // kChunk of each item's 4 kChunk (after the first item's barrier both
    // halves of the group's dS are in place)
    float ds[kNJ][4];  // the group's dS over the tile's keys
#pragma unroll
    for (int p = 0; p < kItems; ++p) {
      if (p >= plan.np) break;
      const float* st = acquire<kDqCols>(plan, ring, nx, i++);
      if (p == 0) get(ds, dss + 2 * grp * 2 * 32 + lane);
      product_pv<kDqCols, true, 4, kChunk>(
          acc[p], ds, st + kChunk * role, g, t,
          live_n8(plan.p0 + kDqCols * p + kChunk * role, kChunk, dh));
    }
  }
  store(dq + plan.ho, acc, r0, tq, plan.p0 + kChunk * role, kDqCols, dh, t);
}

}  // namespace

// The f32 entry points behind dkt_flash_bwd_dq / dkt_flash_bwd_dkv past
// head dim 256 (flash_bwd.cu, which checks the arguments and sets the
// device): q, k, v, dout contiguous f32, 16-byte aligned; head_dim > 256.
cudaError_t flash_bwd_dq_f32_panels(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dvec,
                                    void* dq, int bh, int tq, int tk,
                                    int head_dim, int causal, float scale,
                                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_panels_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tf32_panels_kernel<<<n_blocks(bh, tq, head_dim), kThreads,
                                    kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(dq), tq, tk, head_dim, causal, scale);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dkv_f32_panels(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dvec,
                                     void* dk, void* dv, int bh, int tq,
                                     int tk, int head_dim, int causal,
                                     float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_panels_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tf32_panels_kernel<<<n_blocks(bh, tk, head_dim), kThreads,
                                     kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, head_dim,
      causal, scale);
  return cudaGetLastError();
}
