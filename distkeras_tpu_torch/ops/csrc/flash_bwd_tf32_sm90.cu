// Flash-attention backward in f32 on Hopper's tensor cores (sm_90a), every
// product as 3xTF32: K2 (dQ) and K3 (dK, dV) at head dims 32, 64 and 128,
// and at any head dim in 129-256.  Called from flash_bwd.cu's C interface
// (dkt_flash_bwd_dq, dkt_flash_bwd_dkv) for dtype 0; past 256 both run on
// CUDA cores (flash_bwd_wide.cu).
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2,
// :169) and _bwd_dkv_kernel (K3, :200) under the f32 branch of
// _dot/_dot_t (precision HIGHEST: exact f32 products).  Same function:
// with P = exp(scale * Q K^T - L) under the causal mask k_pos <= q_pos (a
// select: a masked entry is exactly 0), dP = dO V^T and
// dS = scale * P o (dP - D),
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// in f32.  Causal needs Tq == Tk; non-causal takes Tq != Tk; any T (rows
// past T are zero-filled on load and masked).
//
// 3xTF32: each f32 operand x is split into hi = x rounded to tf32 (to
// nearest, ties away, on the bits: (bits + 0x1000) & ~0x1fff) and
// lo = x - hi (exact in f32, |lo| <= 2^-11 |x|).  lo goes to the tensor
// core as it is: a .tf32 operand is read from its top 19 bits (on this
// card, clearing lo's low 13 bits first changed no output bit), so lo
// loses at most 2^-10 of itself, 2^-21 of x.  Each product is
// lo*hi + hi*lo + hi*hi, summed in f32; lo*lo (at most 2^-22 of the
// product) is dropped.  The sums are where precision goes: each mma
// rounds its sum toward zero at the magnitude of its accumulator, so the
// error grows with the number of mma fed through one accumulator.  The
// kernels keep that number small: the small terms of S and dP sum apart
// from hi*hi, and dQ, dK and dV take each half tile's sum apart from zero
// and add it with an f32 add.  tests/test_torch_cuda.py holds the kernels
// to the f32 bound on inputs where one TF32 pass misses it by far.
//
// What bounds them on this card: at the training shape (B*H = 512,
// T = 512, Dh = 64, causal) K2 does 25.8 and K3 34.4 GFLOP of f32
// products, three times that on the TF32 tensor cores: 77.5 and 103.3
// TFLOP at 495 TFLOP/s, 0.156 and 0.209 ms.  Their bytes (Q, K, V, dO
// and L, D read once, the gradients written once) take 0.101 and
// 0.121 ms at 3.35 TB/s.  So the operations bound both: the kernels have
// to keep the tensor cores issuing, with the splits, the exp and the
// shared-memory loads beside them.
//
// Design: one block of four warps per (batch*head, 64-row tile), each
// warp owning 16 rows of every 64 x 64 tile; K2 per query tile, issued
// from the last (longest causal) one down, looping over the key tiles up
// to the diagonal; K3 per key tile, from the first up, looping over the
// query tiles from the diagonal on.  Each output has one writer and the
// reference's summation order (over key tiles for dQ, over query tiles
// for dK and dV, each tile in two halves), no atomics.  Every product is
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, three per 16 x 8 x 8 step:
//   - tf32 wgmma reads its shared-memory operands as stored and has no
//     transpose for 32-bit types, so on wgmma every tile would need hi
//     and lo copies in shared memory, and three of the seven products
//     (dQ = dS K, dV = P^T dO, dK = dS^T Q contract over the tile's rows)
//     transposed copies as well: about 190 KB at Dh = 64 and one block
//     per SM.  mma.sync takes its fragments from registers, so one f32
//     copy of each tile serves both orientations and the split happens in
//     registers as a fragment is loaded.
//   - S = Q K^T and dP = dO V^T (K2), S^T = K Q^T and dP^T = V dO^T (K3,
//     transposed so that P^T and dS^T land in the accumulators): both
//     fragments read along Dh, the contiguous dim.
//   - dQ += dS K, dV += P^T dO, dK += dS^T Q: A is the f32 accumulator of
//     dS, P^T or dS^T, split in place.  The m16n8k8 accumulator holds
//     columns 2t and 2t + 1 of a thread's rows where the A fragment wants
//     t and t + 4; instead of moving values between threads, the k index
//     of each 8-slice is permuted (logical t <-> physical 2t, t + 4 <->
//     2t + 1) on both sides: the B fragment reads rows 2t and 2t + 1 of
//     the slice.  A sum does not depend on the order of its k terms
//     beyond rounding.
//   - A warp takes the 64 columns of S and dP (S^T and dP^T) in two
//     halves of 32, which halves the accumulators it holds at once: with
//     the register budget set for three blocks per SM, K3 (dK and dV
//     accumulators of 32 registers each) does not spill.
//   - Tiles sit in shared memory with a row stride of Dh + 4 floats, so
//     the fragment reads of both orientations (rows g, columns t; rows
//     2t, columns g) hit 32 distinct banks.
//   - The streamed tiles (K and V in K2, Q and dO in K3) arrive by
//     16-byte cp.async (zero fill past T), the resident ones with the
//     first.  One buffer holds the streamed pair: a block loads its next
//     tile once every warp is done with the current one, and the three
//     blocks on an SM (68 KB of shared memory each at Dh = 64) hide one
//     another's loads.  A second buffer, to load a tile ahead, fits only
//     two blocks per SM, which measured slower on this card.  L and D
//     rows of (B*H, Tq) f32 are not 16-byte aligned at odd Tq: K2 reads
//     its two rows per thread once, K3 stages each query tile's 64 + 64
//     values with plain loads beside the tile's cp.async.
//
// At Dh = 128 the tiles double (132 KB of shared memory, one block per
// SM) and so would the accumulators: a block runs eight warps, two per
// 16 rows, each forming the rows' whole S and dP but holding the outputs
// of one half of Dh (Cfg).  S and dP then sum 16 mma deep, twice Dh 64's.
//
// K3 at Dh 129-256 (flash_bwd_dkv_tf32_wide_kernel; the reference's
// BlockSpecs span any Dh) does 8*Dh FLOPs per unmasked pair: at B*H 128,
// T 512, Dh 256, causal (gpt_lm at dim 2048) 34.4 GFLOP, 0.209 ms at the
// 3xTF32 rate, so operations bound it.  Dh 128's design does not carry
// over:
//   - Shared memory: a 64-row tile at stride 260 is 66.5 KB, and four
//     would be 266 KB.  K and V stay resident (64 rows); Q and dO stream
//     in tiles of 32 rows, one buffer as at Dh 128: 200 KB at Dh 256
//     (tiles of D = 256 columns) and 155 KB at 129-192 (D = 192), one
//     block an SM.  32-row key tiles under 64-row Q/dO tiles would fit as
//     well but double the grid and the Q/dO traffic.
//   - Registers: dK + dV at 64 keys x D columns are 128 f32 a thread of
//     eight warps.  Split over warps that each form the whole S^T and
//     dP^T (Dh 128's way, four column slices of 16 warps, 64 registers
//     each), the products would cost 2.5x the minimal ones; measured on an
//     H100 at 700 W (kernel_ab.py, tree against tree) that ran in 1.48 /
//     2.00 ms at Dh 192 / 256 with spills at the 128-register cap.  So
//     each product is formed once: warps w and w + 4 share 16 keys; w
//     forms S^T, P^T and dV over all D columns, w + 4 forms dP^T, takes
//     P^T from w through shared memory (8 KB, each lane's own accumulator
//     values, a named barrier per pair) and forms dS^T and dK.  A warp
//     holds one output (D / 2 registers), the two warps of a pair do the
//     same products, and P^T arrives in the accumulator layout, so it is
//     split as an A operand as it stands.  0.747 / 1.001 ms at Dh 192 /
//     256 (chip_smoke.py k2k3, an H100 at 700 W), 255 registers: S^T and
//     dP^T loop over their pairs of k-steps one pair at a time and the
//     second products split their A fragments again for each 16-column
//     chunk, which changes no sum and took the spills from 204 B to none
//     at D = 256 (1.50 -> 1.00 ms) and to 8 B at D = 192 (0.87 ->
//     0.75 ms, at 0.75x D = 256's time for 0.75x its columns; 8-column
//     chunks left the 8 B).
//   - Precision: S^T and dP^T sum 32 k-steps, twice Dh 128's, so they sum
//     each pair of k-steps' hi*hi from zero (K1's product_s), the small
//     terms apart; each 32-query tile's dK and dV sum from zero and are
//     added in f32.  On queries and keys with a common offset of 1 the
//     kernel is 6.9e-6 to 2.0e-5 from K3 in float64, within GRAD_TOL,
//     where the plain version in f32 is 1.7e-5 to 4.9e-5 off, outside it
//     at Dh 256 causal (chip_smoke.py's k3_tf32_control).
//   - Rows: read unpadded at the caller's Dh, 16-byte cp.async where
//     Dh % 4 == 0 and 4-byte otherwise, tile columns past Dh zero-filled,
//     outputs stored masked at Dh.
//
// K2 at Dh 129-256 (flash_bwd_dq_tf32_wide_kernel) does 6*Dh FLOPs per
// unmasked pair: at B*H 128, T 512, Dh 256, causal 25.8 GFLOP, 0.156 ms
// at the 3xTF32 rate (bytes 0.100 ms), so operations bound it.  It is
// K3's mirror: one block of eight warps per (batch*head, 64-row query
// tile), issued from the last (longest causal) tile down; Q and dO stay
// resident, K and V stream in 32-row tiles through one buffer (203 KB at
// D = 256, 155 KB at D = 192, one block an SM).  Warps w and w + 4 share
// 16 rows: each forms S, P, dP and dS for one half (16 keys) of every
// tile over all of Dh, hands its half of dS to the other through shared
// memory (each lane's own values, a named barrier per pair), and
// accumulates dQ = dS K over one half of D, so every product is formed
// once and both warps issue in both phases.  S and dP sum 32 k-steps,
// hi*hi in pairs from zero (product_s, four pairs unrolled at a time:
// 2-3% faster than all sixteen); each tile's dQ sum starts from zero and
// is added in f32; one writer per output, over the key tiles in order.
// Measured against it on an H100 at 700 W (kernel_ab.py, tree against
// tree; 0.577 / 0.760 ms at Dh 192 / 256 then): warp w forming S and P,
// w + 4 dP and dS for the whole tile, P handed to w + 4 and dS back to w,
// each holding half of dQ, 0.600 / 0.871 ms (the pair waits on itself
// twice a tile); the query tiles of one head side by side in the grid
// (K and V shared in L2), 0.632 / 0.821 ms.  Measured (chip_smoke.py
// k2k3, NVIDIA H100 80GB HBM3, 700.00 W): 0.5745 / 0.7333 ms at Dh
// 192 / 256, 20% / 21% of the 0.1174 / 0.1565 ms bound; the CUDA-core
// kernel it replaces there took 2.28 / 2.29 ms (kernel_ab.py).
//
// Later work: tf32 wgmma for the four products that read both operands
// along Dh (hi/lo copies written as each tile arrives), a producer warp
// and 128-row tiles, a second Q/dO buffer at Dh 129-256, and fusing K2
// into K3.

#include "tf32.cuh"

namespace {

using sm90::kBlock;
using sm90::kThreads;
using tf32::cp_async16;
using tf32::cp_wait_all;
using tf32::FragA;
using tf32::frag_acc;
using tf32::frag_b;
using tf32::join_halves;
using tf32::kHalf;
using tf32::kNJ;
using tf32::kSideKeys;
using tf32::kSideNJ;
using tf32::load_rows;
using tf32::mma3;
using tf32::pair_arrive;
using tf32::pair_sync;
using tf32::product_pv;
using tf32::product_s;
using tf32::product_t;

// A block's shape for head dim D.  At Dh <= 64 four warps, one per 16
// rows of the tile, and the register budget set for three blocks per SM
// (68 KB of shared memory each at Dh = 64).  At Dh = 128 eight: warps w
// and w + 4 share rows, each forms their whole S and dP (contracted over
// all of Dh) but holds the dQ (or dK, dV) columns of one half of Dh, so a
// thread's accumulators stay at their Dh = 64 size; the 132 KB of shared
// memory fit one block per SM.
template <int D>
struct Cfg {
  static constexpr int kSplit = D > 64 ? 2 : 1;
  static constexpr int kCols = D / kSplit;  // output columns of a warp
  static constexpr int kBlockThreads = kThreads * kSplit;
  static constexpr int kMinBlocks = D > 64 ? 1 : 3;
};

// ---------------------------------------------------------------------------
// tiles and products (the 3xTF32 pieces are in tf32.cuh)
// ---------------------------------------------------------------------------

// Rows [r0, r0 + kBlock) of a contiguous (n, D) f32 matrix into a tile of
// row stride D + 4, by the block's threads; rows at or past n read as
// zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  constexpr int kNT = Cfg<D>::kBlockThreads;
#pragma unroll
  for (int u = 0; u < kBlock * kChunks / kNT; ++u) {
    const int i = threadIdx.x + u * kNT;
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const bool valid = r0 + r < n;
    cp_async16(dst + r * (D + 4) + c,
               src + (size_t)(valid ? r0 + r : 0) * D + c, valid);
  }
}

// acc (16 x N) += A Y, A (16 x kHalf) the accumulator a[s], contracted
// along the kHalf rows of y, whose N columns start at y (row stride
// D + 4).  The half tile's sum is taken apart from zero
// and added to acc in f32: a running sum fed through mma over many tiles
// would take each mma's rounding toward zero at its full magnitude.  (The
// small terms share that sum: twelve mma deep, it stays small, and keeping
// them apart would cost the registers of a third accumulator.)
template <int D, int N>
__device__ __forceinline__ void product(float (&acc)[N / 8][4],
                                        const float (&a)[kNJ][4],
                                        const float* y, int g, int t) {
  constexpr int LD = D + 4;
  float part[N / 8][4];
#pragma unroll
  for (int jd = 0; jd < N / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[jd][i] = 0.f;
#pragma unroll
  for (int s = 0; s < kNJ; ++s) {
    const FragA f = frag_acc(a[s]);
#pragma unroll
    for (int jd = 0; jd < N / 8; ++jd)
      mma3(part[jd], f, frag_b<LD>(y, 8 * s, 8 * jd, g, t));
  }
#pragma unroll
  for (int jd = 0; jd < N / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] += part[jd][i];
}

// rows r0 and r0 + 8 of a (16 x N) accumulator into `out` (row stride
// LD), rows at or past n skipped
template <int N, int LD>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[N / 8][4],
                                           int r0, int n, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n) continue;
    float* row = out + (size_t)r * LD + 2 * t;
#pragma unroll
    for (int jd = 0; jd < N / 8; ++jd)
      *reinterpret_cast<float2*>(row + 8 * jd) =
          make_float2(acc[jd][2 * half], acc[jd][2 * half + 1]);
  }
}

template <int D>
__host__ __device__ constexpr size_t tile_floats() {
  return (size_t)kBlock * (D + 4);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kBlockThreads,
                                  Cfg<D>::kMinBlocks)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         float* __restrict__ dq, int tq, int tk, int causal,
                         float scale) {
  constexpr size_t kTile = tile_floats<D>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;  // resident Q and dO
  float* dos = smem + kTile;
  float* ks = smem + 2 * kTile;  // the streamed K and V
  float* vs = smem + 3 * kTile;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the long tiles first
  const int q0 = qt * kBlock;
  int n_k = (tk + kBlock - 1) / kBlock;
  if (causal) n_k = min(n_k, qt + 1);  // key tiles up to the diagonal
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;

  load_tile<D>(qs, q + (size_t)bh * tq * D, q0, tq);
  load_tile<D>(dos, dout + (size_t)bh * tq * D, q0, tq);
  load_tile<D>(ks, kb, 0, tk);
  load_tile<D>(vs, vb, 0, tk);

  constexpr int kN = Cfg<D>::kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr bool kSplit = Cfg<D>::kSplit > 1;
  const int m0 = 16 * (kSplit ? warp % 4 : warp);  // this warp's rows
  const int c0 = kSplit ? kN * (warp / 4) : 0;     // and its dQ columns
  const int r0 = q0 + m0 + g;      // this thread's rows: r0, r0 + 8
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l_row[h] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[h] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
  }
  float acc[kN / 8][4];
#pragma unroll
  for (int jd = 0; jd < kN / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kBlock;
    cp_wait_all();  // this tile (and the resident ones) landed
    __syncthreads();

#pragma unroll 1
    for (int h = 0; h < kBlock; h += kHalf) {  // keys [h, h + kHalf)
      const float* kh = ks + h * (D + 4);
      float sc[kNJ][4], dp[kNJ][4];
      product_t<D>(sc, qs, kh, m0, g, t);                 // S = Q K^T
      product_t<D>(dp, dos, vs + h * (D + 4), m0, g, t);  // dP = dO V^T
      // dS = scale * P o (dP - D), P = exp(scale * S - L) under the mask
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i >> 1);
          const int col = k0 + h + 8 * j + 2 * t + (i & 1);
          const bool keep = row < tq && col < tk && (!causal || col <= row);
          const float p =
              keep ? expf(sc[j][i] * scale - l_row[i >> 1]) : 0.f;
          dp[j][i] = p * (dp[j][i] - d_row[i >> 1]) * scale;
        }
      product<D, kN>(acc, dp, kh + c0, g, t);  // dQ += dS K
    }

    // every read of K and V is done: load the next tile
    __syncthreads();
    if (it + 1 < n_k) {
      load_tile<D>(ks, kb, k0 + kBlock, tk);
      load_tile<D>(vs, vb, k0 + kBlock, tk);
    }
  }
  store_rows<kN, D>(dq + (size_t)bh * tq * D + c0, acc, r0, tq, t);
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kBlockThreads,
                                  Cfg<D>::kMinBlocks)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int tq, int tk, int causal, float scale) {
  constexpr size_t kTile = tile_floats<D>();
  extern __shared__ float4 smem4[];
  // L and D of the query tile
  __shared__ float stats[2][kBlock];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;  // resident K and V
  float* vs = smem + kTile;
  float* qs = smem + 2 * kTile;  // the streamed Q and dO
  float* dos = smem + 3 * kTile;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles (long causal loops) first
  const int k0 = kt * kBlock;
  const int first = causal ? kt : 0;  // query tiles from the diagonal on
  const int n_q = (tq + kBlock - 1) / kBlock - first;
  const int tid = threadIdx.x;
  const float* qb = q + (size_t)bh * tq * D;
  const float* db = dout + (size_t)bh * tq * D;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* dvec_bh = dvec + (size_t)bh * tq;
  // query tile `it` of the loop's L (threads 0-63) and D (64-127)
  constexpr bool kSplit = Cfg<D>::kSplit > 1;
  auto stage_stats = [&](int it) {
    if (kSplit && tid >= 2 * kBlock) return;
    const int i = tid % kBlock, qp = (first + it) * kBlock + i;
    const float* src = tid < kBlock ? lse_bh : dvec_bh;
    stats[tid / kBlock][i] = qp < tq ? src[qp] : 0.f;
  };

  load_tile<D>(ks, k + (size_t)bh * tk * D, k0, tk);
  load_tile<D>(vs, v + (size_t)bh * tk * D, k0, tk);
  load_tile<D>(qs, qb, first * kBlock, tq);
  load_tile<D>(dos, db, first * kBlock, tq);
  stage_stats(0);

  constexpr int kN = Cfg<D>::kCols;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = 16 * (kSplit ? warp % 4 : warp);  // this warp's keys
  const int c0 = kSplit ? kN * (warp / 4) : 0;     // its dK, dV columns
  const int r0 = k0 + m0 + g;      // this thread's keys: r0, r0 + 8
  float acc_k[kN / 8][4], acc_v[kN / 8][4];
#pragma unroll
  for (int jd = 0; jd < kN / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[jd][i] = acc_v[jd][i] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = (first + it) * kBlock;
    const float* ls = stats[0];
    const float* dls = stats[1];
    cp_wait_all();  // this tile (and the resident ones) landed
    __syncthreads();

#pragma unroll 1
    for (int h = 0; h < kBlock; h += kHalf) {  // queries [h, h + kHalf)
      const float* qh = qs + h * (D + 4);
      const float* doh = dos + h * (D + 4);
      // P^T = exp(scale * S^T - L) under the mask, S^T = K Q^T
      float st[kNJ][4], dpt[kNJ][4];
      product_t<D>(st, ks, qh, m0, g, t);
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = r0 + 8 * (i >> 1);
          const int col = h + 8 * j + 2 * t + (i & 1);
          const int qpos = q0 + col;
          const bool keep = qpos < tq && key < tk && (!causal || key <= qpos);
          st[j][i] = keep ? expf(st[j][i] * scale - ls[col]) : 0.f;
        }
      // dV += P^T dO before dP^T is formed: fewer values live at once
      product<D, kN>(acc_v, st, doh + c0, g, t);
      // dS^T = scale * P^T o (dP^T - D), dP^T = V dO^T
      product_t<D>(dpt, vs, doh, m0, g, t);
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dpt[j][i] = st[j][i] *
                      (dpt[j][i] - dls[h + 8 * j + 2 * t + (i & 1)]) * scale;
      product<D, kN>(acc_k, dpt, qh + c0, g, t);  // dK += dS^T Q
    }

    // every read of Q, dO, L and D is done: load the next tile
    __syncthreads();
    if (it + 1 < n_q) {
      load_tile<D>(qs, qb, q0 + kBlock, tq);
      load_tile<D>(dos, db, q0 + kBlock, tq);
      stage_stats(it + 1);
    }
  }
  store_rows<kN, D>(dk + (size_t)bh * tk * D + c0, acc_k, r0, tk, t);
  store_rows<kN, D>(dv + (size_t)bh * tk * D + c0, acc_v, r0, tk, t);
}

// ---------------------------------------------------------------------------
// K3 at Dh 129-256: dK and dV with P^T handed from warp to warp
// ---------------------------------------------------------------------------

// A block of eight warps per (batch*head, 64-key tile).  Warps w and w + 4
// (w < 4) share keys [16w, 16w + 16): w forms S^T = K Q^T, P^T and dV,
// w + 4 forms dP^T = V dO^T, dS^T and dK, each over all D columns (D / 2
// accumulator registers a thread), so every product is formed once.
constexpr int kWideThreads = 256;
constexpr int kWideRows = kHalf;  // rows of a streamed tile (Q, dO; K, V)

// K and V (64 rows) resident, Q and dO (kWideRows rows) streamed, all at
// stride D + 4, and the four warps' P^T (16 x kWideRows each)
template <int D>
constexpr size_t wide_smem_bytes() {
  return sizeof(float) * ((2 * kBlock + 2 * kWideRows) * (D + 4) +
                          4 * 16 * kWideRows);
}

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dkv_tf32_wide_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dvec,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int tq, int tk, int dh, int causal,
                               float scale) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  // L and D of the query tile
  __shared__ float stats[2][kWideRows];
  float* ks = reinterpret_cast<float*>(smem4);  // resident K and V
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;  // the streamed Q and dO
  float* dos = qs + kWideRows * LD;
  // warp w's P^T as its lanes hold it: [w][j][lane], four values each
  float4* pts = reinterpret_cast<float4*>(dos + kWideRows * LD);

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles (long causal loops) first
  const int k0 = kt * kBlock;
  const int first = causal ? k0 / kWideRows : 0;  // from the diagonal on
  const int n_q = (tq + kWideRows - 1) / kWideRows - first;
  const int tid = threadIdx.x;
  const bool vec = dh % 4 == 0;
  const float* qb = q + (size_t)bh * tq * dh;
  const float* db = dout + (size_t)bh * tq * dh;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* dvec_bh = dvec + (size_t)bh * tq;
  // query tile `it` of the loop's L (threads 0-31) and D (32-63)
  auto stage_stats = [&](int it) {
    if (tid >= 2 * kWideRows) return;
    const int i = tid % kWideRows, qp = (first + it) * kWideRows + i;
    const float* src = tid < kWideRows ? lse_bh : dvec_bh;
    stats[tid / kWideRows][i] = qp < tq ? src[qp] : 0.f;
  };

  load_rows<D, kBlock, kWideThreads>(ks, k + (size_t)bh * tk * dh, k0, tk,
                                     dh, vec);
  load_rows<D, kBlock, kWideThreads>(vs, v + (size_t)bh * tk * dh, k0, tk,
                                     dh, vec);
  load_rows<D, kWideRows, kWideThreads>(qs, qb, first * kWideRows, tq, dh,
                                        vec);
  load_rows<D, kWideRows, kWideThreads>(dos, db, first * kWideRows, tq, dh,
                                        vec);
  stage_stats(0);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool forms_p = warp < 4;  // P^T and dV; else dS^T and dK
  const int pair = warp % 4;
  const int m0 = 16 * pair;    // this warp's keys of the tile
  const int r0 = k0 + m0 + g;  // this thread's keys: r0, r0 + 8
  float4* pt = pts + pair * kNJ * 32 + lane;
  float acc[D / 8][4];  // dV or dK
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = (first + it) * kWideRows;
    cp_wait_all();  // this tile (and the resident ones) landed
    __syncthreads();

    // causal: a warp whose first key is past the tile's last query adds
    // exact zeros, and so does its partner
    if (!causal || k0 + m0 < q0 + kWideRows) {
      float c[kNJ][4];
      if (forms_p) {
        // P^T = exp(scale * S^T - L) under the mask, S^T = K Q^T
        product_s<D, 1>(c, ks, qs, m0, g, t);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = r0 + 8 * (i >> 1);
            const int col = 8 * j + 2 * t + (i & 1);
            const int qpos = q0 + col;
            const bool keep =
                qpos < tq && key < tk && (!causal || key <= qpos);
            c[j][i] = keep ? expf(c[j][i] * scale - stats[0][col]) : 0.f;
          }
          pt[32 * j] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
        }
        pair_arrive(1 + pair);
        product_pv<D, false, 2>(acc, c, dos, g, t);  // dV += P^T dO
      } else {
        // dS^T = scale * P^T o (dP^T - D), dP^T = V dO^T
        product_s<D, 1>(c, vs, dos, m0, g, t);
        pair_sync(1 + pair);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float4 p = pt[32 * j];
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            c[j][i] = pj[i] * (c[j][i] - stats[1][8 * j + 2 * t + (i & 1)]) *
                      scale;
        }
        product_pv<D, false, 2>(acc, c, qs, g, t);  // dK += dS^T Q
      }
    }

    // every read of Q, dO, L, D and P^T is done: load the next tile
    __syncthreads();
    if (it + 1 < n_q) {
      load_rows<D, kWideRows, kWideThreads>(qs, qb, q0 + kWideRows, tq, dh,
                                            vec);
      load_rows<D, kWideRows, kWideThreads>(dos, db, q0 + kWideRows, tq, dh,
                                            vec);
      stage_stats(it + 1);
    }
  }
  // rows of dh columns, keys at or past tk and columns at or past dh
  // skipped
  float* out = (forms_p ? dv : dk) + (size_t)bh * tk * dh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= tk) continue;
    float* row = out + (size_t)r * dh;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jd + 2 * t + e;
        if (col < dh) row[col] = acc[jd][2 * half + e];
      }
  }
}

// ---------------------------------------------------------------------------
// K2 at Dh 129-256: dQ with the keys of each tile split within a warp pair
// ---------------------------------------------------------------------------

// A block of eight warps per (batch*head, 64-row query tile), Q and dO
// resident, K and V streamed in tiles of kWideRows keys.  Warps w and
// w + 4 (w < 4) share rows [16w, 16w + 16): each forms S, P, dP and dS
// for one half of every key tile (`side` 0 the first) over all of Dh,
// hands its half of dS to the other through shared memory, and
// accumulates dQ over one half of D (D / 4 registers a thread).  Shared
// memory: Q and dO, K and V, all at stride D + 4, and each warp's half of
// dS as its lanes hold it ([warp][j][lane]).
template <int D>
constexpr size_t wide_dq_smem_bytes() {
  return sizeof(float) * ((2 * kBlock + 2 * kWideRows) * (D + 4) +
                          8 * kSideNJ * 32 * 4);
}

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dq_tf32_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dvec,
                              float* __restrict__ dq, int tq, int tk, int dh,
                              int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int kCols = D / 2;  // dQ columns of a warp
  // S's and dP's pairs of k-steps unrolled four at a time: 2-3% faster
  // than all sixteen (kernel_ab.py, an H100)
  constexpr int kPairsAtOnce = 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // resident Q and dO
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;  // the streamed K and V
  float* vs = ks + kWideRows * LD;
  float4* xs = reinterpret_cast<float4*>(vs + kWideRows * LD);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // long tiles first
  int n_k = (tk + kWideRows - 1) / kWideRows;
  if (causal) n_k = min(n_k, (q0 + kBlock - 1) / kWideRows + 1);
  const bool vec = dh % 4 == 0;
  const float* kb = k + (size_t)bh * tk * dh;
  const float* vb = v + (size_t)bh * tk * dh;

  load_rows<D, kBlock, kWideThreads>(qs, q + (size_t)bh * tq * dh, q0, tq,
                                     dh, vec);
  load_rows<D, kBlock, kWideThreads>(dos, dout + (size_t)bh * tq * dh, q0,
                                     tq, dh, vec);
  load_rows<D, kWideRows, kWideThreads>(ks, kb, 0, tk, dh, vec);
  load_rows<D, kWideRows, kWideThreads>(vs, vb, 0, tk, dh, vec);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp % 4, side = warp / 4;
  const int m0 = 16 * pair;       // the pair's rows of the tile
  const int r0 = q0 + m0 + g;     // this thread's rows: r0, r0 + 8
  const int last = q0 + m0 + 15;  // the pair's last row
  const int c0 = side * kCols;    // this warp's dQ columns
  float4* my_ds = xs + kSideNJ * 32 * warp + lane;
  const float4* its_ds = xs + kSideNJ * 32 * (warp ^ 4) + lane;
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l_row[h] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[h] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
  }
  float acc[kCols / 8][4];
#pragma unroll
  for (int jd = 0; jd < kCols / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kWideRows;
    cp_wait_all();  // this tile (and the resident ones) landed
    __syncthreads();

    // causal: a pair whose last row is before the tile's first key adds
    // exact zeros
    if (!causal || k0 <= last) {
      const int kh = side * kSideKeys;  // this warp's keys of the tile
      float sc[kSideNJ][4], dp[kSideNJ][4];
      product_s<D, kPairsAtOnce>(sc, qs, ks + kh * LD, m0, g, t);  // Q K^T
      product_s<D, kPairsAtOnce>(dp, dos, vs + kh * LD, m0, g, t);  // dO V^T
      // dS = scale * P o (dP - D), P = exp(scale * S - L) under the mask
#pragma unroll
      for (int j = 0; j < kSideNJ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i >> 1);
          const int col = k0 + kh + 8 * j + 2 * t + (i & 1);
          const bool keep = row < tq && col < tk && (!causal || col <= row);
          const float p =
              keep ? expf(sc[j][i] * scale - l_row[i >> 1]) : 0.f;
          dp[j][i] = p * (dp[j][i] - d_row[i >> 1]) * scale;
        }
        my_ds[32 * j] = make_float4(dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
      }
      pair_sync(1 + pair);
      float ds[kNJ][4];  // dS over the tile's keys: both halves
      join_halves(ds, dp, its_ds, side);
      product_pv<D, true, 4, kCols>(acc, ds, ks + c0, g, t);  // dS K
    }

    // every read of K, V and dS is done: load the next tile
    __syncthreads();
    if (it + 1 < n_k) {
      load_rows<D, kWideRows, kWideThreads>(ks, kb, k0 + kWideRows, tk, dh,
                                            vec);
      load_rows<D, kWideRows, kWideThreads>(vs, vb, k0 + kWideRows, tk, dh,
                                            vec);
    }
  }
  // rows of dh columns, rows at or past tq and columns at or past dh
  // skipped
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= tq) continue;
    float* row = dq + ((size_t)bh * tq + r) * dh;
#pragma unroll
    for (int jd = 0; jd < kCols / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * jd + 2 * t + e;
        if (col < dh) row[col] = acc[jd][2 * half + e];
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// two resident tiles and two streamed ones
template <int D>
constexpr size_t smem_bytes() {
  return 4 * tile_floats<D>() * sizeof(float);
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* dvec,
                      float* dq, int bh, int tq, int tk, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_bwd_dq_tf32_kernel<D><<<grid, Cfg<D>::kBlockThreads, smem,
                                stream>>>(
      q, k, v, dout, lse, dvec, dq, tq, tk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* dvec, float* dk, float* dv, int bh,
                       int tq, int tk, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  flash_bwd_dkv_tf32_kernel<D><<<grid, Cfg<D>::kBlockThreads, smem,
                                 stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, tq, tk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wide(const float* q, const float* k, const float* v,
                           const float* dout, const float* lse,
                           const float* dvec, float* dq, int bh, int tq,
                           int tk, int dh, int causal, float scale,
                           cudaStream_t stream) {
  constexpr size_t smem = wide_dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_bwd_dq_tf32_wide_kernel<D><<<grid, kWideThreads, smem, stream>>>(
      q, k, v, dout, lse, dvec, dq, tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wide(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* dvec, float* dk, float* dv, int bh,
                            int tq, int tk, int dh, int causal, float scale,
                            cudaStream_t stream) {
  constexpr size_t smem = wide_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  flash_bwd_dkv_tf32_wide_kernel<D><<<grid, kWideThreads, smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The f32 entry points behind dkt_flash_bwd_dq / dkt_flash_bwd_dkv
// (flash_bwd.cu, which checks the arguments and sets the device): q, k,
// v, dout contiguous f32, 16-byte aligned; head_dim 32, 64, 128 or any
// in 129-256.
cudaError_t flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, void* dq, int bh, int tq,
                             int tk, int head_dim, int causal, float scale,
                             cudaStream_t stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* out = static_cast<float*>(dq);
  switch (head_dim) {
    case 32:
      return launch_dq<32>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), out,
                           bh, tq, tk, causal, scale, stream);
    case 64:
      return launch_dq<64>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), out,
                           bh, tq, tk, causal, scale, stream);
    case 128:
      return launch_dq<128>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), out,
                            bh, tq, tk, causal, scale, stream);
  }
  if (head_dim <= 192)
    return launch_dq_wide<192>(f(q), f(k), f(v), f(dout), f(lse), f(dvec),
                               out, bh, tq, tk, head_dim, causal, scale,
                               stream);
  return launch_dq_wide<256>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), out,
                             bh, tq, tk, head_dim, causal, scale, stream);
}

cudaError_t flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dvec, void* dk, void* dv, int bh,
                              int tq, int tk, int head_dim, int causal,
                              float scale, cudaStream_t stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* gk = static_cast<float*>(dk);
  auto* gv = static_cast<float*>(dv);
  switch (head_dim) {
    case 32:
      return launch_dkv<32>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), gk,
                            gv, bh, tq, tk, causal, scale, stream);
    case 64:
      return launch_dkv<64>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), gk,
                            gv, bh, tq, tk, causal, scale, stream);
    case 128:
      return launch_dkv<128>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), gk,
                             gv, bh, tq, tk, causal, scale, stream);
  }
  if (head_dim <= 192)
    return launch_dkv_wide<192>(f(q), f(k), f(v), f(dout), f(lse), f(dvec),
                                gk, gv, bh, tq, tk, head_dim, causal, scale,
                                stream);
  return launch_dkv_wide<256>(f(q), f(k), f(v), f(dout), f(lse), f(dvec), gk,
                              gv, bh, tq, tk, head_dim, causal, scale,
                              stream);
}
