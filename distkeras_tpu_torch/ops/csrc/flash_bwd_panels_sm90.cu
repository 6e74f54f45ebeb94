// Flash-attention backward in bf16 on Hopper's tensor cores (sm_90a) past
// head dim 256: K2 (dQ) and K3 (dK, dV) at any head dim above 256 that is
// a multiple of 8 (the TMA row stride; the wrapper pads other Dh to the
// next multiple of 8).  Called from flash_bwd.cu's C interface
// (dkt_flash_bwd_dq, dkt_flash_bwd_dkv) for dtype 1; up to 256 bf16 runs
// flash_bwd_sm90.cu, and f32 past 256 flash_bwd_tf32_panels_sm90.cu.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2,
// :169) and _bwd_dkv_kernel (K3, :200), whose BlockSpecs span any head
// dim, under the bf16 branch of _dot/_dot_t.  The same function as
// flash_bwd_sm90.cu's: with P = exp(scale * Q K^T - L) under the causal
// mask k_pos <= q_pos (a select: a masked entry is exactly 0), dP = dO V^T
// from bf16 operands with f32 sums and dS = scale * P o (dP - D) in f32,
// P and dS rounded to bf16 before the second products,
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// with f32 accumulators and bf16 outputs.  Each output has one writer, no
// atomics; dQ sums over key tiles in order, dK and dV over query tiles in
// order.  Causal needs Tq == Tk; non-causal takes Tq != Tk; any T (ragged
// tiles are zero-filled by TMA and masked).
//
// What bounds them on this card: at B*H = 128, T = 512, causal, Dh = 320,
// K2 does 6 * Dh and K3 8 * Dh FLOPs per unmasked (q, k) pair, 32.3 and
// 43.0 GFLOP, 0.033 and 0.043 ms at 989 TFLOP/s of bf16 tensor cores;
// their bytes (Q, K, V, dO bf16 and L, D f32 read once, the gradients
// written once) take 0.063 and 0.075 ms at 3.35 TB/s (Dh 512: 0.100 and
// 0.120).  Bytes bound both, with the operations close behind.
//
// Design: the D = 256 kernels of flash_bwd_sm90.cu carried past 256 in
// output panels.  A block is two warpgroups (256 threads) and owns one
// panel of kPanel = 256 columns of its outputs, the grid holding (panel,
// tile, batch*head) with the panels of one tile side by side, so the
// blocks that read the same rows run together and share them in L2.
// Each warpgroup holds a
// 128-column half of the panel (dQ: 64 accumulator registers a thread;
// dK and dV: 128) and forms the whole S and dP (K3: S^T and dP^T) itself,
// as at D = 256; a warpgroup whose half lies wholly past Dh (the last
// panel at Dh % 256 in 1-128) leaves at once.  A 64 x Dh tile does not
// fit beside the ring at every Dh (128 * Dh bytes), so nothing is
// resident: S and dP accumulate m64n64k16 products over 64-column chunks
// of Q/K and dO/V, each chunk one 32 KB stage of four 64 x 64 boxes,
// 128B-swizzled (a swizzled box is one swizzle row wide), and then the
// panel's columns of K (K2; of dO and then of Q for K3) arrive as a stage
// of their own, read MN-major by the second products with A from
// registers.  Every stage comes by TMA from 3-D tensor maps (Dh, T,
// B*H), so columns past Dh (a box wholly past it reads zeros) and rows
// past T read zeros, and the outputs are stored masked at Dh and T.  A
// block walks a fixed sequence of items (per key tile, K2: the chunks,
// then K's panel; per query tile, K3: the chunks, dO's panel, Q's
// panel) through a ring of kStages = 6 stages (192 KB, one block an SM):
// thread 0 keeps the next items in flight, each stage on its own
// mbarrier, and once both warpgroups are done with an item (a named
// barrier; chunk c's stage is released while chunk c + 1's products run)
// it refills that stage with the item kStages on.  Shared memory and
// registers are the same at every Dh, so any Dh past 256 runs.  L and D
// rows of (B*H, Tq) f32 are not 16-byte aligned at odd Tq, so TMA cannot
// take them: K2 reads its two rows per thread once, K3 stages each query
// tile's 64 + 64 values in shared memory a tile ahead.
//
// The panels repeat the products of S and dP: at Dh 320 the second
// panel's blocks form all of S and dP for 64 columns of output, so K2 does
// 7 * Dh and K3 8 * Dh MACs per pair in place of 3 * Dh and 4 * Dh
// (Dh 512: 9 and 10).  A warpgroup's accumulators cap its columns at 128
// beside S, dP and dS's A fragments (K3 takes all 255 registers, with no
// spill only because it reads %laneid again where it uses it); a third
// warpgroup (a 384-column panel, one block per tile at Dh 320) would
// leave 170 registers a thread (65,536 / 384).
//
// Measured on an H100 at 700 W (kernel_ab.py, B*H 128, T 512, causal):
// K2 0.393 / 0.541 ms and K3 0.508 / 0.677 ms at Dh 320 / 512, against
// 13.8 / 15.5 and 19.9 / 20.6 ms on CUDA cores in the same call, and
// SDPA's backward 1.75 / 2.68 ms.  Tried beside it, in turns: the grid
// with batch*head fastest (as the other kernels order it) ran 4-7%
// slower at Dh 320 and 15-20% at 512; a ring of 4 stages ran as fast as
// 6.  So the stream from L2 into shared memory, not its latency, bounds
// them: each block reads every chunk of Q/dO (K2) or K/V (K3) again per
// tile, and both panels of a tile read the same chunks.

#include "sm90.cuh"

namespace {

using namespace sm90;
using namespace sm90::panels;

// this thread's lane, read again where it is used: K3 would otherwise
// keep a value of it live across its loops, one register past its budget
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  return lane;
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

// K2's item j of a block: key tile t = j / (nc + 1); c = j % (nc + 1)
// below nc is chunk c (Q, dO, K, V, columns [64c, 64c + 64)), c = nc the
// panel's columns of K
__device__ __forceinline__ void dq_item(uint8_t* dst, uint64_t* bar,
                                        const CUtensorMap* q,
                                        const CUtensorMap* k,
                                        const CUtensorMap* v,
                                        const CUtensorMap* dout, int j,
                                        int nc, int q0, int p0, int bh) {
  const int t = j / (nc + 1), c = j % (nc + 1), k0 = t * kBlock;
  if (c < nc) {
    const CUtensorMap* const maps[4] = {q, dout, k, v};
    const int rows[4] = {q0, q0, k0, k0};
    const int cols[4] = {c * kChunk, c * kChunk, c * kChunk, c * kChunk};
    load_stage(dst, bar, maps, rows, cols, bh);
  } else {
    const CUtensorMap* const maps[4] = {k, k, k, k};
    const int rows[4] = {k0, k0, k0, k0};
    const int cols[4] = {p0, p0 + kChunk, p0 + 2 * kChunk, p0 + 3 * kChunk};
    load_stage(dst, bar, maps, rows, cols, bh);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_panels_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           __nv_bfloat16* __restrict__ dq, int tq, int tk,
                           int dh, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  uint8_t* ring = aligned_smem(smem_raw);

  // (panel, query tile, head), panels fastest; a head's query tiles from
  // the last (the longest causal loop) down
  const int n_panels = (dh + kPanel - 1) / kPanel;
  const int n_tiles = (tq + kBlock - 1) / kBlock;
  const int p = blockIdx.x % n_panels;
  const int qt = n_tiles - 1 - (blockIdx.x / n_panels) % n_tiles;
  const int bh = blockIdx.x / n_panels / n_tiles;
  const int q0 = qt * kBlock, p0 = p * kPanel;
  const int nc = (dh + kChunk - 1) / kChunk;  // chunks of S and dP
  int n_k = (tk + kBlock - 1) / kBlock;
  if (causal) n_k = min(n_k, qt + 1);         // key tiles up to the diagonal
  const int n_items = n_k * (nc + 1);
  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int groups = live_groups(p0, dh);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg >= groups) return;  // its columns lie wholly past dh
  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v, *mdo = &tm_do;
  auto load_item = [&](int j) {
    dq_item(ring + (j % kStages) * kStage, &full[j % kStages], mq, mk, mv,
            mdo, j, nc, q0, p0, bh);
  };
  if (tid == 0)
    for (int j = 0; j < kStages && j < n_items; ++j) load_item(j);
  // item i is done in every live warpgroup: refill its stage
  auto advance = [&](int i) {
    sync_groups(groups * kThreads);
    if (tid == 0 && i + kStages < n_items) load_item(i + kStages);
  };

  const int col0 = p0 + wg * kHalf;  // this warpgroup's first dQ column
  const int warp = (tid % kThreads) / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0+8
  const int c0 = 2 * (lane % 4);             // and columns c0 + 8j + {0,1}
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l_row[h] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[h] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
  }
  float acc[kHalf / 2];
#pragma unroll
  for (int e = 0; e < kHalf / 2; ++e) acc[e] = 0.f;

  int i = 0;  // the item in hand
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * kBlock;
    // S = Q K^T and dP = dO V^T over the chunks of Dh
    float sc[32] = {}, dp[32] = {};
    for (int c = 0; c < nc; ++c, ++i) {
      uint8_t* st = ring + (i % kStages) * kStage;  // Q, dO, K, V
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(sc, desc_k<kChunk>(st, kk),
                   desc_k<kChunk>(st + 2 * kBox, kk), c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(dp, desc_k<kChunk>(st + kBox, kk),
                   desc_k<kChunk>(st + 3 * kBox, kk), c > 0 || kk > 0);
      wgmma_commit();
      if (c > 0) {  // the last chunk's products are done
        wgmma_wait<1>();
        advance(i - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    advance(i - 1);

    // P = exp(scale * S - L) under the mask, dS = scale * P o (dP - D),
    // rounded to bf16 as the A operand
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = r0 + 8 * ((e >> 1) & 1);
      const int col = k0 + 8 * (e >> 2) + c0 + (e & 1);
      const bool keep = row < tq && col < tk && (!causal || col <= row);
      const int h = (e >> 1) & 1;
      const float pe = keep ? expf(sc[e] * scale - l_row[h]) : 0.f;
      dp[e] = pe * (dp[e] - d_row[h]) * scale;
    }
    uint32_t a[4][4];
    to_a(dp, a);

    // dQ += dS K, this warpgroup's 128 columns of K's panel read MN-major
    uint8_t* kp = ring + (i % kStages) * kStage + wg * 2 * kBox;
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kHalf>(acc, a[kk], desc_mn<kChunk>(kp, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    advance(i++);
  }
  store_rows_masked<kHalf>(dq + (size_t)bh * tq * dh + col0, acc, r0, tq, c0,
                           dh, dh - col0);
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

// K3's item j of a block: query tile it = j / (nc + 2) of the loop
// (rows q0 = q_first + 64 * it); c = j % (nc + 2) below nc is chunk c
// (K, V, Q, dO, columns [64c, 64c + 64)), c = nc the panel's columns of
// dO, c = nc + 1 those of Q
__device__ __forceinline__ void dkv_item(uint8_t* dst, uint64_t* bar,
                                         const CUtensorMap* q,
                                         const CUtensorMap* k,
                                         const CUtensorMap* v,
                                         const CUtensorMap* dout, int j,
                                         int nc, int k0, int q_first, int p0,
                                         int bh) {
  const int c = j % (nc + 2), q0 = q_first + (j / (nc + 2)) * kBlock;
  if (c < nc) {
    const CUtensorMap* const maps[4] = {k, v, q, dout};
    const int rows[4] = {k0, k0, q0, q0};
    const int cols[4] = {c * kChunk, c * kChunk, c * kChunk, c * kChunk};
    load_stage(dst, bar, maps, rows, cols, bh);
  } else {
    const CUtensorMap* m = c == nc ? dout : q;
    const CUtensorMap* const maps[4] = {m, m, m, m};
    const int rows[4] = {q0, q0, q0, q0};
    const int cols[4] = {p0, p0 + kChunk, p0 + 2 * kChunk, p0 + 3 * kChunk};
    load_stage(dst, bar, maps, rows, cols, bh);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dkv_panels_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int tq, int tk,
                            int dh, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  // L and D of a query tile, two tiles' buffers
  __shared__ float stats[2][2][kBlock];
  uint8_t* ring = aligned_smem(smem_raw);

  // (panel, key tile, head), panels fastest; a head's key tiles from the
  // first (the longest causal loop) up
  const int n_panels = (dh + kPanel - 1) / kPanel;
  const int n_tiles = (tk + kBlock - 1) / kBlock;
  const int p = blockIdx.x % n_panels;
  const int kt = (blockIdx.x / n_panels) % n_tiles;
  const int bh = blockIdx.x / n_panels / n_tiles;
  const int k0 = kt * kBlock, p0 = p * kPanel;
  const int first = causal ? kt : 0;  // query tiles from the diagonal on
  const int n_q = (tq + kBlock - 1) / kBlock - first;
  const int nc = (dh + kChunk - 1) / kChunk;
  const int n_items = n_q * (nc + 2);
  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int groups = live_groups(p0, dh);
  // query tile `it` of the loop's L (threads 0-63) and D (64-127)
  auto stage_stats = [&](int it) {
    if (tid >= 2 * kBlock) return;
    const int r = tid % kBlock, qpos = (first + it) * kBlock + r;
    const float* src = (tid < kBlock ? lse : dvec) + (size_t)bh * tq;
    stats[it & 1][tid / kBlock][r] = qpos < tq ? src[qpos] : 0.f;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stage_stats(0);
  __syncthreads();
  if (wg >= groups) return;  // its columns lie wholly past dh
  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v, *mdo = &tm_do;
  auto load_item = [&](int j) {
    dkv_item(ring + (j % kStages) * kStage, &full[j % kStages], mq, mk, mv,
             mdo, j, nc, k0, first * kBlock, p0, bh);
  };
  if (tid == 0)
    for (int j = 0; j < kStages && j < n_items; ++j) load_item(j);
  // item i is done in every live warpgroup: refill its stage
  auto advance = [&](int i) {
    sync_groups(groups * kThreads);
    if (tid == 0 && i + kStages < n_items) load_item(i + kStages);
  };

  const int warp = (tid % kThreads) / 32;
  // this thread's keys: r0, r0 + 8; its queries c0 + 8j + {0, 1}, with
  // c0 = 2 * (lane_id() % 4)
  const int r0 = k0 + 16 * warp + lane_id() / 4;
  float acc_k[kHalf / 2], acc_v[kHalf / 2];
#pragma unroll
  for (int e = 0; e < kHalf / 2; ++e) acc_k[e] = acc_v[e] = 0.f;

  int i = 0;  // the item in hand
  for (int it = 0; it < n_q; ++it) {
    const int q0 = (first + it) * kBlock;
    // the next tile's L and D: that buffer's last readers (tile it - 1)
    // have passed the barriers of its last items
    if (it + 1 < n_q) stage_stats(it + 1);
    const float* ls = stats[it & 1][0];
    const float* dls = stats[it & 1][1];

    // S^T = K Q^T and dP^T = V dO^T over the chunks of Dh
    float st[32] = {}, dpt[32] = {};
    for (int c = 0; c < nc; ++c, ++i) {
      uint8_t* sg = ring + (i % kStages) * kStage;  // K, V, Q, dO
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(st, desc_k<kChunk>(sg, kk),
                   desc_k<kChunk>(sg + 2 * kBox, kk), c > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(dpt, desc_k<kChunk>(sg + kBox, kk),
                   desc_k<kChunk>(sg + 3 * kBox, kk), c > 0 || kk > 0);
      wgmma_commit();
      if (c > 0) {  // the last chunk's products are done
        wgmma_wait<1>();
        advance(i - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    advance(i - 1);

    // P^T = exp(scale * S^T - L) under the mask and dS^T = scale * P^T o
    // (dP^T - D) from the unrounded P^T, both rounded to bf16 as A
    // operands before either product, so no A operand is in flight beside
    // S^T and dP^T (K3's register peak)
    const int c0 = 2 * (lane_id() % 4);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = r0 + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + c0 + (e & 1);
      const int qpos = q0 + col;
      const bool keep = qpos < tq && key < tk && (!causal || key <= qpos);
      st[e] = keep ? expf(st[e] * scale - ls[col]) : 0.f;
      dpt[e] = st[e] * (dpt[e] - dls[col]) * scale;
    }
    uint32_t pa[4][4], da[4][4];
    to_a(st, pa);
    to_a(dpt, da);

    // dV += P^T dO and dK += dS^T Q, this warpgroup's 128 columns of the
    // panels of dO and Q read MN-major
    const int i_do = i++;
    uint8_t* dop = ring + (i_do % kStages) * kStage + wg * 2 * kBox;
    mbar_wait(&full[i_do % kStages], (i_do / kStages) & 1);
    fence_regs(acc_v);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kHalf>(acc_v, pa[kk], desc_mn<kChunk>(dop, kk));
    wgmma_commit();
    uint8_t* qp = ring + (i % kStages) * kStage + wg * 2 * kBox;
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kHalf>(acc_k, da[kk], desc_mn<kChunk>(qp, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc_v);
    advance(i_do);
    wgmma_wait<0>();
    fence_regs(acc_k);
    advance(i++);
  }
  const int col0 = p0 + wg * kHalf;  // this warpgroup's first column
  const int c0 = 2 * (lane_id() % 4);
  const size_t base = (size_t)bh * tk * dh + col0;
  store_rows_masked<kHalf>(dk + base, acc_k, r0, tk, c0, dh, dh - col0);
  store_rows_masked<kHalf>(dv + base, acc_v, r0, tk, c0, dh, dh - col0);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

// the four inputs' maps: rows of dh columns read in 64 x 64 boxes
cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* dout, int bh, int tq, int tk, int dh) {
  cudaError_t err;
  if ((err = make_map<kChunk>(&m->q, q, bh, tq, dh)) != cudaSuccess)
    return err;
  if ((err = make_map<kChunk>(&m->k, k, bh, tk, dh)) != cudaSuccess)
    return err;
  if ((err = make_map<kChunk>(&m->v, v, bh, tk, dh)) != cudaSuccess)
    return err;
  return make_map<kChunk>(&m->dout, dout, bh, tq, dh);
}

}  // namespace

// The bf16 entry points behind dkt_flash_bwd_dq / dkt_flash_bwd_dkv past
// head dim 256 (flash_bwd.cu, which checks the arguments and sets the
// device): q, k, v, dout contiguous bf16, 16-byte aligned; head_dim > 256
// and a multiple of 8.
cudaError_t flash_bwd_dq_bf16_panels(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dvec,
                                     void* dq, int bh, int tq, int tk,
                                     int head_dim, int causal, float scale,
                                     cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, bh, tq, tk, head_dim);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_panels_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_panels_kernel<<<n_blocks(bh, tq, head_dim), kBlockThreads,
                               kSmemBytes, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<__nv_bfloat16*>(dq), tq,
      tk, head_dim, causal, scale);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dkv_bf16_panels(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dvec,
                                      void* dk, void* dv, int bh, int tq,
                                      int tk, int head_dim, int causal,
                                      float scale, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, bh, tq, tk, head_dim);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_panels_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_panels_kernel<<<n_blocks(bh, tk, head_dim), kBlockThreads,
                                kSmemBytes, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, head_dim, causal, scale);
  return cudaGetLastError();
}
