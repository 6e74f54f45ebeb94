// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a) past
// head dim 256: K1 at any head dim above 256 that is a multiple of 8 (the
// TMA row stride; the wrapper pads other Dh to the next multiple of 8).
// Called from flash_fwd.cu's C interface (dkt_flash_fwd) for dtype 1; up
// to 256 bf16 runs flash_fwd_sm90.cu, and f32 past 256 flash_fwd.cu's
// kernel on CUDA cores.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_fwd_kernel (:83,
// launched by _flash_fwd_raw at :139), whose BlockSpecs span any head
// dim, under the bf16 branch of _dot/_dot_t.  The same function as
// flash_fwd_sm90.cu's: S = scale * Q K^T from bf16 operands with f32
// sums, the causal mask k_pos <= q_pos and keys past Tk as a select (a
// masked entry is exactly 0), the online softmax with m and l = sum(p)
// in f32 over the unrounded p, P rounded to bf16 as the A operand of
// P V, and at the end O / l in bf16 and lse = m + log(l) in f32.  A row
// with every key masked so far keeps m = -inf, with p = 0 and corr = 0
// (sm90.cuh: softmax_tile).  Causal needs Tq == Tk; non-causal takes
// Tq != Tk (the ring hop's shape); any T (ragged tiles are zero-filled by
// TMA and masked).
//
// What bounds it on this card: at B*H = 128, T = 512, causal, Dh = 320
// its bytes (Q, K, V bf16 read once, O bf16 and lse f32 written once)
// take 0.050 ms at 3.35 TB/s (Dh 512: 0.080), and its 4 * Dh FLOPs per
// unmasked (q, k) pair 0.022 ms at 989 TFLOP/s of bf16 tensor cores
// (0.035).  Bytes bound it.
//
// Design: flash_bwd_panels_sm90.cu's panels with one product fewer and
// the online softmax.  A block is two warpgroups (256 threads) and owns
// one panel of kPanel = 256 columns of O for one 64-row query tile, the
// grid holding (panel, query tile, batch*head) with the panels of one
// tile side by side, so the blocks that read the same rows run together
// and share them in L2, and a head's query tiles issued from the last
// (the longest causal loop) down.  Each warpgroup holds a 128-column
// half of the panel's O (64 accumulator registers a thread, beside S's
// 32 and P's 16) and forms the whole S itself; a warpgroup whose half
// lies wholly past Dh (the last panel at Dh % 256 in 1-128) leaves at
// once, so the ring's barrier is a named barrier of the live threads.
// Nothing is resident (a 64 x Dh tile of Q does not fit beside a ring at
// every Dh): per key tile, S accumulates m64n64k16 products over
// 64-column chunks of Q and K, two chunks a stage (Q_c, K_c, Q_c+1,
// K_c+1; a chunk wholly past Dh reads zeros and its products are
// skipped), and then the panel's columns of V arrive as a stage of their
// own, read MN-major (the transpose-B bit) by O += P V with P from
// registers.  Every stage comes by TMA from 3-D tensor maps (Dh, T,
// B*H) through the panels' ring (sm90.cuh: panels), so columns past Dh
// and rows past T read zeros, and O is stored masked at Dh and T.  Every
// block of a tile sums S over the same chunks in the same order, so m, l
// and P are bit-identical across its panels; panel 0's first warpgroup
// writes lse, by plain stores (its rows are not 16-byte aligned at odd
// T).  Shared memory (six 32 KB stages, one block an SM) and registers
// are the same at every Dh, so any Dh past 256 runs.
//
// The panels repeat S: at Dh 320 the second panel's block forms all of S
// for 64 columns of O, and each of a block's warpgroups forms it again,
// so the tensor cores do 2688 FLOPs per pair (8.4 * Dh) in place of
// 4 * Dh: 0.046 ms at the bf16 peak, still under the bytes bound.
//
// Measured on an H100 at 700 W (kernel_ab.py, B*H 128, T 512, causal):
// 0.276 / 0.351 ms at Dh 320 / 512, against 10.58 / 13.10 ms on CUDA
// cores in the same call and SDPA's forward 0.216 / 0.333: 5.5 / 4.4
// times the bytes bound.  Tried beside it, in turns: Q resident in
// shared memory (only up to Dh 512, so a second path) with K streamed
// four chunks a stage, which cuts the L2 -> shared-memory stream by 36 /
// 40%, read 0.96 / 0.89 of its time; so that stream is not all that
// bounds it, and each block's serial chain per key tile (the chunks'
// products, the softmax, P V, each behind a barrier, with one block an
// SM) is the rest.

#include "sm90.cuh"

namespace {

using namespace sm90;
using namespace sm90::panels;

// item j of a block: key tile t = j / (np + 1); c = j % (np + 1) below
// np is the chunk pair c (Q and K, columns [128c, 128c + 128)), c = np
// the panel's columns of V
__device__ __forceinline__ void fwd_item(uint8_t* dst, uint64_t* bar,
                                         const CUtensorMap* q,
                                         const CUtensorMap* k,
                                         const CUtensorMap* v, int j, int np,
                                         int q0, int p0, int bh) {
  const int t = j / (np + 1), c = j % (np + 1), k0 = t * kBlock;
  if (c < np) {
    const int col = 2 * c * kChunk;
    const CUtensorMap* const maps[4] = {q, k, q, k};
    const int rows[4] = {q0, k0, q0, k0};
    const int cols[4] = {col, col, col + kChunk, col + kChunk};
    load_stage(dst, bar, maps, rows, cols, bh);
  } else {
    const CUtensorMap* const maps[4] = {v, v, v, v};
    const int rows[4] = {k0, k0, k0, k0};
    const int cols[4] = {p0, p0 + kChunk, p0 + 2 * kChunk, p0 + 3 * kChunk};
    load_stage(dst, bar, maps, rows, cols, bh);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_panels_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int tq, int tk, int dh,
                        int causal, float scale) {
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
  const int nc = (dh + kChunk - 1) / kChunk;  // chunks of S
  const int np = (nc + 1) / 2;                // ... two a stage
  int n_k = (tk + kBlock - 1) / kBlock;
  if (causal) n_k = min(n_k, qt + 1);         // key tiles up to the diagonal
  const int n_items = n_k * (np + 1);
  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int groups = live_groups(p0, dh);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg >= groups) return;  // its columns lie wholly past dh
  const CUtensorMap *mq = &tm_q, *mk = &tm_k, *mv = &tm_v;
  auto load_item = [&](int j) {
    fwd_item(ring + (j % kStages) * kStage, &full[j % kStages], mq, mk, mv,
             j, np, q0, p0, bh);
  };
  if (tid == 0)
    for (int j = 0; j < kStages && j < n_items; ++j) load_item(j);
  // item i is done in every live warpgroup: refill its stage
  auto advance = [&](int i) {
    sync_groups(groups * kThreads);
    if (tid == 0 && i + kStages < n_items) load_item(i + kStages);
  };

  const int col0 = p0 + wg * kHalf;  // this warpgroup's first O column
  const int warp = (tid % kThreads) / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0+8
  const int c0 = 2 * (lane % 4);             // and columns c0 + 8j + {0,1}
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  // the rows' running max (base 2) and sum, and this half of O
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kHalf / 2];
#pragma unroll
  for (int e = 0; e < kHalf / 2; ++e) acc[e] = 0.f;

  int i = 0;  // the item in hand
  for (int t = 0; t < n_k; ++t) {
    // S = Q K^T over the chunk pairs of Dh
    float sc[32] = {};
    for (int c = 0; c < np; ++c, ++i) {
      uint8_t* st = ring + (i % kStages) * kStage;  // Q_c, K_c, Q_c+1, K_c+1
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(sc, desc_k<kChunk>(st, kk), desc_k<kChunk>(st + kBox, kk),
                   c > 0 || kk > 0);
      if (2 * c + 1 < nc) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss64(sc, desc_k<kChunk>(st + 2 * kBox, kk),
                     desc_k<kChunk>(st + 3 * kBox, kk), 1);
      }
      wgmma_commit();
      if (c > 0) {  // the last pair's products are done
        wgmma_wait<1>();
        advance(i - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    advance(i - 1);

    // P, the rows' m and l, and O's rescale; P in bf16 as the A operand,
    // as the reference rounds it
    float corr[2];
    softmax_tile(sc, m, l, corr, r0, t * kBlock, c0, tk, causal, scale2);
    uint32_t a[4][4];
    to_a(sc, a);
#pragma unroll
    for (int e = 0; e < kHalf / 2; ++e) acc[e] *= corr[(e >> 1) & 1];

    // O += P V, this warpgroup's 128 columns of V's panel read MN-major
    uint8_t* vp = ring + (i % kStages) * kStage + wg * 2 * kBox;
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kHalf>(acc, a[kk], desc_mn<kChunk>(vp, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    advance(i++);
  }

  // O / l, then lse = m + log(l) (m is in base 2)
#pragma unroll
  for (int e = 0; e < kHalf / 2; ++e) acc[e] /= l[(e >> 1) & 1];
  store_rows_masked<kHalf>(out + (size_t)bh * tq * dh + col0, acc, r0, tq,
                           c0, dh, dh - col0);
  if (p == 0 && wg == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < tq)
        lse[(size_t)bh * tq + r] = m[h] * 0.6931471805599453f + logf(l[h]);
    }
  }
}

}  // namespace

// The bf16 entry point behind dkt_flash_fwd past head dim 256
// (flash_fwd.cu, which checks the arguments and sets the device): q (bh,
// tq, head_dim), k and v (bh, tk, head_dim), contiguous bf16, 16-byte
// aligned; head_dim > 256 and a multiple of 8; out like q, lse (bh, tq)
// f32.
cudaError_t flash_fwd_bf16_panels(const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  int bh, int tq, int tk, int head_dim,
                                  int causal, float scale,
                                  cudaStream_t stream) {
  // rows of head_dim columns read in 64 x 64 boxes
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map<kChunk>(&mq, q, bh, tq, head_dim)) != cudaSuccess)
    return err;
  if ((err = make_map<kChunk>(&mk, k, bh, tk, head_dim)) != cudaSuccess)
    return err;
  if ((err = make_map<kChunk>(&mv, v, bh, tk, head_dim)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(flash_fwd_panels_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  flash_fwd_panels_kernel<<<n_blocks(bh, tq, head_dim), kBlockThreads,
                            kSmemBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      tq, tk, head_dim, causal, scale);
  return cudaGetLastError();
}
