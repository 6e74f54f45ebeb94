// Flash-attention backward in bf16 on Hopper's tensor cores (sm_90a):
// K2 (dQ) and K3 (dK, dV) at head dims 32, 64 and 128, and at 129-256.
// Called from flash_bwd.cu's C interface (dkt_flash_bwd_dq,
// dkt_flash_bwd_dkv) for dtype 1; bf16 past 256 runs on CUDA cores
// (flash_bwd_wide.cu).
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2) and
// _bwd_dkv_kernel (K3) under the bf16 branch of _dot/_dot_t.  With
// P = exp(scale * Q K^T - L) under the causal mask k_pos <= q_pos (a
// select: a masked entry is exactly 0), dP = dO V^T (bf16 operands, f32
// sums) and dS = scale * P o (dP - D) in f32, P and dS are rounded to
// bf16 before the second products, as the reference rounds them:
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// with f32 accumulators and bf16 outputs.  Causal needs Tq == Tk;
// non-causal takes Tq != Tk; any T (ragged tiles are zero-filled by TMA
// and masked).
//
// What bounds them on this card: at the training shape (B*H = 512,
// T = 512, Dh = 64, causal) K2 does 25.8 and K3 34.4 GFLOP, 0.026 and
// 0.035 ms at 989 TFLOP/s of bf16 tensor cores; their bytes (Q, K, V, dO
// bf16 and L, D f32 read once, the gradients written once) take 0.051 and
// 0.061 ms at 3.35 TB/s.  So bytes bound both, with the operations close
// behind: the kernels have to keep the tensor cores fed from shared memory
// and their exp/select work off the critical path.  At Dh 256 (B*H =
// 128, gpt_lm at dim 2048) K2 and K3 do the same 25.8 and 34.4 GFLOP
// over the same bytes: 0.050 and 0.060 ms by bytes.
//
// Design: one warpgroup (128 threads) per block and 64-row tiles, the
// wgmma M.  K2 is one block per (batch*head, query tile), issued from the
// last (longest causal) query tile down, looping over key tiles up to the
// diagonal; K3 one block per (batch*head, key tile), issued from the first
// key tile up, looping over query tiles from the diagonal on.  Each output
// has one writer, no atomics.  Every product is wgmma.mma_async m64nNk16,
// bf16 -> f32:
//   - S = Q K^T and dP = dO V^T (K2), S^T = K Q^T and dP^T = V dO^T (K3):
//     both operands in shared memory, K-major (Dh is contiguous);
//   - dQ += dS K, dV += P^T dO, dK += dS^T Q: A from registers, the f32
//     accumulator of S or dP converted to bf16 in place (the m64nNk16
//     accumulator and A-fragment layouts line up), B in shared memory
//     MN-major through wgmma's transpose-B bit.
// The resident tiles (Q and dO for K2, K and V for K3) and a two-stage
// ring of streamed tiles (K and V, or Q and dO) arrive by TMA on mbarriers
// from 3-D tensor maps (Dh, T, B*H), so a ragged last tile reads zeros,
// never the next head.  The swizzle is 128 B for Dh = 64 and 64 B for
// Dh = 32 (one tile row), the same in the tensor map and the wgmma
// descriptor; a block holds six 64-row tiles, 48 KB at Dh = 64.  At
// Dh = 128 a tile is two 64-column panels (a swizzled TMA box is at most
// one swizzle row wide), one box each, and the products step across them
// (sm90.cuh); K3 runs two warpgroups, each forming the whole S^T and
// dP^T but holding the dK and dV of one panel, since one warpgroup's
// 2 x 64 accumulator registers a thread would spill.
//
// K2 and K3 at Dh 129-256 (the reference's BlockSpecs span any Dh) are
// the same kernels on 256-wide tiles of four panels, read from unpadded
// rows of Dh columns (Dh % 8 == 0, the TMA row stride; the wrapper pads
// other Dh to the next multiple of 8), the columns past Dh zero-filled by
// TMA (a box wholly past Dh reads zeros) and the outputs stored masked at
// Dh.  A warpgroup's accumulators would not fit: dK and dV are
// 2 x 64 x 256 f32, 256 registers a thread, and dQ's 128 beside S, dP
// and dS's A fragments would come to about 210.  So both run two
// warpgroups, each holding a 128-column half of the outputs (two panels)
// and each forming the whole S and dP (S^T and dP^T): K3 1.5x the
// minimal products, K2 1.67x, for no traffic between them.  Measured
// against the minimal products for K3 on an H100 at 700 W (kernel_ab.py,
// tree against tree): warpgroup 0 forming S^T and P, warpgroup 1 dP^T
// and dS from P passed in f32, P^T and dS^T written in bf16 to swizzled
// shared memory as both warpgroups' A operands, ran 7-9% slower at Dh 192
// and 256: the products saved cost two block barriers and a serial
// P -> dS hand-off a query tile.  K2 on two warpgroups takes 0.146 /
// 0.155 ms at Dh 192 / 256 (B*H 128, T 512, causal; an H100 at 700 W),
// 156 registers, against 2.37 / 2.47 ms on CUDA cores in the same call.
// Its minimal-products twin (warpgroup 0 forming S and P, warpgroup 1 dP
// and dS, P in f32 and dS's bf16 A fragments passed lane to lane through
// shared memory, 161 registers) ran 3.6-4.5% faster with identical
// outputs (kernel_ab.py, tree against tree): 0.006 ms a call, 0.02 ms of
// the 32 ms gpt_lm step at dim 2048, not worth a second kernel.
// Q, dO (K2) or K, V (K3) resident and the ring are six 32 KB tiles,
// 192 KB: one block of 256 threads an SM.  L and D
// rows of (B*H, Tq) f32 are not 16-byte aligned at odd Tq, so TMA cannot
// take them: K2 reads its two rows per thread once, K3 stages each query
// tile's 64 + 64 values in shared memory a tile ahead.  The stores are
// masked at T.
//
// Later work: a producer warp with setmaxnreg and two consumer
// warpgroups on 128-row tiles, exp2 with the scale folded in, TMA stores,
// and fusing K2 into K3 (dQ by atomics) if a measurement says so.

#include "sm90.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

// K2's warpgroups, each forming the whole S and dP and holding D /
// dq_groups columns of dQ: one up to Dh 128 (at most 64 accumulator
// registers a thread), two at 256, 128 columns each (64 registers beside
// S, dP and dS's A fragments)
template <int D>
__host__ __device__ constexpr int dq_groups() {
  return D == 256 ? 2 : 1;
}
template <int D>
constexpr int dq_threads() {
  return kThreads * dq_groups<D>();
}

template <int D>
__global__ void __launch_bounds__(dq_threads<D>())
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          __nv_bfloat16* __restrict__ dq, int tq, int tk,
                          int dh, int causal, float scale) {
  constexpr uint32_t kTile = Tile<D>::kBytes;
  // the dQ columns a warpgroup owns
  constexpr int kN = D / dq_groups<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];  // the resident tiles, ring stages 0 and 1
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* qs = smem;           // resident Q and dO
  uint8_t* dos = smem + kTile;
  // stage s: K at smem + (2 + 2s) * kTile, V right after it

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the long tiles first
  const int q0 = qt * kBlock;
  int n_k = (tk + kBlock - 1) / kBlock;
  if (causal) n_k = min(n_k, qt + 1);  // key tiles up to the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * kTile);
    tma_load_tile<D>(qs, &tm_q, &bars[0], q0, bh);
    tma_load_tile<D>(dos, &tm_do, &bars[0], q0, bh);
    for (int t = 0; t < 2 && t < n_k; ++t) {
      uint8_t* ks = smem + (2 + 2 * t) * kTile;
      mbar_expect_tx(&bars[1 + t], 2 * kTile);
      tma_load_tile<D>(ks, &tm_k, &bars[1 + t], t * kBlock, bh);
      tma_load_tile<D>(ks + kTile, &tm_v, &bars[1 + t], t * kBlock, bh);
    }
  }

  // this warpgroup's columns of dQ (a constant 0 at one group)
  constexpr bool kSplit = dq_groups<D>() > 1;
  const int wg = kSplit ? tid / kThreads : 0;
  const int warp = (kSplit ? tid % kThreads : tid) / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0+8
  const int c0 = 2 * (lane % 4);             // and columns c0 + 8j + {0,1}
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l_row[h] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[h] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
  }
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int t = 0; t < n_k; ++t) {
    const int s = t & 1;
    const int k0 = t * kBlock;
    uint8_t* ks = smem + (2 + 2 * s) * kTile;
    uint8_t* vs = ks + kTile;
    // this warpgroup's panels of K, the B of its dQ product
    constexpr uint32_t kOwn = kN / Tile<D>::kCols * Tile<D>::kPanelBytes;
    uint8_t* kp = ks + wg * kOwn;
    mbar_wait(&bars[1 + s], (t >> 1) & 1);

    // S = Q K^T and dP = dO V^T, two groups
    float sc[32] = {}, dp[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(sc, desc_k<D>(qs, kk), desc_k<D>(ks, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(dp, desc_k<D>(dos, kk), desc_k<D>(vs, kk), kk > 0);
    wgmma_commit();

    // P = exp(scale * S - L) under the mask, while dP finishes
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = r0 + 8 * ((e >> 1) & 1);
      const int col = k0 + 8 * (e >> 2) + c0 + (e & 1);
      const bool keep = row < tq && col < tk && (!causal || col <= row);
      sc[e] = keep ? expf(sc[e] * scale - l_row[(e >> 1) & 1]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = scale * P o (dP - D), rounded to bf16 as the A operand
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = sc[e] * (dp[e] - d_row[(e >> 1) & 1]) * scale;
    uint32_t a[4][4];
    to_a(dp, a);

    // dQ += dS K, K read MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kN>(acc, a[kk], desc_mn<D>(kp, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // every read of this stage is done: refill it with key tile t + 2
    __syncthreads();
    if (tid == 0 && t + 2 < n_k) {
      mbar_expect_tx(&bars[1 + s], 2 * kTile);
      tma_load_tile<D>(ks, &tm_k, &bars[1 + s], k0 + 2 * kBlock, bh);
      tma_load_tile<D>(vs, &tm_v, &bars[1 + s], k0 + 2 * kBlock, bh);
    }
  }
  if constexpr (D > 128) {  // rows of dh columns
    store_rows_masked<kN>(dq + (size_t)bh * tq * dh + wg * kN, acc, r0, tq,
                          c0, dh, dh - wg * kN);
  } else {
    store_rows<D>(dq + (size_t)bh * tq * D, acc, r0, tq, c0);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

// K3's warpgroups, each forming the whole S^T and dP^T and holding D /
// dkv_groups columns of dK and dV: one at Dh 32 and 64, one per 64-column
// panel at 128 (a thread's two accumulators stay at 64 registers), and
// two at 256, 128 columns each (128 registers)
template <int D>
__host__ __device__ constexpr int dkv_groups() {
  return D == 256 ? 2 : Tile<D>::kPanels;
}
template <int D>
constexpr int dkv_threads() {
  return kThreads * dkv_groups<D>();
}

template <int D>
__global__ void __launch_bounds__(dkv_threads<D>())
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int tq, int tk,
                           int dh, int causal, float scale) {
  constexpr uint32_t kTile = Tile<D>::kBytes;
  // the dK, dV columns a warpgroup owns
  constexpr int kN = D / dkv_groups<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];  // the resident tiles, ring stages 0 and 1
  // L and D of a query tile, one buffer per ring stage
  __shared__ float stats[2][2][kBlock];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ks = smem;           // resident K and V
  uint8_t* vs = smem + kTile;
  // stage s: Q at smem + (2 + 2s) * kTile, dO right after it

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles (long causal loops) first
  const int k0 = kt * kBlock;
  const int first = causal ? kt : 0;  // query tiles from the diagonal on
  const int n_q = (tq + kBlock - 1) / kBlock - first;
  const int tid = threadIdx.x;
  const float* lse_bh = lse + (size_t)bh * tq;
  const float* dvec_bh = dvec + (size_t)bh * tq;
  // this warpgroup's columns of dK and dV (a constant 0 at one group)
  constexpr bool kSplit = dkv_groups<D>() > 1;
  const int wg = kSplit ? tid / kThreads : 0;
  // query tile `it` of the loop's L (threads 0-63) and D (64-127)
  auto stage_stats = [&](int it) {
    if (kSplit && tid >= 2 * kBlock) return;
    const int i = tid % kBlock, q = (first + it) * kBlock + i;
    const float* src = tid < kBlock ? lse_bh : dvec_bh;
    stats[it & 1][tid / kBlock][i] = q < tq ? src[q] : 0.f;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stage_stats(0);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * kTile);
    tma_load_tile<D>(ks, &tm_k, &bars[0], k0, bh);
    tma_load_tile<D>(vs, &tm_v, &bars[0], k0, bh);
    for (int it = 0; it < 2 && it < n_q; ++it) {
      uint8_t* qs = smem + (2 + 2 * it) * kTile;
      mbar_expect_tx(&bars[1 + it], 2 * kTile);
      tma_load_tile<D>(qs, &tm_q, &bars[1 + it], (first + it) * kBlock, bh);
      tma_load_tile<D>(qs + kTile, &tm_do, &bars[1 + it],
                       (first + it) * kBlock, bh);
    }
  }

  const int warp = (kSplit ? tid % kThreads : tid) / 32, lane = tid % 32;
  const int r0 = k0 + 16 * warp + lane / 4;  // this thread's keys: r0, r0+8
  const int c0 = 2 * (lane % 4);             // its queries c0 + 8j + {0,1}
  float acc_k[kN / 2], acc_v[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it & 1;
    const int q0 = (first + it) * kBlock;
    uint8_t* qs = smem + (2 + 2 * s) * kTile;
    uint8_t* dos = qs + kTile;
    // this warpgroup's panels of Q and dO, the B of its second products
    constexpr uint32_t kOwn = kN / Tile<D>::kCols * Tile<D>::kPanelBytes;
    uint8_t* qp = qs + wg * kOwn;
    uint8_t* dop = dos + wg * kOwn;
    const float* ls = stats[s][0];
    const float* dls = stats[s][1];
    mbar_wait(&bars[1 + s], (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T, two groups
    float st[32] = {}, dpt[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(st, desc_k<D>(ks, kk), desc_k<D>(qs, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(dpt, desc_k<D>(vs, kk), desc_k<D>(dos, kk), kk > 0);
    wgmma_commit();

    // P^T = exp(scale * S^T - L) under the mask
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = r0 + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + c0 + (e & 1);
      const int qpos = q0 + col;
      const bool keep = qpos < tq && key < tk && (!causal || key <= qpos);
      st[e] = keep ? expf(st[e] * scale - ls[col]) : 0.f;
    }
    uint32_t pa[4][4];
    to_a(st, pa);

    // dV += P^T dO, dO read MN-major, while dS^T is formed
    fence_regs(acc_v);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kN>(acc_v, pa[kk], desc_mn<D>(dop, kk));
    wgmma_commit();

    // dS^T = scale * P^T o (dP^T - D)
    wgmma_wait<1>();
    fence_regs(dpt);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e >> 2) + c0 + (e & 1);
      dpt[e] = st[e] * (dpt[e] - dls[col]) * scale;
    }
    uint32_t da[4][4];
    to_a(dpt, da);

    // dK += dS^T Q, Q read MN-major
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kN>(acc_k, da[kk], desc_mn<D>(qp, kk));
    wgmma_commit();
    if (it + 1 < n_q) stage_stats(it + 1);
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);

    // every read of this stage is done: refill it with query tile it + 2
    __syncthreads();
    if (tid == 0 && it + 2 < n_q) {
      mbar_expect_tx(&bars[1 + s], 2 * kTile);
      tma_load_tile<D>(qs, &tm_q, &bars[1 + s], q0 + 2 * kBlock, bh);
      tma_load_tile<D>(dos, &tm_do, &bars[1 + s], q0 + 2 * kBlock, bh);
    }
  }
  if constexpr (D > 128) {  // rows of dh columns
    const size_t col = (size_t)bh * tk * dh + wg * kN;
    store_rows_masked<kN>(dk + col, acc_k, r0, tk, c0, dh, dh - wg * kN);
    store_rows_masked<kN>(dv + col, acc_v, r0, tk, c0, dh, dh - wg * kN);
  } else {
    const size_t col = (size_t)bh * tk * D + wg * kN;
    store_rows<kN, D>(dk + col, acc_k, r0, tk, c0);
    store_rows<kN, D>(dv + col, acc_v, r0, tk, c0);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      const void* dout, int bh, int tq, int tk, int d) {
  cudaError_t err;
  if ((err = make_map(&m->q, q, bh, tq, d)) != cudaSuccess) return err;
  if ((err = make_map(&m->k, k, bh, tk, d)) != cudaSuccess) return err;
  if ((err = make_map(&m->v, v, bh, tk, d)) != cudaSuccess) return err;
  return make_map(&m->dout, dout, bh, tq, d);
}

// six tiles and the slack to align them
template <int D>
constexpr size_t smem_bytes() {
  return 6 * Tile<D>::kBytes + 1024;
}

template <int D>
cudaError_t launch_dq(const Maps& m, const float* lse, const float* dvec,
                      void* dq, int bh, int tq, int tk, int dh, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_bwd_dq_wgmma_kernel<D><<<grid, dq_threads<D>(), smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, dvec, static_cast<__nv_bfloat16*>(dq), tq,
      tk, dh, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Maps& m, const float* lse, const float* dvec,
                       void* dk, void* dv, int bh, int tq, int tk, int dh,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, dkv_threads<D>(), smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, dvec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The bf16 entry points behind dkt_flash_bwd_dq / dkt_flash_bwd_dkv
// (flash_bwd.cu, which checks the arguments and sets the device): q, k,
// v, dout contiguous bf16, 16-byte aligned; head_dim 32, 64 or 128, or a
// multiple of 8 in 129-256.
cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dvec, void* dq, int bh, int tq,
                              int tk, int head_dim, int causal, float scale,
                              cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, bh, tq, tk, head_dim);
  if (err != cudaSuccess) return err;
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dvec);
  const int dh = head_dim;
  switch (head_dim) {
    case 32:
      return launch_dq<32>(m, l, d, dq, bh, tq, tk, dh, causal, scale,
                           stream);
    case 64:
      return launch_dq<64>(m, l, d, dq, bh, tq, tk, dh, causal, scale,
                           stream);
    case 128:
      return launch_dq<128>(m, l, d, dq, bh, tq, tk, dh, causal, scale,
                            stream);
    default:  // 129-256
      return launch_dq<256>(m, l, d, dq, bh, tq, tk, dh, causal, scale,
                            stream);
  }
}

cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dk, void* dv, int bh,
                               int tq, int tk, int head_dim, int causal,
                               float scale, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, bh, tq, tk, head_dim);
  if (err != cudaSuccess) return err;
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dvec);
  const int dh = head_dim;
  switch (head_dim) {
    case 32:
      return launch_dkv<32>(m, l, d, dk, dv, bh, tq, tk, dh, causal, scale,
                            stream);
    case 64:
      return launch_dkv<64>(m, l, d, dk, dv, bh, tq, tk, dh, causal, scale,
                            stream);
    case 128:
      return launch_dkv<128>(m, l, d, dk, dv, bh, tq, tk, dh, causal, scale,
                             stream);
    default:  // 129-256
      return launch_dkv<256>(m, l, d, dk, dv, bh, tq, tk, dh, causal, scale,
                             stream);
  }
}
