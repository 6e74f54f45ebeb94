// Flash-attention forward in f32 on Hopper's tensor cores (sm_90a), every
// product as 3xTF32: K1 for head dims up to 256.  Called from
// flash_fwd.cu's C interface (dkt_flash_fwd) for dtype 0: up to Dh 128
// where 64-row query tiles give at least two blocks an SM (smaller grids,
// the serving shapes, take the CUDA-core kernel there), at 129-256 at
// every grid (flash_fwd_tf32_wide_kernel, below).
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_fwd_kernel (:83) under
// the f32 branch of _dot/_dot_t (precision HIGHEST: exact f32 products).
// Same function: for every (batch*head, query row) it streams the keys in
// tiles with the online softmax -- S = scale * Q K^T, the causal mask
// k_pos <= q_pos (a select: -inf before the max, never exp of garbage),
// O = softmax(S) V, lse = m + log(l) -- and writes O and lse in f32.
// Causal needs Tq == Tk; non-causal takes Tq != Tk; any T.
//
// Any Dh <= 128 without a padded copy: the kernel is instantiated for tile
// widths D = 32, 64 and 128 and reads rows of the caller's Dh (dh), the
// columns [dh, D) of each shared-memory tile zero-filled (they add nothing
// to Q K^T and give O columns that are never stored).  Rows arrive by
// 16-byte cp.async when dh % 4 == 0 (a 16-byte aligned base is checked by
// the wrapper), by 4-byte cp.async otherwise.
//
// 3xTF32 as in flash_bwd_tf32_sm90.cu (its header has the recipe and the
// measurements behind it; the pieces are in tf32.cuh): each operand is
// split in registers into tf32 hi and lo as its fragment is loaded, each
// product is lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8, and because the
// tensor core rounds each mma's sum toward zero at its accumulator's
// magnitude, sums are kept short: S's hi*hi sums a pair of k-steps at a
// time from zero, added in f32, its small terms apart, and each half key
// tile's P V starts from zero and is added to O with an f32 add.
//
// What bounds it on this card: at the training shape (B*H = 512,
// T = 512, Dh = 64, causal) K1 does 4*Dh FLOPs per unmasked (q, k) pair,
// 17.2 GFLOP of f32 products, three times that on the TF32 tensor cores:
// 51.7 TFLOP at 495 TFLOP/s, 0.104 ms.  Its bytes (Q, K, V read once, O
// and lse written once) take 0.080 ms at 3.35 TB/s.  So operations bound
// it, and the kernel has to keep the tensor cores issuing with the
// splits, the exp and the shared-memory loads beside them.  At the
// serving shapes (B*H = 8, T <= 512) both bounds are a few microseconds;
// there what counts is how many blocks fill the 132 SMs and how long each
// block's chain of tiles is: a version of this kernel with one or two
// warps a block (16 or 32 query rows) measured 1.17-1.40x the CUDA-core
// kernel's time there on an H100, so it is not used there.
//
// Design: one block of four warps per (batch*head, 64-row query tile),
// each warp owning 16 rows.  Q's tile stays in shared memory; the 64-row
// K and V tiles stream through one buffer by cp.async, the blocks on an
// SM (two at Dh 128, three below) hiding one another's loads as the
// backward's do; blocks are issued from the last (longest causal) query
// tile down, and tiles past the diagonal are skipped.  A warp takes each
// key tile in two halves of 32 keys:
//   - S = Q K^T reads both fragments along Dh (rows of Q and K);
//   - the online softmax (max, rescale, row sum) runs on the accumulator
//     layout: a thread holds columns 2t, 2t + 1 of rows g and g + 8, and
//     the four threads that share a row reduce with quad shuffles.  A row
//     whose keys are all masked so far has m = -inf and takes 0 as its
//     reference, so p = 0 and the rescale 0 instead of NaN;
//   - O += P V takes P's accumulator as the A operand, split in place, in
//     the backward's permuted k order (logical t <-> physical 2t, t + 4 <->
//     2t + 1; the B fragment reads rows 2t and 2t + 1 of V), so nothing
//     moves between threads.  The A fragments of the half are split once
//     and the product runs over 32 output columns at a time, which keeps
//     the partial sum at 16 registers beside O's Dh / 2;
//   - a half whose first key is past the warp's last row is skipped
//     (causal): it would add exact zeros.
// Tiles sit at a row stride of Dh + 4 floats, so both fragment
// orientations hit 32 distinct banks.
//
// K1 at Dh 129-256 (flash_fwd_tf32_wide_kernel; the reference's
// BlockSpecs span any Dh): at B*H 128, T 512, Dh 256, causal (gpt_lm at
// dim 2048) it does 17.2 GFLOP, 0.104 ms at the 3xTF32 rate; its bytes
// take 0.080 ms, so operations bound it.  The design above does not carry
// over:
//   - Shared memory: a 64-row tile at stride 260 is 66.5 KB, so Q and
//     64-row K and V tiles would fill 200 KB with nothing loading ahead,
//     at one block an SM.  Q stays (64 rows); K and V stream in tiles of
//     32 keys through two stages, the next tile loading while this one is
//     used: 205 KB at D = 256 (tiles of 256 columns), 157 KB at 129-192
//     (D = 192).
//   - Registers: O over 16 rows and 256 columns is 128 f32 a thread.  A
//     block runs eight warps; w and w + 4 share 16 rows, each scores one
//     half (16 keys) of every tile over all of Dh, they agree on the rows'
//     maxima through shared memory, each hands its half of P to the other
//     (each lane's own accumulator values, a named barrier per pair) and
//     each accumulates O over one half of D (64 registers at D = 256).
//     Every product is formed once and both warps of a pair issue in both
//     products.  Measured against it on an H100 at 700 W (kernel_ab.py,
//     tree against tree; 0.358 / 0.505 ms at Dh 192 / 256 then): warp w
//     forming S and the softmax for the whole tile and handing P and the
//     rescale to w + 4, 0.407 / 0.577 ms (w + 4 waits through S); both
//     warps forming S over the whole tile (1.5x the products), 0.520 /
//     0.672 ms.  S's pairs of k-steps unrolled four at a time (not all
//     sixteen) took 228 registers without spills at D = 256, where all
//     sixteen spilled 196 bytes and ran 8% slower.
//   - Precision: S sums 32 k-steps, hi*hi in pairs from zero
//     (product_s); each tile's P V from zero, added to the rescaled O in
//     f32; each warp's row sum covers its keys, and the two are added at
//     the end.
//   - Rows: read unpadded at the caller's Dh, 16-byte cp.async where
//     Dh % 4 == 0 and 4-byte otherwise, tile columns past Dh zero-filled,
//     O stored masked at Dh.
//   - At gpt_lm(dim=2048)'s serving joins (B*H 8, T 20-128) it runs on
//     8-16 blocks and still took 0.49-0.67x the CUDA-core kernel's time
//     (0.41x at T 512), so it takes every grid at 129-256.
// Measured (chip_smoke.py k1, NVIDIA H100 80GB HBM3, 700.00 W): 0.3617 /
// 0.4695 ms at Dh 192 / 256 (B*H 128, T 512, causal), 22% / 22% of the
// 0.0782 / 0.1043 ms bound, 0.76x / 0.85x SDPA's f32 forward; the
// CUDA-core kernel it replaces there took 1.40 / 1.49 ms (kernel_ab.py).

#include <math.h>

#include "tf32.cuh"

namespace {

using tf32::cp_wait_all;
using tf32::join_halves;
using tf32::kHalf;
using tf32::kNJ;
using tf32::kSideKeys;
using tf32::kSideNJ;
using tf32::load_rows;
using tf32::pair_sync;
using tf32::product_pv;
using tf32::product_s;

constexpr int kBlock = 64;     // query rows of a block, keys of a tile
constexpr int kThreads = 128;  // four warps, 16 query rows each

// the register budget: three blocks an SM at D <= 64 (52 KB of shared
// memory each), two at D = 128 (101 KB)
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D > 64 ? 2 : 3;
}

// Q's tile and one K and one V tile, each 64 rows at stride D + 4
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * 3 * kBlock * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>())
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int dh,
                      int causal, float scale) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBlock][LD] each
  float* ks = qs + kBlock * LD;
  float* vs = ks + kBlock * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // long tiles first
  int n_k = (tk + kBlock - 1) / kBlock;
  if (causal) n_k = min(n_k, q0 / kBlock + 1);  // key tiles to the diagonal
  const bool vec = dh % 4 == 0;
  const float* kb = k + (size_t)bh * tk * dh;
  const float* vb = v + (size_t)bh * tk * dh;

  load_rows<D, kBlock, kThreads>(qs, q + (size_t)bh * tq * dh, q0, tq, dh,
                                 vec);
  load_rows<D, kBlock, kThreads>(ks, kb, 0, tk, dh, vec);
  load_rows<D, kBlock, kThreads>(vs, vb, 0, tk, dh, vec);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = 16 * warp;      // this warp's rows of the tile
  const int r0 = q0 + m0 + g;    // this thread's rows: r0, r0 + 8
  const int last = q0 + m0 + 15;  // the warp's last row
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kBlock;
    cp_wait_all();  // this tile (and Q) landed
    __syncthreads();

#pragma unroll 1
    for (int h = 0; h < kBlock; h += kHalf) {  // keys k0 + [h, h + kHalf)
      if (causal && k0 + h > last) break;       // all masked for this warp
      float sc[kNJ][4];
      product_s<D>(sc, qs, ks + h * LD, m0, g, t);  // S = Q K^T
      // scale and mask, then the rows' maxima over the half
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i >> 1);
          const int col = k0 + h + 8 * j + 2 * t + (i & 1);
          const bool keep = col < tk && (!causal || col <= row);
          sc[j][i] = keep ? sc[j][i] * scale : -INFINITY;
          mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
        }
      float m_ref[2], corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // the four threads of a row are lanes 4g .. 4g + 3
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[hh], mx[hh]);
        // a row with every key masked so far keeps m = -inf: use 0 as its
        // reference so exp gives p = 0 and corr = 0 instead of NaN
        m_ref[hh] = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = expf(m_run[hh] - m_ref[hh]);
        m_run[hh] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[j][i] = expf(sc[j][i] - m_ref[i >> 1]);
          rs[i >> 1] += sc[j][i];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
        l_run[hh] = l_run[hh] * corr[hh] + rs[hh];
      }
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jd][i] *= corr[i >> 1];
      product_pv<D>(acc, sc, vs + h * LD, g, t);  // O += P V
    }

    // every read of K and V is done: load the next tile
    __syncthreads();
    if (it + 1 < n_k) {
      load_rows<D, kBlock, kThreads>(ks, kb, k0 + kBlock, tk, dh, vec);
      load_rows<D, kBlock, kThreads>(vs, vb, k0 + kBlock, tk, dh, vec);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= tq) continue;
    float* row = o + ((size_t)bh * tq + r) * dh;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jd + 2 * t + e;
        if (c < dh) row[c] = acc[jd][2 * hh + e] / l_run[hh];
      }
    if (t == 0) lse[(size_t)bh * tq + r] = m_run[hh] + logf(l_run[hh]);
  }
}

// ---------------------------------------------------------------------------
// K1 at Dh 129-256: the keys of each tile split within a warp pair
// ---------------------------------------------------------------------------

// A block of eight warps per (batch*head, 64-row query tile); K and V
// stream in tiles of kHalf (32) keys.  Warps w and w + 4 (w < 4) share
// rows [16w, 16w + 16): each scores one half of every key tile (`side` 0
// the first) over all of Dh and accumulates O over one half of D (D / 4
// registers a thread).
constexpr int kWideThreads = 256;

// Q's tile (64 rows) and two stages of one K and one V tile (kHalf rows
// each), all at stride D + 4; each warp's half of P as its lanes hold it
// ([warp][j][lane]) and its rows' maxima ([warp][lane])
template <int D>
constexpr size_t wide_smem_bytes() {
  return sizeof(float) * ((kBlock + 4 * kHalf) * (D + 4) +
                          8 * kSideNJ * 32 * 4 + 8 * 32 * 2);
}

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_tf32_wide_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int tq, int tk, int dh,
                           int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int kCols = D / 2;  // O columns of a warp
  // S's pairs of k-steps unrolled four at a time: at D = 256 all sixteen
  // spilled (196 bytes) and ran 8% slower (kernel_ab.py, an H100)
  constexpr int kPairsAtOnce = 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBlock][LD]
  float* kv = qs + kBlock * LD;  // stage s: K then V, [kHalf][LD] each
  float4* xp = reinterpret_cast<float4*>(kv + 4 * kHalf * LD);
  float2* xm = reinterpret_cast<float2*>(xp + 8 * kSideNJ * 32);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // long tiles first
  int n_k = (tk + kHalf - 1) / kHalf;
  if (causal) n_k = min(n_k, (q0 + kBlock - 1) / kHalf + 1);
  const bool vec = dh % 4 == 0;
  const float* kb = k + (size_t)bh * tk * dh;
  const float* vb = v + (size_t)bh * tk * dh;
  auto load_kv = [&](int it) {
    float* ks = kv + (it & 1) * 2 * kHalf * LD;
    load_rows<D, kHalf, kWideThreads>(ks, kb, it * kHalf, tk, dh, vec);
    load_rows<D, kHalf, kWideThreads>(ks + kHalf * LD, vb, it * kHalf, tk,
                                      dh, vec);
  };
  load_rows<D, kBlock, kWideThreads>(qs, q + (size_t)bh * tq * dh, q0, tq,
                                     dh, vec);
  load_kv(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp % 4, side = warp / 4;
  const int m0 = 16 * pair;       // the pair's rows of the tile
  const int r0 = q0 + m0 + g;     // this thread's rows: r0, r0 + 8
  const int last = q0 + m0 + 15;  // the pair's last row
  const int c0 = side * kCols;    // this warp's O columns
  float2* my_m = xm + 32 * warp + lane;
  const float2* its_m = xm + 32 * (warp ^ 4) + lane;
  float4* my_p = xp + kSideNJ * 32 * warp + lane;
  const float4* its_p = xp + kSideNJ * 32 * (warp ^ 4) + lane;
  // the running max is the pair's; the row sum covers this warp's keys
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[kCols / 8][4];
#pragma unroll
  for (int jd = 0; jd < kCols / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jd][i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kHalf;
    cp_wait_all();  // this tile (and Q) landed
    __syncthreads();  // and every warp is done with the other stage
    if (it + 1 < n_k) load_kv(it + 1);
    if (causal && k0 > last) continue;  // all masked for the pair
    const float* ks = kv + (it & 1) * 2 * kHalf * LD;
    const float* vs = ks + kHalf * LD;

    // S = Q K^T over this warp's keys of the tile
    float sc[kSideNJ][4];
    product_s<D, kPairsAtOnce>(sc, qs, ks + side * kSideKeys * LD, m0, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSideNJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 8 * (i >> 1);
        const int col = k0 + side * kSideKeys + 8 * j + 2 * t + (i & 1);
        const bool keep = col < tk && (!causal || col <= row);
        sc[j][i] = keep ? sc[j][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    // the rows' maxima over both halves of the tile
    *my_m = make_float2(mx[0], mx[1]);
    pair_sync(1 + pair);
    const float2 its = *its_m;
    mx[0] = fmaxf(mx[0], its.x);
    mx[1] = fmaxf(mx[1], its.y);
    float m_ref[2], corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      // a row with every key masked so far keeps m = -inf: use 0 as its
      // reference so exp gives p = 0 and corr = 0 instead of NaN
      m_ref[hh] = m_new == -INFINITY ? 0.f : m_new;
      corr[hh] = expf(m_run[hh] - m_ref[hh]);
      m_run[hh] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kSideNJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[j][i] = expf(sc[j][i] - m_ref[i >> 1]);
        rs[i >> 1] += sc[j][i];
      }
      my_p[32 * j] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l_run[hh] = l_run[hh] * corr[hh] + rs[hh];
    }
#pragma unroll
    for (int jd = 0; jd < kCols / 8; ++jd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jd][i] *= corr[i >> 1];
    // P over the tile's kHalf keys: this warp's half and the partner's
    pair_sync(1 + pair);
    float p[kNJ][4];
    join_halves(p, sc, its_p, side);
    product_pv<D, true, 4, kCols>(acc, p, vs + c0, g, t);  // O += P V
  }

  // the row sums over both halves (the partner is past its last read of
  // the maxima: it has met this warp at the tile's second barrier)
  *my_m = make_float2(l_run[0], l_run[1]);
  pair_sync(1 + pair);
  const float2 its = *its_m;
  const float l_row[2] = {l_run[0] + its.x, l_run[1] + its.y};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= tq) continue;
    float* row = o + ((size_t)bh * tq + r) * dh;
#pragma unroll
    for (int jd = 0; jd < kCols / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * jd + 2 * t + e;
        if (c < dh) row[c] = acc[jd][2 * hh + e] / l_row[hh];
      }
    if (side == 0 && t == 0)
      lse[(size_t)bh * tq + r] = m_run[hh] + logf(l_row[hh]);
  }
}

template <int D>
cudaError_t launch_wide(const float* q, const float* k, const float* v,
                        float* o, float* lse, int bh, int tq, int tk, int dh,
                        int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = wide_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_wide_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_fwd_tf32_wide_kernel<D><<<grid, kWideThreads, smem, stream>>>(
      q, k, v, o, lse, tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int tq, int tk, int dh, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_fwd_tf32_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The f32 entry point behind dkt_flash_fwd (flash_fwd.cu, which checks
// the arguments and sets the device): q (bh, tq, head_dim), k and v
// (bh, tk, head_dim), contiguous f32 from 16-byte aligned addresses, o like
// q, lse (bh, tq); 1 <= head_dim <= 256.
cudaError_t flash_fwd_f32(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int tq, int tk,
                          int head_dim, int causal, float scale,
                          cudaStream_t stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* out = static_cast<float*>(o);
  auto* l = static_cast<float*>(lse);
  if (head_dim <= 32)
    return launch<32>(f(q), f(k), f(v), out, l, bh, tq, tk, head_dim, causal,
                      scale, stream);
  if (head_dim <= 64)
    return launch<64>(f(q), f(k), f(v), out, l, bh, tq, tk, head_dim, causal,
                      scale, stream);
  if (head_dim <= 128)
    return launch<128>(f(q), f(k), f(v), out, l, bh, tq, tk, head_dim,
                       causal, scale, stream);
  if (head_dim <= 192)
    return launch_wide<192>(f(q), f(k), f(v), out, l, bh, tq, tk, head_dim,
                            causal, scale, stream);
  return launch_wide<256>(f(q), f(k), f(v), out, l, bh, tq, tk, head_dim,
                          causal, scale, stream);
}
