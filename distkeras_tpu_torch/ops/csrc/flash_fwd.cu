// Flash-attention forward for Hopper (sm_90a), with a plain C interface:
// K1.  This file holds the entry point for both dtypes and the f32
// CUDA-core kernel; the tensor-core kernels are beside it: f32 as 3xTF32
// on mma.sync (flash_fwd_tf32_sm90.cu), bf16 on wgmma and TMA
// (flash_fwd_sm90.cu up to head dim 256, flash_fwd_panels_sm90.cu past
// it).
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_fwd_kernel, the Pallas
// TPU kernel launched by _flash_fwd_raw.  Same function: for every
// (batch*head, query row) it streams the keys in tiles with the online
// softmax -- S = scale * Q K^T, causal mask k_pos <= q_pos with the tiles
// past the diagonal skipped, O = softmax(S) V, lse = m + log(l) -- and
// writes O in the input dtype and lse in f32.  In bf16, P = exp(S - m) is
// rounded to bf16 before P V and the row sum l is taken of the unrounded
// P, as the reference's _fwd_kernel rounds it (:111-112).  Causal needs
// Tq == Tk; non-causal takes Tq != Tk.
//
// Which kernel runs (dkt_flash_fwd), by dtype, head dim and grid:
//   - bf16, Dh a multiple of 8 up to 256: the wgmma kernel on the least
//     tile of 32, 64, 128, 192 or 256 columns that holds Dh, read from
//     unpadded rows (the wrapper pads other Dh to the next multiple of 8,
//     the TMA row stride);
//   - bf16, Dh a multiple of 8 past 256 (the reference's BlockSpecs span
//     any head dim): the wgmma kernel in 256-column output panels, S from
//     64-column chunks through a TMA ring (flash_fwd_panels_sm90.cu);
//   - f32, Dh <= 128, where 64-row query tiles give at least two blocks an
//     SM (the training shapes): the 3xTF32 kernel;
//   - f32, Dh <= 128, where they do not (the serving shapes, B*H = 8 and
//     T <= 512): the CUDA-core kernel here with 32- or 16-row tiles, which
//     fills the card with more, shorter blocks.  On an H100 it took
//     0.72-0.87x the 3xTF32 kernel's time at those shapes at Dh 64, and
//     the 3xTF32 kernel 0.31-0.61x its time at the training shapes;
//   - f32, Dh 129-256, at any grid: the 3xTF32 kernel's eight-warp form
//     (flash_fwd_tf32_wide_kernel).  At gpt_lm(dim=2048)'s serving joins
//     (B*H = 8, T 20-128, Dh 256) it took 0.55-0.80x the CUDA-core
//     kernel's time on an H100 (kernel_ab.py), and at its training shape
//     0.31-0.33x;
//   - f32 past Dh 256: the CUDA-core kernel.
// Both f32 kernels compute exact f32 products (the JAX package's HIGHEST
// policy); both are held against the plain version on the card.
//
// The CUDA-core kernel (f32 only): f32 FMAs, sums and statistics.  Its
// tiles are D = 32, 64, 128 (at the serving grids) or 256 (past Dh 256)
// columns wide, the columns past the caller's Dh zero-filled on load and
// never stored, so any Dh runs on unpadded rows.  Past Dh 256 a block computes one
// 256-column panel of O (the grid's third dimension holds the panels) and
// forms S over the whole Dh by staging Q and K in 256-column chunks, in
// order, so every panel's block sums S alike and holds the same P; panel
// 0 writes lse.  Registers and shared memory stay at the 256-wide
// tile's.
//
// What bounds it on this card: at the serving shapes (B*H = 8, T <= 512,
// Dh = 64) the work is 4*T^2*Dh FLOPs per head (halved by the causal
// skip) and the bytes are one read of Q, K, V and one write of O: bytes
// bound it up to T = 128, operations from T = 256.  Both bounds are a few
// microseconds at most, so what it pays there is the length of each
// block's serial chain of shared-memory loads and FMAs, and how few blocks
// there are for 132 SMs.  At Dh 256 (B*H = 128, T = 512, causal; gpt_lm at
// dim 2048, 8 heads, batch 16) it does 17.2 GFLOP: 0.104 ms at the 3xTF32
// rate (f32), 0.017 ms at bf16's; operations bound it, and FMAs on CUDA
// cores (67 TFLOP/s) cannot come near either, so both dtypes run there on
// the tensor-core kernels, as bf16 does past 256.
//
// Design: one block of 128 threads per (batch*head, query tile of BM
// rows); a loop over K/V tiles (64 rows, 32 on the 256-wide tile) staged
// in shared memory as f32; each thread owns a (BM/16)x(BN/8) cell tile of
// S and a (BM/16)x(D/8) tile of O in registers, with the running max and
// sum of its rows in f32 registers (the 8 threads sharing a row reduce
// with warp shuffles).  BM is 32 where B*H*T/32 blocks fill the card
// twice and 16 where they do not; on the 256-wide tile, 104 KB of shared
// memory at BM = 32 fit two blocks an SM.  Every row keeps the same key tiles, products and
// summation order whatever BM is.  Up to Dh 64 the next K/V tile is loaded
// into registers while the current one is computed.  Rows and keys past
// the ends are masked, so any T works.  Padded shared-memory strides keep
// every warp access free of bank conflicts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launched.h"

// the bf16 kernels: head_dim a multiple of 8, up to 256
// (flash_fwd_sm90.cu) and past it (flash_fwd_panels_sm90.cu)
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* out, void* lse, int bh, int tq, int tk,
                           int head_dim, int causal, float scale,
                           cudaStream_t stream);
cudaError_t flash_fwd_bf16_panels(const void* q, const void* k,
                                  const void* v, void* out, void* lse,
                                  int bh, int tq, int tk, int head_dim,
                                  int causal, float scale,
                                  cudaStream_t stream);
// the f32 tensor-core kernels (flash_fwd_tf32_sm90.cu); 1 <= head_dim <= 256
cudaError_t flash_fwd_f32(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int tq, int tk,
                          int head_dim, int causal, float scale,
                          cudaStream_t stream);

namespace {

constexpr int kThreads = 128;
constexpr int kTx = 8;                 // threads across a tile's columns
constexpr int kTy = kThreads / kTx;    // threads across its rows (16)

// keys per K/V tile at tile width D
template <int D>
__host__ __device__ constexpr int block_n() {
  return D > 128 ? 32 : 64;
}

template <int D, int BM>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BM + 2 * block_n<D>()) * (D + 1) +
                          BM * (block_n<D>() + 8));
}

template <int D, int BM, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int dh, int causal,
                 float scale) {
  static_assert(D % kTx == 0, "head dim must be a multiple of 8");
  static_assert(BM % kTy == 0, "query tile must be a multiple of 16 rows");
  constexpr int kBlockN = block_n<D>();  // keys per tile
  constexpr int kRn = kBlockN / kTx;     // score columns per thread
  constexpr int kLdp = kBlockN + 8;      // padded stride of the P tile
  constexpr int kRm = BM / kTy;     // rows per thread (1 or 2)
  constexpr int kLd = D + 1;        // padded stride of the Q/K/V tiles
  constexpr int kRd = D / kTx;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [BM][kLd]
  float* ks = qs + BM * kLd;        // [kBlockN][kLd]
  float* vs = ks + kBlockN * kLd;   // [kBlockN][kLd]
  float* ps = vs + kBlockN * kLd;   // [BM][kLdp]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const float* qb = q + (size_t)bh * tq * dh;
  const float* kb = k + (size_t)bh * tk * dh;
  const float* vb = v + (size_t)bh * tk * dh;

  // kChunked (the 256-wide tile, Dh > D): the block computes O's columns
  // [p0, p0 + D) (a panel; gridDim.z panels in all) and forms S over the
  // whole Dh in chunks of D columns, Q's and K's chunk c staged in turn.
  // Otherwise one chunk and one panel, at compile time, and Q is staged
  // once.
  const int p0 = kChunked ? blockIdx.z * D : 0;
  const int n_chunks = kChunked ? (dh + D - 1) / D : 1;
  // columns [c0, c0 + D) of Q; columns at or past dh (and rows past the
  // ends) read as 0
  auto load_q = [&](int c0) {
    for (int i = tid; i < BM * D; i += kThreads) {
      const int r = i / D, c = c0 + i % D;
      const int qr = q0 + r;
      qs[r * kLd + i % D] =
          qr < tq && c < dh ? qb[(size_t)qr * dh + c] : 0.f;
    }
  };
  if (n_chunks == 1) load_q(0);

  // this thread's rows are ty + kTy*i, its columns tx + kTx*j (S) and
  // tx + kTx*c (O)
  float m[kRm], l[kRm], acc[kRm][kRd];
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kRd; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (tk + kBlockN - 1) / kBlockN;
  if (causal) {
    // skip key tiles wholly in the future of this query tile
    n_tiles = min(n_tiles, (q0 + BM - 1) / kBlockN + 1);
  }

  // key tile t + 1 is loaded into registers while tile t is computed, so
  // each tile's load latency hides behind the previous tile's products.
  // At Dh = 128 those would be 128 registers a thread beside O's 64, so
  // each tile goes straight to shared memory instead.
  constexpr bool kPrefetch = D <= 64;
  constexpr int kLoads = kBlockN * D / kThreads;  // of K and of V, each
  float kn[kPrefetch ? kLoads : 1], vn[kPrefetch ? kLoads : 1];
  auto fetch = [&](int t) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + kThreads * it;
      const int kr = t * kBlockN + i / D, c = i % D;
      const bool ok = kr < tk && c < dh;
      kn[it] = ok ? kb[(size_t)kr * dh + c] : 0.f;
      vn[it] = ok ? vb[(size_t)kr * dh + c] : 0.f;
    }
  };
  if (kPrefetch && n_tiles > 0) fetch(0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    float s[kRm][kRn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kRn; ++j) s[i][j] = 0.f;
    // S over chunk c of Dh; V's panel arrives with the last chunk
    for (int ch = 0; ch < n_chunks; ++ch) {
      // the last chunk's (or tile's) readers are done with qs/ks/vs/ps
      __syncthreads();
      if constexpr (kPrefetch) {  // D <= 64: one chunk
#pragma unroll
        for (int it = 0; it < kLoads; ++it) {
          const int i = tid + kThreads * it;
          ks[(i / D) * kLd + i % D] = kn[it];
          vs[(i / D) * kLd + i % D] = vn[it];
        }
      } else {
        const int kc = ch * D;
        const bool last = ch == n_chunks - 1;
        if (n_chunks > 1) load_q(kc);
#pragma unroll 8
        for (int i = tid; i < kBlockN * D; i += kThreads) {
          const int kr = k0 + i / D, c = i % D;
          ks[(i / D) * kLd + c] =
              kr < tk && kc + c < dh ? kb[(size_t)kr * dh + kc + c] : 0.f;
          if (last)
            vs[(i / D) * kLd + c] =
                kr < tk && p0 + c < dh ? vb[(size_t)kr * dh + p0 + c] : 0.f;
        }
      }
      __syncthreads();
      if (kPrefetch && t + 1 < n_tiles) fetch(t + 1);

#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[kRm], kv[kRn];
#pragma unroll
        for (int i = 0; i < kRm; ++i) qv[i] = qs[(ty + kTy * i) * kLd + d];
#pragma unroll
        for (int j = 0; j < kRn; ++j) kv[j] = ks[(tx + kTx * j) * kLd + d];
#pragma unroll
        for (int i = 0; i < kRm; ++i)
#pragma unroll
          for (int j = 0; j < kRn; ++j)
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + kTy * i;
      const int q_pos = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const int k_pos = k0 + tx + kTx * j;
        const bool keep = k_pos < tk && (!causal || k_pos <= q_pos);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the kTx threads of a row are adjacent lanes of one warp
#pragma unroll
      for (int off = 1; off < kTx; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with every key masked so far keeps m = -inf: use 0 as its
      // reference so exp gives p = 0 and corr = 0 instead of NaN
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_ref);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const float p = expf(s[i][j] - m_ref);
        ps[row * kLdp + tx + kTx * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < kTx; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kRd; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBlockN; ++j) {
      float pv[kRm], vv[kRd];
#pragma unroll
      for (int i = 0; i < kRm; ++i) pv[i] = ps[(ty + kTy * i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kRd; ++c) vv[c] = vs[j * kLd + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int c = 0; c < kRd; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = q0 + ty + kTy * i;
    if (r < tq) {
      float* orow = o + ((size_t)bh * tq + r) * dh + p0;
#pragma unroll
      for (int c = 0; c < kRd; ++c)
        if (p0 + tx + kTx * c < dh) orow[tx + kTx * c] = acc[i][c] / l[i];
      if (tx == 0 && p0 == 0) lse[(size_t)bh * tq + r] = m[i] + logf(l[i]);
    }
  }
}

// the 256-wide tile runs only past Dh 256: panels and chunks
template <int D, int BM, bool kChunked = D == 256>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int dh, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BM, kChunked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // one panel of D output columns a block along z
  const dim3 grid(bh, (tq + BM - 1) / BM, (dh + D - 1) / D);
  flash_fwd_kernel<D, BM, kChunked><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

// The query-tile height for (bh, tq) on `device`: 64 rows, halved (down
// to 16) while the grid holds fewer than two blocks per SM.
cudaError_t rows_per_block(int device, int bh, int tq, int* rows) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *rows = 64;
  while (*rows > 16 &&
         (long long)bh * ((tq + *rows - 1) / *rows) < 2LL * sms)
    *rows /= 2;
  return cudaSuccess;
}

// the CUDA-core kernel at tile width D with `rows` (16, or 32 for more)
// query rows a block
template <int D>
cudaError_t launch_rows(int rows, const void* q, const void* k,
                        const void* v, void* o, void* lse, int bh, int tq,
                        int tk, int dh, int causal, float scale,
                        cudaStream_t stream) {
  return rows == 16 ? launch<D, 16>(q, k, v, o, lse, bh, tq, tk, dh, causal,
                                    scale, stream)
                    : launch<D, 32>(q, k, v, o, lse, bh, tq, tk, dh, causal,
                                    scale, stream);
}

}  // namespace

// q: (bh, tq, head_dim), k and v: (bh, tk, head_dim), contiguous, from
// 16-byte aligned addresses (the tensor-core kernels load by TMA or
// cp.async), of dtype 0 (float32) or 1 (bfloat16); o: like q; lse:
// (bh, tq) float32.  head_dim: float32 any >= 1; bfloat16 a multiple of
// 8.  Launches on `stream` of `device` and returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int dkt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int head_dim, int causal, float scale,
                             int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // bf16 runs on wgmma at every head dim, from rows of a 16-byte multiple
  const bool wgmma = dtype == 1;
  if (bh < 1 || tq < 1 || tk < 1 || head_dim < 1 || (causal && tq != tk) ||
      (dtype != 0 && dtype != 1) || (wgmma && head_dim % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma && head_dim > 256) {
    dkt_set_last_kernel(kWgmmaPast256);
    return (int)flash_fwd_bf16_panels(q, k, v, o, lse, bh, tq, tk, head_dim,
                                      causal, scale, s);
  }
  if (wgmma) {
    dkt_set_last_kernel(head_dim <= 128 ? kWgmma : kWgmmaWide);
    return (int)flash_fwd_bf16(q, k, v, o, lse, bh, tq, tk, head_dim, causal,
                               scale, s);
  }
  const bool wide = head_dim > 128;
  int rows;
  if ((err = rows_per_block(device, bh, tq, &rows)) != cudaSuccess)
    return (int)err;
  if (dtype == 0 && (wide ? head_dim <= 256 : rows == 64)) {
    // up to Dh 128 where the grid fills the card, at 129-256 at any grid:
    // tensor cores
    dkt_set_last_kernel(wide ? kTf32Wide : kTf32);
    return (int)flash_fwd_f32(q, k, v, o, lse, bh, tq, tk, head_dim, causal,
                              scale, s);
  }
  dkt_set_last_kernel(kCudaCores);
  if (wide)  // past 256
    return (int)launch_rows<256>(rows, q, k, v, o, lse, bh, tq, tk, head_dim,
                                 causal, scale, s);
  if (head_dim <= 32)
    return (int)launch_rows<32>(rows, q, k, v, o, lse, bh, tq, tk, head_dim,
                                causal, scale, s);
  if (head_dim <= 64)
    return (int)launch_rows<64>(rows, q, k, v, o, lse, bh, tq, tk, head_dim,
                                causal, scale, s);
  return (int)launch_rows<128>(rows, q, k, v, o, lse, bh, tq, tk, head_dim,
                               causal, scale, s);
}

namespace {
thread_local LaunchedKernel last_kernel = kCudaCores;
}  // namespace

void dkt_set_last_kernel(LaunchedKernel kernel) { last_kernel = kernel; }

// The kernel the calling thread's last launch through dkt_flash_fwd,
// dkt_flash_bwd_dq or dkt_flash_bwd_dkv ran (LaunchedKernel, launched.h).
extern "C" int dkt_flash_last_kernel() { return (int)last_kernel; }

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
