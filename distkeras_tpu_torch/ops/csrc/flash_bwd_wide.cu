// Flash-attention backward on CUDA cores past head dim 256: K2 (dQ) and
// K3 (dK, dV) in both dtypes.  Up to 256 both run on Hopper's tensor cores
// (flash_bwd_tf32_sm90.cu in f32, flash_bwd_sm90.cu in bf16).  Called
// from flash_bwd.cu's C interface (dkt_flash_bwd_dq, dkt_flash_bwd_dkv).
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2,
// :169) and _bwd_dkv_kernel (K3, :200), whose BlockSpecs span any head
// dim.  Same function: with P = exp(scale * Q K^T - L) under the causal
// mask k_pos <= q_pos (a select: a masked entry is exactly 0),
// dP = dO V^T and dS = scale * P o (dP - D),
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// f32 inputs are computed with f32 FMAs (the JAX package's HIGHEST
// policy: exact products); bf16 inputs are read as bf16 and widened, with
// f32 products, sums and statistics, and P and dS rounded to bf16 before
// the second products, as the reference's kernels round them (dS is
// formed from the unrounded P).  The outputs are written in the input
// dtype.  Causal needs Tq == Tk; non-causal takes Tq != Tk; any T.
//
// Tiles are D = 256 columns wide.  A block computes one 256-column panel
// of its outputs (dQ; dK and dV), the grid's third dimension holding the
// panels, and forms S and dP over the whole Dh by staging its operands in
// 256-column chunks, in order, so every panel's block holds the same P
// and dS; then the panel's columns of K (K2) or of Q and dO (K3) are
// staged for the second products.  Columns past the caller's Dh are
// zero-filled on load and never stored, so any Dh runs on unpadded rows.
// Registers and shared memory stay at the single tile's.
//
// What bounds them on this card: at B*H = 128, T = 512, Dh = 320, causal,
// K2 does 6*Dh and K3 8*Dh FLOPs per unmasked (q, k) pair, 32.3 and 43.0
// GFLOP: 0.196 and 0.261 ms at the 3xTF32 rate of 165 TFLOP/s (f32),
// 0.033 and 0.043 ms at bf16's 989.  Operations bound both; f32 FMAs on
// CUDA cores (67 TFLOP/s) cannot reach that, and these kernels, staging
// every operand through shared memory, reach a fraction of the FMA rate
// (12-20 ms at Dh 320 and 512 on an H100 at 700 W).  They are the simple
// ones: no configuration or probe of the repo has heads past 256.
//
// An f32 output can equal the plain version (flash_bwd_plain) bit for
// bit: cuBLAS's f32 products at these shapes sum in order with FMA, as
// these loops do, and the kernel's s * scale - L, contracted to one FMA,
// rounds as the plain version's multiply and subtract do when the product
// is exact (a scale that is a power of two).  chip_smoke.py's
// k2k3_exact_reading row shows the first; the check itself is live there
// (a value moved by 1e-4 fails it).
//
// Design (the simple CUDA-core backward): K2 is one block of 128 threads
// per (batch*head, 32-row query tile, panel) that loops over 16-row K/V
// tiles, staging Q, dO, K and V chunk by chunk to recompute S and dP per
// tile, and accumulates its panel of dQ in registers.  K3 is one block per
// (batch*head, 16-row key tile, panel) that loops over 32-row Q/dO tiles
// from the diagonal on, accumulating dK and dV in registers.  The tile
// heights keep a thread's accumulators at 64 floats (2 x 32 of dQ;
// 1 x 32 each of dK and dV) and each block's shared memory near 100 KB,
// two blocks an SM.  Each output has one writer and the reference's
// summation order (over key tiles for dQ, over query tiles for dK and
// dV), no atomics.  Padded shared-memory strides keep warp accesses free
// of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 256;                // tile width
constexpr int kLd = kD + 1;            // padded stride of the (rows, kD) tiles
constexpr int kThreads = 128;
constexpr int kTx = 8;                 // threads across a tile's columns
constexpr int kTy = kThreads / kTx;    // threads across its rows (16)
constexpr int kRd = kD / kTx;          // output columns per thread (32)

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x as a second product reads it: itself in f32, rounded to bf16 in bf16
__device__ __forceinline__ float as_operand(float x, float) { return x; }
__device__ __forceinline__ float as_operand(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [r0, r0 + ROWS), columns [c0, c0 + kD) of a contiguous (n, dh)
// matrix into a padded f32 tile of kD columns; rows past n and columns
// past dh read as 0.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n,
                                      int dh, int c0 = 0) {
#pragma unroll 8
  for (int i = threadIdx.x; i < ROWS * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r * kLd + c] = r0 + r < n && c0 + c < dh
                           ? widen(src[(size_t)(r0 + r) * dh + c0 + c])
                           : 0.f;
  }
}

// Entries [r0, r0 + N) of a length-n f32 vector; past n read as 0.
template <int N>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < N; i += kThreads)
    dst[i] = r0 + i < n ? src[r0 + i] : 0.f;
}

// c[i][j] = sum_d x[row i][d] y[col j][d] for this thread's kRm rows of x
// (ty + kTy*i) and kRn rows of y (tx + kTx*j), contracted over kD; with
// `add`, added to c (the next chunk of Dh)
template <int kRm, int kRn>
__device__ __forceinline__ void scores(float (&c)[kRm][kRn], const float* x,
                                       const float* y, int tx, int ty,
                                       bool add = false) {
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < kRn; ++j)
      if (!add) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float xv[kRm], yv[kRn];
#pragma unroll
    for (int i = 0; i < kRm; ++i) xv[i] = x[(ty + kTy * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < kRn; ++j) yv[j] = y[(tx + kTx * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kRn; ++j) c[i][j] = fmaf(xv[i], yv[j], c[i][j]);
  }
}

// acc[i][c] += sum_j a[row i][j] y[j][col c] for this thread's kRm rows of
// the (rows, N) tile `a` (row stride N + 8) and its output columns
// tx + kTx*c of y
template <int kRm, int N>
__device__ __forceinline__ void accumulate(float (&acc)[kRm][kRd],
                                           const float* a, const float* y,
                                           int tx, int ty) {
#pragma unroll 8
  for (int j = 0; j < N; ++j) {
    float av[kRm], yv[kRd];
#pragma unroll
    for (int i = 0; i < kRm; ++i) av[i] = a[(ty + kTy * i) * (N + 8) + j];
#pragma unroll
    for (int c = 0; c < kRd; ++c) yv[c] = y[j * kLd + tx + kTx * c];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int c = 0; c < kRd; ++c) acc[i][c] = fmaf(av[i], yv[c], acc[i][c]);
  }
}

// rows r0 + ty + kTy*i, columns [p0, p0 + kD) of a (n, dh) output from
// acc, columns past dh and rows past n skipped
template <typename T, int kRm>
__device__ __forceinline__ void store(T* out, const float (&acc)[kRm][kRd],
                                      int r0, int n, int dh, int p0, int tx,
                                      int ty) {
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = r0 + ty + kTy * i;
    if (r >= n) continue;
    T* row = out + (size_t)r * dh + p0;
#pragma unroll
    for (int c = 0; c < kRd; ++c)
      if (p0 + tx + kTx * c < dh) narrow(&row[tx + kTx * c], acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

constexpr int kDqRows = 32;  // query rows of a block (resident)
constexpr int kDqKeys = 16;  // keys of a streamed tile

constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (kDqRows + kDqKeys) * kLd +
                          kDqRows * (kDqKeys + 8));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dq,
                         int tq, int tk, int dh, int causal, float scale) {
  constexpr int kRm = kDqRows / kTy;  // rows per thread (2)
  constexpr int kRn = kDqKeys / kTx;  // keys per thread (2)
  constexpr int kLdp = kDqKeys + 8;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kDqRows][kLd]
  float* dos = qs + kDqRows * kLd;     // [kDqRows][kLd]
  float* ks = dos + kDqRows * kLd;     // [kDqKeys][kLd]
  float* vs = ks + kDqKeys * kLd;      // [kDqKeys][kLd]
  float* ps = vs + kDqKeys * kLd;      // dS, [kDqRows][kLdp]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kDqRows;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const T* qb = q + (size_t)bh * tq * dh;
  const T* db = dout + (size_t)bh * tq * dh;
  const T* kb = k + (size_t)bh * tk * dh;
  const T* vb = v + (size_t)bh * tk * dh;
  // this block's panel of dQ, and the chunks of Dh (> kD) that S and dP
  // sum
  const int p0 = blockIdx.z * kD;
  const int n_chunks = (dh + kD - 1) / kD;

  // this thread's rows are ty + kTy*i, its keys tx + kTx*j
  float l_row[kRm], d_row[kRm], acc[kRm][kRd];
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = q0 + ty + kTy * i;
    l_row[i] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[i] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kRd; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (tk + kDqKeys - 1) / kDqKeys;
  // causal: skip key tiles wholly in the future of this query tile
  if (causal) n_tiles = min(n_tiles, (q0 + kDqRows - 1) / kDqKeys + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kDqKeys;
    float s[kRm][kRn], dp[kRm][kRn];
    for (int ch = 0; ch < n_chunks; ++ch) {
      // the last tile's (or chunk's) readers are done with the tiles
      __syncthreads();
      stage<T, kDqRows>(qs, qb, q0, tq, dh, ch * kD);
      stage<T, kDqRows>(dos, db, q0, tq, dh, ch * kD);
      stage<T, kDqKeys>(ks, kb, k0, tk, dh, ch * kD);
      stage<T, kDqKeys>(vs, vb, k0, tk, dh, ch * kD);
      __syncthreads();
      scores<kRm, kRn>(s, qs, ks, tx, ty, ch > 0);
      scores<kRm, kRn>(dp, dos, vs, tx, ty, ch > 0);
    }
    if (p0 != (n_chunks - 1) * kD) {  // K's panel for dQ += dS K
      __syncthreads();
      stage<T, kDqKeys>(ks, kb, k0, tk, dh, p0);
    }
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + kTy * i;
      const int q_pos = q0 + row;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const int col = tx + kTx * j;
        const int k_pos = k0 + col;
        const bool keep =
            q_pos < tq && k_pos < tk && (!causal || k_pos <= q_pos);
        const float p = keep ? expf(s[i][j] * scale - l_row[i]) : 0.f;
        ps[row * kLdp + col] =
            as_operand(p * (dp[i][j] - d_row[i]) * scale, T());
      }
    }
    __syncthreads();
    accumulate<kRm, kDqKeys>(acc, ps, ks, tx, ty);  // dQ += dS K
  }
  store<T, kRm>(dq + (size_t)bh * tq * dh, acc, q0, tq, dh, p0, tx, ty);
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

constexpr int kDkvKeys = 16;  // keys of a block (resident)
constexpr int kDkvRows = 32;  // query rows of a streamed tile

constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (kDkvKeys + kDkvRows) * kLd +
                          kDkvKeys * (kDkvRows + 8) + 2 * kDkvRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec, T* __restrict__ dk,
                          T* __restrict__ dv, int tq, int tk, int dh,
                          int causal, float scale) {
  constexpr int kRm = kDkvKeys / kTy;  // keys per thread (1)
  constexpr int kRn = kDkvRows / kTx;  // queries per thread (4)
  constexpr int kLdp = kDkvRows + 8;
  extern __shared__ float smem[];
  float* ks = smem;                    // [kDkvKeys][kLd]
  float* vs = ks + kDkvKeys * kLd;     // [kDkvKeys][kLd]
  float* qs = vs + kDkvKeys * kLd;     // [kDkvRows][kLd]
  float* dos = qs + kDkvRows * kLd;    // [kDkvRows][kLd]
  float* ps = dos + kDkvRows * kLd;    // P^T then dS^T, [kDkvKeys][kLdp]
  float* ls = ps + kDkvKeys * kLdp;    // L of the query tile
  float* dls = ls + kDkvRows;          // D of the query tile

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kDkvKeys;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const T* qb = q + (size_t)bh * tq * dh;
  const T* db = dout + (size_t)bh * tq * dh;
  const T* kb = k + (size_t)bh * tk * dh;
  const T* vb = v + (size_t)bh * tk * dh;
  // this block's panel of dK and dV, and the chunks of Dh (> kD) that S
  // and dP sum
  const int p0 = blockIdx.z * kD;
  const int n_chunks = (dh + kD - 1) / kD;

  // this thread's keys are ty + kTy*i; its queries tx + kTx*j (the
  // transposed S, P, dP, dS tiles) and output columns tx + kTx*c
  float acc_k[kRm][kRd], acc_v[kRm][kRd];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int c = 0; c < kRd; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_tiles = (tq + kDkvRows - 1) / kDkvRows;
  // causal: skip query tiles wholly before this key tile
  const int first = causal ? k0 / kDkvRows : 0;

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * kDkvRows;
    // S^T = K Q^T and dP^T = V dO^T
    float pt[kRm][kRn], dpt[kRm][kRn];
    for (int ch = 0; ch < n_chunks; ++ch) {
      // the last tile's (or chunk's) readers are done with the tiles
      __syncthreads();
      stage<T, kDkvKeys>(ks, kb, k0, tk, dh, ch * kD);
      stage<T, kDkvKeys>(vs, vb, k0, tk, dh, ch * kD);
      stage<T, kDkvRows>(qs, qb, q0, tq, dh, ch * kD);
      stage<T, kDkvRows>(dos, db, q0, tq, dh, ch * kD);
      if (ch == 0) {
        stage_vec<kDkvRows>(ls, lse + (size_t)bh * tq, q0, tq);
        stage_vec<kDkvRows>(dls, dvec + (size_t)bh * tq, q0, tq);
      }
      __syncthreads();
      scores<kRm, kRn>(pt, ks, qs, tx, ty, ch > 0);
      scores<kRm, kRn>(dpt, vs, dos, tx, ty, ch > 0);
    }
    if (p0 != (n_chunks - 1) * kD) {  // Q's and dO's panel for dK, dV
      __syncthreads();
      stage<T, kDkvRows>(qs, qb, q0, tq, dh, p0);
      stage<T, kDkvRows>(dos, db, q0, tq, dh, p0);
    }

    // P^T = exp(scale * S^T - L) under the mask, kept unrounded for dS
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + kTy * i;
      const int k_pos = k0 + row;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const int col = tx + kTx * j;
        const int q_pos = q0 + col;
        const bool keep =
            q_pos < tq && k_pos < tk && (!causal || k_pos <= q_pos);
        pt[i][j] = keep ? expf(pt[i][j] * scale - ls[col]) : 0.f;
        ps[row * kLdp + col] = as_operand(pt[i][j], T());
      }
    }
    __syncthreads();
    accumulate<kRm, kDkvRows>(acc_v, ps, dos, tx, ty);  // dV += P^T dO
    __syncthreads();  // every thread has read P^T

    // dS^T = scale * P^T o (dP^T - D), in place of P^T
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + kTy * i;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const int col = tx + kTx * j;
        ps[row * kLdp + col] =
            as_operand(pt[i][j] * (dpt[i][j] - dls[col]) * scale, T());
      }
    }
    __syncthreads();
    accumulate<kRm, kDkvRows>(acc_k, ps, qs, tx, ty);  // dK += dS^T Q
  }
  store<T, kRm>(dk + (size_t)bh * tk * dh, acc_k, k0, tk, dh, p0, tx, ty);
  store<T, kRm>(dv + (size_t)bh * tk * dh, acc_v, k0, tk, dh, p0, tx, ty);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dvec,
                      void* dq, int bh, int tq, int tk, int dh, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kDqRows - 1) / kDqRows, (dh + kD - 1) / kD);
  flash_bwd_dq_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dvec,
                       void* dk, void* dv, int bh, int tq, int tk, int dh,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kDkvKeys - 1) / kDkvKeys, (dh + kD - 1) / kD);
  flash_bwd_dkv_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The entry points behind dkt_flash_bwd_dq / dkt_flash_bwd_dkv on CUDA
// cores (flash_bwd.cu, which checks the arguments and sets the device):
// q, k, v, dout contiguous, of dtype 0 (float32) or 1 (bfloat16), rows of
// head_dim > 256 values.
cudaError_t flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dvec, void* dq, int bh, int tq,
                              int tk, int head_dim, int causal, float scale,
                              int dtype, cudaStream_t stream) {
  auto f = dtype == 0 ? launch_dq<float> : launch_dq<__nv_bfloat16>;
  return f(q, k, v, dout, lse, dvec, dq, bh, tq, tk, head_dim, causal, scale,
           stream);
}

cudaError_t flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dk, void* dv, int bh,
                               int tq, int tk, int head_dim, int causal,
                               float scale, int dtype, cudaStream_t stream) {
  auto f = dtype == 0 ? launch_dkv<float> : launch_dkv<__nv_bfloat16>;
  return f(q, k, v, dout, lse, dvec, dk, dv, bh, tq, tk, head_dim, causal,
           scale, stream);
}
