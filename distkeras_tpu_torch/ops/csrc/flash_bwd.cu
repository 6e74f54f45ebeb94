// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// K2 (dQ) and K3 (dK, dV).  This file holds the f32 kernels and the entry
// points for both dtypes; bf16 goes to the tensor-core kernels of
// flash_bwd_sm90.cu.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2) and
// _bwd_dkv_kernel (K3), the Pallas TPU kernels launched by
// _flash_bwd_raw.  Same function: with P = exp(scale * Q K^T - L) under
// the causal mask k_pos <= q_pos (L the forward's per-row logsumexp),
// dP = dO V^T and dS = scale * P o (dP - D) (D = rowsum(dO o O), computed
// by the caller, with any lse cotangent already folded in as D - g_lse):
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// Causal needs Tq == Tk and skips the tiles past the diagonal; non-causal
// takes Tq != Tk.  The f32 kernels here compute with f32 FMAs (the JAX
// package's HIGHEST policy: no TF32, no tensor cores), which is the
// parity path; the timed main path trains in bf16.
//
// What bounds them on this card: at the training shape (B*H = 512,
// T = 512, Dh = 64, causal) K2 does 6*Dh and K3 8*Dh FLOPs per unmasked
// (q, k) pair -- 26 and 34 GFLOP -- against 67 TFLOP/s of f32 FMA, about
// 0.4 and 0.5 ms; the bytes are about 0.06 ms.  So operations bound both,
// by more than 5x.  These CUDA-core products reach a fraction of that
// peak: every FMA of a 4x8 register tile costs shared-memory loads, and
// only two 85 KB blocks fit on an SM.  Expect several times the bound.
//
// Design: K2 is one block of 128 threads per (batch*head, 64-row query
// tile) that keeps its Q and dO tiles in shared memory and loops over the
// 64-row K/V tiles, recomputing S and dP per tile and accumulating dQ in
// registers.  K3 is one block per (batch*head, 64-row key tile) that keeps
// K and V and loops over the Q/dO tiles from the diagonal on, accumulating
// dK and dV in registers.  Each output has one writer and the reference's
// summation order (over key tiles for dQ, over query tiles for dK/dV), so
// no atomics.  Rows and keys past the ends are masked by a select (masked
// P is exactly 0, never exp of garbage), so any T works.  Padded
// shared-memory strides keep warp accesses free of bank conflicts.
//
// Later work: f32 products as 3xTF32 on wgmma.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the bf16 kernels (flash_bwd_sm90.cu); head_dim 32 or 64
cudaError_t flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dvec, void* dq, int bh, int tq,
                              int tk, int head_dim, int causal, float scale,
                              cudaStream_t stream);
cudaError_t flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dk, void* dv, int bh,
                               int tq, int tk, int head_dim, int causal,
                               float scale, cudaStream_t stream);

namespace {

constexpr int kBlock = 64;             // rows of every tile (queries or keys)
constexpr int kThreads = 128;
constexpr int kTx = 8;                 // threads across a tile's columns
constexpr int kTy = kThreads / kTx;    // threads across its rows (16)
constexpr int kRm = kBlock / kTy;      // tile rows per thread (4)
constexpr int kRn = kBlock / kTx;      // tile columns per thread (8)
constexpr int kLdp = kBlock + 8;       // padded stride of the P / dS tile

// four (kBlock, D) f32 tiles, the P/dS tile, and two kBlock vectors
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * kBlock * (D + 1) + kBlock * kLdp + 2 * kBlock);
}

// Rows [r0, r0 + kBlock) of a contiguous (n, D) matrix into a padded f32
// tile; rows past n read as 0.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int n) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < n ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// Entries [r0, r0 + kBlock) of a length-n f32 vector; past n read as 0.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads)
    dst[i] = r0 + i < n ? src[r0 + i] : 0.f;
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  static_assert(D % kTx == 0, "head dim must be a multiple of 8");
  constexpr int kLd = D + 1;        // padded stride of the (kBlock, D) tiles
  constexpr int kRd = D / kTx;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBlock][kLd]
  float* dos = qs + kBlock * kLd;   // [kBlock][kLd]
  float* ks = dos + kBlock * kLd;   // [kBlock][kLd]
  float* vs = ks + kBlock * kLd;    // [kBlock][kLd]
  float* ps = vs + kBlock * kLd;    // dS, [kBlock][kLdp]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;
  stage<D>(qs, q + (size_t)bh * tq * D, q0, tq);
  stage<D>(dos, dout + (size_t)bh * tq * D, q0, tq);

  // this thread's rows are ty + kTy*i, its columns tx + kTx*j (S, dP) and
  // tx + kTx*c (dQ)
  float l_row[kRm], d_row[kRm], acc[kRm][kRd];
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = q0 + ty + kTy * i;
    l_row[i] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[i] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kRd; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (tk + kBlock - 1) / kBlock;
  if (causal) {
    // skip key tiles wholly in the future of this query tile
    n_tiles = min(n_tiles, (q0 + kBlock - 1) / kBlock + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // the last tile's readers are done with ks/vs/ps
    stage<D>(ks, kb, k0, tk);
    stage<D>(vs, vb, k0, tk);
    __syncthreads();

    float s[kRm][kRn], dp[kRm][kRn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kRn; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[kRm], dov[kRm], kv[kRn], vv[kRn];
#pragma unroll
      for (int i = 0; i < kRm; ++i) {
        qv[i] = qs[(ty + kTy * i) * kLd + d];
        dov[i] = dos[(ty + kTy * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        kv[j] = ks[(tx + kTx * j) * kLd + d];
        vv[j] = vs[(tx + kTx * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kRn; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
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
        ps[row * kLdp + col] = p * (dp[i][j] - d_row[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBlock; ++j) {
      float dsv[kRm], kv[kRd];
#pragma unroll
      for (int i = 0; i < kRm; ++i) dsv[i] = ps[(ty + kTy * i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kRd; ++c) kv[c] = ks[j * kLd + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int c = 0; c < kRd; ++c)
          acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = q0 + ty + kTy * i;
    if (r < tq) {
      float* row = dq + ((size_t)bh * tq + r) * D;
#pragma unroll
      for (int c = 0; c < kRd; ++c) row[tx + kTx * c] = acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dk,
                     float* __restrict__ dv, int tq, int tk, int causal,
                     float scale) {
  static_assert(D % kTx == 0, "head dim must be a multiple of 8");
  constexpr int kLd = D + 1;
  constexpr int kRd = D / kTx;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kBlock][kLd]
  float* vs = ks + kBlock * kLd;    // [kBlock][kLd]
  float* qs = vs + kBlock * kLd;    // [kBlock][kLd]
  float* dos = qs + kBlock * kLd;   // [kBlock][kLd]
  float* ps = dos + kBlock * kLd;   // P^T then dS^T, [kBlock][kLdp]
  float* ls = ps + kBlock * kLdp;   // L of the query tile, [kBlock]
  float* dls = ls + kBlock;         // D of the query tile, [kBlock]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const float* qb = q + (size_t)bh * tq * D;
  const float* db = dout + (size_t)bh * tq * D;
  stage<D>(ks, k + (size_t)bh * tk * D, k0, tk);
  stage<D>(vs, v + (size_t)bh * tk * D, k0, tk);

  // this thread's key rows are ty + kTy*i; its query columns tx + kTx*j
  // (the transposed S, P, dP, dS tiles) and output columns tx + kTx*c
  float acc_k[kRm][kRd], acc_v[kRm][kRd];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int c = 0; c < kRd; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_tiles = (tq + kBlock - 1) / kBlock;
  // causal: skip query tiles wholly above this key tile's diagonal
  const int first = causal ? k0 / kBlock : 0;

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();  // the last tile's readers are done with qs/dos/ps
    stage<D>(qs, qb, q0, tq);
    stage<D>(dos, db, q0, tq);
    stage_vec(ls, lse + (size_t)bh * tq, q0, tq);
    stage_vec(dls, dvec + (size_t)bh * tq, q0, tq);
    __syncthreads();

    // P^T = exp(scale * K Q^T - L) under the mask
    float st[kRm][kRn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kRn; ++j) st[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[kRm], qv[kRn];
#pragma unroll
      for (int i = 0; i < kRm; ++i) kv[i] = ks[(ty + kTy * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kRn; ++j) qv[j] = qs[(tx + kTx * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kRn; ++j) st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
    }
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
        ps[row * kLdp + col] = keep ? expf(st[i][j] * scale - ls[col]) : 0.f;
      }
    }
    __syncthreads();

    // dV += P^T dO
#pragma unroll 8
    for (int j = 0; j < kBlock; ++j) {
      float pv[kRm], dov[kRd];
#pragma unroll
      for (int i = 0; i < kRm; ++i) pv[i] = ps[(ty + kTy * i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kRd; ++c) dov[c] = dos[j * kLd + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int c = 0; c < kRd; ++c)
          acc_v[i][c] = fmaf(pv[i], dov[c], acc_v[i][c]);
    }

    // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kRn; ++j) st[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float vv[kRm], dov[kRn];
#pragma unroll
      for (int i = 0; i < kRm; ++i) vv[i] = vs[(ty + kTy * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kRn; ++j) dov[j] = dos[(tx + kTx * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kRn; ++j) st[i][j] = fmaf(vv[i], dov[j], st[i][j]);
    }
    __syncthreads();  // every thread has read P^T for dV

    // dS^T = scale * P^T o (dP^T - D), in place of P^T
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = ty + kTy * i;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const int col = tx + kTx * j;
        float* e = &ps[row * kLdp + col];
        *e = *e * (st[i][j] - dls[col]) * scale;
      }
    }
    __syncthreads();

    // dK += dS^T Q
#pragma unroll 8
    for (int j = 0; j < kBlock; ++j) {
      float dsv[kRm], qv[kRd];
#pragma unroll
      for (int i = 0; i < kRm; ++i) dsv[i] = ps[(ty + kTy * i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kRd; ++c) qv[c] = qs[j * kLd + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int c = 0; c < kRd; ++c)
          acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = k0 + ty + kTy * i;
    if (r < tk) {
      float* krow = dk + ((size_t)bh * tk + r) * D;
      float* vrow = dv + ((size_t)bh * tk + r) * D;
#pragma unroll
      for (int c = 0; c < kRd; ++c) {
        krow[tx + kTx * c] = acc_k[i][c];
        vrow[tx + kTx * c] = acc_v[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void *dq, *dk, *dv;
  int bh, tq, tk, causal;
  float scale;
};

template <int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tq + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dvec),
      static_cast<float*>(a.dq), a.tq, a.tk, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tk + kBlock - 1) / kBlock);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dvec),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.tq, a.tk,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_bf16(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq, a.bh,
                           a.tq, a.tk, D, a.causal, a.scale, stream);
}

template <int D>
cudaError_t launch_dkv_bf16(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_bf16(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv,
                            a.bh, a.tq, a.tk, D, a.causal, a.scale, stream);
}

using Launcher = cudaError_t (*)(const BwdArgs&, cudaStream_t);

// The launcher for (dtype, head_dim), or nullptr.  Order of `table`:
// (f32, 32), (f32, 64), (bf16, 32), (bf16, 64).
Launcher pick(const Launcher (&table)[4], int dtype, int head_dim) {
  if ((dtype != 0 && dtype != 1) || (head_dim != 32 && head_dim != 64))
    return nullptr;
  return table[2 * dtype + (head_dim == 64 ? 1 : 0)];
}

int run(Launcher f, const BwdArgs& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (f == nullptr || a.bh < 1 || a.tq < 1 || a.tk < 1 ||
      (a.causal && a.tq != a.tk))
    return (int)cudaErrorInvalidValue;
  return (int)f(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q and dout: (bh, tq, head_dim); k and v: (bh, tk, head_dim); all
// contiguous, of dtype 0 (float32) or 1 (bfloat16, 16-byte aligned for
// TMA); lse and dvec: (bh, tq) float32.  dq is written like q.  Launches
// on `stream` of `device` and returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int dkt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dvec, void* dq, int bh, int tq,
                                int tk, int head_dim, int causal, float scale,
                                int dtype, int device, void* stream) {
  static const Launcher table[4] = {
      launch_dq<32>, launch_dq<64>, launch_dq_bf16<32>, launch_dq_bf16<64>};
  const BwdArgs a{q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
                  bh, tq, tk, causal, scale};
  return run(pick(table, dtype, head_dim), a, device, stream);
}

// As dkt_flash_bwd_dq; dk and dv are written like k and v.
extern "C" int dkt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dvec, void* dk, void* dv, int bh,
                                 int tq, int tk, int head_dim, int causal,
                                 float scale, int dtype, int device,
                                 void* stream) {
  static const Launcher table[4] = {
      launch_dkv<32>, launch_dkv<64>, launch_dkv_bf16<32>,
      launch_dkv_bf16<64>};
  const BwdArgs a{q, k, v, dout, lse, dvec, nullptr, dk, dv,
                  bh, tq, tk, causal, scale};
  return run(pick(table, dtype, head_dim), a, device, stream);
}
