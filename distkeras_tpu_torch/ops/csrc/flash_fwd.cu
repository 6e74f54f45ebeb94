// Flash-attention forward for Hopper (sm_90a), with a plain C interface:
// K1.  This file holds the f32 kernel and the entry point for both
// dtypes; bf16 goes to the tensor-core kernel of flash_fwd_sm90.cu.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_fwd_kernel, the Pallas
// TPU kernel launched by _flash_fwd_raw.  Same function: for every
// (batch*head, query row) it streams the keys in tiles with the online
// softmax -- S = scale * Q K^T, causal mask k_pos <= q_pos with the tiles
// past the diagonal skipped, O = softmax(S) V, lse = m + log(l) -- and
// writes O in the input dtype and lse in f32.  Causal needs Tq == Tk;
// non-causal takes Tq != Tk.  The f32 kernel here computes with f32 FMAs
// (the JAX package's HIGHEST policy: no TF32, no tensor cores).
//
// What bounds it on this card: at the serving shapes (B*H = 8, T <= 512,
// Dh = 64) the work is 4*T^2*Dh FLOPs per head (halved by the causal
// skip) against 67 TFLOP/s of f32 FMA, and the bytes are one read of Q,
// K, V and one write of O against 3.35 TB/s: bytes bound it up to
// T = 128, operations from T = 256 (by about 3x at T = 512).  Both
// bounds are a few microseconds at most, so what it really pays at these
// shapes is the length of each block's serial chain of shared-memory
// loads and FMAs, and how few blocks there are for 132 SMs.
//
// Design: one block of 128 threads per (batch*head, query tile of BM
// rows); a loop over 64-row K/V tiles staged in shared memory; each thread
// owns a (BM/16)x8 cell tile of S and a (BM/16)x(Dh/8) tile of O in
// registers, with the running max and sum of its rows in f32 registers
// (the 8 threads sharing a row reduce with warp shuffles).  BM is 64
// where B*H*T/64 blocks already fill the card twice (the training shape)
// and 32 or 16 where they do not (the serving shapes), which shortens each
// block's chain and multiplies the blocks.  Every row keeps the same key
// tiles, products and summation order whatever BM is.  The next K/V tile
// is loaded into registers while the current one is computed.  Rows and
// keys past the ends are masked, so any T works.  At Dh = 128 the tiles
// are loaded without the register prefetch (O's tile doubles).  Padded shared-memory
// strides keep every warp access free of bank conflicts.
//
// Later work: f32 products as 3xTF32 on wgmma.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the bf16 kernel (flash_fwd_sm90.cu); head_dim 32, 64 or 128
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* out, void* lse, int bh, int tq, int tk,
                           int head_dim, int causal, float scale,
                           cudaStream_t stream);

namespace {

constexpr int kBlockN = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr int kTx = 8;                 // threads across a tile's columns
constexpr int kTy = kThreads / kTx;    // threads across its rows (16)
constexpr int kRn = kBlockN / kTx;     // score columns per thread (8)
constexpr int kLdp = kBlockN + 8;      // padded stride of the P tile

template <int D, int BM>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BM + 2 * kBlockN) * (D + 1) + BM * kLdp);
}

template <int D, int BM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 float scale) {
  static_assert(D % kTx == 0, "head dim must be a multiple of 8");
  static_assert(BM % kTy == 0, "query tile must be a multiple of 16 rows");
  constexpr int kRm = BM / kTy;     // rows per thread (1, 2 or 4)
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
  const float* qb = q + (size_t)bh * tq * D;
  const float* kb = k + (size_t)bh * tk * D;
  const float* vb = v + (size_t)bh * tk * D;

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    qs[r * kLd + c] = qr < tq ? qb[(size_t)qr * D + c] : 0.f;
  }

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
      const int kr = t * kBlockN + i / D;
      const bool ok = kr < tk;
      kn[it] = ok ? kb[(size_t)kr * D + i % D] : 0.f;
      vn[it] = ok ? vb[(size_t)kr * D + i % D] : 0.f;
    }
  };
  if (kPrefetch && n_tiles > 0) fetch(0);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the last tile's readers are done with ks/vs/ps
    if constexpr (kPrefetch) {
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int i = tid + kThreads * it;
        ks[(i / D) * kLd + i % D] = kn[it];
        vs[(i / D) * kLd + i % D] = vn[it];
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < kBlockN * D; i += kThreads) {
        const int kr = k0 + i / D;
        const bool ok = kr < tk;
        ks[(i / D) * kLd + i % D] = ok ? kb[(size_t)kr * D + i % D] : 0.f;
        vs[(i / D) * kLd + i % D] = ok ? vb[(size_t)kr * D + i % D] : 0.f;
      }
    }
    __syncthreads();
    if (kPrefetch && t + 1 < n_tiles) fetch(t + 1);

    float s[kRm][kRn];
#pragma unroll
    for (int i = 0; i < kRm; ++i)
#pragma unroll
      for (int j = 0; j < kRn; ++j) s[i][j] = 0.f;
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
        for (int j = 0; j < kRn; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
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
      float* orow = o + ((size_t)bh * tq + r) * D;
#pragma unroll
      for (int c = 0; c < kRd; ++c) orow[tx + kTx * c] = acc[i][c] / l[i];
      if (tx == 0) lse[(size_t)bh * tq + r] = m[i] + logf(l[i]);
    }
  }
}

template <int D, int BM>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + BM - 1) / BM);
  flash_fwd_kernel<D, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), tq, tk, causal, scale);
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

template <int D>
cudaError_t launch_f32(int rows, const void* q, const void* k, const void* v,
                       void* o, void* lse, int bh, int tq, int tk,
                       int causal, float scale, cudaStream_t stream) {
  switch (rows) {
    case 16:
      return launch<D, 16>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                           stream);
    case 32:
      return launch<D, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                           stream);
    default:
      return launch<D, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                           stream);
  }
}

}  // namespace

// q: (bh, tq, head_dim), k and v: (bh, tk, head_dim), contiguous, of
// dtype 0 (float32) or 1 (bfloat16, 16-byte aligned for TMA); o: like q;
// lse: (bh, tq) float32.  head_dim 32, 64 or 128.  Launches on `stream` of
// `device` and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int dkt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int head_dim, int causal, float scale,
                             int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bh < 1 || tq < 1 || tk < 1 || (causal && tq != tk) ||
      (head_dim != 32 && head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      int rows;
      if ((err = rows_per_block(device, bh, tq, &rows)) != cudaSuccess)
        return (int)err;
      switch (head_dim) {
        case 32:
          return (int)launch_f32<32>(rows, q, k, v, o, lse, bh, tq, tk,
                                     causal, scale, s);
        case 64:
          return (int)launch_f32<64>(rows, q, k, v, o, lse, bh, tq, tk,
                                     causal, scale, s);
        default:
          return (int)launch_f32<128>(rows, q, k, v, o, lse, bh, tq, tk,
                                      causal, scale, s);
      }
    }
    case 1:
      return (int)flash_fwd_bf16(q, k, v, o, lse, bh, tq, tk, head_dim,
                                 causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
