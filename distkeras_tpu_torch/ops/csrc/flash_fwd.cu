// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_fwd_kernel, the Pallas
// TPU kernel launched by _flash_fwd_raw.  Same function: for every
// (batch*head, query row) it streams the keys in tiles with the online
// softmax -- S = scale * Q K^T, causal mask k_pos <= q_pos with the tiles
// past the diagonal skipped, O = softmax(S) V, lse = m + log(l) -- and
// writes O in the input dtype and lse in f32.  Causal needs Tq == Tk;
// non-causal takes Tq != Tk.  f32 inputs are computed with f32 FMAs (the
// JAX package's HIGHEST policy: no TF32, no tensor cores); bf16 inputs
// are read as bf16 and widened, with f32 products, sums and statistics.
//
// What bounds it on this card: at the serving shapes (B*H = 8, T <= 512,
// Dh = 64, f32) the work is 4*T^2*Dh FLOPs per head (halved by the
// causal skip) against 67 TFLOP/s of f32 FMA, and the bytes are one read
// of Q, K, V and one write of O against 3.35 TB/s: bytes bound it up to
// T = 128, operations from T = 256 (by about 3x at T = 512).  Both
// bounds are a few microseconds at most, so what it really pays at these
// shapes is too few blocks for 132 SMs (B*H * T/64) and the
// shared-memory traffic of the CUDA-core products.
//
// Design: one block of 128 threads per (batch*head, 64-row query tile);
// a loop over 64-row K/V tiles staged in shared memory (widened to f32);
// each thread owns a 4x8 cell tile of S and a 4x(Dh/8) tile of O in
// registers, with the running max and sum for its 4 rows in f32
// registers (the 8 threads sharing a row reduce with warp shuffles).
// Rows and keys past the ends are masked, so any T works.  Padded
// shared-memory strides keep every warp access free of bank conflicts.
//
// Later work: the products on warpgroup MMA (wgmma: bf16 directly, f32
// as 3xTF32) with TMA loads into a ring of tiles and warp-specialized
// producers, and more blocks in flight at short T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;            // query rows per block
constexpr int kBlockN = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr int kTx = 8;                 // threads across a tile's columns
constexpr int kTy = kThreads / kTx;    // threads across its rows (16)
constexpr int kRm = kBlockM / kTy;     // rows per thread (4)
constexpr int kRn = kBlockN / kTx;     // score columns per thread (8)
constexpr int kLdp = kBlockN + 8;      // padded stride of the P tile

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((kBlockM + 2 * kBlockN) * (D + 1) + kBlockM * kLdp);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 float scale) {
  static_assert(D % kTx == 0, "head dim must be a multiple of 8");
  constexpr int kLd = D + 1;        // padded stride of the Q/K/V tiles
  constexpr int kRd = D / kTx;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBlockM][kLd]
  float* ks = qs + kBlockM * kLd;   // [kBlockN][kLd]
  float* vs = ks + kBlockN * kLd;   // [kBlockN][kLd]
  float* ps = vs + kBlockN * kLd;   // [kBlockM][kLdp]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    qs[r * kLd + c] = qr < tq ? widen(qb[(size_t)qr * D + c]) : 0.f;
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
    n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the last tile's readers are done with ks/vs/ps
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool ok = kr < tk;
      ks[r * kLd + c] = ok ? widen(kb[(size_t)kr * D + c]) : 0.f;
      vs[r * kLd + c] = ok ? widen(vb[(size_t)kr * D + c]) : 0.f;
    }
    __syncthreads();

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
      T* orow = o + ((size_t)bh * tq + r) * D;
#pragma unroll
      for (int c = 0; c < kRd; ++c) narrow(&orow[tx + kTx * c], acc[i][c] / l[i]);
      if (tx == 0) lse[(size_t)bh * tq + r] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k,
                              const void* v, void* o, void* lse, int bh,
                              int tq, int tk, int causal, float scale,
                              cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, tq, head_dim), k and v: (bh, tk, head_dim), contiguous, of
// dtype 0 (float32) or 1 (bfloat16); o: like q; lse: (bh, tq) float32.
// Launches on `stream` of `device` and returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int dkt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk,
                             int head_dim, int causal, float scale,
                             int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bh < 1 || tq < 1 || tk < 1 || (causal && tq != tk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_head_dim<float>(head_dim, q, k, v, o, lse, bh,
                                           tq, tk, causal, scale, s);
    case 1:
      return (int)dispatch_head_dim<__nv_bfloat16>(
          head_dim, q, k, v, o, lse, bh, tq, tk, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dkt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
