// Flash-attention backward in bf16 on Hopper's tensor cores (sm_90a):
// K2 (dQ) and K3 (dK, dV).  Called from flash_bwd.cu's C interface
// (dkt_flash_bwd_dq, dkt_flash_bwd_dkv) for dtype 1; f32 stays there.
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
// and their exp/select work off the critical path.
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
// descriptor; a block holds six 64-row tiles, 48 KB at Dh = 64.  L and D
// rows of (B*H, Tq) f32 are not 16-byte aligned at odd Tq, so TMA cannot
// take them: K2 reads its two rows per thread once, K3 stages each query
// tile's 64 + 64 values in shared memory a tile ahead.  The stores are
// masked at T.
//
// Later work: a producer warp with setmaxnreg and two consumer
// warpgroups on 128-row tiles, exp2 with the scale folded in, TMA stores,
// and fusing K2 into K3 (dQ by atomics) if a measurement says so.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // rows of every tile; the wgmma M
constexpr int kThreads = 128;  // one warpgroup

// ---------------------------------------------------------------------------
// PTX: shared memory, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the barrier's phase `parity` to complete.  A transaction that
// never lands (a bad tensor map) traps after some seconds instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// rows [row, row + kBlock) of head `bh` of a (Dh, T, B*H) tensor map into
// a tile of shared memory; completes `bytes` of the barrier's transaction
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(bh)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Tile geometry for head dim D: a (kBlock, D) bf16 tile has rows of
// D * 2 bytes, one swizzle row (128 B at D = 64, 64 B at D = 32); eight
// rows form one swizzle atom.
template <int D>
struct Tile {
  static constexpr uint32_t kBytes = kBlock * D * 2;
  static constexpr uint32_t kAtom = 8 * D * 2;              // 8 rows
  static constexpr uint64_t kLayout = D == 64 ? 1 : 2;      // 128B / 64B
};

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle.  Both offsets are the stride
// between eight-row atoms: for a K-major operand the leading offset is
// unused (an instruction's 16 K-values lie inside one swizzle row), and
// for an MN-major one the N extent (D) is one atom wide, so only the
// stride offset is read.
template <int D>
__device__ __forceinline__ uint64_t desc(const void* tile, uint32_t offset) {
  const uint64_t atom = (Tile<D>::kAtom >> 4) & 0x3FFF;
  return (((smem_u32(tile) + offset) & 0x3FFFF) >> 4) | (atom << 16) |
         (atom << 32) | (Tile<D>::kLayout << 62);
}
// k-slice kk (16 values of the contracted dim) of a tile read K-major: the
// contracted dim is the tile's columns, 32 bytes a slice
template <int D>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc<D>(tile, kk * 32);
}
// ... read MN-major (transposed B): the contracted dim is the tile's rows
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc<D>(tile, kk * 16 * D * 2);
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both bf16 K-major in
// shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x D, f32) += A (64 x 16, bf16 in registers) B (16 x D), B bf16
// MN-major in shared memory (the transpose-B bit)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The (64 x 64) f32 accumulator as the bf16 A operand of four k16 slices.
// Accumulator entry 4j + i of a thread is row 16*warp + lane/4 + 8*(i/2),
// column 8j + 2*(lane%4) + i%2; A-fragment register h of slice kk holds
// row 16*warp + lane/4 + 8*(h%2), columns 16kk + 8*(h/2) + 2*(lane%4)
// + {0, 1} -- the accumulator's entries 8kk + 2h and 8kk + 2h + 1.
__device__ __forceinline__ void to_a(const float (&acc)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      a[kk][h] = pack_bf16(acc[8 * kk + 2 * h], acc[8 * kk + 2 * h + 1]);
}

// store a (64 x D) f32 accumulator as bf16 rows r0 and r0 + 8 of `out`
// (row stride D), rows at or past n skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2], int r0,
                                           int n, int c0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n) continue;
    auto* row = reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      row[(8 * j + c0) / 2] = __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                                    acc[4 * j + 2 * half + 1]);
  }
}

// the dynamic shared memory, rounded up to the 1024-byte swizzle period
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          __nv_bfloat16* __restrict__ dq, int tq, int tk,
                          int causal, float scale) {
  constexpr uint32_t kTile = Tile<D>::kBytes;
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
    tma_load(qs, &tm_q, &bars[0], q0, bh);
    tma_load(dos, &tm_do, &bars[0], q0, bh);
    for (int t = 0; t < 2 && t < n_k; ++t) {
      uint8_t* ks = smem + (2 + 2 * t) * kTile;
      mbar_expect_tx(&bars[1 + t], 2 * kTile);
      tma_load(ks, &tm_k, &bars[1 + t], t * kBlock, bh);
      tma_load(ks + kTile, &tm_v, &bars[1 + t], t * kBlock, bh);
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0+8
  const int c0 = 2 * (lane % 4);             // and columns c0 + 8j + {0,1}
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    l_row[h] = r < tq ? lse[(size_t)bh * tq + r] : 0.f;
    d_row[h] = r < tq ? dvec[(size_t)bh * tq + r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int t = 0; t < n_k; ++t) {
    const int s = t & 1;
    const int k0 = t * kBlock;
    uint8_t* ks = smem + (2 + 2 * s) * kTile;
    uint8_t* vs = ks + kTile;
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
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a[kk], desc_mn<D>(ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // every read of this stage is done: refill it with key tile t + 2
    __syncthreads();
    if (tid == 0 && t + 2 < n_k) {
      mbar_expect_tx(&bars[1 + s], 2 * kTile);
      tma_load(ks, &tm_k, &bars[1 + s], k0 + 2 * kBlock, bh);
      tma_load(vs, &tm_v, &bars[1 + s], k0 + 2 * kBlock, bh);
    }
  }
  store_rows<D>(dq + (size_t)bh * tq * D, acc, r0, tq, c0);
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int tq, int tk,
                           int causal, float scale) {
  constexpr uint32_t kTile = Tile<D>::kBytes;
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
  // query tile `it` of the loop's L (threads 0-63) and D (64-127)
  auto stage_stats = [&](int it) {
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
    tma_load(ks, &tm_k, &bars[0], k0, bh);
    tma_load(vs, &tm_v, &bars[0], k0, bh);
    for (int it = 0; it < 2 && it < n_q; ++it) {
      uint8_t* qs = smem + (2 + 2 * it) * kTile;
      mbar_expect_tx(&bars[1 + it], 2 * kTile);
      tma_load(qs, &tm_q, &bars[1 + it], (first + it) * kBlock, bh);
      tma_load(qs + kTile, &tm_do, &bars[1 + it], (first + it) * kBlock, bh);
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = k0 + 16 * warp + lane / 4;  // this thread's keys: r0, r0+8
  const int c0 = 2 * (lane % 4);             // its queries c0 + 8j + {0,1}
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it & 1;
    const int q0 = (first + it) * kBlock;
    uint8_t* qs = smem + (2 + 2 * s) * kTile;
    uint8_t* dos = qs + kTile;
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
      wgmma_rs<D>(acc_v, pa[kk], desc_mn<D>(dos, kk));
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
      wgmma_rs<D>(acc_k, da[kk], desc_mn<D>(qs, kk));
    wgmma_commit();
    if (it + 1 < n_q) stage_stats(it + 1);
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);

    // every read of this stage is done: refill it with query tile it + 2
    __syncthreads();
    if (tid == 0 && it + 2 < n_q) {
      mbar_expect_tx(&bars[1 + s], 2 * kTile);
      tma_load(qs, &tm_q, &bars[1 + s], q0 + 2 * kBlock, bh);
      tma_load(dos, &tm_do, &bars[1 + s], q0 + 2 * kBlock, bh);
    }
  }
  store_rows<D>(dk + (size_t)bh * tk * D, acc_k, r0, tk, c0);
  store_rows<D>(dv + (size_t)bh * tk * D, acc_v, r0, tk, c0);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: taken through the runtime, so
// the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous (bh, t, d) bf16 tensor as a 3-D map (d, t, bh) with
// (kBlock, d) boxes; rows past t read as zeros.  `base` must be 16-byte
// aligned (the wrapper checks).
cudaError_t make_map(CUtensorMap* map, const void* base, int bh, int t,
                     int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)d, (cuuint32_t)kBlock, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

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
                      void* dq, int bh, int tq, int tk, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlock - 1) / kBlock);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, dvec, static_cast<__nv_bfloat16*>(dq), tq,
      tk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Maps& m, const float* lse, const float* dvec,
                       void* dk, void* dv, int bh, int tq, int tk, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlock - 1) / kBlock);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, dvec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The bf16 entry points behind dkt_flash_bwd_dq / dkt_flash_bwd_dkv
// (flash_bwd.cu, which checks the arguments and sets the device): q, k,
// v, dout contiguous bf16, 16-byte aligned; head_dim 32 or 64.
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
  return head_dim == 64
             ? launch_dq<64>(m, l, d, dq, bh, tq, tk, causal, scale, stream)
             : launch_dq<32>(m, l, d, dq, bh, tq, tk, causal, scale, stream);
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
  return head_dim == 64
             ? launch_dkv<64>(m, l, d, dk, dv, bh, tq, tk, causal, scale,
                              stream)
             : launch_dkv<32>(m, l, d, dk, dv, bh, tq, tk, causal, scale,
                              stream);
}
