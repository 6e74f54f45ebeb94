// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a): K1.
// Called from flash_fwd.cu's C interface (dkt_flash_fwd) for dtype 1 up
// to head dim 256; past 256 bf16 runs flash_fwd_panels_sm90.cu, and f32
// runs the kernels of flash_fwd_tf32_sm90.cu and flash_fwd.cu.
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_fwd_kernel under the
// bf16 branch of _dot/_dot_t.  For every (batch*head, query row) it
// streams the keys in tiles with the online softmax: S = scale * Q K^T
// (bf16 operands, f32 sums), the causal mask k_pos <= q_pos with the
// tiles past the diagonal skipped, m and l = sum(p) in f32 over the
// unrounded p = exp(S - m), O = O * corr + P V with P rounded to bf16 as
// it becomes the product's A operand (as pallas_attention.py:111-112
// rounds it), and at the end O / l in bf16 and lse = m + log(l) in f32.
// Causal needs Tq == Tk; non-causal takes Tq != Tk (the ring hop's
// shape); any T (ragged tiles are zero-filled by TMA and masked).
//
// What bounds it on this card: at the training shape (B*H = 512,
// T = 512, Dh = 64, causal) it does 4*Dh FLOPs per unmasked (q, k) pair,
// 17.2 GFLOP, 0.017 ms at 989 TFLOP/s of bf16 tensor cores; its bytes
// (Q, K, V bf16 read once, O bf16 and lse f32 written once) take
// 0.040 ms at 3.35 TB/s.  So bytes bound it, with the operations within
// a factor of 2.3: the kernel has to keep the tensor cores fed from
// shared memory and its exp/select work short.  The same holds at
// Dh 256 (B*H = 128, gpt_lm at dim 2048): the same 17.2 GFLOP, 0.040 ms
// of bytes.
//
// Design: K2's (flash_bwd_sm90.cu) with one product fewer and an online
// softmax.  One warpgroup (128 threads) per block and 64-row tiles, the
// wgmma M: one block per (batch*head, query tile), issued from the last
// (longest causal) query tile down, looping over key tiles up to the
// diagonal.  Q is resident; K and V stream through a two-stage ring.
// All arrive by TMA on mbarriers from 3-D tensor maps (Dh, T, B*H), so a
// ragged last tile reads zeros, never the next head; the swizzle is 128 B
// on tiles 64 and 128 wide and 64 B on 32-wide ones, the same in the map
// and the wgmma descriptor.  A swizzled box is at most one swizzle row wide, so a
// Dh = 128 tile is two 64-column panels, one box each, and the products
// step across them (sm90.cuh: Tile, desc_k, and wgmma_rs<D>, one
// m64n64k16 per panel of V).  Per key tile:
//   - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory;
//   - the softmax on the accumulator fragments, in base 2 with the scale
//     folded into one multiply (scale * log2(e)): a row's 64 columns lie
//     in one quad of lanes, so its max and its sum take two shuffles
//     each; the mask (causal, keys past T) is a select on every tile, so
//     a masked entry is exactly 0 (a branch that masks only the tiles that
//     need it measured slower); a row with
//     every key masked so far keeps m = -inf and uses 0 as its reference,
//     so p = 0 and corr = 0 instead of NaN;
//   - O = O * corr + P V: wgmma m64nDk16 with A from registers (the f32
//     S accumulator rounded to bf16) and V read MN-major through the
//     transpose-B bit.
// The loop is pipelined by one tile: iteration t issues S_t and then
// P_{t-1} V_{t-1}, and runs the softmax of S_t while the tensor cores
// work on P_{t-1} V_{t-1}.  O is rescaled and P converted while no
// product is in flight, and the first tile and the last product are
// peeled off the loop, so its body is straight-line code: ptxas
// serializes the products when it cannot prove that no accumulator is
// written between a product's issue and its wait.
// O is stored as bf16 rows, lse as f32 by plain stores (its rows are not
// 16-byte aligned at odd T), both masked at T.
//
// Head dims 129-256 (the reference's BlockSpecs span any Dh): the same
// design on tiles of three or four 64-column panels (D = 192 for
// Dh <= 192, else 256), read from unpadded rows of Dh columns (Dh % 8 ==
// 0, the TMA row stride; the wrapper pads other Dh to the next multiple
// of 8) with the columns past Dh zero-filled by TMA, and O stored masked
// at Dh.  A thread then holds O's 64 x D f32 accumulator, 96 or 128
// registers, beside S (32) and P (16): at 128 threads that fits ptxas's
// 255 (the build phase reports registers and spills).  Q and the K/V
// ring take 5 tiles, 120 or 160 KB: one block an SM.
//
// Head dims below 128 (Dh % 8 == 0): the least of the 32-, 64- and
// 128-wide tiles that holds Dh, so Dh 32, 64 and 128 fill theirs and any
// other Dh runs from unpadded rows, as at 129-256.  The tensor maps take
// their box and swizzle from the tile and their width and row stride from
// Dh (sm90.cuh: make_map), so TMA zero-fills the columns past Dh -- a
// 64-wide tile's last k-step at Dh 48, part of a 128-wide tile's second
// panel at Dh 72-120 -- and shared memory keeps the layout the wgmma
// descriptors read.  S then sums real columns only, O's columns past Dh
// are exactly 0, and O is stored masked at Dh.  The products over the
// zero columns are wasted tensor-core work (a quarter of it at Dh 96),
// which a kernel bound by its bytes has to spare.
//
// Later work: a producer warp with setmaxnreg and two consumer
// warpgroups on 128-row tiles, and TMA stores.

#include "sm90.cuh"

namespace {

using namespace sm90;

// kPartial: rows of dh < D columns, O stored masked at dh (as it always
// is past D = 128)
template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int tq, int tk, int dh,
                       int causal, float scale) {
  constexpr uint32_t kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[5];  // Q, K stages 0 and 1, V stages 0 and 1
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* qs = smem;
  uint64_t* kbar = bars + 1;
  uint64_t* vbar = bars + 3;
  // key tile t's K in stage t % 2 after Q, its V in stage t % 2 after those
  auto k_tile = [&](int t) { return smem + (1 + (t & 1)) * kTile; };
  auto v_tile = [&](int t) { return smem + (3 + (t & 1)) * kTile; };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the long tiles first
  const int q0 = qt * kBlock;
  int n_k = (tk + kBlock - 1) / kBlock;
  if (causal) n_k = min(n_k, qt + 1);  // key tiles up to the diagonal
  const int tid = threadIdx.x;
  auto load_k = [&](int t) {
    mbar_expect_tx(&kbar[t & 1], kTile);
    tma_load_tile<D>(k_tile(t), &tm_k, &kbar[t & 1], t * kBlock, bh);
  };
  auto load_v = [&](int t) {
    mbar_expect_tx(&vbar[t & 1], kTile);
    tma_load_tile<D>(v_tile(t), &tm_v, &vbar[t & 1], t * kBlock, bh);
  };

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], kTile);
    tma_load_tile<D>(qs, &tm_q, &bars[0], q0, bh);
    for (int t = 0; t < 2 && t < n_k; ++t) {
      load_k(t);
      load_v(t);
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0+8
  const int c0 = 2 * (lane % 4);             // and columns c0 + 8j + {0,1}
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  // the rows' running max (base 2) and sum, and O
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float corr[2];     // the rescale of O that goes with the P in a
  uint32_t a[4][4];  // P of the last key tile, the A operand of P V

  // S_t = Q K_t^T into s, one group
  auto issue_s = [&](float (&s)[32], int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(s, desc_k<D>(qs, kk), desc_k<D>(k_tile(t), kk), kk > 0);
    wgmma_commit();
  };
  // O += P_t V_t, V read MN-major, one group
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, a[kk], desc_mn<D>(v_tile(t), kk));
    wgmma_commit();
  };
  // the softmax of S_t (rows past T are computed on zero-filled Q and
  // never stored)
  auto softmax = [&](float (&s)[32], int t) {
    softmax_tile(s, m, l, corr, r0, t * kBlock, c0, tk, causal, scale2);
  };

  // Pipelined by one tile: iteration t issues S_t and P_{t-1} V_{t-1},
  // and runs the softmax of S_t while the tensor cores work on the
  // second.  Accumulator and A registers are written only while no
  // product is in flight, in straight-line code, so ptxas keeps the
  // products asynchronous.
  mbar_wait(&bars[0], 0);
  {
    float sc[32] = {};
    mbar_wait(&kbar[0], 0);
    wgmma_fence();
    issue_s(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, 0);  // O is 0: no rescale
    to_a(sc, a);     // P in bf16, as the reference rounds it
    __syncthreads();
    if (tid == 0 && 2 < n_k) load_k(2);
  }
  for (int t = 1; t < n_k; ++t) {
    float sc[32] = {};
    mbar_wait(&kbar[t & 1], (t >> 1) & 1);
    mbar_wait(&vbar[(t - 1) & 1], ((t - 1) >> 1) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_s(sc, t);
    issue_pv(t - 1);
    wgmma_wait<1>();
    fence_regs(sc);
    softmax(sc, t);
    wgmma_wait<0>();
    fence_regs(acc);
    to_a(sc, a);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    // every read of K_t and of V_{t-1} is done: refill their stages
    __syncthreads();
    if (tid == 0) {
      if (t + 2 < n_k) load_k(t + 2);
      if (t + 1 < n_k) load_v(t + 1);
    }
  }
  mbar_wait(&vbar[(n_k - 1) & 1], ((n_k - 1) >> 1) & 1);
  fence_regs(acc);
  wgmma_fence();
  issue_pv(n_k - 1);
  wgmma_wait<0>();
  fence_regs(acc);

  // O / l, then lse = m + log(l) (m is in base 2)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] /= l[(i >> 1) & 1];
  if constexpr (D > 128 || kPartial)  // rows of dh columns
    store_rows_masked<D>(out + (size_t)bh * tq * dh, acc, r0, tq, c0, dh,
                         dh);
  else
    store_rows<D>(out + (size_t)bh * tq * D, acc, r0, tq, c0);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < tq)
        lse[(size_t)bh * tq + r] = m[h] * 0.6931471805599453f + logf(l[h]);
    }
  }
}

// Q and two ring stages of K and V, and the slack to align them
template <int D>
constexpr size_t smem_bytes() {
  return 5 * Tile<D>::kBytes + 1024;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int bh, tq, tk, dh, causal;
  float scale;
};

template <int D, bool kPartial>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map<D>(&mq, a.q, a.bh, a.tq, a.dh)) != cudaSuccess)
    return err;
  if ((err = make_map<D>(&mk, a.k, a.bh, a.tk, a.dh)) != cudaSuccess)
    return err;
  if ((err = make_map<D>(&mv, a.v, a.bh, a.tk, a.dh)) != cudaSuccess)
    return err;
  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kPartial>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tq + kBlock - 1) / kBlock);
  flash_fwd_wgmma_kernel<D, kPartial><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.out), a.lse, a.tq, a.tk,
      a.dh, a.causal, a.scale);
  return cudaGetLastError();
}

// Dh 32, 64 and 128 fill their tiles and keep the full-row store; a
// narrower Dh runs the tile's partial-row instance
template <int D>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  return a.dh == D ? launch<D, false>(a, stream) : launch<D, true>(a, stream);
}

}  // namespace

// The bf16 entry point behind dkt_flash_fwd (flash_fwd.cu, which checks
// the arguments and sets the device): q (bh, tq, head_dim), k and v (bh,
// tk, head_dim), contiguous bf16, 16-byte aligned; head_dim a multiple of
// 8 up to 256, run on the least tile of 32, 64, 128, 192 and 256 columns
// that holds it; out like q, lse (bh, tq) f32.
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* out, void* lse, int bh, int tq, int tk,
                           int head_dim, int causal, float scale,
                           cudaStream_t stream) {
  const Args a{q, k, v, out, static_cast<float*>(lse), bh, tq, tk,
               head_dim, causal, scale};
  if (head_dim <= 32) return launch_tile<32>(a, stream);
  if (head_dim <= 64) return launch_tile<64>(a, stream);
  if (head_dim <= 128) return launch_tile<128>(a, stream);
  if (head_dim <= 192) return launch<192, false>(a, stream);
  return launch<256, false>(a, stream);
}
