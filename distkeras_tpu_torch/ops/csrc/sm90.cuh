// PTX and launch helpers shared by the Hopper (sm_90a) flash-attention
// kernels in bf16: K1 (flash_fwd_sm90.cu, and past head dim 256
// flash_fwd_panels_sm90.cu) and K2/K3 (flash_bwd_sm90.cu, and past head
// dim 256 flash_bwd_panels_sm90.cu).
// Shared memory and mbarriers, TMA loads from 3-D tensor maps, wgmma
// (both operands in shared memory, or A in registers), the descriptors
// and swizzles of 64-row bf16 tiles, the accumulator -> A-operand and
// accumulator -> global-row conversions, K1's online softmax of one key
// tile, the ring of the 256-column output panels past head dim 256, and
// the tensor-map encoder.
//
// Everything here is inline or a template, so each .cu that includes it
// keeps its own copy and the linked library has no duplicate symbols.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

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

// rows [row, row + kBlock), columns [col, col + box) of head `bh` of a
// (Dh, T, B*H) tensor map into shared memory; completes its bytes of the
// barrier's transaction
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh,
                                         int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
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

// Tile geometry for tile width D (32, 64, 128, 192 or 256; a row of Dh
// <= D columns fills it from the left, zeros past Dh): a (kBlock, D)
// bf16 tile is stored as D / kCols panels of kCols columns, each panel a
// (kBlock, kCols) tile of its own whose rows are one swizzle row (128 B
// at kCols = 64, 64 B at D = 32); eight rows form one swizzle atom.  A
// swizzled TMA box is at most one swizzle row wide, so D = 128 is two
// panels of 64, 192 three and 256 four.
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kPanels = D / kCols;
  static constexpr uint32_t kPanelBytes = kBlock * kCols * 2;
  static constexpr uint32_t kBytes = kBlock * D * 2;
  static constexpr uint32_t kAtom = 8 * kCols * 2;           // 8 rows
  static constexpr uint64_t kLayout = kCols == 64 ? 1 : 2;   // 128B / 64B
};

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle.  Both offsets are the stride
// between eight-row atoms: for a K-major operand the leading offset is
// unused (an instruction's 16 K-values lie inside one swizzle row), and
// for an MN-major one the N extent of a product is one panel, one atom
// wide, so only the stride offset is read.
template <int D>
__device__ __forceinline__ uint64_t desc(const void* tile, uint32_t offset) {
  const uint64_t atom = (Tile<D>::kAtom >> 4) & 0x3FFF;
  return (((smem_u32(tile) + offset) & 0x3FFFF) >> 4) | (atom << 16) |
         (atom << 32) | (Tile<D>::kLayout << 62);
}
// k-slice kk (16 values of the contracted dim) of a tile read K-major: the
// contracted dim is the tile's columns, 32 bytes a slice, kCols / 16
// slices a panel
template <int D>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  constexpr int kSlices = Tile<D>::kCols / 16;
  return desc<D>(tile, (kk / kSlices) * Tile<D>::kPanelBytes +
                           (kk % kSlices) * 32);
}
// ... read MN-major (transposed B): the contracted dim is the tile's rows
// (of the first panel; wgmma_rs<128> steps to the second)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc<D>(tile, kk * 16 * Tile<D>::kCols * 2);
}

// rows [row, row + kBlock) of head `bh` as one (kBlock, D) tile, one
// box per panel; completes kBytes of the barrier's transaction
template <int D>
__device__ __forceinline__ void tma_load_tile(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int bh) {
#pragma unroll
  for (int p = 0; p < Tile<D>::kPanels; ++p)
    tma_load(static_cast<uint8_t*>(dst) + p * Tile<D>::kPanelBytes, map, bar,
             row, bh, p * Tile<D>::kCols);
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

// Dh = 128, 192, 256: one m64n64k16 per 64-column panel of B, panel p's
// descriptor that of the first moved by p * kPanelBytes; d's quarters
// of 32 are the panels' columns, in the order store_rows reads them
template <int P>
__device__ __forceinline__ void wgmma_rs_panels(float (&d)[32 * P],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(&d[32 * p]), a,
                 b + p * (Tile<64>::kPanelBytes >> 4));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_panels<2>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_panels<3>(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_panels<4>(d, a, b);
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

// store a (64 x N) f32 accumulator as bf16 rows r0 and r0 + 8 of `out`
// (row stride LD), rows at or past n skipped
template <int N, int LD = N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[N / 2], int r0,
                                           int n, int c0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n) continue;
    auto* row = reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * LD);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      row[(8 * j + c0) / 2] = __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                                    acc[4 * j + 2 * half + 1]);
  }
}

// store a (64 x N) f32 accumulator as bf16 rows r0 and r0 + 8 of `out`
// (row stride ld), rows at or past n and columns at or past `cols`
// skipped (ld and cols multiples of 8, so a thread's column pair is
// stored whole or not at all): the kernels store a row of Dh columns from
// a tile wider than Dh so
template <int N>
__device__ __forceinline__ void store_rows_masked(__nv_bfloat16* out,
                                                  const float (&acc)[N / 2],
                                                  int r0, int n, int c0,
                                                  int ld, int cols) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n) continue;
    __nv_bfloat16* row = out + (size_t)r * ld;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j + c0 < cols)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                  acc[4 * j + 2 * half + 1]);
  }
}

// the dynamic shared memory, rounded up to the 1024-byte swizzle period
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// K1's online softmax
// ---------------------------------------------------------------------------

// The online softmax of key tile k0 on its S accumulator, rows r0 and
// r0 + 8 of this thread (entry e belongs to row half (e >> 1) & 1 and
// key k0 + c0 + 8 * (e >> 2) + (e & 1)): S is scaled to base 2 (scale2 =
// scale * log2(e)) and masked by a select -- keys at or past tk, and
// under `causal` keys past the row -- so a masked entry is exactly 0; the
// running max m (base 2) and sum l (over the unrounded P) are updated,
// and s holds P on return; corr rescales the rows' earlier O.  A row's
// 64 columns lie in one quad of lanes, so its max and its sum take two
// shuffles each.  A row with every key masked so far keeps m = -inf and
// uses 0 as its reference, so p = 0 and corr = 0 instead of NaN.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int r0, int k0, int c0, int tk,
                                             int causal, float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1;
    const int row = r0 + 8 * h;
    const int col = k0 + 8 * (e >> 2) + c0 + (e & 1);
    s[e] *= scale2;
    if (col >= tk || (causal && col > row)) s[e] = -INFINITY;
    mx[h] = fmaxf(mx[h], s[e]);
  }
  float ref[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    ref[h] = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = exp2f(m[h] - ref[h]);
    m[h] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1;
    s[e] = s[e] == -INFINITY ? 0.f : exp2f(s[e] - ref[h]);
    rs[h] += s[e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    l[h] = l[h] * corr[h] + rs[h];
  }
}

// ---------------------------------------------------------------------------
// past head dim 256: 256-column output panels fed by one ring of stages
// ---------------------------------------------------------------------------

// A block of the panel kernels (flash_fwd_panels_sm90.cu,
// flash_bwd_panels_sm90.cu) owns kPanel columns of its outputs, kHalf
// a warpgroup; it streams its items (64-column chunks of the inputs, and
// the panel's columns of the second product's B) through kStages stages
// of four 64 x 64 boxes each, 128B-swizzled (a swizzled box is one
// swizzle row wide).
namespace panels {

constexpr int kPanel = 256;                      // output columns of a block
constexpr int kHalf = 128;                       // ... of a warpgroup
constexpr int kGroups = kPanel / kHalf;          // warpgroups of a block
constexpr int kBlockThreads = kGroups * kThreads;
constexpr int kChunk = 64;                       // columns of a box
constexpr uint32_t kBox = Tile<kChunk>::kBytes;  // a 64 x 64 box, 8 KB
constexpr uint32_t kStage = 4 * kBox;            // four boxes, 32 KB
constexpr int kStages = 6;
constexpr size_t kSmemBytes = kStages * kStage + 1024;  // + the alignment

// the warpgroups of the block that own columns below dh
__device__ __forceinline__ int live_groups(int p0, int dh) {
  return min(kGroups, (dh - p0 + kHalf - 1) / kHalf);
}

// a barrier of the block's first `threads` threads (its live warpgroups)
__device__ __forceinline__ void sync_groups(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// four boxes of rows [row, row + 64) of head bh, columns col + 64b, from
// `maps[b]`, into one stage; completes the stage's transaction
__device__ __forceinline__ void load_stage(uint8_t* dst, uint64_t* bar,
                                           const CUtensorMap* const (&maps)[4],
                                           const int (&rows)[4],
                                           const int (&cols)[4], int bh) {
  mbar_expect_tx(bar, kStage);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    tma_load(dst + b * kBox, maps[b], bar, rows[b], bh, cols[b]);
}

// one block per (panel, tile of t rows, batch*head)
inline int n_blocks(int bh, int t, int dh) {
  return (dh + kPanel - 1) / kPanel * ((t + kBlock - 1) / kBlock) * bh;
}

}  // namespace panels

// ---------------------------------------------------------------------------
// tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: taken through the runtime, so
// the library needs no link against libcuda
inline EncodeTiled encode_tiled() {
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

// A contiguous (bh, t, dh) bf16 tensor as a 3-D map (dh, t, bh) read in
// the panels of a tile of width D (Tile<D>): (kBlock, kCols) boxes with
// the tile's swizzle, so shared memory is laid out as the wgmma
// descriptors read it whatever the row width.  The global dim and row
// stride come from dh, the box and swizzle from D: columns of a box past
// dh (a row narrower than the tile, or a panel wholly past it) and rows
// past t read as zeros.  `base` must be 16-byte aligned (the wrapper
// checks) and dh * 2 bytes a multiple of 16 (dh % 8 == 0; the C
// interface checks).
template <int D>
inline cudaError_t make_map(CUtensorMap* map, const void* base, int bh,
                            int t, int dh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)t * dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Tile<D>::kCols, (cuuint32_t)kBlock,
                             1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tile<D>::kLayout == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
