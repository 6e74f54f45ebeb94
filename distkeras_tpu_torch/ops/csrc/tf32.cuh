// The 3xTF32 building blocks shared by the f32 flash-attention kernels on
// Hopper's tensor cores (sm_90a): K1 (flash_fwd_tf32_sm90.cu) and K2/K3
// (flash_bwd_tf32_sm90.cu).  cp.async into shared memory, the split of an
// f32 value into tf32 hi and lo, mma.sync.m16n8k8 on tf32 operands, the
// fragment loads of both orientations of a tile (row stride Dh + 4
// floats), the A fragment taken from an accumulator, S = X Y^T over half
// a 64-row tile with the small terms summed apart (in one chain, or in
// pairs of k-steps from zero), unpadded rows of any Dh into a tile, the
// product of an accumulator with a tile's rows over Dh or a slice of it,
// and the named barriers of a warp pair.  The file header of
// flash_bwd_tf32_sm90.cu says why each is as it is.
//
// Everything here is inline or a template, so each .cu that includes it
// keeps its own copy and the linked library has no duplicate symbols.

#pragma once

#include "sm90.cuh"

namespace tf32 {

using sm90::smem_u32;

// 16 bytes from global to shared memory; `valid` false writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// waits for every cp.async this thread has issued
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// 4 bytes from global to shared memory (for rows that are not 16-byte
// aligned); `valid` false writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// x = hi + lo exactly: hi is x rounded to tf32 (its low 13 bits zero),
// lo the rest, which the tensor core reads to tf32 precision
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8) b (8 x 8), tf32 operands, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16n8k8 operand pair split into hi and lo
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// a b in 3xTF32: hi * hi into c, the small terms into cs.  Each mma
// rounds its sum toward zero at the magnitude of its accumulator, so the
// small terms kept apart lose nothing to the large sum, and the three
// products are two chains, not one.
__device__ __forceinline__ void mma3(float (&c)[4], float (&cs)[4],
                                     const FragA& a, const FragB& b) {
  mma(cs, a.lo, b.hi[0], b.hi[1]);
  mma(cs, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma3(c, c, a, b);
}

// Fragment coordinates in a warp: g = lane / 4 and t = lane % 4.  The
// m16n8k8 A fragment holds (row g, col t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B (k t, n g), (k t + 4, n g); the accumulator (row g,
// col 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// A fragment: rows [m0, m0 + 16), columns [k0, k0 + 8) of a tile of
// stride LD
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* x, int m0, int k0,
                                        int g, int t) {
  const float* p = x + (m0 + g) * LD + k0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * LD], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * LD + 4], f.hi[3], f.lo[3]);
  return f;
}

// B fragment of X^T, contracted along X's columns: k = columns
// [k0, k0 + 8), n = rows [n0, n0 + 8) of a tile of stride LD
template <int LD>
__device__ __forceinline__ FragB frag_bt(const float* x, int n0, int k0,
                                         int g, int t) {
  const float* p = x + (n0 + g) * LD + k0 + t;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// B fragment of X, contracted along X's rows in the permuted k order
// (logical t, t + 4 = rows k0 + 2t, k0 + 2t + 1): n = columns [n0, n0 + 8)
template <int LD>
__device__ __forceinline__ FragB frag_b(const float* x, int k0, int n0,
                                        int g, int t) {
  const float* p = x + (k0 + 2 * t) * LD + n0 + g;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[LD], f.hi[1], f.lo[1]);
  return f;
}

// A fragment from columns [8s, 8s + 8) of an accumulator c[s], in the
// permuted k order of frag_b
__device__ __forceinline__ FragA frag_acc(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// A warp takes the tile's 64 columns of S (or S^T) in two halves of kHalf,
// which halves the accumulators it holds at once.
constexpr int kHalf = 32;
constexpr int kNJ = kHalf / 8;  // n8 (or k8) tiles of a half

// c[j] (16 x kHalf) = X Y^T for this warp's rows [m0, m0 + 16) of x and
// the kHalf rows of y, contracted along Dh
template <int D>
__device__ __forceinline__ void product_t(float (&c)[kNJ][4], const float* x,
                                          const float* y, int m0, int g,
                                          int t) {
  constexpr int LD = D + 4;
  float cs[kNJ][4];
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = cs[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA a = frag_a<LD>(x, m0, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      mma3(c[j], cs[j], a, frag_bt<LD>(y, 8 * j, 8 * kk, g, t));
  }
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += cs[j][i];
}

// Rows [r0, r0 + ROWS) of a contiguous (n, dh) f32 matrix into a tile of
// ROWS x D at row stride D + 4, by the block's NT threads; rows at or past
// n and columns at or past dh read as zeros.  16-byte chunks when `vec`
// (dh % 4 == 0), else one float at a time.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int dh, bool vec) {
  if (vec) {
    constexpr int kChunks = D / 4;
#pragma unroll
    for (int u = 0; u < ROWS * kChunks / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      const int r = i / kChunks, c = 4 * (i % kChunks);
      const bool valid = r0 + r < n && c < dh;
      cp_async16(dst + r * (D + 4) + c,
                 valid ? src + (size_t)(r0 + r) * dh + c : src, valid);
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < ROWS * D / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      const int r = i / D, c = i % D;
      const bool valid = r0 + r < n && c < dh;
      cp_async4(dst + r * (D + 4) + c,
                valid ? src + (size_t)(r0 + r) * dh + c : src, valid);
    }
  }
}

// c[j] (16 x 8 NJ) = X Y^T for this warp's rows [m0, m0 + 16) of x and
// the 8 NJ rows of y (kHalf by default), contracted along Dh.  hi*hi of
// each pair of k-steps
// sums from zero and is added to c in f32; the small terms sum apart in
// cs.  The tensor core aligns an mma's addends to the largest and rounds
// toward zero, so in one chain over Dh/8 k-steps (the backward's
// product_t) every product loses bits at the scale of the growing sum and
// S comes out low: on queries and keys with a common offset of 1 (scores
// near 11 at Dh 128), lse ran 5.5e-6 low on average and 1.1e-5 at most
// against float64, where the f32 plain version is 6.7e-6 off.  In pairs
// the mean bias is 9.4e-7 and the largest error 3.8e-6 (O 3.0e-6, the
// plain version's 1.1e-5), for 3-5% more time; each k-step from zero gains
// little more for 19% (an H100, 700 W).  U pairs are unrolled at a time
// (all by default): K3 at Dh 129-256 takes one, to keep its registers.
template <int D, int U = D / 16, int NJ = kNJ>
__device__ __forceinline__ void product_s(float (&c)[NJ][4], const float* x,
                                          const float* y, int m0, int g,
                                          int t) {
  static_assert(D % 16 == 0, "k-steps go in pairs");
  constexpr int LD = D + 4;
  float cs[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = cs[j][i] = 0.f;
#pragma unroll(U)
  for (int kk = 0; kk < D / 8; kk += 2) {
    float pair[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pair[j][i] = 0.f;
#pragma unroll
    for (int k2 = kk; k2 < kk + 2; ++k2) {
      const FragA a = frag_a<LD>(x, m0, 8 * k2, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3(pair[j], cs[j], a, frag_bt<LD>(y, 8 * j, 8 * k2, g, t));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] += pair[j][i];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += cs[j][i];
}

// acc (16 x N) += P V for this warp's 16 rows: P (16 x kHalf) the
// accumulator p[s] (columns 8s .. 8s + 7 of the half), V the kHalf rows of
// `y` (row stride D + 4), its N columns (all D by default) from `y` on;
// K3 at Dh 129-256 forms dV += P^T dO and dK += dS^T Q so, K1 and K2
// there O += P V and dQ += dS K over half of D.  P's fragments are split
// once (or, with !kSplitOnce, again for each chunk, which keeps 32
// registers free); the product runs over kChunk n8 tiles of output
// columns at a time (32 columns by default), each chunk's sum taken apart
// from zero and added to acc in f32.  Neither choice changes a sum.
template <int D, bool kSplitOnce = true, int kChunk = 4, int N = D>
__device__ __forceinline__ void product_pv(float (&acc)[N / 8][4],
                                           const float (&p)[kNJ][4],
                                           const float* y, int g, int t) {
  static_assert(N % (8 * kChunk) == 0, "whole chunks");
  constexpr int LD = D + 4;
  FragA a[kSplitOnce ? kNJ : 1];
  if constexpr (kSplitOnce) {
#pragma unroll
    for (int s = 0; s < kNJ; ++s) a[s] = frag_acc(p[s]);
  }
#pragma unroll
  for (int c0 = 0; c0 < N / 8; c0 += kChunk) {
    float part[kChunk][4];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
    for (int s = 0; s < kNJ; ++s) {
      if constexpr (!kSplitOnce) a[0] = frag_acc(p[s]);
      const FragA& f = a[kSplitOnce ? s : 0];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        mma3(part[j], f, frag_b<LD>(y, 8 * s, 8 * (c0 + j), g, t));
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c0 + j][i] += part[j][i];
  }
}

// Named barriers of a warp pair (id 0 is __syncthreads): pair_sync waits
// until both warps (64 threads) have reached barrier `id`; pair_arrive
// counts this warp in without waiting.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// K1 and K2 at Dh 129-256 split each kHalf-key tile between the two
// warps of a pair: each scores kSideKeys of its keys.
constexpr int kSideKeys = kHalf / 2;
constexpr int kSideNJ = kSideKeys / 8;

// The 16 x kHalf accumulator of a warp pair's shared rows, each warp
// having formed the columns of one half of it (`own`, its keys of a
// tile) and handed them to the other through shared memory: the pair's
// warps hold them at the same lanes, so `other` is the partner's `own`
// as read back.  `side` 0 holds the first half.  Selects, not an index by
// `side`, keep the array in registers.
__device__ __forceinline__ void join_halves(float (&p)[kNJ][4],
                                            const float (&own)[kSideNJ][4],
                                            const float4* other, int side) {
#pragma unroll
  for (int j = 0; j < kSideNJ; ++j) {
    const float4 x = other[32 * j];
    const float xo[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[j][i] = side ? xo[i] : own[j][i];
      p[j + kSideNJ][i] = side ? own[j][i] : xo[i];
    }
  }
}

}  // namespace tf32
