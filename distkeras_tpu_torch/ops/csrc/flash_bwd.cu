// Flash-attention backward, the C interface: K2 (dQ) and K3 (dK, dV) for
// both dtypes.  The kernels live beside it: up to head dim 256 on
// Hopper's tensor cores (sm_90a), f32 as 3xTF32 on mma.sync in
// flash_bwd_tf32_sm90.cu (32, 64, 128 and any in 129-256) and bf16 on
// wgmma and TMA in flash_bwd_sm90.cu (32, 64, 128 and multiples of 8 in
// 129-256); past 256 both dtypes on CUDA cores in flash_bwd_wide.cu.
// This file checks the arguments, sets the device and picks the kernel
// for (dtype, head dim).
//
// Replaces: distkeras_tpu/ops/pallas_attention.py:_bwd_dq_kernel (K2) and
// _bwd_dkv_kernel (K3), the Pallas TPU kernels launched by
// _flash_bwd_raw.  Same function: with P = exp(scale * Q K^T - L) under
// the causal mask k_pos <= q_pos (L the forward's per-row logsumexp),
// dP = dO V^T and dS = scale * P o (dP - D) (D = rowsum(dO o O), computed
// by the caller, with any lse cotangent already folded in as D - g_lse):
//   K2: dQ = dS K
//   K3: dV = P^T dO,  dK = dS^T Q
// Causal needs Tq == Tk; non-causal takes Tq != Tk.  What bounds each
// kernel on this card, and what its design does about it, is in the note
// at the top of its file.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launched.h"

// the f32 kernels (flash_bwd_tf32_sm90.cu) and the bf16 ones
// (flash_bwd_sm90.cu); head_dim 32, 64 or 128, and also 129-256 (for
// bf16 a multiple of 8)
cudaError_t flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, void* dq, int bh, int tq,
                             int tk, int head_dim, int causal, float scale,
                             cudaStream_t stream);
cudaError_t flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dvec, void* dk, void* dv, int bh,
                              int tq, int tk, int head_dim, int causal,
                              float scale, cudaStream_t stream);
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
// the CUDA-core kernels for head_dim > 256 (flash_bwd_wide.cu)
cudaError_t flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dvec, void* dq, int bh, int tq,
                              int tk, int head_dim, int causal, float scale,
                              int dtype, cudaStream_t stream);
cudaError_t flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dk, void* dv, int bh,
                               int tq, int tk, int head_dim, int causal,
                               float scale, int dtype, cudaStream_t stream);

namespace {

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void *dq, *dk, *dv;
  int bh, tq, tk, head_dim, causal;
  float scale;
  int dtype;
};

template <int D>
cudaError_t launch_dq_f32(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_f32(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq, a.bh,
                          a.tq, a.tk, D, a.causal, a.scale, stream);
}

template <int D>
cudaError_t launch_dkv_f32(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_f32(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv,
                           a.bh, a.tq, a.tk, D, a.causal, a.scale, stream);
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

cudaError_t launch_dq_wide(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_wide(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq, a.bh,
                           a.tq, a.tk, a.head_dim, a.causal, a.scale, a.dtype,
                           stream);
}

cudaError_t launch_dkv_wide(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_wide(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv,
                            a.bh, a.tq, a.tk, a.head_dim, a.causal, a.scale,
                            a.dtype, stream);
}

// bf16 K2 and K3 at 129 <= head_dim <= 256 on wgmma, f32 K2 and K3 there
// as 3xTF32 (the runtime head dim)
cudaError_t launch_dq_bf16_wide(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_bf16(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq, a.bh,
                           a.tq, a.tk, a.head_dim, a.causal, a.scale, stream);
}

cudaError_t launch_dkv_bf16_wide(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_bf16(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv,
                            a.bh, a.tq, a.tk, a.head_dim, a.causal, a.scale,
                            stream);
}

cudaError_t launch_dq_f32_wide(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_f32(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq, a.bh,
                          a.tq, a.tk, a.head_dim, a.causal, a.scale, stream);
}

cudaError_t launch_dkv_f32_wide(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_f32(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv,
                           a.bh, a.tq, a.tk, a.head_dim, a.causal, a.scale,
                           stream);
}

using Launcher = cudaError_t (*)(const BwdArgs&, cudaStream_t);

// A launcher and the kernel it runs (launched.h)
struct Pick {
  Launcher f;
  LaunchedKernel kernel;
};

// The launcher for (dtype, head_dim); f is nullptr for what no kernel
// takes.  Order of `table`: (f32, 32), (f32, 64), (f32, 128), (bf16, 32),
// (bf16, 64), (bf16, 128); at 129-256 `f32_wide` takes any head dim and
// `bf16_wide` a multiple of 8 (its TMA row stride); `wide` takes
// head_dim > 256 in either dtype.
Pick pick(const Launcher (&table)[6], Launcher wide, Launcher bf16_wide,
          Launcher f32_wide, int dtype, int head_dim) {
  if (dtype != 0 && dtype != 1) return {nullptr, kCudaCores};
  if (head_dim > 256) return {wide, kCudaCores};
  if (head_dim > 128) {
    if (dtype == 0) return {f32_wide, kTf32Wide};
    return {head_dim % 8 == 0 ? bf16_wide : nullptr, kWgmmaWide};
  }
  const int d = head_dim == 32 ? 0 : head_dim == 64 ? 1 : head_dim == 128 ? 2
                                                                          : -1;
  return {d < 0 ? nullptr : table[3 * dtype + d],
          dtype == 0 ? kTf32 : kWgmma};
}

int run(Pick p, const BwdArgs& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.f == nullptr || a.bh < 1 || a.tq < 1 || a.tk < 1 ||
      (a.causal && a.tq != a.tk))
    return (int)cudaErrorInvalidValue;
  dkt_set_last_kernel(p.kernel);
  return (int)p.f(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q and dout: (bh, tq, head_dim); k and v: (bh, tk, head_dim); all
// contiguous and 16-byte aligned (the tensor-core kernels load tiles by
// cp.async or TMA), of dtype 0 (float32) or 1 (bfloat16); head_dim 32, 64,
// 128 or any past 128, but bf16 in 129-256 a multiple of 8; lse and dvec:
// (bh, tq) float32.  dq is written like q.
// Launches on `stream` of `device` and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int dkt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dvec, void* dq, int bh, int tq,
                                int tk, int head_dim, int causal, float scale,
                                int dtype, int device, void* stream) {
  static const Launcher table[6] = {
      launch_dq_f32<32>,  launch_dq_f32<64>,  launch_dq_f32<128>,
      launch_dq_bf16<32>, launch_dq_bf16<64>, launch_dq_bf16<128>};
  const BwdArgs a{q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
                  bh, tq, tk, head_dim, causal, scale, dtype};
  return run(pick(table, launch_dq_wide, launch_dq_bf16_wide,
                  launch_dq_f32_wide, dtype, head_dim),
             a, device, stream);
}

// As dkt_flash_bwd_dq; dk and dv are written like k and v.
extern "C" int dkt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dvec, void* dk, void* dv, int bh,
                                 int tq, int tk, int head_dim, int causal,
                                 float scale, int dtype, int device,
                                 void* stream) {
  static const Launcher table[6] = {
      launch_dkv_f32<32>,  launch_dkv_f32<64>,  launch_dkv_f32<128>,
      launch_dkv_bf16<32>, launch_dkv_bf16<64>, launch_dkv_bf16<128>};
  const BwdArgs a{q, k, v, dout, lse, dvec, nullptr, dk, dv,
                  bh, tq, tk, head_dim, causal, scale, dtype};
  return run(pick(table, launch_dkv_wide, launch_dkv_bf16_wide,
                  launch_dkv_f32_wide, dtype, head_dim),
             a, device, stream);
}
