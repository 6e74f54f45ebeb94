// Flash-attention backward, the C interface: K2 (dQ) and K3 (dK, dV) for
// both dtypes.  The kernels live beside it: f32 as 3xTF32 on mma.sync in
// flash_bwd_tf32_sm90.cu (32, 64, 128 and any in 129-256) and in
// 512-column output panels past 256 in flash_bwd_tf32_panels_sm90.cu;
// bf16 on wgmma and TMA at any multiple of 8, in flash_bwd_sm90.cu up to
// 256 and in 256-column output panels past it in flash_bwd_panels_sm90.cu.
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
// (flash_bwd_sm90.cu); f32 head_dim 32, 64 or 128, and any in 129-256;
// bf16 a multiple of 8 up to 256
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
// the bf16 kernels for head_dim > 256, a multiple of 8
// (flash_bwd_panels_sm90.cu)
cudaError_t flash_bwd_dq_bf16_panels(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dvec,
                                     void* dq, int bh, int tq, int tk,
                                     int head_dim, int causal, float scale,
                                     cudaStream_t stream);
cudaError_t flash_bwd_dkv_bf16_panels(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dvec,
                                      void* dk, void* dv, int bh, int tq,
                                      int tk, int head_dim, int causal,
                                      float scale, cudaStream_t stream);
// the f32 kernels for head_dim > 256 (flash_bwd_tf32_panels_sm90.cu)
cudaError_t flash_bwd_dq_f32_panels(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dvec,
                                    void* dq, int bh, int tq, int tk,
                                    int head_dim, int causal, float scale,
                                    cudaStream_t stream);
cudaError_t flash_bwd_dkv_f32_panels(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dvec,
                                     void* dk, void* dv, int bh, int tq,
                                     int tk, int head_dim, int causal,
                                     float scale, cudaStream_t stream);

namespace {

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void *dq, *dk, *dv;
  int bh, tq, tk, head_dim, causal;
  float scale;
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

// bf16 K2 and K3 on wgmma (the runtime head dim picks the tile)
cudaError_t launch_dq_bf16(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_bf16(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq, a.bh,
                           a.tq, a.tk, a.head_dim, a.causal, a.scale, stream);
}

cudaError_t launch_dkv_bf16(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_bf16(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv,
                            a.bh, a.tq, a.tk, a.head_dim, a.causal, a.scale,
                            stream);
}

// bf16 K2 and K3 past 256 on wgmma, in output panels
cudaError_t launch_dq_bf16_panels(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_bf16_panels(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq,
                                  a.bh, a.tq, a.tk, a.head_dim, a.causal,
                                  a.scale, stream);
}

cudaError_t launch_dkv_bf16_panels(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_bf16_panels(a.q, a.k, a.v, a.dout, a.lse, a.dvec,
                                   a.dk, a.dv, a.bh, a.tq, a.tk, a.head_dim,
                                   a.causal, a.scale, stream);
}

// f32 K2 and K3 past 256 as 3xTF32, in output panels
cudaError_t launch_dq_f32_panels(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dq_f32_panels(a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dq,
                                 a.bh, a.tq, a.tk, a.head_dim, a.causal,
                                 a.scale, stream);
}

cudaError_t launch_dkv_f32_panels(const BwdArgs& a, cudaStream_t stream) {
  return flash_bwd_dkv_f32_panels(a.q, a.k, a.v, a.dout, a.lse, a.dvec,
                                  a.dk, a.dv, a.bh, a.tq, a.tk, a.head_dim,
                                  a.causal, a.scale, stream);
}

// f32 K2 and K3 at 129 <= head_dim <= 256 as 3xTF32 (the runtime head dim)
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
// takes.  `f32` holds the f32 launchers at 32, 64 and 128, `f32_wide`
// takes any head dim in 129-256 and `f32_panels` any past 256; `bf16`
// takes a multiple of 8 (its TMA row stride) up to 256 and `bf16_panels`
// one past 256.
Pick pick(const Launcher (&f32)[3], Launcher f32_wide, Launcher f32_panels,
          Launcher bf16, Launcher bf16_panels, int dtype, int head_dim) {
  if (dtype != 0 && dtype != 1) return {nullptr, kCudaCores};
  if (dtype == 1) {
    const Pick p = head_dim <= 128   ? Pick{bf16, kWgmma}
                   : head_dim <= 256 ? Pick{bf16, kWgmmaWide}
                                     : Pick{bf16_panels, kWgmmaPast256};
    return {head_dim % 8 == 0 ? p.f : nullptr, p.kernel};
  }
  if (head_dim > 256) return {f32_panels, kTf32Past256};
  if (head_dim > 128) return {f32_wide, kTf32Wide};
  const int d = head_dim == 32 ? 0 : head_dim == 64 ? 1 : head_dim == 128 ? 2
                                                                          : -1;
  return {d < 0 ? nullptr : f32[d], kTf32};
}

int run(Pick p, const BwdArgs& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.f == nullptr || a.bh < 1 || a.tq < 1 || a.tk < 1 ||
      a.head_dim < 1 || (a.causal && a.tq != a.tk))
    return (int)cudaErrorInvalidValue;
  dkt_set_last_kernel(p.kernel);
  return (int)p.f(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q and dout: (bh, tq, head_dim); k and v: (bh, tk, head_dim); all
// contiguous and 16-byte aligned (the tensor-core kernels load tiles by
// cp.async or TMA), of dtype 0 (float32) or 1 (bfloat16); head_dim: f32
// 32, 64, 128 or any past 128; bf16 a multiple of 8; lse and dvec: (bh,
// tq) float32.  dq is written like q.
// Launches on `stream` of `device` and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int dkt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dvec, void* dq, int bh, int tq,
                                int tk, int head_dim, int causal, float scale,
                                int dtype, int device, void* stream) {
  static const Launcher f32[3] = {launch_dq_f32<32>, launch_dq_f32<64>,
                                  launch_dq_f32<128>};
  const BwdArgs a{q, k, v, dout, lse, dvec, dq, nullptr, nullptr,
                  bh, tq, tk, head_dim, causal, scale};
  return run(pick(f32, launch_dq_f32_wide, launch_dq_f32_panels,
                  launch_dq_bf16, launch_dq_bf16_panels, dtype, head_dim),
             a, device, stream);
}

// As dkt_flash_bwd_dq; dk and dv are written like k and v.
extern "C" int dkt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dvec, void* dk, void* dv, int bh,
                                 int tq, int tk, int head_dim, int causal,
                                 float scale, int dtype, int device,
                                 void* stream) {
  static const Launcher f32[3] = {launch_dkv_f32<32>, launch_dkv_f32<64>,
                                  launch_dkv_f32<128>};
  const BwdArgs a{q, k, v, dout, lse, dvec, nullptr, dk, dv,
                  bh, tq, tk, head_dim, causal, scale};
  return run(pick(f32, launch_dkv_f32_wide, launch_dkv_f32_panels,
                  launch_dkv_bf16, launch_dkv_bf16_panels, dtype, head_dim),
             a, device, stream);
}
