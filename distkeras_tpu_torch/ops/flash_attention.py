"""Flash attention, forward only — the port of
``distkeras_tpu.ops.pallas_attention`` (``flash_attention`` and
``flash_attention_lse``).

On a CUDA tensor the forward is the hand-written kernel
``ops/csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``),
through ``flash_fwd_cuda``; on a CPU tensor it is ``flash_fwd_plain``,
the dense version of the same function.  A CUDA tensor never takes the
plain version: the kernel runs or the call raises.

The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) come with
the training slice; until then the autograd backward raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _kernels

_BACKWARD_MSG = "flash backward (K2/K3) is ported with the training slice"


def _to_bh(x):
    """(B, T, H, Dh) → contiguous (B·H, T, Dh)."""
    b, t, h, dh = x.shape
    # reshape alone returns a strided view when b == 1
    return x.transpose(1, 2).reshape(b * h, t, dh).contiguous()


def _from_bh(x, b, h):
    bh, t, dh = x.shape
    return x.reshape(b, h, t, dh).transpose(1, 2)


def _blocks(tq: int, tk: int, block_q: Optional[int],
            block_k: Optional[int]) -> Tuple[int, int]:
    """The JAX package's block rule, kept for API parity: a given block
    (clipped to the length) must divide it.  None means the whole length
    — the TPU's VMEM-sized default (``_auto_block``) does not carry over,
    and the CUDA kernel tiles and masks on its own."""
    bq = tq if block_q is None else min(int(block_q), tq)
    bk = tk if block_k is None else min(int(block_k), tk)
    if tq % bq or tk % bk:
        raise ValueError(f"sequence lengths ({tq}, {tk}) must divide "
                         f"block sizes ({bq}, {bk})")
    return bq, bk


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """Plain PyTorch version of the forward kernel: dense scores, f32
    statistics.  (BH, Tq, Dh) q and (BH, Tk, Dh) k/v → (O (BH, Tq, Dh)
    in q's dtype, lse (BH, Tq) f32)."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(1, 2)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        q_pos = torch.arange(tq, device=s.device)[:, None]
        k_pos = torch.arange(tk, device=s.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.to(torch.float32))
    return o.to(q.dtype), lse


#: dtype codes of the C interface (``dkt_flash_fwd``'s ``dtype``)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64)


def flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    """Launch the CUDA forward kernel.  Same contract as
    ``flash_fwd_plain``; raises on what the kernel does not take.
    ``flash_fwd_cuda.launches`` counts the launches."""
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_fwd_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd_cuda takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected (BH, T, Dh) q/k/v, got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    bh, tq, dh = q.shape
    tk = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch·heads or head dim")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if tq < 1 or tk < 1:
        raise ValueError("empty sequence")
    if causal and tq != tk:
        raise ValueError(f"causal flash needs equal q/k lengths, got "
                         f"{tq} vs {tk}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_fwd_cuda needs contiguous q/k/v")
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dkt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, tq, tk, dh, int(bool(causal)),
        ctypes.c_float(scale), _DTYPE_CODES[q.dtype], q.device.index or 0,
        stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} "
                           f"({lib.dkt_error_string(err).decode()})")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _flash_fwd(q, k, v, causal: bool, scale: float):
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                     f"{q.device}")


class _FlashAttention(torch.autograd.Function):
    """The differentiable op around the forward kernel; its backward
    (K2/K3) is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        return _flash_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(_BACKWARD_MSG)


def flash_attention_lse(q, k, v, causal: bool = False, block_q=None,
                        block_k=None):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) → (out (B, Tq, H, Dh), lse
    (B, H, Tq) f32).  Causal requires Tq == Tk; non-causal allows
    Tq ≠ Tk.  Precision follows the input dtype: f32 inputs are computed
    in f32, bf16 inputs with f32 accumulation and statistics."""
    b, t, h, dh = q.shape
    tk = k.shape[1]
    _blocks(t, tk, block_q, block_k)
    if causal and t != tk:
        raise ValueError(f"causal flash needs equal q/k lengths, got "
                         f"{t} vs {tk}")
    out, lse = _FlashAttention.apply(_to_bh(q), _to_bh(k), _to_bh(v),
                                     bool(causal), 1.0 / math.sqrt(dh))
    return _from_bh(out, b, h), lse.reshape(b, h, t)


def flash_attention(q, k, v, causal: bool = False, block_q=None,
                    block_k=None):
    """Flash attention; q/k/v (B, T, H, Dh) → (B, T, H, Dh)."""
    return flash_attention_lse(q, k, v, causal, block_q, block_k)[0]
