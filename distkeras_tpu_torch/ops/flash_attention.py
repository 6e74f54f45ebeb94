"""Flash attention, forward and backward — the port of
``distkeras_tpu.ops.pallas_attention`` (``flash_attention`` and
``flash_attention_lse``).

On CUDA tensors the forward is a hand-written kernel, the port of the
Pallas ``_fwd_kernel`` (through ``flash_fwd_cuda``), and the backward two
kernels, the ports of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (through
``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda``).  Up to head dim 128
they run on tensor cores: in bf16 on wgmma and TMA
(``ops/csrc/flash_fwd_sm90.cu``, ``ops/csrc/flash_bwd_sm90.cu``), in f32
as 3xTF32 on mma.sync (``ops/csrc/flash_fwd_tf32_sm90.cu``,
``ops/csrc/flash_bwd_tf32_sm90.cu``), and so from 129 to 256: the bf16
kernels on 192- and 256-wide wgmma tiles, the f32 ones as 3xTF32 on
192- and 256-wide tiles.  Past 256 the bf16 kernels run on wgmma in
256-column output panels (``ops/csrc/flash_fwd_panels_sm90.cu``,
``ops/csrc/flash_bwd_panels_sm90.cu``), and so does the f32 backward as
3xTF32 (``ops/csrc/flash_bwd_tf32_panels_sm90.cu``).  The f32 forward up
to 128 at grids too small for 64-row tiles (the serving shapes), and
past 256, runs on CUDA cores (``ops/csrc/flash_fwd.cu``), which take any
head dim, as the reference's BlockSpecs do.
``kernel_head_dim`` names the width each kernel runs.  On CPU tensors
they are ``flash_fwd_plain`` and ``flash_bwd_plain``, the dense versions
of the same functions.  A CUDA tensor never takes a plain version: the
kernel runs or the call raises.

Head dims: the f32 forward and the f32 K2 and K3 past 128 read rows of
the caller's Dh and mask the columns past it in their tiles.  The bf16
kernels on wgmma (K1, K2 and K3 at every head dim) read rows
of the caller's Dh into tiles of 32, 64, 128, 192 or 256 columns, or
past 256 in 64-column chunks, TMA zero-filling the columns past Dh, and
store their outputs at Dh; TMA needs the rows' byte stride a multiple of
16 (Dh % 8 == 0), so the wrappers zero-pad bf16 q, k, v (and dO) along
Dh to the next multiple of 8 at any other Dh (``pad_head_dim``), run the
kernel with the caller's ``scale`` and slice the outputs back.  The f32
K2 and K3 up to 128 are instantiated for 32, 64 and 128 (``HEAD_DIMS``,
the widths of their cp.async tiles), and the wrappers pad any other Dh
up to 128 to the next of those the same way.  A pad is the same
function: zero columns add nothing to QKᵀ, O's and the gradients' padded
columns are products with zeros, and D = rowsum(dO∘O) does not see them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _kernels


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
    and the CUDA kernels tile and mask on their own."""
    bq = tq if block_q is None else min(int(block_q), tq)
    bk = tk if block_k is None else min(int(block_k), tk)
    if tq % bq or tk % bk:
        raise ValueError(f"sequence lengths ({tq}, {tk}) must divide "
                         f"block sizes ({bq}, {bk})")
    return bq, bk


def _causal_keep(tq: int, tk: int, device):
    """(Tq, Tk) bool: key position ≤ query position."""
    return (torch.arange(tk, device=device)[None, :]
            <= torch.arange(tq, device=device)[:, None])


def flash_fwd_plain(q, k, v, causal: bool, scale: float):
    """Plain PyTorch version of the forward kernel: dense scores, f32
    statistics.  (BH, Tq, Dh) q and (BH, Tk, Dh) k/v → (O (BH, Tq, Dh)
    in q's dtype, lse (BH, Tq) f32).  For bf16 inputs P = exp(S − rowmax)
    is rounded to bf16 before P·V and the product divided by the f32 row
    sum of the unrounded P, as the reference's kernel does when one key
    tile holds the whole row."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(*s.shape[-2:], s.device),
                          float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    vf = v.to(torch.float32)
    if q.dtype == torch.float32:
        o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p.to(q.dtype).to(torch.float32), vf) \
            / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, lse, do, dvec, causal: bool, scale: float):
    """Plain PyTorch version of the backward kernels (K2 and K3 together):
    with P = exp(scale·QKᵀ − L) under the causal mask, dP = dO·Vᵀ and
    dS = scale·P∘(dP − D), returns (dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO),
    computed in f32 and cast to q's, k's and v's dtypes.  For bf16 inputs
    P and dS are rounded to bf16 before the second products, as the
    reference's kernels round them.  Shapes as the kernels': q/do (BH, Tq,
    Dh), k/v (BH, Tk, Dh), lse/dvec (BH, Tq) f32."""
    qf, kf, vf, dof = (x.to(torch.float32) for x in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(1, 2)) * scale
                  - lse[..., None])
    if causal:
        # a select, so a masked entry is exactly 0 whatever exp gave
        p = p.masked_fill(~_causal_keep(*p.shape[-2:], p.device), 0.0)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = p * (dp - dvec[..., None]) * scale
    # the second products' operands in the input dtype (a no-op for f32)
    p, ds = (x.to(q.dtype).to(torch.float32) for x in (p, ds))
    return (torch.matmul(ds, kf).to(q.dtype),
            torch.matmul(ds.transpose(1, 2), qf).to(k.dtype),
            torch.matmul(p.transpose(1, 2), dof).to(v.dtype))


#: dtype codes of the C interface (the ``dtype`` argument)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the f32 K2 and K3 are instantiated for up to 128 (the other
#: tensor-core kernels read any Dh there: the f32 K1 unpadded, the bf16
#: ones a multiple of 8)
HEAD_DIMS = (32, 64, 128)


def kernel_head_dim(dh: int, dtype: torch.dtype, kernel: str) -> int:
    """The head dim the CUDA ``kernel`` ("fwd", "dq" or "dkv") runs a Dh
    of ``dtype`` as, the rows the wrapper hands it — the padding half of
    the routing, whose other half is the C entry points' choice of kernel
    (they refuse a width this does not give them): bf16 the next multiple
    of 8 (the wgmma kernels' TMA rows of a 16-byte multiple, at every
    Dh), so a Dh of a multiple of 8 crosses unpadded; the f32 forward any Dh; the f32 K2 and K3 up to 128
    the least of ``HEAD_DIMS`` that holds it; past that Dh itself (the
    f32 K2 and K3 at 129–256 and in panels past 256 mask the columns
    past Dh and take any Dh)."""
    if dtype == torch.bfloat16:
        return -(-dh // 8) * 8
    if kernel == "fwd" and dtype == torch.float32:
        return dh
    return next((size for size in HEAD_DIMS if dh <= size), dh)


def pad_head_dim(x: torch.Tensor, size: int) -> torch.Tensor:
    """``x`` (…, Dh) zero-padded along its last axis to ``size``, as a
    new contiguous tensor (``x`` itself when Dh is already ``size``)."""
    dh = x.shape[-1]
    return x if dh == size else F.pad(x, (0, size - dh))


def _unpad(x: torch.Tensor, dh: int) -> torch.Tensor:
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


def _check(name: str, q, k, v, causal: bool, stats=(), do=None):
    """Refuse what the kernels do not take; returns (bh, tq, tk, dh).
    ``stats`` are (BH, Tq) f32 vectors (lse, D); ``do`` is shaped and
    typed like q."""
    tensors = (q, k, v, *stats) + (() if do is None else (do,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected (BH, T, Dh) q/k/v, got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    bh, tq, dh = q.shape
    tk = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch·heads or head dim")
    if dh < 1:
        raise ValueError("empty head dim")
    if tq < 1 or tk < 1:
        raise ValueError("empty sequence")
    if causal and tq != tk:
        raise ValueError(f"causal flash needs equal q/k lengths, got "
                         f"{tq} vs {tk}")
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise ValueError(f"{name}: dO {tuple(do.shape)} {do.dtype} must be "
                         f"shaped and typed like q {tuple(q.shape)} "
                         f"{q.dtype}")
    for t in stats:
        if t.dtype != torch.float32 or t.shape != (bh, tq):
            raise ValueError(f"{name}: lse and D must be ({bh}, {tq}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if any(t is not None and t.data_ptr() % 16 for t in (q, k, v, do)):
        # the tensor-core kernels load their tiles by TMA (bf16) or by
        # 16-byte cp.async (f32)
        raise ValueError(f"{name}: q, k, v (and dO) must start at a "
                         f"16-byte aligned address (a view with a storage "
                         f"offset may not)")
    return bh, tq, tk, dh


#: the kernel each C entry point reports it ran
#: (``dkt_flash_last_kernel``), by its code in ``csrc/launched.h``: bf16
#: on wgmma up to head dim 128, bf16 on wgmma at 129–256, f32 as
#: 3xTF32 up to 128, CUDA cores (K1 only), f32 as 3xTF32 at 129–256, bf16
#: on wgmma past 256 and f32 as 3xTF32 past 256 (K2, K3 only; both in
#: 256-column output panels)
KERNELS = {
    "dkt_flash_fwd": ("flash_fwd", "flash_fwd_wgmma_wide", "flash_fwd_f32",
                      "flash_fwd_cuda_cores", "flash_fwd_f32_wide",
                      "flash_fwd_wgmma_past256", None),
    "dkt_flash_bwd_dq": ("flash_bwd_dq", "flash_bwd_dq_wgmma_wide",
                         "flash_bwd_dq_f32", None, "flash_bwd_dq_f32_wide",
                         "flash_bwd_dq_wgmma_past256",
                         "flash_bwd_dq_f32_past256"),
    "dkt_flash_bwd_dkv": ("flash_bwd_dkv", "flash_bwd_dkv_wgmma_wide",
                          "flash_bwd_dkv_f32", None, "flash_bwd_dkv_f32_wide",
                          "flash_bwd_dkv_wgmma_past256",
                          "flash_bwd_dkv_f32_past256"),
}
#: launches by (kernel of ``KERNELS``, dtype name, the caller's head dim),
#: each counted where its launch returned, under the kernel the C entry
#: point reports it ran; ``reset_launches`` sets them to 0
KERNEL_LAUNCHES: Counter = Counter()
#: guards every count: async thread workers launch kernels from several
#: Python threads at once (ctypes drops the GIL inside the launch), and
#: neither ``+=`` on an attribute nor on a ``Counter`` item is atomic
_COUNT_LOCK = threading.Lock()


def _launch(fn: str, *args, device) -> str:
    """Call the C function ``fn`` on the current stream of ``device``,
    raise on a nonzero CUDA error, and return the name of the kernel it
    ran (``KERNELS``)."""
    lib = _kernels.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.dkt_error_string(err).decode()})")
    return KERNELS[fn][lib.dkt_flash_last_kernel()]


def _count(wrapper, kernel: str, dtype: torch.dtype, dh: int) -> None:
    """One launch of ``kernel`` through ``wrapper`` at head dim ``dh``."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        KERNEL_LAUNCHES[(kernel, str(dtype).removeprefix("torch."), dh)] += 1


def flash_fwd_cuda(q, k, v, causal: bool, scale: float):  # dklint: hot
    """Launch the CUDA forward kernel (K1).  Same contract as
    ``flash_fwd_plain``; raises on what the kernel does not take.
    ``flash_fwd_cuda.launches`` counts the launches (and
    ``KERNEL_LAUNCHES`` each by the kernel that ran)."""
    bh, tq, tk, dh = _check("flash_fwd_cuda", q, k, v, causal)
    size = kernel_head_dim(dh, q.dtype, "fwd")
    q, k, v = (pad_head_dim(x, size) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    kernel = _launch("dkt_flash_fwd", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, tq, tk,
                     size, 1 if causal else 0, ctypes.c_float(scale),
                     _DTYPE_CODES[q.dtype], device=q.device)
    _count(flash_fwd_cuda, kernel, q.dtype, dh)
    return _unpad(o, dh), lse


def flash_bwd_dq_cuda(q, k, v, lse, do, dvec, causal: bool, scale: float):  # dklint: hot
    """Launch K2: dQ, like ``flash_bwd_plain``'s first output.
    ``flash_bwd_dq_cuda.launches`` counts the launches (and
    ``KERNEL_LAUNCHES`` each by the kernel that ran)."""
    bh, tq, tk, dh = _check("flash_bwd_dq_cuda", q, k, v, causal,
                            (lse, dvec), do)
    size = kernel_head_dim(dh, q.dtype, "dq")
    q, k, v, do = (pad_head_dim(x, size) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    kernel = _launch("dkt_flash_bwd_dq", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     dvec.data_ptr(), dq.data_ptr(), bh, tq, tk, size,
                     1 if causal else 0, ctypes.c_float(scale),
                     _DTYPE_CODES[q.dtype], device=q.device)
    _count(flash_bwd_dq_cuda, kernel, q.dtype, dh)
    return _unpad(dq, dh)


def flash_bwd_dkv_cuda(q, k, v, lse, do, dvec, causal: bool, scale: float):  # dklint: hot
    """Launch K3: (dK, dV), like ``flash_bwd_plain``'s last two outputs.
    ``flash_bwd_dkv_cuda.launches`` counts the launches (and
    ``KERNEL_LAUNCHES`` each by the kernel that ran)."""
    bh, tq, tk, dh = _check("flash_bwd_dkv_cuda", q, k, v, causal,
                            (lse, dvec), do)
    size = kernel_head_dim(dh, q.dtype, "dkv")
    q, k, v, do = (pad_head_dim(x, size) for x in (q, k, v, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel = _launch("dkt_flash_bwd_dkv", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                     dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, tq,
                     tk, size, 1 if causal else 0, ctypes.c_float(scale),
                     _DTYPE_CODES[q.dtype], device=q.device)
    _count(flash_bwd_dkv_cuda, kernel, q.dtype, dh)
    return _unpad(dk, dh), _unpad(dv, dh)


def _wrappers() -> dict:
    return {w.__name__: w for w in (flash_fwd_cuda, flash_bwd_dq_cuda,
                                    flash_bwd_dkv_cuda)}


def reset_launches() -> None:
    """Set every launch count to 0: each wrapper's ``launches`` and
    ``KERNEL_LAUNCHES``."""
    with _COUNT_LOCK:
        for wrapper in _wrappers().values():
            wrapper.launches = 0
        KERNEL_LAUNCHES.clear()


def launch_counts() -> dict:
    """Every launch count as plain data — ``{"wrappers": {name: n},
    "kernels": [[kernel, dtype, dh, n], ...]}`` — what a worker process
    reports to its parent (``add_launches``)."""
    with _COUNT_LOCK:
        return {"wrappers": {n: w.launches for n, w in _wrappers().items()},
                "kernels": [[k, d, h, n] for (k, d, h), n in
                            sorted(KERNEL_LAUNCHES.items())]}


def add_launches(counts: dict) -> None:
    """Add another process's ``launch_counts()`` into this process's
    counts (the async runner folds its worker processes' launches)."""
    wrappers = _wrappers()
    with _COUNT_LOCK:
        for name, n in (counts.get("wrappers") or {}).items():
            wrappers[name].launches += int(n)
        for k, d, h, n in counts.get("kernels") or []:
            KERNEL_LAUNCHES[(str(k), str(d), int(h))] += int(n)


reset_launches()


def _on(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return q.device.type


class _FlashAttention(torch.autograd.Function):
    """The differentiable op: (q, k, v) in (BH, T, Dh) → (O, lse).  Its
    backward computes D = rowsum(dO∘O) in f32 (as the JAX package does,
    outside the kernels), folds an lse cotangent in as D − g_lse, and runs
    K2 and K3 (their plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if _on(q) == "cuda":
            o, lse = flash_fwd_cuda(q, k, v, causal, scale)
        else:
            o, lse = flash_fwd_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        # the cotangent of _from_bh's transposed view arrives strided
        do = torch.zeros_like(q) if g_out is None \
            else g_out.to(q.dtype).contiguous()
        dvec = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
        if g_lse is not None:
            dvec = dvec - g_lse.to(torch.float32)
        args = (q, k, v, lse, do, dvec.contiguous(), ctx.causal, ctx.scale)
        if _on(q) == "cuda":
            dq = flash_bwd_dq_cuda(*args)
            dk, dv = flash_bwd_dkv_cuda(*args)
        else:
            dq, dk, dv = flash_bwd_plain(*args)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = False, block_q=None,
                        block_k=None):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) → (out (B, Tq, H, Dh), lse
    (B, H, Tq) f32), differentiable in both outputs.  Causal requires
    Tq == Tk; non-causal allows Tq ≠ Tk.  Precision follows the input
    dtype: f32 inputs are computed in f32, bf16 inputs with f32
    accumulation and statistics."""
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
