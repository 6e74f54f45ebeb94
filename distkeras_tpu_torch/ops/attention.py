"""Attention ops + the ``MultiHeadAttention`` layer (the port of
``distkeras_tpu.ops.attention``).

* ``dot_product_attention`` — dense reference attention.
* ``apply_rope`` — rotary embeddings, HALF-SPLIT convention (dim i pairs
  with dim i + Dh/2), as in the JAX package.
* ``MultiHeadAttention`` — fused qkv projection, grouped-query K/V,
  dense or flash attention, and the cached-decode protocol.
* ``LayerNorm`` / ``PositionalEmbedding`` / ``GlobalAvgPool1D``.

``impl="flash"`` runs ``ops.flash_attention`` (the hand-written CUDA
kernel on the card, its plain version on the CPU).  Sequence-parallel
ring attention (a set ``mesh``) is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Layer, glorot_uniform, register, uniform_scale
from .flash_attention import flash_attention


def dot_product_attention(q, k, v, *, causal: bool = False):
    """q: (B, Tq, H, Dh); k/v: (B, Tk, H, Dh) → (B, Tq, H, Dh)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores,
                             torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def apply_rope(x, positions, base: float = 10000.0):
    """Rotate each (i, i + Dh/2) pair of ``x`` (B, T, H, Dh) by
    position-scaled angles.  ``positions``: (T,) shared, or (B, T) per
    row (ragged cached decode)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs   # (…, T, half)
    if ang.ndim == 2:  # shared positions: broadcast over the batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


_MIN_FLASH_BLOCK = 32  # the JAX package's floor for a flash block


def _largest_divisor_block(t: int, cap: int = 128) -> int:
    """Largest block size ≤ cap dividing t (T=200 → 100, prime T → 1)."""
    for b in range(min(cap, t), 0, -1):
        if t % b == 0:
            return b
    return 1


def _flash_with_blocking(q, k, v, causal: bool, t: int):
    """Flash attention with the JAX package's block rule: a T whose
    largest divisor block is below ``_MIN_FLASH_BLOCK`` is end-padded to
    a multiple of 128 when causal (exact: padded keys sit after every
    real query, padded query rows are sliced off) and refused when not
    (padded keys would be attended).  The CUDA kernel itself masks any
    tail; the rule is kept so both packages accept the same shapes."""
    blk = _largest_divisor_block(t)
    if blk >= _MIN_FLASH_BLOCK or t <= _MIN_FLASH_BLOCK:
        return flash_attention(q, k, v, causal)
    if not causal:
        raise ValueError(
            f"impl='flash' needs a sequence length with a block-sized "
            f"divisor; T={t}'s largest block is {blk} (< "
            f"{_MIN_FLASH_BLOCK}).  Pad T to a multiple of 128 (with key "
            f"masking) or use impl='dense'.")
    pad = -t % 128
    padded = [F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v)]
    return flash_attention(*padded, True)[:, :t]


@register
class MultiHeadAttention(Layer):
    """Self-attention over (T, D) inputs: one fused (D, D + 2·KV·Dh) qkv
    projection, grouped-query K/V (``num_kv_heads``), output projection.
    ``impl``: ``"dense"`` or ``"flash"``."""

    time_mixing = True  # has its own apply_decode/apply_prefill rules

    def __init__(self, num_heads: int, causal: bool = False,
                 impl: str = "dense", num_kv_heads: Optional[int] = None,
                 rope: bool = False):
        super().__init__()
        if impl not in ("dense", "flash"):
            raise ValueError(f"impl must be 'dense' or 'flash', got {impl!r}")
        self.num_heads = int(num_heads)
        self.rope = bool(rope)
        self.num_kv_heads = None if num_kv_heads is None \
            else int(num_kv_heads)
        if self.num_kv_heads is not None:
            if self.num_kv_heads < 1:
                raise ValueError(f"num_kv_heads must be >= 1, got "
                                 f"{num_kv_heads}")
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"num_heads {num_heads} not divisible by num_kv_heads "
                    f"{num_kv_heads}")
        self.causal = bool(causal)
        self.impl = impl
        #: runtime attachment for sequence-parallel ring attention in the
        #: JAX package; not ported yet, so a set mesh raises
        self.mesh = None

    @property
    def _kv(self) -> int:
        return self.num_kv_heads if self.num_kv_heads is not None \
            else self.num_heads

    def build(self, in_shape, gen):
        t, d = in_shape
        if d % self.num_heads:
            raise ValueError(f"model dim {d} not divisible by "
                             f"{self.num_heads} heads")
        dh = d // self.num_heads
        if self.rope and dh % 2:
            raise ValueError(
                f"rope=True needs an even head dim, got Dh = {dh} "
                f"(dim {d} / {self.num_heads} heads)")
        self.qkv = nn.Parameter(
            glorot_uniform(gen, (d, d + 2 * self._kv * dh)))
        self.out = nn.Parameter(glorot_uniform(gen, (d, d)))
        return in_shape

    def _project(self, x):
        """x (B, T, D) → q (B, T, H, Dh), k/v (B, T, KV, Dh)."""
        b, t, d = x.shape
        h, kv = self.num_heads, self._kv
        dh = d // h
        qkv = x @ self.qkv.to(x.dtype)
        q = qkv[..., :d].reshape(b, t, h, dh)
        k = qkv[..., d:d + kv * dh].reshape(b, t, kv, dh)
        v = qkv[..., d + kv * dh:].reshape(b, t, kv, dh)
        return q, k, v

    def _expand_kv(self, k):
        """(B, T, KV, Dh) → (B, T, H, Dh): head = kv_idx·G + g, like
        ``jnp.repeat`` on the head axis."""
        g = self.num_heads // self._kv
        return k if g == 1 else torch.repeat_interleave(k, g, dim=2)

    def _check_mesh(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ring attention (a mesh-attached MultiHeadAttention) is not "
                "ported yet; detach the mesh")

    def forward(self, x):
        self._check_mesh()
        b, t, d = x.shape
        q, k, v = self._project(x)
        if self.rope:
            pos = torch.arange(t, device=x.device)
            q = apply_rope(q, pos)
            k = apply_rope(k, pos)
        k = self._expand_kv(k)
        v = self._expand_kv(v)
        if self.impl == "flash":
            o = _flash_with_blocking(q, k, v, self.causal, t)
        else:
            o = dot_product_attention(q, k, v, causal=self.causal)
        return o.reshape(b, t, d) @ self.out.to(x.dtype)

    def init_cache(self, batch, in_shape):
        t, d = in_shape
        shape = (batch, t, self._kv, d // self.num_heads)
        dev = self.qkv.device
        return {"k": torch.zeros(shape, device=dev),
                "v": torch.zeros(shape, device=dev)}

    def apply_decode(self, x, cache, pos):
        """One-token cached decode: write this position's K/V into the
        cache (in place), attend the single query over positions <= pos.
        ``pos``: an int (uniform batch) or a (B,) tensor (per-row
        positions, ragged decode).  Grouped-query attention attends via a
        (KV, G) grouped einsum, so the cache is never expanded."""
        if not self.causal:
            raise ValueError("cached decode requires causal=True attention")
        self._check_mesh()
        b, d = x.shape
        h, kv = self.num_heads, self._kv
        g = h // kv
        dh = d // h
        per_row = torch.is_tensor(pos) and pos.ndim == 1
        if not per_row:
            pos = int(pos)
        q, k, v = self._project(x[:, None, :])
        if self.rope:
            p1 = pos[:, None] if per_row else torch.full(
                (1,), pos, device=x.device)
            q = apply_rope(q, p1)
            k = apply_rope(k, p1)
        kc, vc = cache["k"], cache["v"]
        if per_row:
            rows = torch.arange(b, device=x.device)
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
        else:
            kc[:, pos] = k[:, 0].to(kc.dtype)
            vc[:, pos] = v[:, 0].to(vc.dtype)
        qg = q[:, 0].reshape(b, kv, g, dh).to(torch.float32)
        s = torch.einsum("bkgd,btkd->bkgt", qg,
                         kc.to(torch.float32)) / math.sqrt(dh)
        t_idx = torch.arange(kc.shape[1], device=x.device)
        horizon = pos[:, None, None, None] if per_row else pos
        s = torch.where(t_idx[None, None, None, :] <= horizon, s, -1e30)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgt,btkd->bkgd", w,
                         vc.to(torch.float32)).to(x.dtype)
        return o.reshape(b, d) @ self.out.to(x.dtype), cache

    def apply_prefill(self, x, cache):
        """Full causal forward over ``x`` (through the layer's own impl)
        that returns every position's K/V as the cache."""
        if not self.causal:
            raise ValueError("cached decode requires causal=True attention")
        self._check_mesh()
        b, t, d = x.shape
        q, k, v = self._project(x)
        if self.rope:
            pos = torch.arange(t, device=x.device)
            q = apply_rope(q, pos)
            k = apply_rope(k, pos)
        cache = {"k": k.to(cache["k"].dtype).contiguous(),
                 "v": v.to(cache["v"].dtype).contiguous()}
        k = self._expand_kv(k)
        v = self._expand_kv(v)
        if self.impl == "flash":
            o = _flash_with_blocking(q, k, v, True, t)
        else:
            o = dot_product_attention(q, k, v, causal=True)
        return o.reshape(b, t, d) @ self.out.to(x.dtype), cache

    def get_config(self):
        return {"num_heads": self.num_heads, "causal": self.causal,
                "impl": self.impl, "num_kv_heads": self.num_kv_heads,
                "rope": self.rope}


@register
class LayerNorm(Layer):
    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = float(epsilon)

    def build(self, in_shape, gen):
        d = in_shape[-1]
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        return in_shape

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)  # population var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)

    def get_config(self):
        return {"epsilon": self.epsilon}


@register
class PositionalEmbedding(Layer):
    """Learned absolute position embeddings added to the token
    embeddings: (T, D) -> (T, D)."""

    def __init__(self, max_len: int):
        super().__init__()
        self.max_len = int(max_len)

    def build(self, in_shape, gen):
        t, d = in_shape
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds "
                             f"max_len={self.max_len}")
        self.table = nn.Parameter(uniform_scale(gen, (self.max_len, d)))
        return in_shape

    def forward(self, x):
        t = x.shape[1]
        return x + self.table[:t].to(x.dtype)

    def apply_decode(self, x, cache, pos):
        # a (B,) tensor gathers one row per batch element; an int one row
        row = self.table[pos] if torch.is_tensor(pos) \
            else self.table[int(pos)]
        return x + row.to(x.dtype), cache

    def get_config(self):
        return {"max_len": self.max_len}


@register
class GlobalAvgPool1D(Layer):
    """Mean over the time axis: (T, D) -> (D,)."""
    time_mixing = True

    def out_shape(self, in_shape):
        return (in_shape[-1],)

    def forward(self, x):
        return x.mean(dim=1)
