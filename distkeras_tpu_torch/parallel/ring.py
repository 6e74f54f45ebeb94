"""Ring attention — sequence parallelism over the ``sp`` mesh axis, the
port of ``distkeras_tpu.parallel.ring``.

Each rank keeps its Q shard and the K/V shards rotate around the ring
(``mesh.ppermute``, one neighbour hop a step, K and V in one message);
the softmax is combined online (``ring_attention``'s blockwise form) or
hop by hop through the logsumexps of a fused kernel
(``_ring_attention_flash``: ``ops.flash_attention.flash_attention_lse``
on every hop — K1 on a CUDA tensor, K2/K3 in its backward, which takes
the lse cotangent ``_merge_lse`` feeds back).  The inner functions take
this rank's local shards, as the JAX ones do inside ``shard_map``;
``ring_attention_sharded`` takes the whole (B, T, H, Dh) arrays, the same
on every rank, and returns the whole output.

The zigzag layout (``zigzag_ring_attention``) gives rank d the chunks
(d, 2P−1−d) so every rank runs the same half-block work each hop under
causal masking; Ulysses (``ulysses_attention``) re-shards sequence to
heads with one ``all_to_all`` each way around a whole-T attention.

Skipped causal hops launch nothing and fold in as the constant partials
(0, ``_NEG``): exp(_NEG − lse) is exactly 0 in f32; their rotated K/V
still take part in the backward (``mesh.depend_on``), so every rank runs
the same collectives there.  A hop's operand cut
from a shard (zigzag's half blocks) is a fresh contiguous tensor before
it reaches the kernel, which takes 16-byte aligned rows only.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import numpy as np
import torch

from .mesh import (Mesh, P, all_to_all, current_mesh, depend_on, ppermute,
                   shard_map)

_NEG = -1e30  # finite -inf stand-in: keeps the online-softmax exp() NaN-free


def _merge_lse(o_a, lse_a, o_b, lse_b):
    """Exactly combine two attention partials over disjoint key blocks via
    their logsumexps: out = Σ o_i·exp(lse_i − lse_tot).  Shapes:
    o (B, T, H, Dh) f32, lse (B, H, T) f32."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return (o_a.float() * w_a + o_b.float() * w_b), lse


def _dense_lse(q, k, v, causal: bool):
    """One einsum attention hop returning (o_f32, lse): the blockwise
    counterpart of ``flash_attention_lse``.  Rectangular q/k lengths are
    the zigzag hop shape; causal (equal lengths) masks the local lower
    triangle."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(dh)
    if causal:
        t = q.shape[1]
        if k.shape[1] != t:
            raise ValueError("causal hop needs equal q/k lengths")
        ar = torch.arange(t, device=q.device)
        mask = ar[None, :] <= ar[:, None]
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None], v.float())
    return o, m + torch.log(l)


def _fresh(x):
    """A new contiguous tensor (the kernels read 16-byte aligned rows; a
    slice may start anywhere)."""
    return x.clone(memory_format=torch.contiguous_format)


def _flash_lse(q, k, v, causal):
    from ..ops.flash_attention import flash_attention_lse
    o, lse = flash_attention_lse(_fresh(q), _fresh(k), _fresh(v), causal)
    return o.float(), lse


def _hop_att(impl: str):
    """Per-hop attention primitive: (q, k, v, causal) → (o f32, lse)."""
    if impl == "flash":
        return _flash_lse
    if impl != "blockwise":
        raise ValueError(f"impl must be blockwise|flash, got {impl!r}")
    return _dense_lse


def _ring(p_size: int):
    return [(j, (j + 1) % p_size) for j in range(p_size)]


def _rotate(kb, vb, axis_name, perm, mesh):
    """The next hop's K/V: one ``ppermute`` of both, stacked."""
    kv = ppermute(torch.stack([kb, vb]), axis_name, perm, mesh)
    return kv[0], kv[1]


def ring_attention(q, k, v, axis_name: str, *, causal: bool = False,
                   impl: str = "blockwise", mesh: Optional[Mesh] = None):
    """Blockwise ring attention over this rank's shards (B, T_loc, H, Dh),
    sharded on T over ``axis_name``; returns this rank's output shard.

    ``impl="flash"`` runs ``flash_attention_lse`` on each hop and merges
    the hops through their logsumexps; ``"blockwise"`` keeps the einsum
    online-softmax formulation."""
    if impl == "flash":
        return _ring_attention_flash(q, k, v, axis_name, causal=causal,
                                     mesh=mesh)
    if impl != "blockwise":
        raise ValueError(f"impl must be blockwise|flash, got {impl!r}")
    mesh = current_mesh(mesh)
    p_size = mesh.procs(axis_name)
    my_idx = mesh.coord(axis_name)
    b, t_loc, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    dev = q.device

    o = torch.zeros((b, t_loc, h, dh), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t_loc), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t_loc), _NEG, dtype=torch.float32, device=dev)
    perm = _ring(p_size)
    q_pos = my_idx * t_loc + torch.arange(t_loc, device=dev)
    qf = q.float()
    kb, vb = k, v
    for i in range(p_size):
        # kv block i originated on rank (my_idx − i) mod P
        src = (my_idx - i) % p_size
        if not causal or src <= my_idx:
            # blocks from ranks after this one are fully masked: skipped
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
            if causal:
                k_pos = src * t_loc + torch.arange(t_loc, device=dev)
                mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
                s = torch.where(mask, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
            o = o * corr.transpose(1, 2)[..., None] + pv
            m = m_new
        else:
            # the skipped block's rotation still gets its backward
            o = depend_on(o, kb, vb)
        if i + 1 < p_size:
            kb, vb = _rotate(kb, vb, axis_name, perm, mesh)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _ring_attention_flash(q, k, v, axis_name: str, *, causal: bool,
                          mesh: Optional[Mesh] = None):
    """Flash ring: hop 0 is the home (diagonal) block — the causal kernel
    when masking; later hops are fully visible or fully masked whole
    blocks, so they run the unmasked kernel or nothing, and a skipped hop
    folds out through the lse merge."""
    mesh = current_mesh(mesh)
    p_size = mesh.procs(axis_name)
    my_idx = mesh.coord(axis_name)
    perm = _ring(p_size)
    o_acc, lse_acc = _flash_lse(q, k, v, causal)
    kb, vb = k, v
    for i in range(1, p_size):
        kb, vb = _rotate(kb, vb, axis_name, perm, mesh)
        src = (my_idx - i) % p_size
        if causal and src >= my_idx:
            # block src strictly after this shard: fully masked — no
            # kernel; lse = _NEG gives it exactly zero weight
            b, t_loc, h, dh = q.shape
            o_i = torch.zeros((b, t_loc, h, dh), dtype=torch.float32,
                              device=q.device)
            lse_i = torch.full((b, h, t_loc), _NEG, dtype=torch.float32,
                               device=q.device)
            o_i = depend_on(o_i, kb, vb)
        else:
            o_i, lse_i = _flash_lse(q, kb, vb, False)
        o_acc, lse_acc = _merge_lse(o_acc, lse_acc, o_i, lse_i)
    return o_acc.to(q.dtype)


# ---------------------------------------------------------------------------
# zigzag (striped) layout: load-balanced causal ring attention
# ---------------------------------------------------------------------------
#
# The sequence splits into 2P chunks and rank d holds the pair
# (d, 2P−1−d): one early chunk E_d and one late chunk L_d.  Causal
# visibility between shards then decomposes into half blocks with no
# partial masks off the diagonal:
#
#   source s earlier (s < d): E_d and L_d both see E_s fully, neither
#       sees L_s              → attend (q_full × k_early)
#   source s later (s > d): only L_d sees anything — E_s and L_s, both
#       fully                 → attend (q_late × k_full)
#   home (s = d): E×E diagonal + L×E full + L×L diagonal
#
# so every rank runs the same work every hop (Striped Attention, Brandon
# et al. 2023).


def zigzag_order(p_size: int) -> np.ndarray:
    """Chunk permutation putting the 2P sequence chunks into zigzag
    layout: rank d's shard = chunks (d, 2P−1−d)."""
    order = np.empty(2 * p_size, np.int64)
    order[0::2] = np.arange(p_size)
    order[1::2] = 2 * p_size - 1 - np.arange(p_size)
    return order


def _take_chunks(x, order, p_size: int, axis: int):
    t = x.shape[axis]
    c = t // (2 * p_size)
    shape = x.shape[:axis] + (2 * p_size, c) + x.shape[axis + 1:]
    idx = torch.as_tensor(order, device=x.device)
    return torch.index_select(x.reshape(shape), axis, idx).reshape(x.shape)


def zigzag_shuffle(x, p_size: int, axis: int = 1):
    """Reorder the sequence ``axis`` (length divisible by 2P) into zigzag
    layout; inverse of :func:`zigzag_unshuffle`."""
    t = x.shape[axis]
    if t % (2 * p_size):
        raise ValueError(f"zigzag needs the sequence length ({t}) "
                         f"divisible by 2·axis_size ({2 * p_size})")
    return _take_chunks(x, zigzag_order(p_size), p_size, axis)


def zigzag_unshuffle(x, p_size: int, axis: int = 1):
    return _take_chunks(x, np.argsort(zigzag_order(p_size)), p_size, axis)


def zigzag_ring_attention(q, k, v, axis_name: str, *,
                          impl: str = "blockwise",
                          mesh: Optional[Mesh] = None):
    """Load-balanced causal ring attention over the zigzag layout, on this
    rank's shards already zigzag-ordered (rank d holds [chunk d ; chunk
    2P−1−d], see :func:`zigzag_shuffle`): (B, 2c, H, Dh) each.  Returns
    the output shard in the same order.  Every hop is one half-block call
    on every rank: 3 at home (c × c causal twice, c × c unmasked), then
    2c × c or c × 2c unmasked."""
    mesh = current_mesh(mesh)
    p_size = mesh.procs(axis_name)
    my_idx = mesh.coord(axis_name)
    b, t2, h, dh = q.shape
    if t2 % 2:
        raise ValueError(f"zigzag shard length must be even, got {t2}")
    c = t2 // 2
    att = _hop_att(impl)
    perm = _ring(p_size)

    q_e, q_l = q[:, :c], q[:, c:]
    k_e, k_l = k[:, :c], k[:, c:]
    v_e, v_l = v[:, :c], v[:, c:]

    # home hop: E×E diagonal, L×E full (L is globally later), L×L diagonal
    o_e, lse_e = att(q_e, k_e, v_e, True)
    o_l1, lse_l1 = att(q_l, k_e, v_e, False)
    o_l2, lse_l2 = att(q_l, k_l, v_l, True)
    o_l, lse_l = _merge_lse(o_l1, lse_l1, o_l2, lse_l2)
    o_acc = torch.cat([o_e, o_l], dim=1)
    lse_acc = torch.cat([lse_e, lse_l], dim=2)

    kb, vb = k, v
    for i in range(1, p_size):
        kb, vb = _rotate(kb, vb, axis_name, perm, mesh)
        src = (my_idx - i) % p_size
        if src < my_idx:
            # source strictly earlier: both chunks see its early chunk
            # fully, neither its late one — one (2c × c) call
            o_i, lse_i = att(q, kb[:, :c], vb[:, :c], False)
        else:
            # source strictly later: only the late chunk attends, to all
            # of it — one (c × 2c) call
            o_h, lse_h = att(q_l, kb, vb, False)
            o_i = torch.cat([torch.zeros_like(o_h), o_h], dim=1)
            lse_i = torch.cat([torch.full_like(lse_h, _NEG), lse_h], dim=2)
        o_acc, lse_acc = _merge_lse(o_acc, lse_acc, o_i, lse_i)
    return o_acc.to(q.dtype)


def ring_schedule_flops(p_size: int, t_loc: int, *, causal: bool,
                        layout: str = "contiguous"):
    """Score-element counts (q·k pairs whose dot products are computed)
    per rank for one ring pass: contiguous + causal skips fully masked
    hops (ranks imbalanced — the last computes P blocks); zigzag runs 3
    half blocks at home and 2 half blocks' worth per further hop on
    every rank."""
    full = t_loc * t_loc
    if layout == "zigzag":
        if not causal:
            return [p_size * full] * p_size  # the plain ring
        half = (t_loc // 2) * (t_loc // 2)
        return [3 * half + (p_size - 1) * 2 * half] * p_size
    if layout != "contiguous":
        raise ValueError(f"layout must be contiguous|zigzag, got {layout!r}")
    if not causal:
        return [p_size * full] * p_size
    return [(d + 1) * full for d in range(p_size)]


def ulysses_attention(q, k, v, axis_name: str, *, causal: bool = False,
                      impl: str = "auto", mesh: Optional[Mesh] = None):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses) on this rank's
    shards: one ``all_to_all`` re-shards (B, T/P, H, Dh) to (B, T, H/P,
    Dh), each rank runs whole-T attention over its head group (``impl``
    "flash" — the port's flash op, K1 on the card — or "dense"; "auto"
    is "flash"), and a second ``all_to_all`` restores sequence
    sharding.  Heads must divide the axis size."""
    mesh = current_mesh(mesh)
    p_size = mesh.procs(axis_name)
    h = q.shape[2]
    if h % p_size:
        raise ValueError(f"ulysses needs heads ({h}) divisible by the "
                         f"{axis_name!r} axis size ({p_size}); use the "
                         f"ring path for head counts below the mesh")
    qh, kh, vh = (all_to_all(x, axis_name, 2, 1, tiled=True, mesh=mesh)
                  for x in (q, k, v))
    if impl == "auto":
        impl = "flash"
    if impl == "flash":
        from ..ops.flash_attention import flash_attention
        o = flash_attention(qh, kh, vh, causal)
    elif impl == "dense":
        from ..ops.attention import dot_product_attention
        o = dot_product_attention(qh, kh, vh, causal=causal)
    else:
        raise ValueError(f"impl must be auto|flash|dense, got {impl!r}")
    return all_to_all(o, axis_name, 1, 2, tiled=True, mesh=mesh)


def ring_attention_sharded(mesh: Mesh, q, k, v, *, axis: str = "sp",
                           batch_axis: Optional[str] = None,
                           causal: bool = False, impl: str = "blockwise",
                           layout: str = "contiguous",
                           pre_shuffled: bool = False):
    """Whole-array entry point: q/k/v (B, T, H, Dh), the same on every
    rank, are sharded on T over ``mesh[axis]`` (and on B over
    ``batch_axis``, dp × sp: the rings stay within sp); returns the whole
    output on every rank.  ``impl``: "blockwise", "flash" (the fused op
    per hop) or "ulysses".  ``layout="zigzag"`` (causal; T divisible by
    2·axis size) re-stripes the sequence for the balanced schedule;
    ``pre_shuffled=True`` when q/k/v already arrive in zigzag order (the
    output then stays zigzag)."""
    spec = P(batch_axis, axis)
    p_size = mesh.procs(axis)
    if pre_shuffled and layout != "zigzag":
        raise ValueError("pre_shuffled=True only makes sense with "
                         "layout='zigzag'")
    if layout == "zigzag":
        if impl == "ulysses":
            raise ValueError("layout='zigzag' is a ring schedule; the "
                             "ulysses all-to-all path is already balanced")
        if not causal and pre_shuffled:
            raise ValueError("pre_shuffled zigzag requires causal=True "
                             "(non-causal rings don't use the stripe)")
        if causal:
            if not pre_shuffled:
                q, k, v = (zigzag_shuffle(x, p_size) for x in (q, k, v))
            inner = partial(zigzag_ring_attention, axis_name=axis,
                            impl=impl, mesh=mesh)
            out = shard_map(inner, mesh, (spec, spec, spec), spec)(q, k, v)
            return out if pre_shuffled else zigzag_unshuffle(out, p_size)
        # non-causal attention has no masked hops to balance: the plain
        # ring is the zigzag schedule
        layout = "contiguous"
    elif layout != "contiguous":
        raise ValueError(f"layout must be contiguous|zigzag, got {layout!r}")
    if impl == "ulysses":
        inner = partial(ulysses_attention, axis_name=axis, causal=causal,
                        mesh=mesh)
    else:
        inner = partial(ring_attention, axis_name=axis, causal=causal,
                        impl=impl, mesh=mesh)
    return shard_map(inner, mesh, (spec, spec, spec), spec)(q, k, v)
