"""The port's flash attention (``distkeras_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas flash attention, which runs in interpret
mode on the CPU — outputs and gradients.  On the CPU the port runs its
plain versions; the CUDA kernels themselves are held against those plain
versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``)."""

import functools
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from distkeras_tpu.models.model import Model as JaxModel
from distkeras_tpu.ops import attention as ja
from distkeras_tpu.ops.attention import _flash_with_blocking as jax_fwb
from distkeras_tpu.ops.attention import dot_product_attention as jax_dense
from distkeras_tpu.ops.pallas_attention import _flash_bwd_raw, _flash_fwd_raw
from distkeras_tpu.ops.pallas_attention import flash_attention as jax_flash
from distkeras_tpu.ops.pallas_attention import (
    flash_attention_lse as jax_flash_lse)
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.ops import _kernels
from distkeras_tpu_torch.ops.attention import _flash_with_blocking
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import (
    _blocks, _from_bh, _to_bh, flash_attention, flash_attention_lse,
    flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_plain, flash_fwd_cuda,
    flash_fwd_plain, kernel_head_dim, pad_head_dim)
from distkeras_tpu_torch.utils.weights import (load_jax_variables,
                                               to_numpy_variables)

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX package's own flash-vs-dense bound
#: the JAX package's f32 flash-vs-dense gradient bound
#: (tests/test_pallas_attention.py: rtol 5e-4 / atol 1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def qkv(b=2, t=64, h=2, dh=32, tk=None, seed=0):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    return (rng.normal(size=(b, t, h, dh)).astype(np.float32),
            rng.normal(size=(b, tk, h, dh)).astype(np.float32),
            rng.normal(size=(b, tk, h, dh)).astype(np.float32))


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_and_lse_match_jax(causal):
    q, k, v = qkv()
    jo, jl = jax_flash_lse(*_jax(q, k, v), causal, 16, 16)
    to, tl = flash_attention_lse(*_torch(q, k, v), causal, 16, 16)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tl.dtype == torch.float32 and tl.shape == (2, 2, 64)
    np.testing.assert_array_equal(
        flash_attention(*_torch(q, k, v), causal).numpy(), to.numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_matches_jax_f32_dense(causal):
    q, k, v = qkv()
    dense = np.asarray(jax_dense(*_jax(q, k, v), causal=causal))
    out = flash_attention(*(t.to(torch.bfloat16) for t in _torch(q, k, v)),
                          causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), dense, rtol=0.06,
                               atol=0.06)


def test_flash_rectangular_non_causal():
    q, k, v = qkv(t=16, tk=48)
    jo, jl = jax_flash_lse(*_jax(q, k, v), False, 16, 16)
    to, tl = flash_attention_lse(*_torch(q, k, v), False, 16, 16)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_causal_needs_equal_lengths():
    q, k, v = qkv(t=16, tk=48)
    with pytest.raises(ValueError, match="equal q/k lengths"):
        jax_flash(*_jax(q, k, v), True, 16, 16)
    with pytest.raises(ValueError, match="equal q/k lengths"):
        flash_attention(*_torch(q, k, v), True, 16, 16)


def test_blocks_reject_non_dividing_block():
    q, k, v = qkv()
    with pytest.raises(ValueError, match="must divide"):
        jax_flash(*_jax(q, k, v), False, 24, 16)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(*_torch(q, k, v), False, 24, 16)
    assert _blocks(64, 48, None, None) == (64, 48)
    assert _blocks(64, 48, 128, 16) == (64, 16)


@pytest.mark.parametrize("b", [1, 3])
def test_bh_layout_round_trip(b):
    x = torch.from_numpy(qkv(b=b, t=5, h=4, dh=8)[0])
    bh = _to_bh(x)
    assert bh.shape == (4 * b, 5, 8) and bh.is_contiguous()
    np.testing.assert_array_equal(_from_bh(bh, b, 4).numpy(), x.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_blocking_awkward_length(causal):
    """T = 257 has no block-sized divisor: causal pads to 384 exactly,
    non-causal refuses — in both packages."""
    q, k, v = qkv(b=1, t=257, h=2, dh=16, seed=1)
    if not causal:
        with pytest.raises(ValueError, match="block-sized"):
            jax_fwb(*_jax(q, k, v), False, 257)
        with pytest.raises(ValueError, match="block-sized"):
            _flash_with_blocking(*_torch(q, k, v), False, 257)
        return
    ref = np.asarray(jax_fwb(*_jax(q, k, v), True, 257))
    out = _flash_with_blocking(*_torch(q, k, v), True, 257)
    assert out.shape == (1, 257, 2, 16)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_dense(*_jax(q, k, v), causal=True)),
        **TOL)


def _cotangents(q, t, seed=5):
    """A random output cotangent shaped like ``q`` and a random lse
    cotangent (B, H, T), from numpy."""
    rng = np.random.default_rng(seed)
    b, _, h, _ = q.shape
    return (rng.normal(size=q.shape).astype(np.float32),
            rng.normal(size=(b, h, t)).astype(np.float32))


def _jax_lse_vjp(causal):
    """jit of the JAX package's (out, lse) vjp, blocks of 16."""
    def f(q, k, v, g_out, g_lse):
        _, pull = jax.vjp(
            lambda a, b, c: jax_flash_lse(a, b, c, causal, 16, 16), q, k, v)
        return pull((g_out.astype(q.dtype), g_lse))
    return jax.jit(f)


@pytest.mark.parametrize("causal,t,tk", [(True, 64, None), (False, 64, None),
                                         (False, 16, 48)])
def test_flash_lse_grads_match_jax(causal, t, tk):
    """dq, dk, dv through (out, lse), with a random cotangent on both,
    against ``jax.vjp`` of the JAX package's ``flash_attention_lse``:
    square causal, square non-causal and rectangular non-causal."""
    q, k, v = qkv(t=t, tk=tk)
    g_out, g_lse = _cotangents(q, t)
    ref = _jax_lse_vjp(causal)(*_jax(q, k, v, g_out, g_lse))
    tq, tk_, tv = (x.requires_grad_() for x in _torch(q, k, v))
    out, lse = flash_attention_lse(tq, tk_, tv, causal, 16, 16)
    got = torch.autograd.grad((out, lse), (tq, tk_, tv),
                              _torch(g_out, g_lse))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_jax(causal):
    """``flash_attention`` alone (no lse cotangent: the port's backward
    takes ``g_lse`` as None) against ``jax.vjp`` of the JAX package's
    flash, on a random output cotangent."""
    q, k, v = qkv(t=32)
    g_out, _ = _cotangents(q, 32)
    ref = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda x, y, z: jax_flash(x, y, z, causal, 16, 16), a, b, c)[1](g))(
        *_jax(q, k, v, g_out))
    tq, tk, tv = (x.requires_grad_() for x in _torch(q, k, v))
    flash_attention(tq, tk, tv, causal, 16, 16).backward(
        torch.from_numpy(g_out))
    for a, b in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_grads_match_jax(causal):
    """bf16 inputs: gradients come back in bf16 and match the JAX
    package's own bf16 flash gradients within the outputs' bf16 rounding
    (rtol 1e-2, atol 1e-2 of the largest |value|), from the same bf16
    inputs."""
    q, k, v = qkv(t=64)
    g_out, g_lse = _cotangents(q, 64)
    ref = _jax_lse_vjp(causal)(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        *_jax(g_out, g_lse))
    tq, tk, tv = (x.to(torch.bfloat16).requires_grad_()
                  for x in _torch(q, k, v))
    out, lse = flash_attention_lse(tq, tk, tv, causal, 16, 16)
    got = torch.autograd.grad((out, lse), (tq, tk, tv),
                              (torch.from_numpy(g_out).to(torch.bfloat16),
                               torch.from_numpy(g_lse)))
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-2,
                                   atol=1e-2 * np.abs(b).max())


@pytest.mark.parametrize("causal,t,tk", [(False, 64, 64), (True, 64, 64),
                                         (False, 16, 48)])
def test_plain_bf16_backward_matches_jax_kernels(causal, t, tk):
    """bf16 ``flash_bwd_plain`` (what the card holds the bf16 K2/K3
    against) against the JAX package's bf16 backward kernels
    (``_flash_bwd_raw``, interpret mode, blocks of 16) on the same inputs:
    q, k, v, dO in bf16, L and D in f32.  Both round P and dS to bf16
    before the second products, so they agree within one bf16 ulp of each
    value (rtol 2⁻⁷) plus 1e-5 of the largest |value|; measured here: at
    most 1.9e-6 (1.4e-6 of the largest |value|), most outputs exactly.
    Without the rounding the plain version is off by up to 0.6% of the
    largest |value|."""
    rng = np.random.default_rng(7)
    bh, dh = 4, 32
    q, do = (torch.from_numpy(rng.normal(size=(bh, t, dh)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(bh, tk, dh)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    scale = dh ** -0.5
    # L and D from the f32 forward of the same values: inputs of both
    # sides, independent of how the bf16 forward rounds
    o, lse = flash_fwd_plain(q.float(), k.float(), v.float(), causal, scale)
    dvec = (do.float() * o.to(torch.bfloat16).float()).sum(-1)
    got = flash_bwd_plain(q, k, v, lse, do, dvec, causal, scale)
    ref = jax.jit(functools.partial(_flash_bwd_raw, causal=causal, bq=16,
                                    bk=16, scale=scale))(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
          for x in (q, k, v, do)),
        *(jnp.asarray(x.numpy())[:, None, :] for x in (lse, dvec)))
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(b).max())


def _tf32(x, rounded=True):
    """x to tf32 on the bits of its int32 view: to nearest, ties away from
    zero (``rounded``), or by dropping the low 13 bits."""
    bits = x.view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b with tf32 operands and f32 sums: one pass (hi·hi, what TF32
    tensor cores give), or three (3xTF32, the f32 backward kernels' recipe
    in ``ops/csrc/flash_bwd_tf32_sm90.cu``: hi rounded to tf32, lo = the
    rest, read by the tensor core to tf32 by dropping bits, lo·lo
    dropped)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b - b_hi, False)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _bwd_tf32(q, k, v, lse, do, dvec, causal, scale, passes):
    """``flash_bwd_plain``'s f32 function with its five products
    (S, dP, dQ, dK, dV) through ``_tf32_matmul``."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    p = torch.exp(_tf32_matmul(q, t(k), passes) * scale - lse[..., None])
    if causal:
        p = torch.where(torch.ones(p.shape[-2:], dtype=torch.bool).tril(),
                        p, 0.0)
    dp = _tf32_matmul(do, t(v), passes)
    ds = p * (dp - dvec[..., None]) * scale
    return (_tf32_matmul(ds, k, passes), _tf32_matmul(t(ds), q, passes),
            _tf32_matmul(t(p), do, passes))


def _tf32_scores(a, b, passes):
    """a @ bᵀ, contracted along Dh, as the f32 kernels at Dh 129–256 sum
    S and dP (``tf32.cuh`` ``product_s``): hi·hi of each pair of 8-wide
    k-steps from zero, the pairs added in f32 in order, the small terms
    (lo·hi + hi·lo) summed apart over all of Dh and added last; one pass
    is hi·hi alone."""
    a_hi, b_hi = _tf32(a), _tf32(b.transpose(1, 2))
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b.transpose(1, 2) - b_hi,
                                                False)
    out = torch.zeros(a.shape[:-1] + b.shape[1:2])
    for k0 in range(0, a.shape[-1], 16):
        out = out + a_hi[..., k0:k0 + 16] @ b_hi[..., k0:k0 + 16, :]
    return out + (a_lo @ b_hi + a_hi @ b_lo)


def _tiled(a, b, passes, dim, tile=32):
    """Σ over tiles of ``tile`` along a's axis ``dim`` (the contracted
    one) of a_tile @ b_tile through ``_tf32_matmul``: each tile's product
    from zero, added in f32, as the wide kernels add each 32-row tile's
    O, dQ, dK and dV."""
    out = 0
    for k0 in range(0, a.shape[dim], tile):
        out = out + _tf32_matmul(a.narrow(dim, k0, min(tile, a.shape[dim]
                                                       - k0)),
                                 b[:, k0:k0 + tile], passes)
    return out


def _causal_mask(tq, tk):
    return torch.ones((tq, tk), dtype=torch.bool).tril()


def _fwd_tf32_wide(q, k, v, causal, scale, passes):
    """The f32 K1 at Dh 129–256: the online softmax over 32-key tiles, S
    through ``_tf32_scores``, each tile's P·V from zero through
    ``_tf32_matmul`` and added to the rescaled O in f32."""
    bh, tq, _ = q.shape
    keep = _causal_mask(tq, k.shape[1]) if causal else None
    m = torch.full((bh, tq, 1), -float("inf"))
    l, o = torch.zeros((bh, tq, 1)), 0
    for k0 in range(0, k.shape[1], 32):
        s = _tf32_scores(q, k[:, k0:k0 + 32], passes) * scale
        if causal:
            s = s.masked_fill(~keep[:, k0:k0 + 32], -float("inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _tf32_matmul(p, v[:, k0:k0 + 32], passes)
        m = m_new
    return o / l, (m + torch.log(l))[..., 0]


def _bwd_tf32_wide(q, k, v, lse, do, dvec, causal, scale, passes):
    """The f32 K2 and K3 at Dh 129–256: S and dP through
    ``_tf32_scores``; dQ summed over 32-key tiles, dK and dV over 32-query
    tiles (``_tiled``)."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    p = torch.exp(_tf32_scores(q, k, passes) * scale - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(*p.shape[-2:]), p, 0.0)
    ds = p * (_tf32_scores(do, v, passes) - dvec[..., None]) * scale
    return (_tiled(ds, k, passes, 2), _tiled(t(ds), q, passes, 2),
            _tiled(t(p), do, passes, 2))


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("causal,t,tk", [(True, 64, 64), (False, 32, 96)])
def test_wide_3xtf32_recipe_matches_jax_kernels(kernel, causal, t, tk):
    """The f32 kernels' arithmetic at head dims 129–256 (Dh 256 here),
    emulated in plain torch — 3xTF32 with S and dP's hi·hi summed in
    pairs of k-steps from zero and each 32-row tile's output product
    summed from zero and added in f32 (``_fwd_tf32_wide``,
    ``_bwd_tf32_wide``) — against the JAX package's Pallas kernels
    (``_flash_fwd_raw``, ``_flash_bwd_raw``, interpret mode, f32
    HIGHEST) on Q and K with a common offset of 1 (scores near 16):
    forward O and lse within the f32 flash bound (``TOL``), gradients
    within ``GRAD_TOL``; one TF32 pass misses both."""
    rng = np.random.default_rng(13)
    bh, dh = 2, 256
    q, k = (torch.from_numpy((rng.normal(size=(bh, n, dh)) + 1.0).astype(
        np.float32)) for n in (t, tk))
    v = torch.from_numpy(rng.normal(size=(bh, tk, dh)).astype(np.float32))
    scale = dh ** -0.5
    if kernel == "fwd":
        out = jax.jit(functools.partial(_flash_fwd_raw, causal=causal,
                                        bq=16, bk=16, scale=scale))(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)))
        ref = (out[0], out[1][:, 0])
        run = functools.partial(_fwd_tf32_wide, q, k, v, causal, scale)
        tol = TOL
    else:
        do = torch.from_numpy(rng.normal(size=(bh, t, dh)).astype(np.float32))
        o, lse = flash_fwd_plain(q, k, v, causal, scale)
        dvec = (do * o).sum(-1)
        ref = jax.jit(functools.partial(_flash_bwd_raw, causal=causal, bq=16,
                                        bk=16, scale=scale))(
            *(jnp.asarray(x.numpy()) for x in (q, k, v, do)),
            *(jnp.asarray(x.numpy())[:, None, :] for x in (lse, dvec)))
        run = functools.partial(_bwd_tf32_wide, q, k, v, lse, do, dvec,
                                causal, scale)
        tol = GRAD_TOL
    for got, one_pass, r in zip(run(passes=3), run(passes=1), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, **tol)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(one_pass.numpy(), r, **tol)


@pytest.mark.parametrize("dh", [320, 512])
@pytest.mark.parametrize("causal,t,tk", [(True, 64, 64), (False, 32, 96)])
def test_past256_3xtf32_backward_recipe_matches_jax_kernels(causal, t, tk,
                                                            dh):
    """The f32 K2 and K3 past head dim 256 (``ops/csrc/
    flash_bwd_tf32_panels_sm90.cu``), emulated in plain torch: S and dP
    summed over all of Dh in the order every 256-column panel's block
    sums its 64-column chunks (hi·hi of each pair of k-steps from zero,
    the pairs added in f32 in order, the small terms apart and added
    last: ``_tf32_scores``, since the chunks end on pairs), each 32-row
    tile's dQ, dK and dV from zero and added in f32 (``_tiled``), which
    splitting the outputs into panels does not change — against the JAX
    package's Pallas backward (``_flash_bwd_raw``, interpret mode, f32
    HIGHEST) on Q and K with a common offset of 1 (scores near 18 and
    23): within ``GRAD_TOL``, where one TF32 pass misses it."""
    rng = np.random.default_rng(17)
    bh = 2
    q, k = (torch.from_numpy((rng.normal(size=(bh, n, dh)) + 1.0).astype(
        np.float32)) for n in (t, tk))
    v = torch.from_numpy(rng.normal(size=(bh, tk, dh)).astype(np.float32))
    do = torch.from_numpy(rng.normal(size=(bh, t, dh)).astype(np.float32))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale)
    dvec = (do * o).sum(-1)
    ref = jax.jit(functools.partial(_flash_bwd_raw, causal=causal, bq=16,
                                    bk=16, scale=scale))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, do)),
        *(jnp.asarray(x.numpy())[:, None, :] for x in (lse, dvec)))
    args = (q, k, v, lse, do, dvec, causal, scale)
    for got, one_pass, r in zip(_bwd_tf32_wide(*args, passes=3),
                                _bwd_tf32_wide(*args, passes=1), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, **GRAD_TOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(one_pass.numpy(), r, **GRAD_TOL)


@pytest.mark.parametrize("causal,t,tk,dh", [(True, 64, 64, 32),
                                            (False, 16, 48, 32),
                                            (True, 64, 64, 64)])
def test_3xtf32_recipe_matches_jax_backward(causal, t, tk, dh):
    """The f32 backward kernels' arithmetic, 3xTF32, emulated here in
    plain torch, against the JAX package's Pallas backward
    (``_flash_bwd_raw``, interpret mode, f32 HIGHEST): within the f32
    flash-vs-dense gradient bound (rtol 5e-4, atol 1e-5), on Q and K with
    a common offset of 1, where scores cluster near 64·scale.  One TF32
    pass misses that bound on the same inputs, by far: the kernels need
    the three products."""
    rng = np.random.default_rng(11)
    bh = 4
    q, k = (torch.from_numpy((rng.normal(size=(bh, n, dh)) + 1.0).astype(
        np.float32)) for n in (t, tk))
    v = torch.from_numpy(rng.normal(size=(bh, tk, dh)).astype(np.float32))
    do = torch.from_numpy(rng.normal(size=(bh, t, dh)).astype(np.float32))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale)
    dvec = (do * o).sum(-1)
    ref = jax.jit(functools.partial(_flash_bwd_raw, causal=causal, bq=16,
                                    bk=16, scale=scale))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, do)),
        *(jnp.asarray(x.numpy())[:, None, :] for x in (lse, dvec)))
    args = (q, k, v, lse, do, dvec, causal, scale)
    for got, one_pass, r in zip(_bwd_tf32(*args, passes=3),
                                _bwd_tf32(*args, passes=1), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, **GRAD_TOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(one_pass.numpy(), r, **GRAD_TOL)


@pytest.mark.parametrize("causal,t,tk", [(False, 64, 64), (True, 64, 64),
                                         (False, 16, 48)])
def test_plain_bf16_forward_matches_jax_kernel(causal, t, tk):
    """bf16 ``flash_fwd_plain`` (what the card holds the bf16 K1 against)
    against the JAX package's bf16 forward kernel (``_flash_fwd_raw``,
    interpret mode) on the same bf16 q, k, v: O and lse within one bf16
    ulp of each value (rtol 2⁻⁷) plus 1e-5 of the largest |value|.  The
    reference runs with query blocks of 16 and one key block holding the
    whole row, the recurrence the plain version writes out: P =
    exp(S − rowmax) rounded to bf16 before P·V, divided by the f32 sum of
    the unrounded P.  Measured here: every O equal, lse within 4.8e-7.
    Keeping P in f32 instead (the plain version before this test) is off
    by up to 0.0078, 0.29–0.49% of the largest |value|.  With key blocks
    of 16 the reference rounds each block's P against its running max, and
    both versions are off by up to 0.0039–0.0078, so that setting cannot
    tell them apart."""
    rng = np.random.default_rng(7)
    bh, dh = 4, 32
    q = torch.from_numpy(rng.normal(size=(bh, t, dh)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.normal(size=(bh, tk, dh)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    scale = dh ** -0.5
    got = flash_fwd_plain(q, k, v, causal, scale)
    ref_o, ref_lse = jax.jit(functools.partial(
        _flash_fwd_raw, causal=causal, bq=16, bk=tk, scale=scale))(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for a, b in zip(got, (ref_o, np.asarray(ref_lse)[:, 0])):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,t,tk", [(True, 48, 48), (False, 16, 48)])
def test_plain_kernels_match_jax_kernels_at_head_dim_128(dtype, causal, t,
                                                          tk):
    """Head dim 128, which the CUDA kernels take since they were extended
    past 32 and 64: ``flash_fwd_plain`` and ``flash_bwd_plain`` (what the
    card holds K1, K2 and K3 against) against the JAX package's Pallas
    kernels (``_flash_fwd_raw``, ``_flash_bwd_raw``, interpret mode, one
    key block a row for the forward as in the bf16 test above) on the same
    inputs.  f32: within the f32 flash-vs-dense bounds (O and lse ``TOL``,
    gradients ``GRAD_TOL``); bf16: within one bf16 ulp of each value
    (rtol 2⁻⁷) plus 1e-5 of the largest |value|."""
    _plain_against_jax_kernels(dtype, causal, t, tk, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,t,tk", [(True, 48, 48), (False, 16, 48)])
@pytest.mark.parametrize("dh", [16, 96, 192, 256])
def test_plain_kernels_match_jax_kernels_at_odd_head_dims(dtype, causal, t,
                                                          tk, dh):
    """Head dims past the tensor-core kernels' 32, 64 and 128: those run
    zero-padded to an instantiated size (16 as 32, 96 as 128) and those
    past 128 on the CUDA-core kernels (192, 256).  The plain versions
    against the JAX package's Pallas kernels, whose blocks span any head
    dim, at the bounds of the head-dim-128 test."""
    _plain_against_jax_kernels(dtype, causal, t, tk, dh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_match_jax_kernels_past_head_dim_256(dtype):
    """Dh 320, which the CUDA kernels take in 256-column panels (bf16 on
    wgmma; f32 K1 on CUDA cores, K2 and K3 as 3xTF32): the plain
    versions against the JAX
    package's Pallas kernels (interpret mode), causal, at the bounds of
    the head-dim-128 test."""
    _plain_against_jax_kernels(dtype, True, 32, 32, 320)


@pytest.mark.parametrize("dh", [264, 512])
def test_bf16_plain_kernels_match_jax_kernels_at_more_head_dims_past_256(dh):
    """Dh 264 (a last panel of 8 columns) and 512 (two full panels), where
    the bf16 K1, K2 and K3 run on wgmma in 256-column output panels: the
    plain versions against the JAX package's Pallas kernels (interpret
    mode), causal, B·H 3, T 32, at the bounds of the head-dim-128 test."""
    _plain_against_jax_kernels("bfloat16", True, 32, 32, dh)


@pytest.mark.parametrize("causal,t,tk", [(True, 32, 32), (False, 16, 48)])
def test_f32_plain_kernels_match_jax_kernels_at_head_dim_512(causal, t, tk):
    """Dh 512, where the f32 K2 and K3 run as 3xTF32 in one 512-column
    output panel and the f32 K1 on CUDA cores in two of 256: the plain
    versions against the JAX package's Pallas kernels (interpret mode,
    f32 HIGHEST), causal and not, B·H 3, at the bounds of the
    head-dim-128 test."""
    _plain_against_jax_kernels("float32", causal, t, tk, 512)


def _plain_against_jax_kernels(dtype, causal, t, tk, dh):
    rng = np.random.default_rng(13)
    bh = 3
    tdt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, do = (torch.from_numpy(rng.normal(size=(bh, t, dh)).astype(
        np.float32)).to(tdt) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(bh, tk, dh)).astype(
        np.float32)).to(tdt) for _ in range(2))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale)
    dvec = (do.float() * o.float()).sum(-1)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jdt)
                       for x in (q, k, v, do))
    ref_o, ref_lse = jax.jit(functools.partial(
        _flash_fwd_raw, causal=causal, bq=16, bk=tk, scale=scale))(
        jq, jk, jv)
    ref_g = jax.jit(functools.partial(
        _flash_bwd_raw, causal=causal, bq=16, bk=16, scale=scale))(
        jq, jk, jv, jdo,
        *(jnp.asarray(x.numpy())[:, None, :] for x in (lse, dvec)))
    got_g = flash_bwd_plain(q, k, v, lse, do, dvec, causal, scale)
    pairs = [(o, ref_o, TOL), (lse, np.asarray(ref_lse)[:, 0], TOL)] + \
        [(a, b, GRAD_TOL) for a, b in zip(got_g, ref_g)]
    for a, b, tol in pairs:
        assert a.dtype == (torch.float32 if a is lse else tdt)
        b = np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, **tol)
        else:
            atol = 1e-5 * np.abs(b).max()
            if a is o and dh > 128:
                # both round P = exp(S - max) to bf16 before P·V, from S
                # summed over Dh in different orders: past 128 terms a P
                # at a rounding boundary can round one way here and the
                # other there (measured: 6 of 9216 O values at Dh 192,
                # 3.3e-4 apart), which moves O by up to 2⁻⁸ of p·|v|/l
                atol += 2 ** -8 * np.abs(v.float().numpy()).max()
            np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                       atol=atol)


@pytest.mark.parametrize("dtype,dh", [
    ("float32", 1), ("float32", 16), ("float32", 48), ("float32", 96),
    ("bfloat16", 1), ("bfloat16", 5), ("bfloat16", 42), ("bfloat16", 127)])
def test_zero_padded_head_dim_is_the_same_function(dtype, dh):
    """What the CUDA wrappers do at a head dim their kernels do not read
    as it is — the f32 K2 and K3 at a Dh up to 128 other than 32, 64 and
    128, the bf16 kernels at a Dh not a multiple of 8 (their TMA row
    stride): the plain versions on inputs zero-padded to
    ``kernel_head_dim``, sliced back, equal the plain versions on the
    unpadded inputs (the caller's scale kept), and the padded columns of
    O, dQ, dK and dV are exactly 0.  f32 within 1e-6 relative to the
    largest |value| (the products' summation length differs); bf16 within
    one bf16 ulp."""
    tdt = getattr(torch, dtype)
    size = kernel_head_dim(dh, tdt, "dq")
    want = next(s for s in (32, 64, 128) if dh <= s) \
        if dtype == "float32" else -(-dh // 8) * 8
    assert size == want and size > dh
    rng = np.random.default_rng(dh)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(3, 40, dh)).astype(
        np.float32)).to(tdt) for _ in range(4))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, True, scale)
    po, plse = flash_fwd_plain(*(pad_head_dim(x, size) for x in (q, k, v)),
                               True, scale)
    dvec = (do.float() * o.float()).sum(-1)
    grads = flash_bwd_plain(q, k, v, lse, do, dvec, True, scale)
    pgrads = flash_bwd_plain(*(pad_head_dim(x, size) for x in (q, k, v)),
                             lse, pad_head_dim(do, size), dvec, True, scale)
    assert pad_head_dim(q, dh) is q
    for got, ref in [(po, o), (plse, lse), *zip(pgrads, grads)]:
        if got.shape[-1] == size:
            assert not got[..., dh:].any()
            got = got[..., :dh]
        ref = ref.float().numpy()
        rtol = 1e-6 if dtype == "float32" or got is plse else 2 ** -7
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                   atol=1e-6 * np.abs(ref).max())
    # the bf16 kernels read rows of a multiple of 8 columns as they are,
    # and pad other Dh to the next multiple of 8 (K1, K2 and K3 on wgmma,
    # past 256 in 256-column panels); the f32 K1 reads any Dh, the f32 K2
    # and K3 any past 128 (3xTF32 in 512-column panels past 256)
    bf16, f32 = torch.bfloat16, torch.float32
    kinds = ("fwd", "dq", "dkv")
    assert all(kernel_head_dim(d, bf16, k) == d
               for d in range(8, 1025, 8) for k in kinds)
    assert [kernel_head_dim(d, bf16, k) for d in (1, 5, 127, 129, 130, 255)
            for k in kinds] == [d for d in (8, 8, 128, 136, 136, 256)
                                for _ in kinds]
    assert [kernel_head_dim(d, dt, "dq") for dt in (bf16, f32)
            for d in (129, 256, 257, 300, 320, 512)] == \
        [136, 256, 264, 304, 320, 512, 129, 256, 257, 300, 320, 512]
    assert [kernel_head_dim(d, bf16, k) for d in (257, 300, 1023)
            for k in kinds] == [d for d in (264, 304, 1024) for _ in kinds]
    assert [kernel_head_dim(d, f32, k) for d in (257, 300)
            for k in kinds] == [d for d in (257, 300) for _ in kinds]
    assert [kernel_head_dim(d, f32, k) for d in (16, 48, 96)
            for k in kinds] == [16, 32, 32, 48, 64, 64, 96, 128, 128]
    assert [kernel_head_dim(130, f32, k) for k in kinds] == [130, 130, 130]


@pytest.mark.parametrize("dh,size", [(130, 136), (200, 200), (257, 264),
                                     (300, 304)])
def test_bf16_dq_padding_past_128_is_the_same_function(dh, size):
    """What the CUDA K2 wrapper does with a bf16 head dim past 128 (in
    129–256 the 192- or 256-wide wgmma tiles, past 256 the 256-column
    output panels), whose wgmma kernel reads TMA rows of a multiple of 8
    columns: the plain
    backward on inputs zero-padded to ``kernel_head_dim``, sliced back,
    equals it on the unpadded inputs (the caller's scale kept), and the
    padded columns of dQ, dK and dV are exactly 0.  Within one bf16 ulp
    (the products' summation length differs)."""
    assert kernel_head_dim(dh, torch.bfloat16, "dq") == size
    rng = np.random.default_rng(dh)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 24, dh)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, True, scale)
    dvec = (do.float() * o.float()).sum(-1)
    grads = flash_bwd_plain(q, k, v, lse, do, dvec, True, scale)
    pgrads = flash_bwd_plain(*(pad_head_dim(x, size) for x in (q, k, v)),
                             lse, pad_head_dim(do, size), dvec, True, scale)
    for got, ref in zip(pgrads, grads):
        assert got.shape[-1] == size and not got[..., dh:].any()
        ref = ref.float().numpy()
        np.testing.assert_allclose(got[..., :dh].float().numpy(), ref,
                                   rtol=2 ** -7,
                                   atol=1e-6 * np.abs(ref).max())


def test_flash_attention_layer_at_head_dim_256_matches_jax():
    """``MultiHeadAttention(impl="flash")`` at dim 512 with 2 heads (Dh 256,
    which the CUDA kernels take in one 256-wide tile) against the JAX
    package's layer (Pallas flash in interpret mode) on the same weights,
    carried by ``load_jax_variables``: the output within the f32 flash
    bound (``TOL``) and the gradients of the input and of every parameter
    under a random cotangent within the f32 gradient bound
    (``GRAD_TOL``)."""
    _flash_layer_against_jax(512)


def test_flash_attention_layer_at_head_dim_320_matches_jax():
    """As the Dh 256 test at dim 640 with 2 heads: Dh 320, which the CUDA
    kernels take in two 256-column panels."""
    _flash_layer_against_jax(640)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_layer_at_head_dim_96_matches_jax(dtype):
    """As the Dh 256 test at dim 192 with 2 heads: Dh 96, GPT-NeoX-20B's
    and Phi-3-mini's head dim, which the bf16 kernels read unpadded into
    a 128-wide tile.  In bf16 (the input, and so every product, in bf16
    on both sides) within the bf16 bound of the repo's flash checks
    (rtol 1e-2, atol 1e-2 of the reference's largest |value|)."""
    _flash_layer_against_jax(192, dtype)


def _flash_layer_against_jax(dim, dtype="float32"):
    jm = JaxModel(ja.MultiHeadAttention(2, causal=True, impl="flash"),
                  input_shape=(16, dim))
    v = jax.tree_util.tree_map(np.asarray, jm.init(5))
    model = Model.from_config(json.loads(json.dumps(jm.config())))
    model.init(0, device="cpu")
    load_jax_variables(model, v)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, dim)).astype(np.float32)
    g = rng.normal(size=(2, 16, dim)).astype(np.float32)
    # the layer computes in its input's dtype on both sides
    jx = jnp.asarray(x, getattr(jnp, dtype))

    def close(a, b, tol):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-2,
                                       atol=1e-2 * np.abs(b).max())

    def loss(params, xs):
        return jnp.sum(jm.apply({**v, "params": params}, xs)[0] * g)
    ref = jm.apply(v, jx)[0]
    ref_gp, ref_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        v["params"], jx)

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    out = model(tx)
    assert out.dtype == tx.dtype and ref.dtype == jx.dtype
    (out * torch.from_numpy(g)).sum().backward()
    close(out.detach().float().numpy(), ref, TOL)
    close(tx.grad.float().numpy(), ref_gx, GRAD_TOL)
    # the parameters' gradients in the JAX layout: write them over the
    # parameters and read the tree back
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    got_gp = to_numpy_variables(model)["params"]
    pairs = list(zip(jax.tree_util.tree_leaves(got_gp),
                     jax.tree_util.tree_leaves(ref_gp)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(v["params"])) > 0
    for a, b in pairs:
        close(a, b, GRAD_TOL)


def test_awkward_length_causal_pad_gradients_are_exact():
    """T = 257 pads to 384 on the causal path; the padded rows' zero
    cotangent must leave q/k/v gradients exact — against JAX's dense
    attention gradients (as ``tests/test_pallas_attention.py`` checks the
    JAX package)."""
    q, k, v = qkv(b=1, t=257, h=2, dh=16, seed=1)
    ref = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        jax_dense(a, b, c, causal=True) ** 2), argnums=(0, 1, 2)))(
        *_jax(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _torch(q, k, v))
    (_flash_with_blocking(tq, tk, tv, True, 257) ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("causal,tk", [(True, None), (False, 40)])
def test_plain_backward_matches_autograd_of_dense(causal, tk):
    """``flash_bwd_plain`` (the kernels' plain version, which the card
    holds K2/K3 against) equals autograd through the port's dense
    attention, with D = rowsum(dO∘O) − g_lse."""
    q, k, v = qkv(t=24, tk=tk)
    g_out, g_lse = _cotangents(q, 24)
    tq, tk_, tv = (x.requires_grad_() for x in _torch(q, k, v))
    dense = dot_product_attention(tq, tk_, tv, causal=causal)
    lse_ref = torch.logsumexp(torch.einsum(
        "bqhd,bkhd->bhqk", tq, tk_) / np.sqrt(32) + (torch.triu(
            torch.full((24, 24), float("-inf")), 1) if causal else 0),
        dim=-1)
    ref = torch.autograd.grad((dense, lse_ref), (tq, tk_, tv),
                              _torch(g_out, g_lse))
    qb, kb, vb, dob = (_to_bh(torch.from_numpy(a))
                       for a in (q, k, v, g_out))
    o, lse = flash_fwd_plain(qb, kb, vb, causal, 32 ** -0.5)
    dvec = (dob * o).sum(-1) - torch.from_numpy(g_lse).reshape(4, 24)
    got = flash_bwd_plain(qb, kb, vb, lse, dob, dvec, causal, 32 ** -0.5)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_from_bh(a, 2, 2).numpy(), b.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (_to_bh(t) for t in _torch(*qkv(t=16)))
    launches = flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_fwd_cuda(q, k, v, True, 0.25)
    assert flash_fwd_cuda.launches == launches
    lse = torch.zeros(q.shape[:2])
    bwd = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v, lse, q, lse, True, 0.25)
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == bwd



def test_library_key_covers_every_csrc_file(tmp_path, monkeypatch):
    """Every ``.cu`` under ``ops/csrc`` is compiled, and the built
    library's name hashes every file there, headers included: a changed
    shared header (``sm90.cuh``) must not reuse a stale library."""
    csrc = os.path.dirname(_kernels.SOURCES[0])
    assert sorted(map(os.path.basename, _kernels.SOURCES)) == sorted(
        f for f in os.listdir(csrc) if f.endswith(".cu"))
    copy = tmp_path / "csrc"
    shutil.copytree(csrc, copy)
    monkeypatch.setattr(_kernels, "_CSRC", str(copy))
    before = _kernels.lib_path()
    assert before == _kernels.lib_path()
    with open(copy / "sm90.cuh", "a") as f:
        f.write("\n// changed\n")
    assert _kernels.lib_path() != before


def test_kernel_names_follow_the_c_interface_codes():
    """``KERNELS`` names the kernel each C entry point reports it ran by
    its code in ``csrc/launched.h``, the one place the codes are defined;
    past head dim 128 all three kernels have a wgmma kernel (bf16) and a
    3xTF32 one (f32); past 256 all three have a bf16 wgmma kernel in
    output panels, and K2 and K3 an f32 3xTF32 one (K1's slot of it
    ``None``); only K1 has a CUDA-core kernel (K2's and K3's slot of it
    ``None``); the launch counts start from 0 after
    ``reset_launches``; and ``chip_smoke.CUDA_KERNELS`` lists every named
    kernel once."""
    import importlib
    import re
    import chip_smoke
    fa_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    csrc = os.path.dirname(_kernels.SOURCES[0])
    with open(os.path.join(csrc, "launched.h")) as f:
        codes = dict(re.findall(r"(k\w+) = (\d+),", f.read()))
    assert codes == {"kWgmma": "0", "kWgmmaWide": "1", "kTf32": "2",
                     "kCudaCores": "3", "kTf32Wide": "4",
                     "kWgmmaPast256": "5", "kTf32Past256": "6"}
    assert set(fa_mod.KERNELS) == set(_kernels.SIGNATURES) - {
        "dkt_flash_last_kernel", "dkt_error_string"}
    assert all(len(names) == len(codes) for names in fa_mod.KERNELS.values())
    assert all(names[1] for names in fa_mod.KERNELS.values())
    assert [names[4] for names in fa_mod.KERNELS.values()] == [
        "flash_fwd_f32_wide", "flash_bwd_dq_f32_wide",
        "flash_bwd_dkv_f32_wide"]
    assert [names[5] for names in fa_mod.KERNELS.values()] == [
        "flash_fwd_wgmma_past256", "flash_bwd_dq_wgmma_past256",
        "flash_bwd_dkv_wgmma_past256"]
    assert [names[6] for names in fa_mod.KERNELS.values()] == [
        None, "flash_bwd_dq_f32_past256", "flash_bwd_dkv_f32_past256"]
    assert [names[3] for names in fa_mod.KERNELS.values()] == [
        "flash_fwd_cuda_cores", None, None]
    names = [n for ns in fa_mod.KERNELS.values() for n in ns if n]
    assert sorted(names) == sorted(n for n, _, _ in chip_smoke.CUDA_KERNELS)
    fa_mod.KERNEL_LAUNCHES[("flash_fwd", "float32", 64)] += 1
    flash_fwd_cuda.launches += 1
    fa_mod.reset_launches()
    assert not fa_mod.KERNEL_LAUNCHES and flash_fwd_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_jax_on_the_card(causal):
    """Where one machine has both JAX and a card: the CUDA kernel against
    the JAX package's flash directly (``tests/test_torch_cuda.py`` holds it
    against its plain version on machines without JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = qkv(dh=64)
    jo, jl = jax_flash_lse(*_jax(q, k, v), causal, 16, 16)
    launches = flash_fwd_cuda.launches
    to, tl = flash_attention_lse(*(t.cuda() for t in _torch(q, k, v)),
                                 causal, 16, 16)
    assert flash_fwd_cuda.launches == launches + 1
    np.testing.assert_allclose(to.cpu().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.cpu().numpy(), np.asarray(jl), **TOL)
