"""The port's CUDA paths on the card: the flash-attention kernels (K1
forward, K2/K3 backward) against their plain versions, the wrappers'
refusals, the decode engine on a small model, the serving fleet
(prefix cache, router, KV fabric), speculative decoding and beam
search, a short flash-vs-dense
``SingleTrainer`` run, the sync distributed trainers (card against
CPU, the window-edge rules on CUDA tensors, K1–K3 launches under ADAG),
checkpoints, resume and disk streaming on the card, and the async
parameter server's thread and process workers on the card (exact
K1–K3 launch counts), the sharded parameter server and the switch-MoE
LM trained and served on the card, the profiler readings (step split,
device trace) and a continual run held against the CPU, the yaml's
flash LM through ``config.run`` and as a ``Job`` in a child process
(exact K1–K3 launches), and two gloo ranks sharing the card (``tests/test_torch_mesh_child.py``): each
collective's route on CUDA tensors, and a two-rank ring forward against
K1 over the whole T.
Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False (the kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as dkt
from chip_smoke import attention_float64, dkv_float64, dq_float64
from distkeras_tpu_torch import SingleTrainer
from distkeras_tpu_torch.data import load_lm_corpus
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model, generate_tokens, zoo
from distkeras_tpu_torch.models.layers import Dense, Sequential
from distkeras_tpu_torch.parallel import sync
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, _from_bh, _to_bh, flash_attention_lse,
    flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_bwd_plain, flash_fwd_cuda,
    flash_fwd_plain)
from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig
from distkeras_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(b, t, h, dh, dtype, tk=None, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tk = t if tk is None else tk
    return [torch.randn((b, n, h, dh), generator=gen, device="cuda")
            .to(dtype) for n in (t, tk, tk)]


@pytest.mark.parametrize("dtype,causal,t,tk,dh,tol", [
    (torch.float32, True, 200, None, 64, 1e-5),
    (torch.float32, False, 16, 48, 64, 1e-5),
    (torch.float32, True, 257, None, 32, 1e-5),
    (torch.bfloat16, True, 200, None, 64, 2e-2),
    (torch.bfloat16, False, 130, None, 32, 2e-2),
    (torch.float32, True, 200, None, 128, 1e-5),
    (torch.float32, False, 16, 48, 128, 1e-5),
    (torch.bfloat16, True, 200, None, 128, 2e-2),
])
def test_kernel_matches_plain(dtype, causal, t, tk, dh, tol):
    q, k, v = _qkv(2, t, 4, dh, dtype, tk)
    launches = flash_fwd_cuda.launches
    out, lse = flash_attention_lse(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 1
    ref, ref_lse = flash_fwd_plain(_to_bh(q), _to_bh(k), _to_bh(v), causal,
                                   dh ** -0.5)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - _from_bh(ref, 2, 4).float()).abs().max() <= tol
    assert (lse.reshape(8, t) - ref_lse).abs().max() <= tol


@pytest.mark.parametrize("causal,t,tk,dh", [
    *[(c, t, None, dh) for t in (64, 100, 257, 512) for dh in (32, 64, 128)
      for c in (True, False)],
    (False, 100, 257, 64), (False, 512, 100, 32), (False, 16, 48, 64),
    (False, 100, 257, 128), (False, 512, 100, 128)])
def test_bf16_forward_kernel_matches_plain(causal, t, tk, dh):
    """The bf16 K1 (wgmma + TMA) against ``flash_fwd_plain`` on the same
    (B·H, T, Dh) inputs: O and lse within ``_close``'s bf16 bound (both
    sides round P to bf16 before P·V), one launch."""
    q, k, v = (_to_bh(x) for x in _qkv(2, t, 4, dh, torch.bfloat16, tk))
    launches = flash_fwd_cuda.launches
    o, lse = flash_fwd_cuda(q, k, v, causal, dh ** -0.5)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 1
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, dh ** -0.5)
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
    _close(o, o_ref, torch.bfloat16)
    _close(lse, lse_ref, torch.bfloat16)


def test_bf16_forward_kernel_at_the_training_shape_and_a_batch_1_join():
    """The bf16 K1 at the bf16 probe's training shape (B·H = 512, T = 512,
    Dh = 64, causal), and a batch-1 join of 200 tokens through
    ``flash_attention_lse`` (whose ``_to_bh`` copies hand the kernel
    contiguous, aligned rows), against ``flash_fwd_plain``."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn((512, 512, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = flash_fwd_cuda(q, k, v, True, 0.125)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, 0.125)
    _close(o, o_ref, torch.bfloat16)
    _close(lse, lse_ref, torch.bfloat16)
    q, k, v = _qkv(1, 200, 8, 64, torch.bfloat16, seed=5)
    launches = flash_fwd_cuda.launches
    out, lse = flash_attention_lse(q, k, v, True)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 1
    o_ref, lse_ref = flash_fwd_plain(_to_bh(q), _to_bh(k), _to_bh(v), True,
                                     0.125)
    _close(_to_bh(out), o_ref, torch.bfloat16)
    _close(lse.reshape(8, 200), lse_ref, torch.bfloat16)


def _close(got, ref, dtype):
    """f32 within the JAX package's flash-vs-dense gradient bound (rtol
    5e-4, atol 1e-5); bf16, where both sides round P, dS and the outputs
    to bf16, within that rounding (rtol 1e-2, atol 1e-2 of the reference's
    largest |value|)."""
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        tol = dict(rtol=5e-4, atol=1e-5)
    else:
        tol = dict(rtol=1e-2, atol=1e-2 * ref.abs().max().item())
    torch.testing.assert_close(got, ref, **tol)


@pytest.mark.parametrize("dtype,causal,t,tk,dh", [
    (torch.float32, True, 200, None, 64),
    (torch.float32, False, 16, 48, 64),
    (torch.float32, False, 100, 130, 32),
    (torch.float32, True, 257, None, 32),
    (torch.float32, True, 257, None, 64),
    (torch.float32, False, 512, 100, 32),
    (torch.bfloat16, True, 200, None, 64),
    (torch.bfloat16, False, 130, None, 32),
    (torch.bfloat16, True, 64, None, 64),
    (torch.bfloat16, True, 64, None, 32),
    (torch.bfloat16, True, 100, None, 64),
    (torch.bfloat16, True, 100, None, 32),
    (torch.bfloat16, True, 257, None, 64),
    (torch.bfloat16, True, 257, None, 32),
    (torch.bfloat16, True, 512, None, 64),
    (torch.bfloat16, True, 512, None, 32),
    (torch.bfloat16, False, 100, 257, 64),
    (torch.bfloat16, False, 512, 100, 32),
    (torch.bfloat16, False, 16, 48, 64),
    (torch.float32, True, 200, None, 128),
    (torch.float32, True, 257, None, 128),
    (torch.float32, False, 100, 257, 128),
    (torch.bfloat16, True, 64, None, 128),
    (torch.bfloat16, True, 257, None, 128),
    (torch.bfloat16, True, 512, None, 128),
    (torch.bfloat16, False, 100, 257, 128),
])
def test_backward_kernels_match_plain(dtype, causal, t, tk, dh):
    """K2 and K3 (bf16 on wgmma, f32 as 3xTF32 on mma.sync) against
    ``flash_bwd_plain`` on the same inputs, and through autograd, with an
    lse cotangent, within ``_close``'s bounds."""
    q, k, v = (x.requires_grad_() for x in _qkv(2, t, 4, dh, dtype, tk))
    out, lse = flash_attention_lse(q, k, v, causal)
    gen = torch.Generator(device="cuda").manual_seed(1)
    g_out = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    launches = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    grads = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    torch.cuda.synchronize()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == \
        (launches[0] + 1, launches[1] + 1)
    scale = dh ** -0.5
    qb, kb, vb, ob, dob = (_to_bh(x.detach()) for x in (q, k, v, out, g_out))
    o_ref, lse_ref = flash_fwd_plain(qb, kb, vb, causal, scale)
    dvec = (dob.float() * ob.float()).sum(-1) - g_lse.reshape(8, t)
    refs = flash_bwd_plain(qb, kb, vb, lse.detach().reshape(8, t), dob,
                           dvec, causal, scale)
    for got, ref in zip(grads, refs):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        _close(got, _from_bh(ref, 2, 4), dtype)
    # the kernels alone, on the plain version's inputs
    args = (qb, kb, vb, lse_ref, dob, dvec, causal, scale)
    _close(flash_bwd_dq_cuda(*args), flash_bwd_plain(*args)[0], dtype)
    for got, ref in zip(flash_bwd_dkv_cuda(*args), flash_bwd_plain(*args)[1:]):
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_at_the_training_shape(dtype):
    """K2 and K3 at the probe's training shape (B·H = 512, T = 512,
    Dh = 64, causal) against ``flash_bwd_plain``: one launch each, within
    ``_close``'s bound of the dtype."""
    bh, t, dh = 512, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((bh, t, dh), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, True, scale)
    dvec = (do.float() * o.float()).sum(-1)
    args = (q, k, v, lse, do, dvec, True, scale)
    launches = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == \
        (launches[0] + 1, launches[1] + 1)
    for g, r in zip(got, flash_bwd_plain(*args)):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        _close(g, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_at_a_head_dim_128_training_shape(dtype):
    """K1, K2 and K3 at head dim 128 (``gpt_lm(dim=1024, num_heads=8)``'s
    heads; B·H = 256, T = 512, causal) against the plain versions: one
    launch each, within ``_close``'s bound of the dtype."""
    bh, t, dh = 256, 512, 128
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn((bh, t, dh), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    scale = dh ** -0.5
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, scale)
    o, lse = flash_fwd_cuda(q, k, v, True, scale)
    if dtype == torch.float32:
        assert (o - o_ref).abs().max() <= 1e-5
        assert (lse - lse_ref).abs().max() <= 1e-5
    else:
        _close(o, o_ref, dtype)
        _close(lse, lse_ref, dtype)
    dvec = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, lse_ref, do, dvec, True, scale)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    for g, r in zip(got, flash_bwd_plain(*args)):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        _close(g, r, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,t,tk", [(True, 100, 100), (False, 64, 130)])
@pytest.mark.parametrize("dh", [16, 48, 96])
def test_kernels_at_head_dims_between_the_instantiated_ones(dtype, causal,
                                                            t, tk, dh):
    """A head dim the kernels are not instantiated for runs as the next
    instantiated one (zero-padded): K1, K2 and K3 against the plain
    versions on the unpadded inputs, one launch each, within ``_close``'s
    bound, the outputs contiguous and of the caller's Dh."""
    gen = torch.Generator(device="cuda").manual_seed(dh)
    q, do = (torch.randn((6, t, dh), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((6, tk, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = dh ** -0.5
    counts = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    o, lse = flash_fwd_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, scale)
    dvec = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, lse_ref, do, dvec, causal, scale)
    got = (o, lse, flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == tuple(c + 1 for c in counts)
    for g, r in zip(got, (o_ref, lse_ref, *flash_bwd_plain(*args))):
        assert g.shape == r.shape and g.is_contiguous()
        assert bool(torch.isfinite(g).all())
        if dtype == torch.float32 and g is o or g is lse:
            assert (g - r).abs().max() <= 1e-5
        else:
            _close(g, r, dtype)


#: B·H of f32 forward cases that take the 3xTF32 kernel: 64-row query
#: tiles give at least two blocks an SM (2 x 132 on an H100) from T = 100;
#: at B·H 8 (the serving shapes) the CUDA-core kernel runs up to Dh 128
TC_BH = 136


@pytest.mark.parametrize("bh,causal,t,tk,dh", [
    *[(TC_BH, c, t, None, dh) for dh in (16, 32, 48, 64, 96, 128)
      for c in (True, False) for t in (100, 257)],
    (TC_BH, False, 100, 257, 96), (TC_BH, True, 130, None, 5),
    (TC_BH, False, 130, None, 127), (TC_BH, False, 130, 64, 1),
    *[(TC_BH, c, 130, None, dh) for dh in (130, 192, 193, 255, 256)
      for c in (True, False)],
    (TC_BH, False, 100, 257, 200), (TC_BH, False, 100, 257, 255),
    *[(8, True, t, None, 64) for t in (64, 128, 256, 512)],
    *[(8, c, 100, None, dh) for dh in (16, 96, 128) for c in (True, False)],
    (8, False, 16, 48, 64), (8, False, 512, 100, 1), (8, True, 130, None, 5),
    (8, False, 100, 257, 127)])
def test_f32_forward_kernel_matches_plain(bh, causal, t, tk, dh):
    """The f32 K1 against ``flash_fwd_plain`` on the same inputs: O and lse
    within 1e-5, one launch, rows of the caller's Dh read unpadded.  At
    B·H ``TC_BH`` the 3xTF32 kernel runs (Dh 1, 5, 127, 130, 193 and 255
    by its 4-byte loads; past 128 its eight-warp form); at B·H 8, the
    serving shapes among them (T 64–512, Dh 64), the CUDA-core kernel with
    32- and 16-row tiles."""
    q, k, v = (_to_bh(x) for x in _qkv(bh // 4, t, 4, dh, torch.float32,
                                         tk))
    launches = flash_fwd_cuda.launches
    o, lse = flash_fwd_cuda(q, k, v, causal, dh ** -0.5)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 1
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, dh ** -0.5)
    assert o.shape == o_ref.shape and bool(torch.isfinite(o).all())
    assert (o - o_ref).abs().max() <= 1e-5
    assert (lse - lse_ref).abs().max() <= 1e-5


@pytest.mark.parametrize("bh,dh", [(512, 64), (256, 128), (256, 96)])
def test_f32_forward_kernel_at_the_training_shapes(bh, dh):
    """The f32 K1 at the training shapes (T = 512, causal; query tiles of
    64 rows) against ``flash_fwd_plain``: within 1e-5."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = (torch.randn((bh, 512, dh), generator=gen, device="cuda")
               for _ in range(3))
    o, lse = flash_fwd_cuda(q, k, v, True, dh ** -0.5)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, dh ** -0.5)
    assert (o - o_ref).abs().max() <= 1e-5
    assert (lse - lse_ref).abs().max() <= 1e-5


@pytest.mark.parametrize("causal,t,tk,dh", [
    (True, 100, None, 32), (True, 200, None, 64), (False, 130, 64, 64),
    (True, 200, None, 128), (True, 512, None, 64)])
def test_f32_forward_kernel_is_3xtf32_not_tf32(causal, t, tk, dh):
    """On Q and K with a common offset of 1 (scores near 64·scale, whose
    differences TF32's three digits blur), the 3xTF32 K1 (B·H ``TC_BH``)
    is within the f32 bound of 1e-5 of attention computed in float64, and
    the plain forward with TF32 products (``allow_tf32``) misses it by
    far: the kernel's products are 3xTF32 (split hi/lo operands), not one
    TF32 pass.  float64 is the witness because the plain version in f32 is
    itself up to 1.1e-5 from it at Dh 128 on such inputs."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    tk = t if tk is None else tk
    q = torch.randn((TC_BH, t, dh), generator=gen, device="cuda") + 1.0
    k = torch.randn((TC_BH, tk, dh), generator=gen, device="cuda") + 1.0
    v = torch.randn((TC_BH, tk, dh), generator=gen, device="cuda")
    scale = dh ** -0.5
    exact = attention_float64(torch, q, k, v, causal, scale)
    got = flash_fwd_cuda(q, k, v, causal, scale)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_fwd_plain(q, k, v, causal, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert max((g - r).abs().max().item() for g, r in zip(got, exact)) \
        <= 1e-5
    assert min((g - r).abs().max().item() for g, r in zip(tf32, exact)) \
        > 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,t,tk", [(True, 100, 100), (False, 64, 130),
                                         (True, 257, 257), (False, 200, 200),
                                         (False, 257, 100)])
@pytest.mark.parametrize("dh", [130, 136, 192, 200, 256])
def test_kernels_at_head_dims_past_128(dtype, causal, t, tk, dh):
    """Head dims 129–256: in bf16 K1, K2 and K3 on wgmma (192- and
    256-wide tiles from unpadded rows; Dh 130 padded to 136), in f32 as
    3xTF32 on mma.sync (unpadded rows, 192 or 256 columns wide; K1 so at
    B·H 6 too, a grid of fewer blocks than SMs).  K1, K2 and K3 against
    the plain versions,
    causal and not, Tq ≠ Tk both ways, ragged T, one launch each, each
    counted under its kernel; K1 in f32 within 1e-5, the rest within
    ``_close``'s bound of the dtype."""
    gen = torch.Generator(device="cuda").manual_seed(dh)
    q, do = (torch.randn((6, t, dh), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((6, tk, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = dh ** -0.5
    counts = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    before = Counter(KERNEL_LAUNCHES)
    o, lse = flash_fwd_cuda(q, k, v, causal, scale)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, scale)
    dvec = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, lse_ref, do, dvec, causal, scale)
    got = (o, lse, flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == tuple(c + 1 for c in counts)
    name = str(dtype).removeprefix("torch.")
    kernels = (("flash_fwd_wgmma_wide", "flash_bwd_dq_wgmma_wide",
                "flash_bwd_dkv_wgmma_wide") if dtype == torch.bfloat16 else
               ("flash_fwd_f32_wide", "flash_bwd_dq_f32_wide",
                "flash_bwd_dkv_f32_wide"))
    assert KERNEL_LAUNCHES - before == Counter(
        {(kernel, name, dh): 1 for kernel in kernels})
    for g, r in zip(got, (o_ref, lse_ref, *flash_bwd_plain(*args))):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert bool(torch.isfinite(g).all())
        if dtype == torch.float32 and g is o or g is lse:
            assert (g - r).abs().max() <= 1e-5
        else:
            _close(g, r, dtype)


def _close_o(o, ref, v):
    """bf16 O past head dim 128 against the plain version: ``_close``'s
    bound plus 2⁻⁸·max|V|.  Both round P = exp(S − max) to bf16 before
    P·V, from S summed over Dh in different orders, so a P at a rounding
    boundary can round one way in each (the CPU test's allowance,
    ``tests/test_torch_flash.py``)."""
    o, ref = o.float(), ref.float()
    atol = 1e-2 * ref.abs().max().item() \
        + 2 ** -8 * v.float().abs().max().item()
    torch.testing.assert_close(o, ref, rtol=1e-2, atol=atol)


def _wide_inputs(bh, t, tk, dh, dtype, causal, seed):
    """q, k, v, dO in ``dtype`` and the plain forward's (O, lse), with
    D = rowsum(dO∘O): the same inputs for kernel and plain version."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((bh, t, dh), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bh, tk, dh), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, dh ** -0.5)
    dvec = (do.float() * o_ref.float()).sum(-1)
    return (q, k, v, lse_ref, do, dvec, causal, dh ** -0.5), o_ref


@pytest.mark.parametrize("dh", [192, 256])
def test_bf16_wgmma_k1_k3_at_the_dim_2048_training_shape(dh):
    """The bf16 K1, K2 and K3 at ``gpt_lm(dim=2048)``'s training shape
    (B·H = 128, T = 512, causal; Dh 256, and 192 beside it) against the
    plain versions, each launch counted under its wgmma kernel, and K1
    through ``flash_attention_lse`` on a batch-1 join of 200 tokens (8
    heads)."""
    args, o_ref = _wide_inputs(128, 512, 512, dh, torch.bfloat16, True, dh)
    q, k, v, lse_ref = args[:4]
    before = Counter(KERNEL_LAUNCHES)
    o, lse = flash_fwd_cuda(q, k, v, True, args[-1])
    _close_o(o, o_ref, v)
    _close(lse, lse_ref, torch.bfloat16)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    for g, r in zip(got, flash_bwd_plain(*args)):
        assert bool(torch.isfinite(g).all())
        _close(g, r, torch.bfloat16)
    assert KERNEL_LAUNCHES - before == Counter(
        {("flash_fwd_wgmma_wide", "bfloat16", dh): 1,
         ("flash_bwd_dq_wgmma_wide", "bfloat16", dh): 1,
         ("flash_bwd_dkv_wgmma_wide", "bfloat16", dh): 1})
    q, k, v = _qkv(1, 200, 8, dh, torch.bfloat16, seed=dh)
    launches = flash_fwd_cuda.launches
    out, lse = flash_attention_lse(q, k, v, True)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 1
    o_ref, lse_ref = flash_fwd_plain(_to_bh(q), _to_bh(k), _to_bh(v), True,
                                     dh ** -0.5)
    _close_o(_to_bh(out), o_ref, v)
    _close(lse.reshape(8, 200), lse_ref, torch.bfloat16)


@pytest.mark.parametrize("dh", [192, 256])
def test_f32_k3_at_the_dim_2048_training_shape(dh):
    """The f32 K2 and K3 (3xTF32 on mma.sync) at ``gpt_lm(dim=2048)``'s
    training shape (B·H = 128, T = 512, causal; Dh 256, and 192 beside
    it) against ``flash_bwd_plain`` within the f32 bound, their launches
    counted under ``flash_bwd_dq_f32_wide`` and
    ``flash_bwd_dkv_f32_wide``."""
    args, _ = _wide_inputs(128, 512, 512, dh, torch.float32, True, dh)
    before = Counter(KERNEL_LAUNCHES)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    for g, r in zip(got, flash_bwd_plain(*args)):
        assert bool(torch.isfinite(g).all())
        _close(g, r, torch.float32)
    assert KERNEL_LAUNCHES - before == Counter(
        {("flash_bwd_dq_f32_wide", "float32", dh): 1,
         ("flash_bwd_dkv_f32_wide", "float32", dh): 1})


@pytest.mark.parametrize("dh", [192, 256])
def test_f32_k1_at_the_dim_2048_training_shape(dh):
    """The f32 K1 at ``gpt_lm(dim=2048)``'s training shape (B·H = 128,
    T = 512, causal; Dh 256, and 192 beside it) against
    ``flash_fwd_plain``: O and lse within 1e-5, the launch counted under
    ``flash_fwd_f32_wide`` (3xTF32 on mma.sync, eight warps a block)."""
    args, o_ref = _wide_inputs(128, 512, 512, dh, torch.float32, True, dh)
    q, k, v, lse_ref = args[:4]
    before = Counter(KERNEL_LAUNCHES)
    o, lse = flash_fwd_cuda(q, k, v, True, args[-1])
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES - before == Counter(
        {("flash_fwd_f32_wide", "float32", dh): 1})
    assert bool(torch.isfinite(o).all())
    assert (o - o_ref).abs().max() <= 1e-5
    assert (lse - lse_ref).abs().max() <= 1e-5


#: the f32 K1 at Dh 129-256 on a grid of B·H 8 (``gpt_lm(dim=2048)``'s
#: serving joins): the kernel the measured dispatch gives it, the 3xTF32
#: one, which took 0.52-0.75x the CUDA-core kernel's time there
#: (``PERF.md`` §6, PR 11)
SERVE_WIDE_K1 = "flash_fwd_f32_wide"


@pytest.mark.parametrize("bh,t,want", [(128, 512, "flash_fwd_f32_wide"),
                                       (8, 100, SERVE_WIDE_K1),
                                       (8, 512, SERVE_WIDE_K1)])
def test_f32_k1_at_head_dim_256_dispatches_by_grid_fill(bh, t, want):
    """At Dh 256 the f32 K1 takes its 3xTF32 kernel on
    ``gpt_lm(dim=2048)``'s training grid (B·H 128, where 64-row query
    tiles give at least two blocks an SM) and ``SERVE_WIDE_K1`` at the
    serving grids (B·H 8, a join of 100 tokens and a full row of 512),
    where below Dh 128 the grid's fill picks the CUDA-core kernel: one
    launch, counted under that kernel, within 1e-5 of
    ``flash_fwd_plain``."""
    gen = torch.Generator(device="cuda").manual_seed(bh + t)
    q, k, v = (torch.randn((bh, t, 256), generator=gen, device="cuda")
               for _ in range(3))
    before = Counter(KERNEL_LAUNCHES)
    o, lse = flash_fwd_cuda(q, k, v, True, 256 ** -0.5)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES - before == Counter({(want, "float32", 256): 1})
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, 256 ** -0.5)
    assert (o - o_ref).abs().max() <= 1e-5
    assert (lse - lse_ref).abs().max() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,t,tk", [(True, 100, 100), (False, 64, 130)])
@pytest.mark.parametrize("dh", [257, 300, 320, 512])
def test_kernels_at_head_dims_past_256(dtype, causal, t, tk, dh):
    """Head dims past 256, which the CUDA-core kernels take in 256-column
    panels (S and dP summed over every chunk of Dh): K1, K2 and K3 against
    the plain versions, one launch each, on CUDA cores; f32 O and lse
    within 1e-5, the rest within ``_close``'s bound of the dtype (bf16 O
    within ``_close_o``)."""
    args, o_ref = _wide_inputs(4, t, tk, dh, dtype, causal, dh)
    q, k, v, lse_ref = args[:4]
    counts = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    before = Counter(KERNEL_LAUNCHES)
    o, lse = flash_fwd_cuda(q, k, v, causal, args[-1])
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == tuple(c + 1 for c in counts)
    name = str(dtype).removeprefix("torch.")
    assert KERNEL_LAUNCHES - before == Counter(
        {(kernel, name, dh): 1 for kernel in (
            "flash_fwd_cuda_cores", "flash_bwd_dq_wide",
            "flash_bwd_dkv_wide")})
    assert o.shape == q.shape and bool(torch.isfinite(o).all())
    if dtype == torch.float32:
        assert (o - o_ref).abs().max() <= 1e-5
        assert (lse - lse_ref).abs().max() <= 1e-5
    else:
        _close_o(o, o_ref, v)
        _close(lse, lse_ref, dtype)
    for g, r in zip(got, flash_bwd_plain(*args)):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert bool(torch.isfinite(g).all())
        _close(g, r, dtype)


@pytest.mark.parametrize("t,dh", [(2048, 64), (2048, 128), (4096, 64),
                                  (4096, 128), (2048, 256), (4096, 256)])
def test_f32_backward_kernels_at_long_sequences(t, dh):
    """The f32 K2/K3 (3xTF32; at Dh 256 on 256-wide tiles) over long
    causal rows, where dK and dV sum the most query tiles and dQ the
    most key tiles: still within the f32 bound (rtol 5e-4, atol 1e-5) of
    ``flash_bwd_plain``."""
    bh = 4
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn((bh, t, dh), generator=gen, device="cuda")
                   for _ in range(4))
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, True, scale)
    args = (q, k, v, lse, do, (do * o).sum(-1), True, scale)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    for g, r in zip(got, flash_bwd_plain(*args)):
        assert bool(torch.isfinite(g).all())
        _close(g, r, torch.float32)


@pytest.mark.parametrize("causal,t,tk,dh", [
    (True, 100, None, 32), (True, 200, None, 64), (False, 64, 130, 64),
    (True, 200, None, 128)])
def test_f32_backward_kernels_are_3xtf32_not_tf32(causal, t, tk, dh):
    """On Q and K with a common offset of 1 (scores near 64·scale, whose
    differences TF32's three digits blur), the plain version with TF32
    products (``allow_tf32``) misses ``_close``'s f32 bound against the
    plain version in f32, and the f32 kernels meet it: their products are
    3xTF32 (split hi/lo operands), not one TF32 pass."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    tk = t if tk is None else tk
    q, do = (torch.randn((8, t, dh), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((8, tk, dh), generator=gen, device="cuda")
            for _ in range(2))
    q, k = q + 1.0, k + 1.0
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale)
    args = (q, k, v, lse, do, (do * o).sum(-1), causal, scale)
    ref = flash_bwd_plain(*args)
    got = (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_bwd_plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, r, one_pass in zip(got, ref, tf32):
        _close(g, r, torch.float32)
        with pytest.raises(AssertionError):
            _close(one_pass, r, torch.float32)


@pytest.mark.parametrize("causal,t,tk,dh", [
    (True, 200, None, 192), (True, 200, None, 256), (False, 64, 130, 256)])
def test_f32_wide_k3_is_3xtf32_not_tf32(causal, t, tk, dh):
    """At head dims 129–256, on Q and K with a common offset of 1, the f32
    K3 is within ``_close``'s f32 bound of dK and dV computed in float64,
    and the plain version with TF32 products (``allow_tf32``) misses it:
    its products are 3xTF32, not one TF32 pass.  float64 is the witness
    because on such inputs the plain version in f32 can itself be outside
    that bound (``chip_smoke.py``'s ``k3_tf32_control``: 1.7e-5 to 4.9e-5
    from float64 on an H100, outside it at Dh 256 causal, against the
    kernel's 6.9e-6 to 2.0e-5)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    tk = t if tk is None else tk
    q, do = (torch.randn((8, t, dh), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((8, tk, dh), generator=gen, device="cuda")
            for _ in range(2))
    q, k = q + 1.0, k + 1.0
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale)
    args = (q, k, v, lse, do, (do * o).sum(-1), causal, scale)
    exact = dkv_float64(torch, *args)
    before = Counter(KERNEL_LAUNCHES)
    got = flash_bwd_dkv_cuda(*args)
    assert KERNEL_LAUNCHES - before == Counter(
        {("flash_bwd_dkv_f32_wide", "float32", dh): 1})
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_bwd_plain(*args)[1:]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, r, one_pass in zip(got, exact, tf32):
        _close(g, r, torch.float32)
        with pytest.raises(AssertionError):
            _close(one_pass, r, torch.float32)


@pytest.mark.parametrize("causal,t,tk,dh", [
    (True, 200, None, 192), (True, 200, None, 256), (False, 64, 130, 256)])
def test_f32_wide_k2_is_3xtf32_not_tf32(causal, t, tk, dh):
    """At head dims 129–256, on Q and K with a common offset of 1, the f32
    K2 is within ``_close``'s f32 bound of dQ computed in float64, and
    the plain version with TF32 products (``allow_tf32``) misses it: its
    products are 3xTF32, not one TF32 pass (S and dP sum 24 or 32 k-steps
    there, hi·hi in pairs from zero).  float64 is the witness, as for
    K3."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    tk = t if tk is None else tk
    q, do = (torch.randn((8, t, dh), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((8, tk, dh), generator=gen, device="cuda")
            for _ in range(2))
    q, k = q + 1.0, k + 1.0
    scale = dh ** -0.5
    o, lse = flash_fwd_plain(q, k, v, causal, scale)
    args = (q, k, v, lse, do, (do * o).sum(-1), causal, scale)
    exact = dq_float64(torch, *args)
    before = Counter(KERNEL_LAUNCHES)
    got = flash_bwd_dq_cuda(*args)
    assert KERNEL_LAUNCHES - before == Counter(
        {("flash_bwd_dq_f32_wide", "float32", dh): 1})
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_bwd_plain(*args)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _close(got, exact, torch.float32)
    with pytest.raises(AssertionError):
        _close(tf32, exact, torch.float32)


@pytest.mark.parametrize("causal,t,tk,dh", [
    (True, 200, None, 192), (True, 200, None, 256), (False, 130, 64, 256)])
def test_f32_wide_k1_is_3xtf32_not_tf32(causal, t, tk, dh):
    """At head dims 129–256 (B·H 128: 64-row tiles fill the card), on Q
    and K with a common offset of 1, the f32 K1 is within 1e-5 of
    attention computed in float64 (O and lse), and the plain forward with
    TF32 products (``allow_tf32``) misses it: its products are 3xTF32, not
    one TF32 pass (S sums 24 or 32 k-steps there, hi·hi in pairs from
    zero)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    tk = t if tk is None else tk
    q = torch.randn((128, t, dh), generator=gen, device="cuda") + 1.0
    k = torch.randn((128, tk, dh), generator=gen, device="cuda") + 1.0
    v = torch.randn((128, tk, dh), generator=gen, device="cuda")
    scale = dh ** -0.5
    exact = attention_float64(torch, q, k, v, causal, scale)
    before = Counter(KERNEL_LAUNCHES)
    got = flash_fwd_cuda(q, k, v, causal, scale)
    assert KERNEL_LAUNCHES - before == Counter(
        {("flash_fwd_f32_wide", "float32", dh): 1})
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = flash_fwd_plain(q, k, v, causal, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert max((g - r).abs().max().item() for g, r in zip(got, exact)) \
        <= 1e-5
    assert min((g - r).abs().max().item() for g, r in zip(tf32, exact)) \
        > 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_backward_refuses_unaligned_inputs(dtype):
    """The backward kernels load tiles by TMA (bf16) or 16-byte cp.async
    (f32), both of which need 16-byte aligned addresses: a contiguous view
    at an odd storage offset is refused before any launch, in either
    dtype."""
    bh, t, dh = 2, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randn(bh * t * dh + 1, generator=gen, device="cuda").to(
        dtype)
    shifted = base[1:].view(bh, t, dh)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    q = torch.randn((bh, t, dh), generator=gen, device="cuda").to(dtype)
    lse = torch.zeros((bh, t), device="cuda")
    launches = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        for i in range(4):
            args = [q, q, q, lse, q, lse, True, 0.125]
            args[(0, 1, 2, 4)[i]] = shifted
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(*args)
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == \
        launches


def test_bf16_forward_refuses_unaligned_inputs():
    """The bf16 K1 loads its tiles by TMA too: a contiguous bf16 q, k or v
    at an odd storage offset is refused before any launch."""
    bh, t, dh = 2, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = torch.randn(bh * t * dh + 1, generator=gen, device="cuda").to(
        torch.bfloat16)
    shifted = base[1:].view(bh, t, dh)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    q = torch.randn((bh, t, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    launches = flash_fwd_cuda.launches
    for i in range(3):
        args = [q, q, q]
        args[i] = shifted
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_fwd_cuda(*args, True, 0.125)
    assert flash_fwd_cuda.launches == launches


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Head dim 257 runs (the CUDA-core kernels take any Dh past 256, as
    the reference does): one launch, within 1e-5 of the plain version.
    What the kernels do not take is refused before any launch: float16,
    non-contiguous inputs, causal with unequal lengths, and for the
    backward a strided dO, a float64 lse and a CPU tensor."""
    q, k, v = (_to_bh(x) for x in _qkv(1, 64, 2, 257, torch.float32))
    launches = flash_fwd_cuda.launches
    o, lse = flash_fwd_cuda(q, k, v, True, 0.1)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 1
    o_ref, lse_ref = flash_fwd_plain(q, k, v, True, 0.1)
    assert (o - o_ref).abs().max() <= 1e-5
    assert (lse - lse_ref).abs().max() <= 1e-5
    launches = flash_fwd_cuda.launches
    q, k, v = (_to_bh(x) for x in _qkv(1, 64, 2, 64, torch.float16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_fwd_cuda(q, k, v, True, 0.1)
    q, k, v = (_to_bh(x) for x in _qkv(1, 64, 2, 64, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       True, 0.1)
    with pytest.raises(ValueError, match="equal q/k lengths"):
        flash_fwd_cuda(q[:, :32].contiguous(), k, v, True, 0.1)
    assert flash_fwd_cuda.launches == launches
    bwd = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    lse = torch.zeros(q.shape[:2], device="cuda")
    do = torch.zeros_like(q)
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, k, v, lse, do.transpose(1, 2).contiguous().transpose(1, 2),
               lse, True, 0.1)
        with pytest.raises(ValueError, match="float32"):
            fn(q, k, v, lse.double(), do, lse, True, 0.1)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v, lse, do.cpu(), lse, True, 0.1)
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == bwd


def test_engine_on_the_card_matches_generate_tokens():
    model = zoo.gpt_lm(vocab_size=64, dim=64, num_heads=2, num_blocks=2,
                       seq_len=64, attention_impl="flash").init(3)
    assert model.device.type == "cuda"
    registry = Registry()
    engine = DecodeEngine(model, ServeConfig(slots=2, max_new_tokens=8,
                                             prefill_buckets=(16, 32)),
                          registry=registry).warmup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n) for n in (5, 20, 40, 11)]
    launches = flash_fwd_cuda.launches
    engine.start()
    try:
        answers = [r.result(timeout=120) for r in
                   [engine.submit(p, max_new_tokens=m)
                    for p, m in zip(prompts, (8, 3, 6, 8))]]
    finally:
        engine.stop()
    assert flash_fwd_cuda.launches == launches + 2 * len(prompts)
    for p, got in zip(prompts, answers):
        ref = generate_tokens(model, p[None], len(got))[0, len(p):]
        np.testing.assert_array_equal(got, ref.cpu().numpy())
    assert registry.counter("jit.retraces").value == 0


def _card_lm(seed=3, impl="flash"):
    return zoo.gpt_lm(vocab_size=64, dim=64, num_heads=2, num_blocks=2,
                      seq_len=64, attention_impl=impl).init(seed)


def test_fleet_on_the_card_serves_warm_and_counts_cold_joins():
    """Two prefix-cached engines on the card behind a ``ServeRouter``
    with the KV fabric, over loopback: every answer equals
    ``generate_tokens``, a forced spill replicates and the repeat spill
    lands warm, and K1 ran exactly once per block per cold join (counted
    from the engines' own ``serve.prefix.misses``), never in a warm
    join."""
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    from distkeras_tpu_torch.serve import (RouterConfig, ServeClient,
                                           ServeRouter, ServeServer)
    model = _card_lm()
    cfg = ServeConfig(slots=2, max_new_tokens=8, prefill_buckets=(16, 32),
                      prefix_cache=True, prefix_block=8)
    servers = [ServeServer(DecodeEngine(model, cfg,
                                        registry=Registry()).warmup())
               .start() for _ in range(2)]
    router = ServeRouter([("127.0.0.1", s.port) for s in servers],
                         config=RouterConfig(affinity_block=8,
                                             max_inflight=2,
                                             stats_interval_s=30.0)).start()
    rng = np.random.default_rng(1)
    groups = [rng.integers(0, 64, 16) for _ in range(2)]
    reset_launches()
    replies = []
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            for g in groups:
                for _ in range(2):
                    p = np.concatenate([g, rng.integers(0, 64, 4)])
                    replies.append((p, client.generate(p, 6)))
            owner = router.backends[0]
            with router._lock:
                owner.inflight = 2
            p = np.concatenate([groups[0], rng.integers(0, 64, 4)])
            first = client.generate(p, 6)
            replies.append((p, first))
            t_end = time.monotonic() + 30
            while router.registry.counter(
                    "serve.router.kv_replications").value < 1:
                assert time.monotonic() < t_end
                time.sleep(0.02)
            p = np.concatenate([groups[0], rng.integers(0, 64, 4)])
            second = client.generate(p, 6)
            replies.append((p, second))
            with router._lock:
                owner.inflight = 0
        torch.cuda.synchronize()
        served_launches = flash_fwd_cuda.launches
        misses = sum(s.engine.registry.counter("serve.prefix.misses").value
                     for s in servers)
    finally:
        router.stop()
        for s in servers:
            s.stop()
    assert first["warm"] is False and second["warm"] is True
    assert served_launches == 2 * misses and misses == 3
    for p, reply in replies:
        assert reply["ok"], reply
        ref = generate_tokens(model, p[None], 6)[0, len(p):]
        np.testing.assert_array_equal(reply["tokens"], ref.cpu().numpy())


def test_spec_and_beam_on_the_card():
    """Speculative decoding with a narrow draft on the card equals
    ``generate_tokens`` (K1 once per block of target and draft per cold
    join), and ``generate_beam`` on the flash model equals its dense
    twin's (one K1 launch per block for the prefill)."""
    from distkeras_tpu_torch.models import generate_beam
    model = _card_lm()
    # a flash draft (``draft_lm`` builds dense attention): its joins run K1
    draft = zoo.gpt_lm(vocab_size=64, dim=32, num_heads=1, num_blocks=1,
                       seq_len=64, attention_impl="flash").init(7)
    registry = Registry()
    engine = DecodeEngine(model, ServeConfig(slots=2, max_new_tokens=8,
                                             prefill_buckets=(16, 32),
                                             spec_k=3),
                          registry=registry, draft_model=draft).warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, n) for n in (5, 20, 40)]
    launches = flash_fwd_cuda.launches
    with engine:
        answers = [r.result(timeout=120) for r in
                   [engine.submit(p, 8) for p in prompts]]
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 3 * len(prompts)
    for p, got in zip(prompts, answers):
        ref = generate_tokens(model, p[None], 8)[0, len(p):]
        np.testing.assert_array_equal(got, ref.cpu().numpy())
    assert registry.counter("serve.spec.proposed").value > 0
    dense = _card_lm(impl="dense")
    dense.load_state_dict(model.state_dict())
    x = rng.integers(0, 64, (2, 12))
    launches = flash_fwd_cuda.launches
    out, scores = generate_beam(model, x, 8, num_beams=3,
                                return_scores=True)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == launches + 2
    ref, ref_scores = generate_beam(dense, x, 8, num_beams=3,
                                    return_scores=True)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())
    assert (scores - ref_scores).abs().max().item() <= 1e-4


def test_single_trainer_flash_matches_dense_on_the_card():
    """A 2-block flash LM and its dense twin (same seed, so the same
    weights) trained by ``SingleTrainer`` on the card: the flash model's
    steps run K1, K2 and K3 once per block each, and both give the same
    per-step losses and trained parameters."""
    ds = load_lm_corpus(n_train=32, seq_len=128, vocab_size=64)[0]
    cfg = dict(vocab_size=64, dim=64, num_heads=2, num_blocks=2,
               seq_len=128)
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    runs = {}
    for impl in ("flash", "dense"):
        before = [k.launches for k in kernels]
        t = SingleTrainer(zoo.gpt_lm(**cfg, attention_impl=impl), "sgd",
                          "sparse_categorical_crossentropy", batch_size=8,
                          num_epoch=2, learning_rate=0.1)
        model = t.train(ds)
        assert model.device.type == "cuda"
        runs[impl] = (np.concatenate(t.get_history()), t.trained_variables,
                      [k.launches - b for k, b in zip(kernels, before)])
    assert runs["flash"][2] == [2 * 8] * 3 and runs["dense"][2] == [0] * 3
    np.testing.assert_allclose(runs["flash"][0], runs["dense"][0], rtol=1e-4)
    for a, b in zip(*(tree_leaves(runs[i][1]["params"])
                      for i in ("flash", "dense"))):
        np.testing.assert_allclose(a, b, atol=1e-4)


def _toy():
    """``tests/test_trainers_sync.py:toy_problem`` (2048 rows, 10
    features, 3 classes, one-hot labels)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2048, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(2048, 3)), axis=-1)
    return OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))


@pytest.mark.parametrize("name", ["ADAG", "EAMSGD"])
def test_sync_trainer_on_the_card_matches_the_cpu(name):
    """8 workers, window 4, 3 epochs of the f32 toy problem, TF32 off:
    the trained center and the per-worker losses on the card within rtol
    1e-5 plus 1e-6 of the largest |value| of the CPU's."""
    ds = _toy()
    out = {}
    for device in ("cpu", "cuda"):
        model = Model(Sequential([Dense(32, "relu"), Dense(3, "softmax")]),
                      input_shape=(10,))
        t = getattr(dkt, name)(model, num_workers=8, communication_window=4,
                               label_col="label_onehot", num_epoch=3,
                               batch_size=32, learning_rate=0.05,
                               device=device)
        t.train(ds)
        assert t.get_history()[0].shape == (8, 8)
        out[device] = tree_leaves(t.trained_variables) + t.get_history()
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("rule", ["adag", "downpour", "dynsgd", "easgd",
                                  "none"])
def test_rules_on_cuda_tensors(rule):
    """Each window-edge rule on a stacked (8, 4) tree of CUDA tensors
    against its closed form; the integer leaf passes unchanged."""
    algo = {"adag": sync.AdagSync(), "downpour": sync.DownpourSync(),
            "dynsgd": sync.DynSgdSync(), "easgd": sync.EasgdSync(0.25),
            "none": sync.NoCommSync()}[rule]
    c = torch.linspace(-1, 1, 4, device="cuda")
    l = torch.arange(32, dtype=torch.float32, device="cuda").reshape(8, 4)
    n = torch.arange(32, device="cuda").reshape(8, 4)
    c2, l2 = algo.communicate({"w": c, "n": n[0]}, {"w": l, "n": n})
    assert c2["w"].is_cuda and l2["w"].shape == (8, 4)
    assert torch.equal(l2["n"], n)
    mean, moved = l.mean(0), c + (l - c).sum(0)
    want = {"adag": (mean, mean.expand(8, 4)),
            "downpour": (moved, moved.expand(8, 4)),
            "easgd": (c + (0.25 * (l - c)).sum(0), l - 0.25 * (l - c)),
            "none": (c, l)}
    want["dynsgd"] = want["downpour"]
    torch.testing.assert_close(c2["w"], want[rule][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(l2["w"], want[rule][1], rtol=1e-6, atol=0)


def test_adag_over_the_flash_lm_launches_each_kernel_per_worker_step():
    """ADAG over a 2-block flash LM in bf16, 4 workers, window 2, 2
    epochs of 4 steps a worker: K1, K2 and K3 launch exactly W x steps x
    blocks times each, and the loss is finite."""
    ds = load_lm_corpus(n_train=4 * 2 * 4, seq_len=128, vocab_size=64)[0]
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    t = dkt.ADAG(zoo.gpt_lm(vocab_size=64, dim=64, num_heads=2,
                            num_blocks=2, seq_len=128,
                            attention_impl="flash"),
                 "sgd", "sparse_categorical_crossentropy", num_workers=4,
                 batch_size=2, communication_window=2, num_epoch=2,
                 learning_rate=0.1, compute_dtype="bfloat16")
    t.train(ds)
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [4 * 4 * 2 * 2] * 3
    assert all(np.isfinite(h).all() and h.shape == (4, 4)
               for h in t.get_history())


def _flash_lm_trainer(epochs, **kw):
    cfg = dict(vocab_size=64, dim=64, num_heads=2, num_blocks=2, seq_len=128,
               attention_impl="flash")
    return SingleTrainer(zoo.gpt_lm(**cfg), "adam",
                         "sparse_categorical_crossentropy", batch_size=8,
                         num_epoch=epochs, learning_rate=0.01,
                         compute_dtype="bfloat16", **kw)


def test_a_card_trainers_checkpoint_restores_onto_the_card(tmp_path):
    """A card trainer's checkpoint restores its state on the card: the
    restored tensors are CUDA tensors, bit-identical to what was saved,
    and the file holds the generator's CUDA state."""
    from distkeras_tpu_torch.utils import checkpoint
    ds = load_lm_corpus(n_train=32, seq_len=128, vocab_size=64)[0]
    t = _flash_lm_trainer(1, checkpoint_dir=str(tmp_path))
    t.train(ds)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    # the live state after the epoch: adam's count and moments on the card
    names = dkt.utils.weights.jax_leaf_names(t.model)
    opt = t._window_run()[1].init(dict(t.model.named_parameters()))
    like = t._state_tree(opt)
    tree, meta = mgr.restore(like)
    assert meta["epoch"] == 0
    assert meta[checkpoint.GENERATORS]["device"] == "cuda"
    variables = tree[0]
    assert all(x.is_cuda for x in variables + tree[1][1:])
    for got, live in zip(variables, like[0]):
        assert torch.equal(got, live.detach())
    assert tree[1][0] == 4   # adam's step count: 4 steps of batch 8
    assert len(tree[1]) == 1 + 2 * len(names[0])


def test_resume_is_bit_identical_on_the_card(tmp_path):
    """The flash LM in bf16 with adam: 3 epochs straight against 1 epoch
    plus a resume to 3, on the card, bit for bit."""
    ds = load_lm_corpus(n_train=32, seq_len=128, vocab_size=64)[0]
    straight = _flash_lm_trainer(3)
    straight.train(ds)
    _flash_lm_trainer(1, checkpoint_dir=str(tmp_path)).train(ds)
    resumed = _flash_lm_trainer(3, checkpoint_dir=str(tmp_path))
    resumed.train(ds, resume=True)
    for a, b in zip(resumed.get_history(), straight.get_history()[1:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(resumed.trained_variables),
                    tree_leaves(straight.trained_variables)):
        np.testing.assert_array_equal(a, b)


def test_single_trainer_streams_on_the_card(tmp_path):
    """The flash LM streamed from disk shards on the card equals its
    in-memory run on the same batches, and runs K1-K3 per block per
    step."""
    from distkeras_tpu_torch.data import ShardedFileDataset
    ds = load_lm_corpus(n_train=64, seq_len=128, vocab_size=64)[0]
    src = ShardedFileDataset.write(ds, str(tmp_path), rows_per_shard=20)
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    runs = []
    for data in (ds, src):
        before = [k.launches for k in kernels]
        t = _flash_lm_trainer(2)
        model = t.train(data)
        assert model.device.type == "cuda"
        runs.append((t, [k.launches - b for k, b in zip(kernels, before)]))
    (ram, ram_launches), (disk, disk_launches) = runs
    assert disk_launches == ram_launches == [2 * 8 * 2] * 3
    for a, b in zip(disk.get_history() + tree_leaves(disk.trained_variables),
                    ram.get_history() + tree_leaves(ram.trained_variables)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


# -- the async parameter server on the card ----------------------------------

def _async_lm(name, **kw):
    cfg = dict(vocab_size=64, dim=64, num_heads=2, num_blocks=2, seq_len=128,
               attention_impl="flash")
    return getattr(dkt, name)(zoo.gpt_lm(**cfg), "sgd",
                              "sparse_categorical_crossentropy",
                              batch_size=2, communication_window=2,
                              num_epoch=2, learning_rate=0.1,
                              compute_dtype="bfloat16", mode="async", **kw)


@pytest.mark.parametrize("name", ["DOWNPOUR", "DynSGD", "EAMSGD"])
def test_async_thread_workers_on_the_card_count_launches_exactly(name):
    """``mode="async"`` with 4 thread workers over a 2-block flash LM in
    bf16, window 2, 2 epochs of 4 steps a worker, each worker its own
    replica on the card: every window commits once, K1, K2 and K3
    launch exactly W x steps x blocks times each (the counts are kept
    under a lock, so threads launching at once lose none), the PS's
    accounting identity holds and the loss is finite."""
    ds = load_lm_corpus(n_train=4 * 2 * 4, seq_len=128, vocab_size=64)[0]
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    kw = dict(rho=1.0) if name == "EAMSGD" else {}
    t = _async_lm(name, num_workers=4, **kw)
    model = t.train(ds)
    assert model.device.type == "cuda"
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [4 * 4 * 2 * 2] * 3
    assert t.ps_stats["num_updates"] == 4 * 2 * 2
    snap = t.ps_stats["registry"]
    assert snap["ps.commit_requests"]["value"] == \
        snap["ps.commits"]["value"] == 16
    assert all(np.isfinite(h).all() and h.shape == (4, 4)
               for h in t.get_history())


@pytest.mark.parametrize("ps_shards", [1, 2])
def test_async_process_workers_on_the_card_fold_their_launches(ps_shards):
    """Two process workers, each with its own CUDA context: their K1-K3
    launches come back into the parent's counts.  Over 2 shards each
    worker is handed the shard ports as a list and every shard applies
    each window once."""
    ds = load_lm_corpus(n_train=2 * 2 * 4, seq_len=128, vocab_size=64)[0]
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    t = _async_lm("DOWNPOUR", num_workers=2, async_workers="processes",
                  ps_shards=ps_shards)
    t.train(ds)
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [2 * 4 * 2 * 2] * 3
    assert t.ps_stats["num_updates"] == 2 * 2 * 2
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    assert t.ps_stats["registry"]["ps.commits"]["value"] == \
        ps_shards * 2 * 2 * 2


def test_sharded_async_run_on_the_card_counts_launches_exactly():
    """DOWNPOUR over 3 PS shards with 2 thread workers on the card: K1, K2
    and K3 launch exactly W x steps x blocks times each, every shard
    applies each window once, its accounting identity holds, and one
    worker's run is bit-identical on 1 and on 2 shards."""
    ds = load_lm_corpus(n_train=2 * 2 * 4, seq_len=128, vocab_size=64)[0]
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    t = _async_lm("DOWNPOUR", num_workers=2, ps_shards=3)
    assert t.train(ds).device.type == "cuda"
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [2 * 4 * 2 * 2] * 3
    snap = t.ps_stats["registry"]
    assert snap["ps.commits"]["value"] == 3 * 2 * 2 * 2
    assert snap["ps.commit_requests"]["value"] == \
        snap["ps.commits"]["value"] + snap["ps.commits_dropped"]["value"] \
        + snap["ps.commits_tombstoned"]["value"]
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    ds1 = load_lm_corpus(n_train=2 * 4, seq_len=128, vocab_size=64)[0]
    runs = []
    for shards in (1, 2):
        t = _async_lm("DOWNPOUR", num_workers=1, ps_shards=shards)
        t.train(ds1)
        runs.append(tree_leaves(t.trained_variables))
    assert all(np.array_equal(a, b) for a, b in zip(*runs))


def test_moe_lm_trains_in_bf16_and_serves_in_f32_on_the_card():
    """``gpt_lm(moe_experts=4)`` on the card: 2 bf16 ``SingleTrainer``
    steps with ``aux_weight`` launch K1-K3 once per block per step, the
    loss and the aux state are finite; served in f32 by ``DecodeEngine``,
    every answer equals ``generate_tokens`` and K1 runs once per block per
    cold join."""
    cfg = dict(vocab_size=64, dim=64, num_heads=2, num_blocks=2,
               seq_len=64, attention_impl="flash", moe_experts=4)
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    t = SingleTrainer(zoo.gpt_lm(**cfg), "sgd",
                      "sparse_categorical_crossentropy", batch_size=4,
                      learning_rate=0.1, compute_dtype="bfloat16",
                      aux_weight=0.01)
    t.train(load_lm_corpus(n_train=8, seq_len=64, vocab_size=64)[0])
    assert [k.launches - b for k, b in zip(kernels, before)] == [2 * 2] * 3
    assert all(np.isfinite(h).all() for h in t.get_history())
    aux = tree_leaves(t.trained_variables["state"])
    assert len(aux) == 2 and all(np.isfinite(a) and a > 0 for a in aux)
    model = zoo.gpt_lm(**cfg).init(5)
    engine = DecodeEngine(model, ServeConfig(slots=2, max_new_tokens=6,
                                             prefill_buckets=(16, 32)),
                          registry=Registry()).warmup()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n) for n in (7, 20, 31)]
    launches = flash_fwd_cuda.launches
    engine.start()
    try:
        answers = [r.result(timeout=120) for r in
                   [engine.submit(p, max_new_tokens=6) for p in prompts]]
    finally:
        engine.stop()
    assert flash_fwd_cuda.launches == launches + 2 * len(prompts)
    for p, got in zip(prompts, answers):
        ref = generate_tokens(model, p[None], len(got))[0, len(p):]
        np.testing.assert_array_equal(got, ref.cpu().numpy())


def test_step_split_and_device_trace_on_the_card(tmp_path):
    """``profile={"trace_dir", "step_split"}`` on the card: epoch 0's
    ``torch.profiler`` trace names the bf16 K1, K2 and K3 CUDA functions,
    the split holds one observation per warm window call (host dispatch
    and the CUDA-event device span, each within the training's wall),
    and ``device_trace`` around a kernel call writes its name."""
    import json
    import os
    from distkeras_tpu_torch.obs import device_trace
    lm = dict(vocab_size=64, dim=64, num_heads=2, num_blocks=1, seq_len=64,
              attention_impl="flash")
    ds = load_lm_corpus(n_train=64, seq_len=64, vocab_size=64)[0]
    t = SingleTrainer(zoo.gpt_lm(**lm), "sgd",
                      "sparse_categorical_crossentropy", num_epoch=3, batch_size=16, learning_rate=0.1,
                      compute_dtype="bfloat16",
                      profile={"trace_dir": str(tmp_path / "tr"),
                               "step_split": True})
    reg = Registry()
    t.tracer.registry = reg
    t.train(ds)
    with open(tmp_path / "tr" / "epoch0" / "trace.json") as f:
        text = f.read()
    json.loads(text)
    for sym in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                "flash_bwd_dkv_wgmma_kernel"):
        assert sym in text, sym
    assert not os.path.exists(tmp_path / "tr" / "epoch1")
    snap = reg.snapshot()
    host, dev = snap["step.host_seconds"], snap["step.device_seconds"]
    assert host["count"] == dev["count"] == 2
    assert 0 < dev["sum"] <= t.get_training_time()
    assert 0 < host["sum"] <= t.get_training_time()
    q, k, v = _qkv(1, 64, 2, 64, torch.float32)
    with device_trace(str(tmp_path / "one")):
        flash_attention_lse(q, k, v, True)
        torch.cuda.synchronize()
    with open(tmp_path / "one" / "trace.json") as f:
        assert "flash_fwd_kernel" in f.read()


def test_continual_run_on_the_card_matches_the_cpu():
    """Two intervals of ``ContinualTrainer`` in f32 on the card and on the
    CPU from the same weights: per-window losses within rtol 1e-4, the
    same gate decisions, K1–K3 once per block per step on the card."""
    from distkeras_tpu_torch.continual import (ContinualConfig,
                                               ContinualTrainer,
                                               synthetic_lm_feed)
    from distkeras_tpu_torch.ops.flash_attention import reset_launches
    lm = dict(vocab_size=64, dim=64, num_heads=2, num_blocks=2, seq_len=64,
              attention_impl="flash")
    out = {}
    for device in ("cuda", "cpu"):
        cfg = ContinualConfig(batch_size=4, window_steps=2, snapshot_every=2,
                              history=2, min_history=1)
        t = ContinualTrainer(zoo.gpt_lm(**lm), "adam",
                             "sparse_categorical_crossentropy", config=cfg,
                             learning_rate=1e-2, device=device)
        losses, run = [], t._run_fn

        def record(*a, run=run, losses=losses):
            res = run(*a)
            losses.append(res[2].cpu().numpy())
            return res

        t._run_fn = record
        reset_launches()
        t.run(synthetic_lm_feed(64, 64, 4, seed=0), intervals=2)
        counts = [w.launches for w in (flash_fwd_cuda, flash_bwd_dq_cuda,
                                       flash_bwd_dkv_cuda)]
        out[device] = (np.concatenate(losses),
                       [(e["kind"], e["deploy"])
                        for e in t.gate.history_log()], counts)
        assert t.registry.counter("jit.retraces").value == 0
    (lc, dc, kc), (lh, dh, kh) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lc, lh, rtol=1e-4)
    assert dc == dh
    steps = 2 * 2 * 2  # intervals x windows x batches
    assert kc == [lm["num_blocks"] * steps] * 3 and kh == [0, 0, 0]


@pytest.fixture(scope="module")
def card_ranks():
    """Two gloo ranks on ``cuda:0`` (NCCL takes one rank a card), spawned
    once for the mesh cases below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from test_torch_mesh_child import run_ranks
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 3)).astype(np.float32)
    qkv = [rng.normal(size=(2, 256, 4, 64)).astype(np.float32)
           for _ in range(3)]
    cases = [("collectives", "card_collectives", dict(x=x))]
    cases += [(f"ring-{layout}-{int(causal)}", "card_ring",
               dict(q=qkv[0], k=qkv[1], v=qkv[2], causal=causal,
                    layout=layout))
              for layout, causal in (("contiguous", True),
                                     ("contiguous", False),
                                     ("zigzag", True))]
    cases.append(("trainers", "card_trainers", {}))
    return run_ranks(2, cases, device="cuda")


@pytest.mark.parametrize("op", ["psum", "all_gather", "all_to_all",
                                "ppermute", "broadcast"])
def test_collective_routes_on_cuda_tensors_over_gloo(card_ranks, op):
    """gloo runs all_reduce, broadcast, all_gather and all_to_all on CUDA
    tensors and refuses send/recv: ppermute alone goes through a host
    copy, counted; every result equals the CPU collective's."""
    for res in card_ranks:
        got = res["collectives"]
        assert got["ops"][op] == {"device": "cuda:0", "equal": True}
        assert got["routes"]["ppermute"] == "host"
        assert all(got["routes"][k] == "direct" for k in
                   ("all_reduce", "broadcast", "all_gather", "all_to_all"))
        host = got["stats"]["host_calls"]
        assert host == {"ppermute": 1}, host


@pytest.mark.parametrize("case,launches", [
    ("ring-contiguous-1", (1, 2)), ("ring-contiguous-0", (2, 2)),
    ("ring-zigzag-1", (4, 4))])
def test_two_rank_ring_forward_matches_k1_over_the_whole_t(card_ranks, case,
                                                         launches):
    for r, res in enumerate(card_ranks):
        got = res[case]
        assert got["max_abs_err"] <= 1e-5 * max(1.0, got["ref_max"]), got
        assert got["launches"] == launches[r]


def test_spmd_leaves_and_gradients_sit_on_the_card(card_ranks):
    """``SpmdTrainer`` on mp 2 over two gloo ranks on ``cuda:0``: every
    parameter block, optimizer-state tensor and gradient is on the card,
    the split leaves take less than their global bytes, and K1 runs once
    a block a step (2 blocks × 2 steps)."""
    for res in card_ranks:
        got = res["trainers"]["spmd"]
        assert got["devices"] == ["cuda:0"], got
        assert got["split"]
        assert got["launches"] == 2 * 2


def test_neither_mesh_trainer_runs_the_plain_attention_on_the_card(
        card_ranks):
    """The plain versions never see a CUDA tensor in ``SpmdTrainer`` or
    ``PipelineTrainer``; the pipeline's stage sits on the card and its K1
    runs (M + S − 1) × 1 block a stage × 2 steps = 6 times a rank."""
    for res in card_ranks:
        got = res["trainers"]
        assert got["plain_on_cuda"] == []
        assert got["pipe"]["devices"] == ["cuda:0"]
        assert got["pipe"]["launches"] == (2 + 2 - 1) * 1 * 2



# -- the config layer and jobs on the card ----------------------------------

def _yaml_lm_quick(rows=256):
    """configs/bench_all.yaml's flash LM, ``quick`` (Dh 16, bf16), read by
    the port's own reader."""
    import dataclasses
    import os
    from distkeras_tpu_torch import config
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "bench_all.yaml")
    cfg = {c.name: c for c in config.load_file(path)}[
        "GPT-LM flash T=256 (bf16)"].with_quick()
    return dataclasses.replace(
        cfg, dataset_kwargs={**cfg.dataset_kwargs, "n_train": rows})


def test_config_run_of_the_yaml_lm_launches_each_kernel_per_block_step():
    """``config.run`` of the yaml's flash LM (``quick``) on the card, twice
    (``repeat=2``): K1, K2 and K3 each once a block a step."""
    from distkeras_tpu_torch import config
    cfg = _yaml_lm_quick()
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    row = config.run(cfg, repeat=2)
    steps = 256 // cfg.trainer_kwargs["batch_size"]
    want = 2 * cfg.model_kwargs["num_blocks"] * steps * \
        cfg.trainer_kwargs["num_epoch"]
    assert [k.launches - b for k, b in zip(kernels, before)] == [want] * 3
    assert row["samples_per_sec"] > 0 and len(row["rates"]) == 2


def test_a_job_runs_on_the_card_in_a_child_process():
    """``Job.run()`` with no device: the runner trains on the card in its
    own process, its K1-K3 launches fold into this process's counts, and
    the trained model comes back onto the card."""
    from distkeras_tpu_torch import config
    cfg = _yaml_lm_quick(rows=128)
    job = config.to_job(cfg)
    kernels = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    before = [k.launches for k in kernels]
    model = job.run(timeout=600)
    want = cfg.model_kwargs["num_blocks"] * (128 // 64) * \
        cfg.trainer_kwargs["num_epoch"]
    assert [k.launches - b for k, b in zip(kernels, before)] == [want] * 3
    assert model.device.type == "cuda"
    assert len(job.result_history) == cfg.trainer_kwargs["num_epoch"]
