"""The port's flash attention (``distkeras_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas flash attention, which runs in interpret
mode on the CPU.  On the CPU the port runs its plain version; the CUDA
kernel itself is held against that plain version on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distkeras_tpu.ops.attention import _flash_with_blocking as jax_fwb
from distkeras_tpu.ops.attention import dot_product_attention as jax_dense
from distkeras_tpu.ops.pallas_attention import flash_attention as jax_flash
from distkeras_tpu.ops.pallas_attention import (
    flash_attention_lse as jax_flash_lse)
from distkeras_tpu_torch.ops.attention import _flash_with_blocking
from distkeras_tpu_torch.ops.flash_attention import (
    _BACKWARD_MSG, _blocks, _from_bh, _to_bh, flash_attention,
    flash_attention_lse, flash_fwd_cuda)

TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX package's own flash-vs-dense bound


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


def test_backward_is_not_ported_yet():
    q, k, v = (t.requires_grad_() for t in _torch(*qkv(t=16)))
    out = flash_attention(q, k, v, True)
    with pytest.raises(NotImplementedError, match="K2/K3"):
        out.sum().backward()
    assert "training slice" in _BACKWARD_MSG


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (_to_bh(t) for t in _torch(*qkv(t=16)))
    launches = flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_fwd_cuda(q, k, v, True, 0.25)
    assert flash_fwd_cuda.launches == launches



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
