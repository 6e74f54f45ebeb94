"""The port's CUDA paths on the card: the flash-attention kernel against
its plain version, the wrapper's refusals, and the decode engine on a
small model.  Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False (the kernel has no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import generate_tokens, zoo
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.ops.flash_attention import (
    _from_bh, _to_bh, flash_attention_lse, flash_fwd_cuda, flash_fwd_plain)
from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig

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


def test_wrapper_refuses_what_the_kernel_does_not_take():
    launches = flash_fwd_cuda.launches
    q, k, v = (_to_bh(x) for x in _qkv(1, 64, 2, 128, torch.float32))
    with pytest.raises(ValueError, match="head dim 128"):
        flash_fwd_cuda(q, k, v, True, 0.1)
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
