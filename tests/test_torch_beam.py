"""The port's ``generate_beam`` on the CPU against the JAX package's on the
same weights: equal tokens and best scores within 1e-5, on both decode
strategies, with ragged prompts, EOS freezing, a length penalty and
``return_scores``; its argument checks; and the refusal to drift onto
the CPU when no device is named."""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.generation import generate_beam as jax_beam
from distkeras_tpu.models.generation import generate_tokens as jax_generate
from distkeras_tpu_torch.models import Model, generate_beam
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ = 64, 64


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=2,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(5))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(9).integers(0, VOCAB, (3, 10)).astype(
        np.int32)


def _both(lm, prompt, steps, **kw):
    jm, v, tm = lm
    jout, jscore = jax_beam(jm, v, prompt, steps, return_scores=True, **kw)
    tout, tscore = generate_beam(tm, prompt, steps, return_scores=True,
                                 device="cpu", **kw)
    return (np.asarray(jout), np.asarray(jscore), tout.numpy(),
            tscore.numpy())


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("num_beams", [1, 4])
def test_beam_equals_jax(lm, prompts, use_cache, num_beams):
    jout, jscore, tout, tscore = _both(lm, prompts, 8, num_beams=num_beams,
                                       use_cache=use_cache)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_allclose(tscore, jscore, rtol=0, atol=1e-5)
    assert tout.shape == (3, 18) and tout.dtype == np.int64


def test_one_beam_is_greedy(lm, prompts):
    jm, v, tm = lm
    out = generate_beam(tm, prompts, 6, num_beams=1, device="cpu").numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_generate(
        jm, v, prompts, 6)))


@pytest.mark.parametrize("use_cache", [True, False])
def test_beam_ragged_prompts_equal_jax(lm, prompts, use_cache):
    lengths = [10, 4, 7]
    padded = prompts.copy()
    for row, n in enumerate(lengths):
        padded[row, n:] = 0
    jout, jscore, tout, tscore = _both(lm, padded, 6, num_beams=3,
                                       prompt_lengths=lengths,
                                       use_cache=use_cache)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_allclose(tscore, jscore, rtol=0, atol=1e-5)


@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
def test_beam_eos_and_length_penalty_equal_jax(lm, prompts,
                                               length_penalty):
    """An EOS the beams reach mid-run freezes them (score and length stop
    accumulating); the length penalty divides by the generated length."""
    jm, v, _ = lm
    greedy = np.asarray(jax_generate(jm, v, prompts, 8))[:, 10:]
    eos = int(greedy[0, 2])
    jout, jscore, tout, tscore = _both(lm, prompts, 8, num_beams=4,
                                       eos_id=eos,
                                       length_penalty=length_penalty)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_allclose(tscore, jscore, rtol=0, atol=1e-5)
    assert (tout[:, 10:] == eos).any()


def test_beam_arguments_are_checked(lm, prompts):
    _, _, tm = lm
    out, scores = generate_beam(tm, prompts, 0, return_scores=True,
                                device="cpu")
    np.testing.assert_array_equal(out.numpy(), prompts)
    assert scores.shape == (3,) and not scores.any()
    with pytest.raises(ValueError, match="num_beams"):
        generate_beam(tm, prompts, 4, num_beams=0, device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        generate_beam(tm, prompts, SEQ, device="cpu")
    with pytest.raises(ValueError, match="prompt_lengths"):
        generate_beam(tm, prompts, 4, prompt_lengths=[1, 2], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_beam(tm, prompts, 4)
