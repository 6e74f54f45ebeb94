"""The port's generation (``distkeras_tpu_torch.models.generation``)
against the JAX package's on the same weights: greedy ``generate_tokens``
token for token (uniform and ragged prompts, with and without ``eos_id``,
KV-cached and full recompute), the per-row sampling filters and
distributions at 1e-6, and the exact argmax of greedy rows when
sampling."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import generation as jg
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu_torch.models import Model, generation as tg
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ, STEPS = 32, 48, 10


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=2,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(1))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def _prompts():
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, VOCAB, (3, 14)).astype(np.int32)
    lengths = np.array([14, 9, 5], np.int32)
    for row, n in enumerate(lengths):
        prompt[row, n:] = 0          # right padding
    return prompt, lengths


CASES = [(ragged, cache, eos) for ragged in (False, True)
         for cache in (True, False) for eos in (False, True)]


@pytest.mark.parametrize("ragged,use_cache,with_eos", CASES)
def test_greedy_tokens_equal_jax(lm, ragged, use_cache, with_eos):
    jm, v, tm = lm
    prompt, lengths = _prompts()
    kw = {"use_cache": use_cache}
    if ragged:
        kw["prompt_lengths"] = lengths
    if with_eos:
        # the token the greedy continuation of row 0 emits third: every
        # row that reaches it freezes there
        free = tg.generate_tokens(tm, prompt, STEPS, device="cpu", **kw)
        kw["eos_id"] = int(free[0, prompt.shape[1] + 2])
    ref = np.asarray(jg.generate_tokens(jm, v, prompt, STEPS, **kw))
    out = tg.generate_tokens(tm, prompt, STEPS, device="cpu", **kw)
    assert out.dtype == torch.long and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_zero_steps_and_validation(lm):
    _, _, tm = lm
    prompt, _ = _prompts()
    out = tg.generate_tokens(tm, prompt, 0, device="cpu")
    np.testing.assert_array_equal(out.numpy(), prompt)
    with pytest.raises(ValueError, match="seq_len"):
        tg.generate_tokens(tm, prompt, SEQ, device="cpu")
    with pytest.raises(ValueError, match="prompt_lengths"):
        tg.generate_tokens(tm, prompt, 2, device="cpu",
                           prompt_lengths=[1, 2])


def _sampling_inputs():
    rng = np.random.default_rng(3)
    logits = (3 * rng.normal(size=(4, 40))).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    top_k = np.array([0, 3, 7, 0], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.7], np.float32)
    return logits, temp, top_k, top_p


def test_filter_logits_rowwise_matches_jax():
    logits, _, top_k, top_p = _sampling_inputs()
    ref = np.asarray(jg.filter_logits_rowwise(jnp.asarray(logits), top_k,
                                              top_p))
    out = tg.filter_logits_rowwise(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_rowwise_dist_matches_jax():
    logits, temp, top_k, top_p = _sampling_inputs()
    ref = np.asarray(jg.rowwise_dist(jnp.asarray(logits), temp, top_k,
                                     top_p))
    out = tg.rowwise_dist(torch.from_numpy(logits), temp, top_k, top_p)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_sample_rowwise_greedy_rows_take_exact_argmax():
    logits, temp, top_k, top_p = _sampling_inputs()
    temp = np.array([0.0, 0.9, 0.0, 1.0], np.float32)
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits)
    dist = tg.rowwise_dist(t, temp, top_k, top_p)
    for _ in range(5):
        out = tg.sample_rowwise(gen, t, temp, top_k, top_p)
        assert out[0] == int(np.argmax(logits[0]))
        assert out[2] == int(np.argmax(logits[2]))
        # sampled rows only ever draw tokens their distribution allows
        assert dist[1, out[1]] > 0 and dist[3, out[3]] > 0


def test_decode_window_matches_jax(lm):
    jm, v, tm = lm
    prompt, _ = _prompts()
    buf = np.zeros((3, SEQ), np.int32)
    buf[:, :14] = prompt
    window = np.random.default_rng(5).integers(0, VOCAB, (3, 4)).astype(
        np.int32)
    params, state = v["params"], v["state"]
    _, jcache = jax.jit(jm.layer.apply_prefill)(
        params, state, jnp.asarray(buf), jm.layer.init_cache(3, jm.input_shape))
    ref, _ = jax.jit(lambda c, start: jg.decode_window(
        jm.layer, params, state, jnp.asarray(window), c, start, limit=SEQ))(
        jcache, jnp.asarray([14, 9, 5]))
    with torch.no_grad():
        _, tcache = tm.layer.apply_prefill(
            torch.from_numpy(buf).long(),
            tm.layer.init_cache(3, tm.input_shape))
        out, _ = tg.decode_window(tm.layer, torch.from_numpy(window).long(),
                                  tcache, torch.tensor([14, 9, 5]),
                                  limit=SEQ)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_write_at_skips_positions_past_the_end():
    buf = torch.zeros((3, 4), dtype=torch.long)
    tg._write_at(buf, torch.tensor([7, 8, 9]), torch.tensor([0, 4, 3]), 4,
                 keep=torch.tensor([True, True, False]))
    assert buf.tolist() == [[7, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    tg._write_at(buf, torch.tensor([1, 2, 3]), 2, 4)
    assert buf[:, 2].tolist() == [1, 2, 3]
