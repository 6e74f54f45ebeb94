"""The port's speculative decoding on the CPU: greedy answers equal to the
JAX package's ``generate_tokens`` at both ends of draft quality, across
prefill buckets, with EOS mid-window and composed with the prefix cache;
the sampled path's deterministic probes (top-k 1 is greedy, a self-draft
accepts everything); and a statistical test that the first token the
spec step emits is distributed as the target's own ``rowwise_dist``,
with a draft that disagrees with it.  The JAX package samples with
``jax.random``, so sampled runs are compared by distribution, never draw
by draw."""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.generation import generate_tokens as jax_generate
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.models.generation import _model_cache, rowwise_dist
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig
from distkeras_tpu_torch.serve.spec import build_spec_step
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ = 64, 64
BUCKETS = (8, 16, 32)


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=1,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(4))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    draft = zoo.draft_lm(tm, dim=16, num_heads=2, num_blocks=1).init(
        7, device="cpu")
    return jm, v, tm, draft


def _engine(tm, draft, registry, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_queue", 8)
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("prefill_buckets", BUCKETS)
    return DecodeEngine(tm, ServeConfig(**kw), registry=registry,
                        device="cpu", draft_model=draft).warmup()


def _ref(lm, prompt, steps):
    jm, v = lm[:2]
    out = jax_generate(jm, v, np.asarray(prompt, np.int32)[None, :],
                       int(steps))
    return np.asarray(out)[0, len(prompt):]


def _refs(lm, prompts, steps):
    """JAX ``generate_tokens`` continuations of ``prompts`` from ONE
    ragged batch (one compiled program for the lot)."""
    jm, v = lm[:2]
    lengths = [len(p) for p in prompts]
    padded = np.zeros((len(prompts), max(lengths)), np.int32)
    for row, p in enumerate(prompts):
        padded[row, :len(p)] = p
    out = np.asarray(jax_generate(jm, v, padded, int(steps),
                                  prompt_lengths=lengths))
    return [out[row, n:n + int(steps)] for row, n in enumerate(lengths)]


def _v(snap, name):
    return snap[name]["value"]


@pytest.mark.parametrize("which,lo,hi", [("self", 0.99, 1.0),
                                         ("narrow", 0.0, 0.5)])
def test_spec_greedy_parity_across_buckets(lm, which, lo, hi):
    """Greedy spec answers equal ``generate_tokens`` at a self-draft
    (every window accepted) and at an independent narrow draft (windows
    rejected early), prompts over every bucket, two rows decoding at
    once; ``jit.retraces == 0``."""
    _, _, tm, narrow = lm
    draft = tm if which == "self" else narrow
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, VOCAB, n) for n in (3, 8, 17, 40)]
    reg = Registry()
    with _engine(tm, draft, reg, spec_k=3) as eng:
        reqs = [eng.submit(p, 10) for p in prompts]
        got = [r.result(timeout=60) for r in reqs]
    for g, r in zip(got, _refs(lm, prompts, 10)):
        np.testing.assert_array_equal(g, r)
    snap = reg.snapshot()
    rate = _v(snap, "serve.spec.accept_rate")
    assert lo <= rate <= hi, rate
    assert _v(snap, "serve.spec.proposed") > 0
    assert _v(snap, "serve.tokens_out") == 40
    assert _v(snap, "jit.retraces") == 0


def test_spec_eos_mid_window_stops_exactly(lm):
    _, _, tm, _ = lm
    for seed in range(16):
        prompt = np.random.default_rng(seed).integers(0, VOCAB, 5)
        full = _ref(lm, prompt, 8)
        eos = int(full[1])              # inside the first k = 3 window
        if eos != int(full[0]):
            break
    else:
        pytest.skip("every probed continuation repeats its 2nd token")
    reg = Registry()
    with _engine(tm, tm, reg, spec_k=3, eos_id=eos) as eng:
        got = eng.submit(prompt, 8).result(timeout=60)
    assert list(got) == list(full[:2])
    assert _v(reg.snapshot(), "serve.tokens_out") == 2


def test_spec_composes_with_the_prefix_cache(lm):
    """A warm suffix join fills the draft's cache beside the target's;
    the speculative decode that follows stays greedy-exact."""
    _, _, tm, narrow = lm
    rng = np.random.default_rng(24)
    shared = rng.integers(0, VOCAB, 8)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, n)])
               for n in (3, 4, 12)]
    refs = _refs(lm, prompts, 8)
    for draft, rate_lo in ((tm, 0.99), (narrow, 0.0)):
        reg = Registry()
        with _engine(tm, draft, reg, spec_k=2, prefix_cache=True,
                     prefix_cache_mb=8.0, prefix_block=8) as eng:
            for p, r in zip(prompts, refs):
                np.testing.assert_array_equal(
                    eng.submit(p, 8).result(timeout=60), r)
        snap = reg.snapshot()
        assert _v(snap, "serve.prefix.hits") == 2
        assert _v(snap, "serve.spec.accept_rate") >= rate_lo
        assert _v(snap, "jit.retraces") == 0


def test_spec_sampling_with_top_k_1_is_greedy(lm):
    """top_k = 1 leaves one candidate: the sampled accept/reject path
    (draft draws from q, target accepts against p, residual on
    rejection) must reproduce the argmax chain exactly."""
    _, _, tm, narrow = lm
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, VOCAB, n) for n in (4, 9)]
    refs = _refs(lm, prompts, 8)
    for draft in (tm, narrow):
        reg = Registry()
        with _engine(tm, draft, reg, spec_k=3) as eng:
            for p, r in zip(prompts, refs):
                got = eng.submit(p, 8, temperature=0.9,
                                 top_k=1).result(timeout=60)
                np.testing.assert_array_equal(got, r)
        assert _v(reg.snapshot(), "jit.retraces") == 0


def test_spec_sampling_self_draft_accepts_everything(lm):
    """With the draft == the target, q == p, so ``u·q(x) <= p(x)`` holds
    for every proposal: accept rate 1.0 at temperature > 0, beside a
    greedy row that stays exact."""
    _, _, tm, _ = lm
    rng = np.random.default_rng(26)
    greedy_p, hot_p = rng.integers(0, VOCAB, 5), rng.integers(0, VOCAB, 6)
    reg = Registry()
    with _engine(tm, tm, reg, spec_k=3) as eng:
        hot = eng.submit(hot_p, 9, temperature=1.0, top_p=0.9)
        greedy = eng.submit(greedy_p, 9)
        got_hot, got_greedy = hot.result(60), greedy.result(60)
    np.testing.assert_array_equal(got_greedy, _ref(lm, greedy_p, 9))
    assert got_hot.shape == (9,) and ((got_hot >= 0)
                                      & (got_hot < VOCAB)).all()
    snap = reg.snapshot()
    assert _v(snap, "serve.spec.accept_rate") == 1.0
    assert _v(snap, "jit.retraces") == 0


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 0.9),
                                              (0.7, 12, 1.0)])
def test_spec_sampling_preserves_the_target_distribution(lm, temp, top_k,
                                                         top_p):
    """The speculative-sampling identity: the first token one spec step
    emits is distributed as ``rowwise_dist`` of the target's carried
    logits, whatever the draft proposes.  One step over 4096 identical
    sampled rows (the narrow draft disagrees with the target, so
    rejections and residual draws happen) plus a greedy row; the
    empirical distribution is held to the target's by total variation
    and by a chi-square statistic."""
    _, _, tm, draft = lm
    b, k, plen = 4097, 3, 6
    prompt = torch.as_tensor(np.random.default_rng(27).integers(
        0, VOCAB, plen))
    buf = torch.zeros((b, SEQ), dtype=torch.long)
    buf[:, :plen] = prompt
    with torch.no_grad():
        y, cache = tm.layer.apply_prefill(buf, _model_cache(tm, b))
        dy, dcache = draft.layer.apply_prefill(buf, _model_cache(draft, b))
        logits, dlogits = y[:, plen - 1], dy[:, plen - 1]
        pos = torch.full((b,), plen, dtype=torch.long)
        active = torch.ones((b,), dtype=torch.bool)
        tv = torch.full((b,), temp)
        tv[-1] = 0.0                            # the greedy row
        tk = torch.full((b,), top_k, dtype=torch.long)
        tp = torch.full((b,), top_p)
        gen = torch.Generator().manual_seed(5)
        step = build_spec_step(tm, draft, k)
        out = step(buf, cache, dcache, pos, logits, dlogits, active, tv,
                   tk, tp, gen, True)
        emitted, counts = out[5], out[6]
        want = rowwise_dist(logits[:1], tv[:1], tk[:1], tp[:1])[0].numpy()
    assert int(emitted[-1, 0]) == int(torch.argmax(logits[-1]))
    n = b - 1
    freq = np.bincount(emitted[:-1, 0].numpy(), minlength=VOCAB) / n
    tv_dist = 0.5 * np.abs(freq - want).sum()
    assert tv_dist < 0.05, tv_dist
    mask = want * n >= 5
    assert freq[want == 0].sum() == 0       # nothing outside the filter
    chi2 = float((((freq[mask] - want[mask]) * n) ** 2
                  / (want[mask] * n)).sum())
    # the 0.999 quantile of chi-square with 63 degrees of freedom is 103
    assert chi2 < 110, chi2
    assert 1 <= int(counts.min()) and int(counts.max()) <= k + 1
    # the narrow draft disagrees: not every window was accepted
    assert float(counts[:-1].float().mean()) < k + 1


def test_spec_needs_a_compatible_draft(lm):
    _, _, tm, draft = lm
    cfg = dict(prefill_buckets=BUCKETS, max_new_tokens=12)
    with pytest.raises(ValueError, match="draft model"):
        DecodeEngine(tm, ServeConfig(spec_k=2, **cfg), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        DecodeEngine(tm, ServeConfig(**cfg), device="cpu",
                     draft_model=draft)
    wrong = zoo.gpt_lm(vocab_size=VOCAB + 1, dim=16, num_heads=2,
                       num_blocks=1, seq_len=SEQ).init(0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        DecodeEngine(tm, ServeConfig(spec_k=2, **cfg), device="cpu",
                     draft_model=wrong)
