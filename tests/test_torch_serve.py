"""The port's continuous-batching ``DecodeEngine`` on the CPU: served
greedy answers against the JAX package's ``generate_tokens`` on the same
weights (the ground truth ``tests/test_serve.py`` holds the JAX engine
to), with prompts over every prefill bucket and requests joining
mid-decode; admission control; the zero-retrace contract after
``warmup()``; and the refusal to drift onto the CPU when no device is
named.  The accelerators' tests are ``tests/test_torch_serve_prefix.py``
and ``tests/test_torch_serve_spec.py``."""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.generation import generate_tokens as jax_generate
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.models.generation import generate_tokens
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig, ServeRejected
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ = 32, 64
BUCKETS = (8, 16, 32)          # resolved to (8, 16, 32, 64)


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=1,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(2))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def _engine(tm, registry, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("prefill_buckets", BUCKETS)
    return DecodeEngine(tm, ServeConfig(**kw), registry=registry,
                        device="cpu")


def test_served_answers_equal_jax_generate_tokens(lm):
    jm, v, tm = lm
    rng = np.random.default_rng(11)
    lengths = [5, 12, 30, 50, 3, 20]       # every bucket: 8, 16, 32, 64
    max_new = [8, 3, 6, 8, 2, 5]           # short ones free slots early
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32) for n in lengths]
    registry = Registry()
    engine = _engine(tm, registry).warmup()
    compiles = registry.counter("jit.compiles").value
    engine.start()
    try:
        # six requests on two slots: four join mid-decode as others retire
        reqs = [engine.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, max_new)]
        answers = [r.result(timeout=60) for r in reqs]
    finally:
        engine.stop()
    # one ragged JAX batch is the offline reference for every prompt
    padded = np.zeros((len(prompts), max(lengths)), np.int32)
    for row, p in enumerate(prompts):
        padded[row, :len(p)] = p
    ref = np.asarray(jax_generate(jm, v, padded, max(max_new),
                                  prompt_lengths=lengths))
    for row, (p, m, got) in enumerate(zip(prompts, max_new, answers)):
        np.testing.assert_array_equal(got, ref[row, len(p):len(p) + m])
    snap = registry.snapshot()
    assert snap["serve.joins"]["value"] == 6
    assert snap["serve.completed"]["value"] == 6
    assert snap["serve.tokens_out"]["value"] == sum(max_new)
    assert snap["jit.retraces"]["value"] == 0
    assert compiles == len(BUCKETS) + 2          # 4 joins + the step
    assert snap["jit.compiles"]["value"] == compiles


def test_sampled_requests_share_the_batch(lm):
    _, _, tm = lm
    registry = Registry()
    engine = _engine(tm, registry, seed=3).warmup().start()
    try:
        greedy = engine.submit(np.arange(6), max_new_tokens=6)
        sampled = engine.submit(np.arange(9), max_new_tokens=6,
                                temperature=0.8, top_k=5, top_p=0.9)
        g, s = greedy.result(timeout=60), sampled.result(timeout=60)
    finally:
        engine.stop()
    ref = generate_tokens(tm, np.arange(6)[None], 6, device="cpu")
    np.testing.assert_array_equal(g, ref[0, 6:].numpy())
    assert s.shape == (6,) and ((0 <= s) & (s < VOCAB)).all()
    assert registry.counter("jit.retraces").value == 0


def test_admission_rejections_are_counted(lm):
    _, _, tm = lm
    registry = Registry()
    engine = _engine(tm, registry, max_queue=2)   # never started
    queued = [engine.submit(np.arange(4)) for _ in range(2)]
    with pytest.raises(ServeRejected, match="queue full"):
        engine.submit(np.arange(4))
    assert not engine.drain(timeout=0.05)
    with pytest.raises(ServeRejected, match="draining"):
        engine.submit(np.arange(4))
    engine.stop(drain=False)
    for req in queued:
        with pytest.raises(ServeRejected, match="aborted"):
            req.result(timeout=1)
    snap = registry.snapshot()
    assert snap["serve.rejected_queue_full"]["value"] == 1
    assert snap["serve.rejected_draining"]["value"] == 1
    assert snap["serve.rejected_aborted"]["value"] == 2
    assert snap["serve.rejected"]["value"] == 4
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit(np.arange(4), max_new_tokens=9)


def test_promote_validates_and_swaps_weights(lm):
    _, _, tm = lm
    model = Model.from_config(tm.config()).init(5, device="cpu")
    engine = _engine(model, Registry()).warmup()
    bad = {k: v[..., :1] for k, v in tm.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        engine.promote(bad)
    engine.promote(tm.state_dict())
    engine.start()
    try:
        got = engine.submit(np.arange(7), max_new_tokens=4).result(timeout=60)
    finally:
        engine.stop()
    ref = generate_tokens(tm, np.arange(7)[None], 4, device="cpu")
    np.testing.assert_array_equal(got, ref[0, 7:].numpy())


def test_no_device_and_no_card_raises(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    _, _, tm = lm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tm, ServeConfig(prefill_buckets=BUCKETS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_tokens(tm, np.arange(4)[None], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.gpt_lm(vocab_size=VOCAB, dim=16, num_blocks=1,
                   seq_len=SEQ).init(0)
