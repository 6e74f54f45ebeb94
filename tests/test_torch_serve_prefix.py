"""The port's prefix KV cache on the CPU: ``PrefixCache`` against the JAX
package's under one sequence of operations (hits, evictions, bytes, the
aliases an eviction re-points), and the engine's warm joins — served
answers equal to cold joins and to the JAX package's ``generate_tokens``
on the same weights, the warm/cold TTFT split, eviction under budget
pressure, and ``promote()``'s flush and KV version bump."""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.generation import generate_tokens as jax_generate
from distkeras_tpu.obs import Registry as JRegistry
from distkeras_tpu.serve import prefix as jprefix
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.serve import DecodeEngine, ServeConfig
from distkeras_tpu_torch.serve import prefix as tprefix
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ, BLOCK = 64, 64, 8
BUCKETS = (8, 16, 32)              # resolved to (8, 16, 32, 64)


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=2,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(3))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def _engine(tm, registry, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("prefill_buckets", BUCKETS)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("prefix_cache_mb", 8.0)
    kw.setdefault("prefix_block", BLOCK)
    return DecodeEngine(tm, ServeConfig(**kw), registry=registry,
                        device="cpu").warmup()


def _ref(lm, prompt, steps, variables=None):
    jm, v, _ = lm
    out = jax_generate(jm, v if variables is None else variables,
                       np.asarray(prompt, np.int32)[None, :], int(steps))
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


# ---------------------------------------------------------------------------
# PrefixCache against the JAX package's
# ---------------------------------------------------------------------------

def _entry(mod, host):
    return mod.PrefixEntry(np.asarray(host, np.int32),
                           np.zeros((1, SEQ), np.int32),
                           {"k": np.zeros((SEQ, 4), np.float32),
                            "v": np.zeros((SEQ, 4), np.float32)})


@pytest.mark.parametrize("block", [4, 8])
def test_prefix_cache_matches_jax_under_one_operation_sequence(block):
    """Inserts (shared system prefixes, covered content, duplicates),
    lookups, peeks, ``hottest`` and a budget that forces evictions of
    alias owners: every outcome and counter equal in both packages."""
    rng = np.random.default_rng(block)
    system = rng.integers(0, VOCAB, 2 * block)
    contents = [np.concatenate([system, rng.integers(0, VOCAB, n)])
                for n in (3, 1, block, 5)]
    contents += [rng.integers(0, VOCAB, 3 * block), system, contents[0]]
    probes = [np.concatenate([system, rng.integers(0, VOCAB, 2)]),
              contents[2], system[:block + 1], rng.integers(0, VOCAB, 9),
              contents[4][:2 * block + 3], np.asarray([system[0]])]
    one = _entry(tprefix, contents[0]).nbytes
    caches = {}
    for name, mod, reg in (("jax", jprefix, JRegistry()),
                           ("torch", tprefix, Registry())):
        caches[name] = (mod, reg, mod.PrefixCache(3 * one + one // 2, reg,
                                                  block=block))
    outcomes = {}
    for name, (mod, reg, cache) in caches.items():
        seen = []
        for i, content in enumerate(contents):
            cache.insert(_entry(mod, content))
            for probe in probes[:i + 1]:
                hit = cache.lookup(probe)
                seen.append(None if hit is None else
                            (hit[0].host_tokens.tolist(), hit[1]))
                peek = cache.peek(probe)
                seen.append(None if peek is None else
                            (peek[0].host_tokens.tolist(), peek[1]))
            seen.append([e.host_tokens.tolist()
                         for e in cache.hottest(3, 10 * one)])
            seen.append((len(cache), cache.nbytes))
        snap = reg.snapshot()
        seen.append({k: snap[k]["value"] for k in sorted(snap)
                     if k.startswith("serve.prefix.")})
        seen.append(cache.flush())
        seen.append((len(cache), cache.nbytes))
        outcomes[name] = seen
    assert outcomes["torch"] == outcomes["jax"]
    counters = outcomes["torch"][-3]
    assert counters["serve.prefix.evictions"] >= 1
    assert counters["serve.prefix.hits"] >= 1


def test_tree_nbytes_counts_tensors_and_arrays():
    tree = [None, {"k": torch.zeros((1, SEQ, 2, 4)),
                   "v": np.zeros((1, SEQ, 2, 4), np.float32)}]
    assert tprefix.tree_nbytes(tree) == 2 * SEQ * 8 * 4
    assert tprefix.tree_nbytes(tree) == jprefix.tree_nbytes(
        [None, {"k": np.zeros((1, SEQ, 2, 4), np.float32),
                "v": np.zeros((1, SEQ, 2, 4), np.float32)}])


# ---------------------------------------------------------------------------
# the engine's warm joins
# ---------------------------------------------------------------------------

def test_warm_joins_equal_cold_joins_and_jax(lm):
    """Prompts sharing a block-aligned prefix warm-join over the cached
    KV: every answer equals the JAX package's ``generate_tokens`` and the
    same prompts served cold; the hit/miss counters and the TTFT split
    record each outcome; the suffix ladder holds ``jit.retraces == 0``."""
    _, _, tm = lm
    rng = np.random.default_rng(20)
    shared = rng.integers(0, VOCAB, 2 * BLOCK)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, n)])
               for n in (3, 5, 9, 20)]     # suffixes over three buckets
    reg = Registry()
    eng = _engine(tm, reg)
    compiles = _v(reg.snapshot(), "jit.compiles")
    assert compiles == 2 * 4 + 1           # joins + sjoins + the step
    with eng:
        warm = [eng.submit(p, 6).result(timeout=60) for p in prompts]
        # a fully cached prompt: the match caps at len - 1 and the last
        # token replays, regenerating its logits exactly
        again = eng.submit(prompts[0], 6).result(timeout=60)
    creg = Registry()
    with _engine(tm, creg, prefix_cache=False) as cold_eng:
        cold = [cold_eng.submit(p, 6).result(timeout=60) for p in prompts]
    for w, c, r in zip(warm, cold, _refs(lm, prompts, 6)):
        np.testing.assert_array_equal(w, r)
        np.testing.assert_array_equal(w, c)
    np.testing.assert_array_equal(again, warm[0])
    snap = reg.snapshot()
    assert _v(snap, "serve.prefix.misses") == 1
    assert _v(snap, "serve.prefix.hits") == 4
    assert _v(snap, "serve.prefix.inserts") == 4   # the resubmission dedups
    assert snap["serve.ttft_cold_seconds"]["count"] == 1
    assert snap["serve.ttft_warm_seconds"]["count"] == 4
    assert _v(snap, "jit.compiles") == compiles
    assert _v(snap, "jit.retraces") == 0
    csnap = creg.snapshot()
    assert _v(csnap, "serve.prefix.hits") == 0
    assert csnap["serve.ttft_cold_seconds"]["count"] == 0


def test_concurrent_warm_and_cold_joins_mid_decode(lm):
    """Warm joins into slots freed mid-decode, beside rows still
    decoding: answers stay exact."""
    _, _, tm = lm
    rng = np.random.default_rng(21)
    shared = rng.integers(0, VOCAB, BLOCK)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, n)])
               for n in (2, 7, 4, 11, 1)]
    news = [8, 2, 5, 3, 7]
    reg = Registry()
    with _engine(tm, reg) as eng:
        first = eng.submit(prompts[0], news[0]).result(timeout=60)
        reqs = [eng.submit(p, m) for p, m in zip(prompts[1:], news[1:])]
        got = [first] + [r.result(timeout=60) for r in reqs]
    for m, g, r in zip(news, got, _refs(lm, prompts, max(news))):
        np.testing.assert_array_equal(g, r[:m])
    snap = reg.snapshot()
    assert _v(snap, "serve.prefix.hits") == 4
    assert _v(snap, "jit.retraces") == 0


def test_lru_eviction_under_budget_pressure(lm):
    _, _, tm = lm
    rng = np.random.default_rng(22)
    reg = Registry()
    eng = _engine(tm, reg, prefix_cache_mb=0.09)
    entry_bytes = 2 * 2 * SEQ * 32 * 4 + SEQ * 4   # 2 blocks of K, V + row
    prompts = [rng.integers(0, VOCAB, 10) for _ in range(5)]
    with eng:
        for p in prompts:
            np.testing.assert_array_equal(eng.submit(p, 5).result(60),
                                          _ref(lm, p, 5))
    snap = reg.snapshot()
    assert _v(snap, "serve.prefix.inserts") == 5
    assert _v(snap, "serve.prefix.evictions") == 5 - int(
        0.09 * 1024 * 1024 // entry_bytes)
    assert _v(snap, "serve.prefix.bytes") <= 0.09 * 1024 * 1024
    assert _v(snap, "serve.prefix.bytes") == \
        _v(snap, "serve.prefix.entries") * entry_bytes


def test_promote_flushes_the_cache_and_bumps_the_kv_version(lm):
    jm, _, tm = lm
    v_new = jax.tree_util.tree_map(np.asarray, jm.init(42))
    new_model = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(new_model, v_new)
    model = Model.from_config(jm.config()).init(0, device="cpu")
    model.load_state_dict(tm.state_dict())
    prompt = np.random.default_rng(23).integers(0, VOCAB, 9)
    reg = Registry()
    with _engine(model, reg, prefix_block=4) as eng:
        before = eng.submit(prompt, 6).result(timeout=60)
        assert len(eng._prefix) == 1 and eng.kv_version == 0
        eng.promote(new_model.state_dict())
        assert len(eng._prefix) == 0           # flushed with the swap
        after = eng.submit(prompt, 6).result(timeout=60)
        assert eng.kv_version == 1             # bumped at adoption
    np.testing.assert_array_equal(before, _ref(lm, prompt, 6))
    np.testing.assert_array_equal(after, _ref(lm, prompt, 6, v_new))
    snap = reg.snapshot()
    assert _v(snap, "serve.prefix.misses") == 2   # no stale-KV hit
    assert _v(snap, "jit.retraces") == 0
