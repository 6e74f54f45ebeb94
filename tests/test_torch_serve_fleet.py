"""The port's serving fleet on the CPU, over loopback: ``ServeRouter``
routing (prefix affinity, then least-loaded under ``max_inflight``),
eviction that requeues to a survivor with exact accounting, no-survivor
rejection, fleet ``promote`` (atomic per engine, rolled forward to a
rejoining engine), a v1-pinned engine, the KV fabric (replication on a
forced spill, then a warm secondary; a chaos reset during ``kv_fetch``
absorbed; migration on a planned drain), the cross-package KV seam (a
JAX engine's ``kv_export`` document joins warm in a torch engine and the
reverse, a stale-version push refused both ways), and the router's
telemetry store.  Every served answer is held to the JAX package's
``generate_tokens`` on the same weights."""

import os
import time

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.generation import generate_tokens as jax_generate
from distkeras_tpu.obs import Registry as JRegistry
from distkeras_tpu.serve import DecodeEngine as JEngine
from distkeras_tpu.serve import ServeClient as JClient
from distkeras_tpu.serve import ServeConfig as JConfig
from distkeras_tpu.serve import ServeServer as JServer
from distkeras_tpu_torch.chaos import SocketFaults
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.serve import (DecodeEngine, RouterConfig,
                                       ServeClient, ServeConfig,
                                       ServeRouter, ServeServer)
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ, BLOCK = 64, 64, 8
CFG = dict(slots=2, max_queue=16, max_new_tokens=8,
           prefill_buckets=(16, 32), prefix_cache=True,
           prefix_cache_mb=8.0, prefix_block=BLOCK)


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=1,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(8))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def _model(lm, variables=None):
    jm, v, _ = lm
    model = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(model, v if variables is None else variables)
    return model


def _server(lm, max_wire_version=2, port=0, variables=None):
    eng = DecodeEngine(_model(lm, variables), ServeConfig(**CFG),
                       registry=Registry(), device="cpu").warmup()
    return ServeServer(eng, port=port,
                       max_wire_version=max_wire_version).start()


def _fleet(lm, n, **kw):
    return [_server(lm, **kw) for _ in range(n)]


def _router(servers, **cfg_kw):
    cfg_kw.setdefault("affinity_block", BLOCK)
    # the poller stays off the tests' critical path unless asked for
    cfg_kw.setdefault("stats_interval_s", 30.0)
    return ServeRouter([("127.0.0.1", s.port) for s in servers],
                       config=RouterConfig(**cfg_kw)).start()


def _stop_all(router, servers):
    router.stop()
    for s in servers:
        s.stop()


def _ref(lm, prompt, steps, variables=None):
    jm, v, _ = lm
    out = jax_generate(jm, v if variables is None else variables,
                       np.asarray(prompt, np.int32)[None, :], int(steps))
    return np.asarray(out)[0, len(prompt):]


def _prompt(rng, shared, tail=3):
    return np.concatenate([shared, rng.integers(0, VOCAB, tail)]).astype(
        np.int32)


def _wait_for(cond, what, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _v(snap, name):
    return snap[name]["value"]


def _exact(snap):
    return _v(snap, "serve.router.requests") == \
        _v(snap, "serve.router.completed") + \
        _v(snap, "serve.router.rejected")


def test_route_affinity_then_least_loaded_under_the_inflight_bound():
    router = ServeRouter([("127.0.0.1", 1), ("127.0.0.1", 2)],
                         config=RouterConfig(affinity_block=BLOCK,
                                             max_inflight=2))
    rng = np.random.default_rng(0)
    prompt = _prompt(rng, rng.integers(0, VOCAB, 2 * BLOCK))
    be0, affine = router._route(prompt)
    assert affine is False
    be1, affine = router._route(prompt)
    assert be1 is be0 and affine is True
    other, affine = router._route(_prompt(rng, rng.integers(0, VOCAB, 16)))
    assert other is not be0 and affine is False   # least-loaded spreads
    with router._lock:
        be0.inflight, other.inflight = 2, 0
    spill, affine = router._route(prompt)
    assert spill is other and affine is False
    with router._lock:
        be0.inflight = other.inflight = 0
    back, affine = router._route(prompt)
    assert back is be0 and affine is True          # the owner keeps it
    with router._lock:
        for be in router.backends:
            be.inflight = 2
    assert router._route(prompt) == (None, False)
    snap = router.registry.snapshot()
    assert _v(snap, "serve.router.affinity_hits") == 2
    assert _v(snap, "serve.router.affinity_misses") == 3


def test_affine_traffic_lands_warm_and_stats_merge(lm):
    rng = np.random.default_rng(1)
    groups = [rng.integers(0, VOCAB, 2 * BLOCK) for _ in range(2)]
    servers = _fleet(lm, 2)
    router = _router(servers, stats_interval_s=0.05)
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            for g in groups:
                for i in range(3):
                    p = _prompt(rng, g)
                    reply = client.generate(p, 5)
                    assert reply["ok"] and reply["warm"] is (i > 0)
                    np.testing.assert_array_equal(reply["tokens"],
                                                  _ref(lm, p, 5))
            st = client.stats()
        _wait_for(lambda: len(router.telemetry.summary()["sources"]) == 2
                  if router.telemetry else False, "telemetry sources")
        sources = router.telemetry.summary()["sources"]
    finally:
        _stop_all(router, servers)
    assert sorted(sources) == sorted(f"engine:127.0.0.1:{s.port}"
                                     for s in servers)
    assert [e["requests"] for e in st["engines"]] == [3, 3]
    stats = st["stats"]
    assert _v(stats, "serve.prefix.hits") == 4
    assert _v(stats, "serve.prefix.misses") == 2
    assert _v(stats, "serve.router.affinity_hits") == 4
    assert _exact(stats) and _v(stats, "jit.retraces") == 0


def test_eviction_requeues_to_a_survivor_with_exact_accounting(lm):
    rng = np.random.default_rng(2)
    shared = rng.integers(0, VOCAB, 2 * BLOCK)
    servers = _fleet(lm, 2)
    router = _router(servers)
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            assert client.generate(_prompt(rng, shared), 4)["ok"]
            victim = next(i for i, e in enumerate(client.stats()["engines"])
                          if e["requests"] == 1)
            # the engine dies; the router's idle connections to it are
            # closed first so the server's stop joins no handler blocked
            # in recv
            router.backends[victim].close_pool()
            servers[victim].stop()
            p1 = _prompt(rng, shared)
            reply = client.generate(p1, 4)
            assert reply["ok"], reply
            np.testing.assert_array_equal(reply["tokens"], _ref(lm, p1, 4))
            st = client.stats()
    finally:
        _stop_all(router, servers)
    stats = st["stats"]
    assert _v(stats, "serve.router.evictions") == 1
    assert _v(stats, "serve.router.requeues") == 1
    assert _v(stats, "serve.router.requests") == 2 and _exact(stats)
    assert st["engines_alive"] == 1


def test_no_survivor_rejects_with_a_recorded_rejection(lm):
    servers = _fleet(lm, 1)
    router = _router(servers)
    prompt = np.arange(6, dtype=np.int32)
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            assert client.generate(prompt, 4)["ok"]
            router.backends[0].close_pool()
            servers[0].stop()
            reply = client.generate(prompt, 4)
            assert reply["ok"] is False and reply["rejected"]
            # a malformed field is answered and counted too
            bad = client._rpc({"action": "generate", "prompt": prompt,
                               "max_new_tokens": "many"})
            assert bad["ok"] is False
            snap = router.registry.snapshot()
    finally:
        _stop_all(router, servers)
    assert _v(snap, "serve.router.rejected_no_backend") >= 1
    assert _v(snap, "serve.router.requests") == 3 and _exact(snap)


def test_fleet_promote_is_atomic_per_engine_then_rolls_forward(lm):
    """One ``promote`` through the front door (the JAX ``variables``
    tree): the live engines deploy, the dead one is named; when it comes
    back on its address with the old weights, the poller rejoins it and
    rolls the promote forward."""
    jm = lm[0]
    v_new = jax.tree_util.tree_map(np.asarray, jm.init(44))
    prompt = np.random.default_rng(3).integers(0, VOCAB, 6)
    servers = _fleet(lm, 3)
    router = _router(servers, stats_interval_s=0.05)
    down_port = servers[2].port
    try:
        servers[2].stop()
        with ServeClient("127.0.0.1", router.port) as client:
            reply = client.promote(v_new)
        assert reply["ok"] is False
        assert reply["promoted"] == 2 and reply["failed"] == 1
        assert [a for a, r in reply["engines"].items() if not r["ok"]] \
            == [f"127.0.0.1:{down_port}"]
        for srv in servers[:2]:
            with ServeClient("127.0.0.1", srv.port) as c:
                np.testing.assert_array_equal(
                    c.generate(prompt, 6)["tokens"],
                    _ref(lm, prompt, 6, v_new))
        servers[2] = _server(lm, port=down_port)
        _wait_for(lambda: router.registry.counter(
            "serve.router.promote_rollforwards").value >= 1,
            "roll-forward")
        assert router.registry.counter("serve.router.rejoins").value == 1
        with ServeClient("127.0.0.1", down_port) as c:
            np.testing.assert_array_equal(c.generate(prompt, 6)["tokens"],
                                          _ref(lm, prompt, 6, v_new))
    finally:
        _stop_all(router, servers)


def test_v1_pinned_engine_and_client_interop(lm):
    rng = np.random.default_rng(4)
    groups = [rng.integers(0, VOCAB, 2 * BLOCK) for _ in range(2)]
    servers = [_server(lm, max_wire_version=1), _server(lm)]
    router = _router(servers)
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            for g in groups:
                for _ in range(2):
                    p = _prompt(rng, g)
                    np.testing.assert_array_equal(
                        client.generate(p, 4)["tokens"], _ref(lm, p, 4))
            st = client.stats()
        with ServeClient("127.0.0.1", router.port, wire_version=1) as c1:
            p = rng.integers(0, VOCAB, 5)
            np.testing.assert_array_equal(c1.generate(p, 4)["tokens"],
                                          _ref(lm, p, 4))
    finally:
        _stop_all(router, servers)
    assert [e["requests"] for e in st["engines"]] == [2, 2]


def test_spill_replicates_then_the_secondary_serves_warm(lm):
    rng = np.random.default_rng(5)
    shared = rng.integers(0, VOCAB, 2 * BLOCK)
    servers = _fleet(lm, 2)
    router = _router(servers, max_inflight=2)
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            assert client.generate(_prompt(rng, shared), 4)["ok"]
            owner = next(b for b in router.backends if b.requests == 1)
            with router._lock:
                owner.inflight = 2       # the owner at its bound: spill
            p1 = _prompt(rng, shared)
            r1 = client.generate(p1, 4)
            assert r1["ok"] and r1["warm"] is False
            np.testing.assert_array_equal(r1["tokens"], _ref(lm, p1, 4))
            _wait_for(lambda: router.registry.counter(
                "serve.router.kv_replications").value == 1, "replication")
            p2 = _prompt(rng, shared)
            r2 = client.generate(p2, 4)
            assert r2["ok"] and r2["warm"] is True
            assert r2["engine"] == r1["engine"] != owner.addr
            np.testing.assert_array_equal(r2["tokens"], _ref(lm, p2, 4))
            with router._lock:
                owner.inflight = 0
            snap = router.registry.snapshot()
    finally:
        _stop_all(router, servers)
    assert _v(snap, "serve.router.affinity_secondary_hits") == 1
    assert snap["serve.router.ttft_spill_cold_seconds"]["count"] == 1
    assert snap["serve.router.ttft_spill_warm_seconds"]["count"] == 1
    assert _v(snap, "serve.router.kv_push_bytes") > 0
    assert _exact(snap)


def test_chaos_reset_during_kv_fetch_is_absorbed(lm):
    rng = np.random.default_rng(6)
    shared = rng.integers(0, VOCAB, 2 * BLOCK)
    servers = _fleet(lm, 2)
    router = _router(servers, max_inflight=2)
    fabric = router._kv_fabric
    try:
        p0 = _prompt(rng, shared)
        with ServeClient("127.0.0.1", router.port) as client:
            assert client.generate(p0, 4)["ok"]
        owner = next(b for b in router.backends if b.requests == 1)
        target = next(b for b in router.backends if b is not owner)
        key = router._affinity_keys(p0)[0]
        with SocketFaults({"send:kv_fetch_stream": [1]}) as faults:
            fabric._run_replicate(key, owner.idx, target.idx, p0)
        assert faults.injected == 1
        assert router.registry.counter(
            "serve.router.kv_replications").value == 0
        assert fabric._inflight_bytes == 0
        fabric._run_replicate(key, owner.idx, target.idx, p0)
        assert router.registry.counter(
            "serve.router.kv_replications").value == 1
        with ServeClient("127.0.0.1", servers[target.idx].port) as ct:
            p = _prompt(rng, shared)
            r = ct.generate(p, 4)
            assert r["warm"] is True
            np.testing.assert_array_equal(r["tokens"], _ref(lm, p, 4))
    finally:
        _stop_all(router, servers)


def test_planned_drain_migrates_hot_kv_then_drains(lm):
    rng = np.random.default_rng(7)
    groups = [rng.integers(0, VOCAB, 2 * BLOCK) for _ in range(2)]
    servers = _fleet(lm, 2)
    router = _router(servers)
    try:
        with ServeClient("127.0.0.1", router.port) as client:
            for g in groups:
                assert client.generate(_prompt(rng, g), 4)["ok"]
            victim = router.backends[0]
            out = client.drain(engine=victim.addr)
            assert out["ok"] and out["migrated"] >= 1 and out["drained"]
            for g in groups:
                p = _prompt(rng, g)
                r = client.generate(p, 4)
                assert r["warm"] is True and r["engine"] != victim.addr
                np.testing.assert_array_equal(r["tokens"], _ref(lm, p, 4))
            # scale back up: the parked engine rejoins
            assert client.undrain(engine=victim.addr)["ok"]
            snap = router.registry.snapshot()
    finally:
        _stop_all(router, servers)
    assert _v(snap, "serve.router.kv_migrations") >= 1
    assert _v(snap, "serve.router.rejoins") == 1
    assert _exact(snap)


def test_kv_documents_cross_packages_and_stale_pushes_are_refused(lm):
    """A JAX engine's exported entry joins a torch engine warm, and a
    torch engine's joins a JAX engine; after each importer's promote, the
    same documents stamped with the old version are refused as stale and
    the prompt cold-prefills under the new weights."""
    jm, v, _ = lm
    v_new = jax.tree_util.tree_map(np.asarray, jm.init(45))
    rng = np.random.default_rng(9)
    for direction in ("jax->torch", "torch->jax"):
        jax_srv = JServer(JEngine(jm, v, JConfig(**CFG),
                                  registry=JRegistry()).warmup()).start()
        torch_srv = _server(lm)
        src, dst = (jax_srv, torch_srv) if direction == "jax->torch" \
            else (torch_srv, jax_srv)
        prompt = rng.integers(0, VOCAB, 2 * BLOCK + 3)
        try:
            with ServeClient("127.0.0.1", src.port) as cs, \
                    JClient("127.0.0.1", dst.port) as cd:
                assert cs.generate(prompt, 4)["ok"]
                doc = cs.kv_fetch(prompt=prompt)
                assert doc["found"] and doc["version"] == 0
                r = cd.kv_push(doc["entries"], doc["version"])
                assert r["joined"] == 1 and r["refused"] == 0, r
                warm = cd.generate(prompt, 4)
                assert warm["warm"] is True
                np.testing.assert_array_equal(warm["tokens"],
                                              _ref(lm, prompt, 4))
                assert cd.promote(v_new)["ok"]
                _wait_for(lambda: dst.engine.kv_version == 1, "adoption")
                r = cd.kv_push(doc["entries"], doc["version"])
                assert r["joined"] == 0 and r["refused_stale"] == 1
                cold = cd.generate(prompt, 4)
                assert cold["warm"] is False
                np.testing.assert_array_equal(cold["tokens"],
                                              _ref(lm, prompt, 4, v_new))
                bad = cd.kv_push([{"host_tokens": prompt,
                                   "cache": {"not": "a cache"}}], 1)
                assert bad["joined"] == 0 and bad["refused"] == 1
        finally:
            jax_srv.stop()
            torch_srv.stop()
