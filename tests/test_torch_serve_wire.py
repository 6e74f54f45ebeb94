"""The port's ``ServeServer`` and ``ServeClient`` on the CPU, over loopback,
against the JAX package's: a torch client drives a JAX server and a JAX
client drives a torch server with equal answers (greedy, and sampled
with ``top_k`` 1), each on both wire versions; v1/v2 interop; load
shedding, malformed fields answered on the same connection, a
``promote`` that carries the JAX ``variables`` tree, ``kv_fetch`` /
``kv_push`` documents, and the graceful drain."""

import os
import threading

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
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.serve import (DecodeEngine, ServeClient,
                                       ServeConfig, ServeServer)
from distkeras_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_racecheck import racecheck_module

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

#: the port's race checker over this file's PS / fleet threads
_port_racecheck = racecheck_module()

VOCAB, SEQ = 64, 64
CFG = dict(slots=2, max_queue=8, max_new_tokens=8,
           prefill_buckets=(16, 32), prefix_cache=True,
           prefix_cache_mb=8.0, prefix_block=8)


@pytest.fixture(scope="module")
def lm():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=1,
                     seq_len=SEQ, attention_impl="flash")
    v = jax.tree_util.tree_map(np.asarray, jm.init(6))
    tm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, tm


def _torch_server(tm, max_wire_version=2, **kw):
    model = Model.from_config(tm.config()).init(0, device="cpu")
    model.load_state_dict(tm.state_dict())
    eng = DecodeEngine(model, ServeConfig(**{**CFG, **kw}),
                       registry=Registry(), device="cpu").warmup()
    return ServeServer(eng, max_wire_version=max_wire_version).start()


@pytest.fixture(scope="module")
def servers(lm):
    jm, v, tm = lm
    jeng = JEngine(jm, v, JConfig(**CFG), registry=JRegistry()).warmup()
    pair = {"jax": JServer(jeng).start(), "torch": _torch_server(tm)}
    yield pair
    for srv in pair.values():
        srv.stop()


def _ref(lm, prompt, steps, variables=None):
    jm, v, _ = lm
    out = jax_generate(jm, v if variables is None else variables,
                       np.asarray(prompt, np.int32)[None, :], int(steps))
    return np.asarray(out)[0, len(prompt):]


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")])
@pytest.mark.parametrize("wire", [1, None])
def test_clients_drive_servers_across_packages(lm, servers, client_pkg,
                                               server_pkg, wire):
    cls = ServeClient if client_pkg == "torch" else JClient
    rng = np.random.default_rng(len(client_pkg) + 7 * (wire or 2)
                                + 3 * len(server_pkg))
    shared = rng.integers(0, VOCAB, 8)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, n)])
               for n in (3, 6)]
    with cls("127.0.0.1", servers[server_pkg].port,
             wire_version=wire) as c:
        assert c.wire_version == (1 if wire == 1 else 2)
        for p in prompts:
            reply = c.generate(p, 6)
            assert reply["ok"], reply
            np.testing.assert_array_equal(reply["tokens"], _ref(lm, p, 6))
            assert reply["warm"] in (True, False)
            assert {"e2e_s", "queue_wait_s", "ttft_s"} <= set(reply)
        # a sampled request with one candidate is still the argmax chain
        reply = c.generate(prompts[0], 6, temperature=0.8, top_k=1)
        np.testing.assert_array_equal(reply["tokens"],
                                      _ref(lm, prompts[0], 6))
        stats = c.stats()
        assert stats["server"] == "ServeServer"
        assert stats["slots"] == 2 and stats["seq_len"] == SEQ
        assert stats["prefill_buckets"] == [16, 32, 64]
        assert stats["stats"]["serve.prefix.hits"]["value"] >= 1


def test_malformed_fields_are_answered_and_sheds_are_counted(lm):
    _, _, tm = lm
    srv = _torch_server(tm, max_queue=1)
    try:
        with ServeClient("127.0.0.1", srv.port) as c:
            assert "prompt" in c._rpc({"action": "generate"})["error"]
            bad = c._rpc({"action": "generate", "prompt": np.arange(4),
                          "max_new_tokens": 99})
            assert not bad["ok"] and "max_new_tokens" in bad["error"]
            bad = c._rpc({"action": "generate", "prompt": np.arange(4),
                          "temperature": "hot"})
            assert not bad["ok"] and "error" in bad
            assert "unknown action" in c._rpc({"action": "nope"})["error"]
            assert not c.promote({"params": [], "state": []})["ok"]
            assert "version" in c._rpc({"action": "kv_push",
                                        "entries": [{}]})["error"]
            refused = c.kv_push([{"host_tokens": np.arange(3)}], 0)
            assert refused["joined"] == 0 and refused["refused"] == 1
            assert not c._rpc({"action": "kv_fetch"})["ok"]
            # the connection survived every bad request
            assert c.generate(np.arange(5), 3)["ok"]
            # load shedding: a drained engine refuses, and counts it
            assert c.drain(timeout_s=5)["drained"]
            shed = c.generate(np.arange(5), 3)
            assert shed == {"ok": False, "rejected": True,
                            "reason": "draining"}
            assert c.undrain()["was_draining"]
            assert c.generate(np.arange(5), 3)["ok"]
            snap = c.stats()["stats"]
        assert snap["serve.rejected_draining"]["value"] == 1
    finally:
        srv.stop()


def test_queue_full_sheds_with_a_recorded_rejection(lm):
    _, _, tm = lm
    srv = _torch_server(tm, slots=1, max_queue=1)
    replies = []
    try:
        def call():
            with ServeClient("127.0.0.1", srv.port) as c:
                replies.append(c.generate(np.arange(6), 8))
        threads = [threading.Thread(target=call) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        snap = srv.registry.snapshot()
    finally:
        srv.stop()
    shed = [r for r in replies if not r["ok"]]
    assert len(replies) == 6 and all(r["ok"] or r["reason"] == "queue full"
                                     for r in replies)
    assert snap["serve.rejected_queue_full"]["value"] == len(shed)
    assert snap["serve.completed"]["value"] == 6 - len(shed)


def test_promote_over_the_wire_carries_the_jax_tree(lm):
    """A JAX client promotes a JAX ``variables`` tree into a torch server
    (v1 and v2 frames): the served answers become the new weights'
    ``generate_tokens``, and the prefix cache is flushed."""
    jm, _, tm = lm
    v_new = jax.tree_util.tree_map(np.asarray, jm.init(43))
    prompt = np.random.default_rng(3).integers(0, VOCAB, 11)
    for wire in (1, None):
        srv = _torch_server(tm)
        try:
            with JClient("127.0.0.1", srv.port, wire_version=wire) as c:
                before = c.generate(prompt, 6)["tokens"]
                reply = c.promote(v_new)
                assert reply == {"ok": True, "promotions": 1}
                after = c.generate(prompt, 6)
            assert after["warm"] is False    # flushed: no stale-KV hit
        finally:
            srv.stop()
        np.testing.assert_array_equal(before, _ref(lm, prompt, 6))
        np.testing.assert_array_equal(after["tokens"],
                                      _ref(lm, prompt, 6, v_new))


def test_kv_fetch_documents_have_the_jax_layout(lm, servers):
    """``kv_fetch`` from a torch server and from a JAX server, on both
    wire versions: the same keys, token row and leaf shapes and dtypes,
    and the same KV values at the entry's positions."""
    prompt = np.random.default_rng(4).integers(0, VOCAB, 20)
    docs = {}
    for pkg, srv in servers.items():
        for wire in (1, None):
            with ServeClient("127.0.0.1", srv.port, wire_version=wire) as c:
                assert c.generate(prompt, 2)["ok"]
                doc = c.kv_fetch(prompt=prompt)
            assert doc["ok"] and doc["found"] and doc["version"] == 0
            docs[pkg, wire] = doc["entries"][0]
    ref = docs["jax", None]
    for key, entry in docs.items():
        assert set(entry) == {"host_tokens", "cache"}
        np.testing.assert_array_equal(entry["host_tokens"], prompt)
        assert entry["host_tokens"].dtype == np.int32
        got = jax.tree_util.tree_leaves(entry["cache"])
        want = jax.tree_util.tree_leaves(ref["cache"])
        assert [(g.shape, g.dtype) for g in got] == \
            [(w.shape, w.dtype) for w in want] == \
            [((1, SEQ, 2, 16), np.float32)] * 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[:, :20], w[:, :20], atol=1e-5)


def test_graceful_stop_completes_in_flight_requests(lm):
    _, _, tm = lm
    srv = _torch_server(tm)
    replies = []

    def call(n):
        with ServeClient("127.0.0.1", srv.port) as c:
            replies.append(c.generate(np.arange(n), 8))
    threads = [threading.Thread(target=call, args=(n,)) for n in (5, 9, 13)]
    for t in threads:
        t.start()
    # every request in flight (submitted to the engine) before the stop:
    # a client still dialing when the listener closes is refused, which
    # is the stop's contract for new connections, not a dropped request
    deadline = 30.0
    while srv.engine._c_requests.value < 3 and deadline > 0:
        threading.Event().wait(0.01)
        deadline -= 0.01
    srv.stop(drain=True)
    for t in threads:
        t.join(30)
    assert len(replies) == 3
    snap = srv.registry.snapshot()
    done = sum(r["ok"] for r in replies)
    assert snap["serve.completed"]["value"] == done
    assert done + snap["serve.rejected"]["value"] == 3
    assert all(r["ok"] or r.get("rejected") for r in replies)
