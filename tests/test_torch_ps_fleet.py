"""The port's async fleet on the CPU: two thread workers, faults and
elasticity, PS checkpoints and exact resume, and process workers.

* Two thread workers of DOWNPOUR: every window commits once, the loss
  falls, and under the JAX package's chaos schedules (a reset on the
  third commit send; a fault injector dropping every third commit) the
  accounting identity ``requests == applied + dropped + tombstoned``
  holds with the same counts as the JAX package's run.
* A stalled worker (``chaos.ThreadStall``) is evicted past
  ``heartbeat_hard_s`` and respawned at its committed window; its late
  commit tombstones.  ``add_worker()`` joins a worker into the live run.
* ``checkpoint_dir`` + ``train(resume=True)``: a PS checkpoint written
  by either package resumes in either, each worker at its
  ``commits_by_worker`` window (one worker: deterministic, held within
  the sync trainers' bound of the JAX resume).
* Two process workers (``async_workers="processes"``) train on the CPU,
  and their launch-count records fold into the parent's.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu import chaos as jchaos
from distkeras_tpu.data.transformers import OneHotTransformer as JaxOneHot
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import chaos
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.ps import workers as workers_mod
from distkeras_tpu_torch.utils import load_jax_variables
from tests.test_torch_racecheck import racecheck_module

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

#: the port's race checker over this file's PS / fleet threads
_port_racecheck = racecheck_module()

#: 512 rows over 2 workers at batch 32 and window 4: 2 windows a worker
#: an epoch, 8 commits in 2 epochs
COMMON = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", num_epoch=2, batch_size=32,
              learning_rate=0.05, communication_window=4, mode="async")


def _val(snap, name):
    return snap.get(name, {}).get("value", 0)


def _accounting(snap) -> dict:
    counts = {k: _val(snap, f"ps.{k}") for k in (
        "commit_requests", "commits", "commits_dropped",
        "commits_tombstoned", "evictions", "respawns", "joins")}
    assert counts["commit_requests"] == counts["commits"] + \
        counts["commits_dropped"] + counts["commits_tombstoned"]
    return counts


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def _toy(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(n, 3)), axis=-1)
    return x, y


@pytest.fixture(scope="module")
def data():
    x, y = _toy()
    jds = JaxOneHot(3, "label", "label_onehot").transform(
        dk.Dataset({"features": x, "label": y}))
    pds = OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))
    return jds, pds


def _jax_mlp():
    return dk.Model(JaxSequential([JaxDense(32, "relu"),
                                   JaxDense(3, "softmax")]), input_shape=(10,))


def _port_mlp(jm=None):
    """The port's MLP; with ``jm`` its ``init`` loads the JAX init."""
    jm = jm or _jax_mlp()
    model = Model.from_config(jm.config())
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jm.init(seed)))
        return model
    model.init = init
    return model


# ---------------------------------------------------------------------------
# two thread workers, under the JAX package's fault schedules
# ---------------------------------------------------------------------------

def test_two_thread_workers_commit_every_window_and_learn(data):
    t = dkt.DOWNPOUR(_port_mlp(), "sgd", num_workers=2, device="cpu",
                     **COMMON)
    t.train(data[1])
    assert t.ps_stats["num_updates"] == 8
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    hist = t.get_history()
    assert [h.shape for h in hist] == [(2, 8), (2, 8)]
    assert np.mean(hist[1]) < np.mean(hist[0])
    counts = _accounting(t.ps_stats["registry"])
    assert counts["commit_requests"] == 8
    epochs = [r for r in t.metrics.records if r["event"] == "epoch"]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert any(r["event"] == "ps_stats" for r in t.metrics.records)


def _reset_run(pkg, chaos_mod, model, ds):
    t = pkg.DOWNPOUR(model, "sgd", num_workers=2,
                     **COMMON, **({"device": "cpu"} if pkg is dkt else {}))
    with chaos_mod.SocketFaults({"send:commit": [3]}) as faults:
        t.train(ds)
    return faults.injected, t


def test_commit_reset_respawns_with_the_jax_packages_counts(data):
    """A reset on the third commit send kills that worker's incarnation
    (commits never auto-retry); the supervisor respawns it at its
    committed window.  Counts equal the JAX package's run."""
    jinj, jt = _reset_run(dk, jchaos, _jax_mlp(), data[0])
    pinj, pt = _reset_run(dkt, chaos, _port_mlp(), data[1])
    assert pinj == jinj == 1
    pc = _accounting(pt.ps_stats["registry"])
    assert pc == _accounting(jt.ps_stats["registry"])
    assert pc["evictions"] == pc["respawns"] == 1
    assert pt.ps_stats["num_updates"] == jt.ps_stats["num_updates"] == 8
    assert len(pt.get_history()) == 2


def test_fault_injector_drops_with_the_jax_packages_counts(data):
    """The runner's fault injector drops every third commit request: the
    dropped windows are lost, not retried, in both packages."""
    def injector():
        n = {"k": 0}
        lock = threading.Lock()

        def drop(action, msg):
            with lock:
                n["k"] += 1
                return n["k"] % 3 == 0
        return drop

    from distkeras_tpu.ps.runner import run_async_training as jrun
    from distkeras_tpu_torch.ps.runner import run_async_training as prun
    jt = dk.DOWNPOUR(_jax_mlp(), "sgd", num_workers=2, **COMMON)
    jrun(jt, data[0], fault_injector=injector())
    pt = dkt.DOWNPOUR(_port_mlp(), "sgd", num_workers=2, device="cpu",
                      **COMMON)
    prun(pt, data[1], fault_injector=injector())
    pc = _accounting(pt.ps_stats["registry"])
    assert pc == _accounting(jt.ps_stats["registry"])
    assert pc["commit_requests"] == 8 and pc["commits_dropped"] == 2
    assert pt.ps_stats["num_updates"] == 6


# ---------------------------------------------------------------------------
# eviction, respawn, elastic join
# ---------------------------------------------------------------------------

def test_thread_stall_evicts_respawns_and_tombstones(data):
    t = dkt.DOWNPOUR(_port_mlp(), "sgd", num_workers=2, device="cpu",
                     heartbeat_hard_s=1.0, startup_grace_s=60.0, **COMMON)
    out = {}
    with chaos.ThreadStall(workers_mod.PullCommitWorker, worker_id=1,
                           stall_after=1) as stall:
        th = threading.Thread(target=lambda: out.update(m=t.train(data[1])),
                              daemon=True)
        th.start()
        assert stall.wait_stalled(60), "worker 1 never hit the stall point"
        _wait(lambda: t._supervisor is not None, 30, "the supervisor")
        sup = t._supervisor
        _wait(lambda: sup.ps.registry.counter("ps.evictions").value >= 1,
              60, "the stalled worker's eviction")
        stall.resume()  # the SIGCONT: straight into a tombstoned commit
        th.join(120)
    assert not th.is_alive(), "training never completed"
    assert out["m"] is t.model
    counts = _accounting(t.ps_stats["registry"])
    assert counts["evictions"] == counts["respawns"] == 1
    assert counts["commits_tombstoned"] >= 1
    # the respawn resumed at window 1: every window applied exactly once
    assert t.ps_stats["num_updates"] == 8
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    assert t.ps_stats["registry"]["ps.recovery_seconds"]["count"] == 1
    kinds = [r["kind"] for r in t.metrics.records
             if r["event"] == "fleet_event"]
    assert kinds[:2] == ["evict", "respawn"]


def test_add_worker_joins_the_live_run(data):
    t = dkt.DOWNPOUR(_port_mlp(), "sgd", num_workers=2, device="cpu",
                     **COMMON)
    with pytest.raises(RuntimeError, match="no live async run"):
        t.add_worker()
    out = {}
    with chaos.ThreadStall(workers_mod.PullCommitWorker, worker_id=0,
                           stall_after=1) as stall:
        th = threading.Thread(target=lambda: out.update(m=t.train(data[1])),
                              daemon=True)
        th.start()
        assert stall.wait_stalled(60), "worker 0 never hit the stall gate"
        _wait(lambda: t._supervisor is not None, 30, "the supervisor")
        sup = t._supervisor
        assert t.add_worker() == 2
        _wait(lambda: sup.ps.commits_by_worker.get(2, 0) >= 1, 60,
              "the joined worker's first commit")
        stall.resume()
        th.join(120)
    assert not th.is_alive(), "training never completed"
    counts = _accounting(t.ps_stats["registry"])
    assert counts["joins"] == 1 and counts["evictions"] == 0
    # the joined worker trained a full share (partition 0's ring slot)
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4, 2: 4}
    assert t.ps_stats["num_updates"] == 12
    with pytest.raises(RuntimeError, match="no live async run"):
        t.add_worker()


def test_concurrent_joins_take_distinct_worker_ids():
    """Joins racing a slow spawn: while one worker's spawn is under way
    its id stays reserved, so joins that pick the next id concurrently
    take distinct ones and an explicit id being spawned is refused."""
    from distkeras_tpu_torch.obs import Registry
    from distkeras_tpu_torch.ps.runner import FleetSupervisor

    class PS:
        registry = Registry()
        mutex = threading.Lock()
        generations = {}

        def register_join(self, k):
            return 0, 0

    gate = threading.Event()

    def slow_spawn(k, window, gen, attempt):
        gate.wait(30)
        return ("handle", k)

    sup = FleetSupervisor(PS(), None, slow_spawn)
    ids = []
    threads = [threading.Thread(target=lambda: ids.append(sup.add_worker()))
               for _ in range(3)]
    for t in threads:
        t.start()
    _wait(lambda: len(sup.spawning) == 3, 30, "three reserved spawns")
    with pytest.raises(ValueError, match="already live"):
        sup.add_worker(1)
    gate.set()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(ids) == [0, 1, 2] and sorted(sup.live) == [0, 1, 2]
    assert not sup.spawning


# ---------------------------------------------------------------------------
# PS checkpoints and exact resume, across the packages
# ---------------------------------------------------------------------------

def _ckpt_run(pkg, model, ds, directory, epochs, resume=False):
    kw = dict(COMMON, num_epoch=epochs)
    t = pkg.ADAG(model, "sgd", num_workers=1, checkpoint_dir=str(directory),
                 **kw, **({"device": "cpu"} if pkg is dkt else {}))
    t.train(ds, resume=resume)
    return t


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_from_a_ps_checkpoint_written_by_either_package(
        writer, data, tmp_path):
    """One worker, 1 epoch with a PS checkpoint every commit, then
    ``train(resume=True)`` for 2 epochs from that directory in each
    package: the worker resumes at its committed window (4), trains only
    epoch 2, and the port's resumed center matches the JAX resume."""
    jm = _jax_mlp()
    first_pkg, first_model = (dk, jm) if writer == "jax" \
        else (dkt, _port_mlp(jm))
    first = _ckpt_run(first_pkg, first_model, data[0 if writer == "jax"
                                                   else 1], tmp_path, 1)
    assert first.ps_stats["num_updates"] == 4
    assert sorted(os.listdir(tmp_path))[-1] == "step-4.ckpt"
    jdir, pdir = tmp_path / "j", tmp_path / "p"
    for d in (jdir, pdir):
        d.mkdir()
        os.link(tmp_path / "step-4.ckpt", d / "step-4.ckpt")
    jt = _ckpt_run(dk, jm, data[0], jdir, 2, resume=True)
    pt = _ckpt_run(dkt, _port_mlp(jm), data[1], pdir, 2, resume=True)
    for t in (jt, pt):
        # 4 restored commits + the 4 windows of epoch 2
        assert t.ps_stats["num_updates"] == 8
        assert t.ps_stats["commits_by_worker"] == {0: 8}
        assert len(t.get_history()) == 1
    ref = [np.asarray(x) for x in
           jax.tree_util.tree_leaves(jt.trained_variables)]
    largest = max(float(np.max(np.abs(x))) for x in ref)
    got = jax.tree_util.tree_leaves(pt.trained_variables)
    for a, b in zip(got, ref):
        assert np.all(np.abs(a - b) <= 1e-6 * largest + 1e-5 * np.abs(b))
    np.testing.assert_allclose(pt.get_history()[0], jt.get_history()[0],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# process workers
# ---------------------------------------------------------------------------

def test_two_process_workers_train_and_fold_their_records(data):
    t = dkt.DOWNPOUR(_port_mlp(), "sgd", num_workers=2, device="cpu",
                     async_workers="processes", **COMMON)
    t.train(data[1])
    assert t.ps_stats["num_updates"] == 8
    assert t.ps_stats["commits_by_worker"] == {0: 4, 1: 4}
    hist = t.get_history()
    assert [h.shape for h in hist] == [(2, 8), (2, 8)]
    assert np.mean(hist[1]) < np.mean(hist[0])
    _accounting(t.ps_stats["registry"])
    recs = [r for r in t.metrics.records if r["event"] == "kernel_launches"]
    assert sorted(r["worker_id"] for r in recs) == [0, 1]
    # on the CPU no kernel launches: the records carry zeros
    assert all(set(r["counts"]["wrappers"].values()) == {0} for r in recs)
    beats = [r for r in t.metrics.records if r["event"] == "heartbeat"]
    assert sorted({r["worker_id"] for r in beats}) == [0, 1]
    with pytest.raises(ValueError, match="string worker_optimizer"):
        from distkeras_tpu_torch.ops.optimizers import sgd
        dkt.DOWNPOUR(_port_mlp(), sgd(0.1), num_workers=2, device="cpu",
                     async_workers="processes", **COMMON).train(data[1])


def test_a_process_worker_spec_without_a_device_needs_the_card(
        tmp_path, monkeypatch):
    """``python -m distkeras_tpu_torch.ps.worker_main SPEC`` is an entry
    point: a spec that names no device runs on the card, and with no
    card it raises rather than train on the host."""
    from distkeras_tpu_torch.ps import worker_main
    from distkeras_tpu_torch.utils import serde
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tmp_path / "spec.bin"
    spec.write_bytes(serde.tree_to_bytes({"worker_id": 0, "seed": 0}))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        worker_main.run_spec(str(spec))
