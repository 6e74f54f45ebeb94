"""The port's continual-learning loop against the JAX package's, on the
CPU, at the JAX tests' size (``gpt_lm(vocab 16, dim 16, 2 heads, 1 block,
seq_len 16, flash)``; JAX runs the Pallas kernels in interpret mode, the
port their plain versions):

* ``ContinualConfig`` refuses what the JAX one refuses, with the same
  messages; ``synthetic_lm_feed`` gives the same batches bit for bit
  (plain, abrupt drift, ramp); ``DeployGate`` makes the same decisions
  on the same deltas;
* ``ContinualTrainer`` from the same weights over 12 intervals with a
  drift at 10: per-window losses within rtol 1e-4 of JAX's and the same
  deploy decisions; checkpoints cross both ways (a resume from either
  package's file continues the same interval numbering, ``
  batches_consumed`` offset and losses);
* deploys into a live engine in the process and over the ``promote``
  RPC, served answers equal ``generate_tokens`` of the deployed tree and
  stay so while training goes on; a failed deploy is recorded and
  training continues; a partial interval never reaches the gate; a
  crashed daemon restarts at the exact stream offset.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.continual import ContinualConfig as JConfig
from distkeras_tpu.continual import ContinualTrainer as JTrainer
from distkeras_tpu.continual import DeployGate as JGate
from distkeras_tpu.continual import synthetic_lm_feed as jfeed
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.obs import Registry as JRegistry

from distkeras_tpu_torch.continual import (DEFAULT_WATCH, LOSS_BUCKETS,
                                           ContinualConfig,
                                           ContinualTrainer, DeployGate,
                                           synthetic_lm_feed)
from distkeras_tpu_torch.models import Model, generate_tokens
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.serve import (DecodeEngine, ServeClient,
                                       ServeConfig, ServeServer)
from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
from distkeras_tpu_torch.utils.weights import (load_jax_variables,
                                               to_numpy_variables)

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ = 16, 16
SCE = "sparse_categorical_crossentropy"
#: the JAX tests' cadence: 4 windows of 4 batches of 16 an interval
CADENCE = dict(batch_size=16, window_steps=4, snapshot_every=4, history=3,
               min_history=2)
INTERVALS, DRIFT = 12, 10
PER_INTERVAL = CADENCE["window_steps"] * CADENCE["snapshot_every"]


@pytest.fixture(scope="module")
def jmodel():
    return jzoo.gpt_lm(vocab_size=VOCAB, dim=16, num_heads=2, num_blocks=1,
                       seq_len=SEQ, attention_impl="flash")


def _port_model(jm):
    """The port's model whose ``init(seed)`` loads the JAX ``init(seed)``
    (the packages' generators differ)."""
    model = Model.from_config(jm.config())
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jm.init(seed)))
        return model
    model.init = init
    return model


def _record(trainer, out, index):
    """Wrap the trainer's window program to keep each window's losses
    (the JAX program returns them 4th, the port's 3rd)."""
    run = trainer._run_fn

    def recorded(*a):
        res = run(*a)
        out.append(np.asarray(res[index]) if index == 3
                   else res[index].detach().cpu().numpy().copy())
        return res
    trainer._run_fn = recorded


def _jax_trainer(jm, ckdir=None, **kw):
    return JTrainer(jm, "adam", SCE, config=JConfig(**CADENCE),
                    learning_rate=1e-2, registry=JRegistry(),
                    checkpoint_dir=ckdir, **kw)


def _port_trainer(jm, ckdir=None, **kw):
    kw.setdefault("registry", Registry())
    return ContinualTrainer(_port_model(jm), "adam", SCE,
                            config=ContinualConfig(**CADENCE),
                            learning_rate=1e-2, checkpoint_dir=ckdir,
                            device="cpu", **kw)


def _decisions(trainer):
    return [{k: e[k] for k in ("interval", "kind", "deploy", "deployed",
                               "reason", "metrics")}
            for e in trainer.gate.history_log()]


@pytest.fixture(scope="module")
def runs(jmodel, tmp_path_factory):
    """Both packages' 12-interval runs from the same weights, drift at
    interval 10, each checkpointing into its own directory."""
    base = tmp_path_factory.mktemp("continual")
    out = {}
    for name, make, index, feed in (
            ("jax", _jax_trainer, 3, jfeed),
            ("port", _port_trainer, 2, synthetic_lm_feed)):
        ckdir = str(base / name)
        t = make(jmodel, ckdir)
        losses = []
        _record(t, losses, index)
        t.run(feed(VOCAB, SEQ, 16, seed=0, drift_after=DRIFT * PER_INTERVAL),
              intervals=INTERVALS)
        out[name] = (t, np.concatenate(losses), ckdir)
    return out


# ---------------------------------------------------------------------------
# config, feed, gate
# ---------------------------------------------------------------------------

_BAD_CONFIGS = [dict(batch_size=0), dict(window_steps=0),
                dict(snapshot_every=-1), dict(history=0),
                dict(min_history=0), dict(checkpoint_keep=0),
                dict(prefetch=-1), dict(history=2, min_history=3),
                dict(max_intervals=0)]


@pytest.mark.parametrize("kw", _BAD_CONFIGS)
def test_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        JConfig(**kw)
    with pytest.raises(ValueError) as got:
        ContinualConfig(**kw)
    assert str(got.value) == str(want.value)


def test_config_defaults_match_jax():
    from distkeras_tpu.continual import DEFAULT_WATCH as JW
    from distkeras_tpu.continual import LOSS_BUCKETS as JB
    assert (DEFAULT_WATCH, LOSS_BUCKETS) == (JW, JB)
    assert ContinualConfig().config_row() == JConfig().config_row()
    assert ContinualConfig(**CADENCE).config_row() == \
        JConfig(**CADENCE).config_row()


@pytest.mark.parametrize("kw", [dict(), dict(step=3, seed=7),
                                dict(drift_after=5),
                                dict(drift_after=3, drift_ramp=6,
                                     drift_step=5)])
def test_synthetic_feed_matches_jax_bit_for_bit(kw):
    a, b = jfeed(VOCAB, SEQ, 8, **kw), synthetic_lm_feed(VOCAB, SEQ, 8, **kw)
    for _ in range(12):
        (jx, jy), (px, py) = next(a), next(b)
        assert px.dtype == jx.dtype and py.dtype == jy.dtype
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


def _loss_delta(reg_cls, values):
    reg = reg_cls()
    h = reg.histogram("continual.loss", LOSS_BUCKETS)
    for v in values:
        h.observe(float(v))
    reg.counter("jit.retraces")
    reg.counter("continual.deploys").inc(3)   # bookkeeping: not watched
    return reg.snapshot()


def test_deploy_gate_matches_jax():
    rng = np.random.default_rng(4)
    seq = [rng.uniform(0.5, 3.0, 32) * np.exp(-i / 2) for i in range(5)]
    seq += [np.linspace(0.011, 0.049, 32)] * 4
    seq += [np.linspace(2.5, 3.5, 32)] * 3
    logs, snaps = [], []
    for gate_cls, reg_cls in ((JGate, JRegistry), (DeployGate, Registry)):
        reg = reg_cls()
        gate = gate_cls(history=3, min_history=2, registry=reg)
        for i, v in enumerate(seq):
            entry = gate.decide(gate.observe(_loss_delta(reg_cls, v)),
                                interval=i)
            if entry["deploy"]:
                gate.record_deployed(entry)
        logs.append(gate.history_log())
        snaps.append(reg.snapshot())
    assert logs[1] == logs[0]
    assert snaps[1] == snaps[0]
    kinds = {e["kind"] for e in logs[1]}
    assert {"stable", "step"} <= kinds and any(e["deployed"]
                                               for e in logs[1])
    for gate_cls in (JGate, DeployGate):
        with pytest.raises(ValueError, match="min_history must lie"):
            gate_cls(history=2, min_history=3)


# ---------------------------------------------------------------------------
# the trainer against JAX's
# ---------------------------------------------------------------------------

def test_losses_and_deploy_decisions_match_jax(runs):
    (jt, jl, _), (pt, pl, _) = runs["jax"], runs["port"]
    assert pl.shape == jl.shape == (INTERVALS * PER_INTERVAL,)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert _decisions(pt) == _decisions(jt)
    log = _decisions(pt)
    assert any(e["deployed"] and e["interval"] < DRIFT for e in log)
    assert any(e["interval"] >= DRIFT and e["reason"].startswith(
        "drift-dirty") for e in log)
    for name in ("continual.windows", "continual.steps", "continual.samples",
                 "continual.intervals", "continual.checkpoints",
                 "continual.deploys", "continual.deploys_rejected",
                 "continual.rejected_dirty", "continual.rejected_warmup",
                 "continual.verdicts_stable", "continual.verdicts_step",
                 "continual.verdicts_trend", "jit.retraces"):
        assert pt.registry.counter(name).value == \
            jt.registry.counter(name).value, name
    assert pt.registry.counter("jit.retraces").value == 0
    assert pt.registry.snapshot()["continual.loss"]["counts"] == \
        jt.registry.snapshot()["continual.loss"]["counts"]
    # the deployed tree is the JAX one's, and the trainer's final tree
    want = jax.tree_util.tree_leaves(jt.deployed)
    got = jax.tree_util.tree_leaves(pt.deployed)
    assert pt.deployed_interval == jt.deployed_interval
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("source,resumer", [("port", "jax"),
                                            ("jax", "port")])
def test_checkpoints_cross_both_ways(runs, jmodel, source, resumer,
                                     tmp_path):
    """A checkpoint one package wrote resumes the other's trainer: the
    same ``interval`` / ``batches_consumed`` meta, the interval numbering
    continues, and the next interval's losses are the writer's own
    resume's within rtol 1e-4."""
    import shutil
    ckdir = str(tmp_path / "ck")
    shutil.copytree(runs[source][2], ckdir)
    mgr = CheckpointManager(ckdir)
    step = mgr.latest_step()
    assert step == INTERVALS - 1
    losses = {}
    for name in (source, resumer):
        d = str(tmp_path / f"resume_{name}")
        shutil.copytree(ckdir, d)
        make, index, feed = (_jax_trainer, 3, jfeed) if name == "jax" \
            else (_port_trainer, 2, synthetic_lm_feed)
        t = make(jmodel, d)
        out = []
        _record(t, out, index)
        offset = INTERVALS * PER_INTERVAL
        f = feed(VOCAB, SEQ, 16, seed=0, drift_after=DRIFT * PER_INTERVAL)
        for _ in range(offset):
            next(f)
        t.run(f, intervals=1, resume=True)
        assert t.gate.history_log()[0]["interval"] == INTERVALS
        assert t.batches_consumed == (INTERVALS + 1) * PER_INTERVAL
        losses[name] = np.concatenate(out)
        mgr2 = CheckpointManager(d)
        assert mgr2.latest_step() == INTERVALS
    np.testing.assert_allclose(losses[resumer], losses[source], rtol=1e-4)
    # the meta either package wrote
    from distkeras_tpu_torch.utils import serde
    with open(mgr.path(step), "rb") as f:
        meta = serde.tree_from_bytes(f.read())["meta"]
    assert meta["interval"] == INTERVALS - 1
    assert meta["batches_consumed"] == INTERVALS * PER_INTERVAL


# ---------------------------------------------------------------------------
# deploys, failures, partial intervals, the daemon
# ---------------------------------------------------------------------------

def _engine(jm, registry=None):
    model = _port_model(jm).init(0, device="cpu")
    return DecodeEngine(model, ServeConfig(slots=2, max_new_tokens=8),
                        registry=registry if registry is not None
                        else Registry(), device="cpu").warmup()


def _ref(jm, variables, prompt, steps):
    model = _port_model(jm).init(0, device="cpu")
    load_jax_variables(model, variables)
    out = generate_tokens(model, np.asarray(prompt)[None, :], steps,
                          device="cpu")
    return out[0, len(prompt):].numpy()


def test_engine_promote_in_process_and_answers_stay_deployed(jmodel):
    """In-process deploys into a live engine on the trainer's registry:
    the engine answers as ``generate_tokens`` of the deployed tree, and
    windows trained after the last deploy (the drift's dirty intervals)
    leave its weights and answers as they were."""
    reg = Registry()
    engine = _engine(jmodel, reg)
    engine.start()
    try:
        t = _port_trainer(jmodel, deploy_to=engine, registry=reg)
        t.run(synthetic_lm_feed(VOCAB, SEQ, 16, seed=0,
                                drift_after=DRIFT * PER_INTERVAL),
              intervals=INTERVALS)
        assert t.deployed is not None and t.deployed_interval < DRIFT
        prompt = np.arange(6) % VOCAB
        got = engine.submit(prompt, 6).result(timeout=60)
        np.testing.assert_array_equal(got, _ref(jmodel, t.deployed,
                                                prompt, 6))
        served = jax.tree_util.tree_leaves(to_numpy_variables(engine.model))
        for a, b in zip(served, jax.tree_util.tree_leaves(t.deployed)):
            np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(t.variables),
            jax.tree_util.tree_leaves(t.deployed)))
        assert not np.array_equal(got, _ref(jmodel, jax.tree_util.tree_map(
            np.asarray, jmodel.init(0)), prompt, 6))
    finally:
        engine.stop()
    snap = reg.snapshot()
    assert snap["serve.promotions"]["value"] == \
        snap["continual.deploys"]["value"] >= 1
    assert snap["jit.retraces"]["value"] == 0


def test_deploys_over_the_promote_rpc(jmodel):
    reg = Registry()
    with ServeServer(_engine(jmodel, reg)) as srv:
        with ServeClient("127.0.0.1", srv.port) as client:
            cfg = dict(CADENCE, history=2, min_history=1)
            t = ContinualTrainer(_port_model(jmodel), "adam", SCE,
                                 config=ContinualConfig(**cfg),
                                 learning_rate=1e-2, registry=Registry(),
                                 deploy_to=client, device="cpu")
            t.run(synthetic_lm_feed(VOCAB, SEQ, 16, seed=2), intervals=2)
            assert t.deployed is not None
            prompt = np.arange(4) % VOCAB
            reply = client.generate(prompt, 5)
    assert reply["ok"]
    np.testing.assert_array_equal(np.asarray(reply["tokens"]),
                                  _ref(jmodel, t.deployed, prompt, 5))
    assert reg.counter("serve.promotions").value == \
        t.registry.counter("continual.deploys").value >= 1


def test_deploy_failure_is_recorded_and_training_continues(jmodel):
    calls = []

    def broken(host_vars):
        calls.append(host_vars)
        raise ConnectionError("deploy target gone")

    def refused(host_vars):
        return {"ok": False, "error": "tree does not match"}

    for target in (broken, refused):
        t = ContinualTrainer(_port_model(jmodel), "adam", SCE,
                             config=ContinualConfig(**dict(
                                 CADENCE, history=2, min_history=1)),
                             learning_rate=1e-2, registry=Registry(),
                             deploy_to=target, device="cpu")
        t.run(synthetic_lm_feed(VOCAB, SEQ, 16, seed=3), intervals=2)
        snap = t.registry.snapshot()
        failed = [e for e in t.gate.history_log()
                  if e["reason"].startswith("deploy failed")]
        assert failed and all(not e["deployed"] for e in failed)
        assert snap["continual.deploy_errors"]["value"] == len(failed)
        assert snap["continual.deploys"]["value"] == 0
        assert snap["continual.intervals"]["value"] == 2
        assert t.deployed is None
        if target is broken:
            assert len(calls) == len(failed)
    assert set(calls[0]) == {"params", "state"}


def test_partial_interval_never_reaches_the_gate(jmodel):
    feed = synthetic_lm_feed(VOCAB, SEQ, 16, seed=7)
    batches = [next(feed) for _ in range(16 + 6)]  # 1 interval + 1.5 windows
    t = _port_trainer(jmodel, deploy_to=lambda v: None)
    t.run(iter(batches))
    snap = t.registry.snapshot()
    assert snap["continual.intervals"]["value"] == 1
    assert sum(snap[f"continual.verdicts_{k}"]["value"]
               for k in ("stable", "step", "trend")) == 1
    assert snap["continual.windows"]["value"] == 5  # the partial trained
    assert len(t.gate.history_log()) == 1
    with pytest.raises(ValueError, match="nothing was trained"):
        _port_trainer(jmodel).run(iter(batches[:2]))


def test_daemon_restart_resumes_the_exact_stream(jmodel, tmp_path):
    """A crash inside interval 1 restarts from interval 0's checkpoint
    with the feed rebuilt at the recorded offset; the run ends at the
    original interval 4, and its losses equal an uninterrupted run's."""
    feeds = []
    ref = _port_trainer(jmodel)
    ref_losses = []
    _record(ref, ref_losses, 2)
    ref.run(synthetic_lm_feed(VOCAB, SEQ, 16, seed=0), intervals=4)

    t = _port_trainer(jmodel, str(tmp_path))
    calls = {"n": 0}
    run = t._run_fn

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 6:  # interval 0 checkpointed; dies inside 1
            raise RuntimeError("injected continual crash")
        return run(*a)

    t._run_fn = flaky
    losses = []
    _record(t, losses, 2)

    def factory(offset):
        feeds.append(offset)
        f = synthetic_lm_feed(VOCAB, SEQ, 16, seed=0)
        for _ in range(offset):
            next(f)
        return f

    t.start(synthetic_lm_feed(VOCAB, SEQ, 16, seed=0), intervals=4,
            max_restarts=1, feed_factory=factory)
    t._thread.join(300)
    assert not t._thread.is_alive()
    assert feeds == [PER_INTERVAL]
    assert t.registry.counter("continual.restarts").value == 1
    assert t.intervals_done == 4
    assert t.registry.counter("continual.intervals").value == 4
    # windows 0-4 ran before the crash; the resumed run re-trains
    # interval 1 from interval 0's checkpoint
    kept = np.concatenate(losses[:4] + losses[5:])
    np.testing.assert_array_equal(kept, np.concatenate(ref_losses))


def test_daemon_start_stop(jmodel):
    import time
    t = _port_trainer(jmodel)
    t.start(synthetic_lm_feed(VOCAB, SEQ, 16, seed=5))
    deadline = time.monotonic() + 120
    while t.registry.counter("continual.intervals").value < 2:
        assert time.monotonic() < deadline, "daemon never reached 2"
        time.sleep(0.01)
    assert t.stop() is not None
    with pytest.raises(RuntimeError, match="already started"):
        t._thread = object()
        t.start(synthetic_lm_feed(VOCAB, SEQ, 16))
