"""The port's scenario harness against the JAX package's, on the CPU:

* the scenario configs the port's bench keeps as data equal the JAX
  bench's; ``poisson_trace``, ``diurnal_trace`` and ``spike_trace`` give
  the JAX package's arrivals for each named scenario's seed; a JSONL
  trace either package saved replays equal in the other;
* ``build_prompt``, ``PhaseAccountant`` and ``AutoScaler.decide`` give
  the same tokens, reports and decision sequences on the same inputs;
* the ``smoke`` scenario against a port fleet on the CPU (one engine
  behind the port's router, ``OBS_BASELINE.json``'s alert rules on)
  holds the three-way accounting identity, and the JAX package's runner
  against the port's router settles the same trace with the same
  accounting as the port's runner (the wire is shared).
"""

import os

import numpy as np
import pytest
import torch

import bench as jbench
from distkeras_tpu import scenario as js
from distkeras_tpu.obs import Registry as JRegistry
from distkeras_tpu.serve import ServeClient as JClient

from distkeras_tpu_torch import bench
from distkeras_tpu_torch import scenario as ps
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs import TIME_BUCKETS, Registry
from distkeras_tpu_torch.serve import (DecodeEngine, RouterConfig,
                                       ServeClient, ServeConfig,
                                       ServeRouter, ServeServer)

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

#: a small flash LM whose sequence budget holds the committed lengths
#: (prompts up to 40 tokens, 24 new)
LM = dict(vocab_size=64, dim=16, num_heads=2, num_blocks=1, seq_len=80,
          attention_impl="flash")


def _jax_spec(name):
    sc = jbench.SCENARIO_TRACES[name]
    return jbench._scenario_spec(name, sc,
                                 js.LengthModel(**jbench.SCENARIO_LENGTHS),
                                 js.PrefixMix(**jbench.SCENARIO_MIX))


def test_scenario_configs_equal_the_jax_benchs():
    for name in ("SCENARIO_MODEL", "SCENARIO_FLEET", "SCENARIO_LENGTHS",
                 "SCENARIO_MIX", "SCENARIO_SLO", "SCENARIO_POLICY",
                 "SCENARIO_TRACES", "SCENARIO_COMMITTED"):
        assert getattr(bench, name) == getattr(jbench, name), name


@pytest.mark.parametrize("name", sorted(bench.SCENARIO_TRACES))
def test_traces_match_jax(name):
    got = bench.scenario_spec(name, bench.SCENARIO_TRACES[name])
    want = _jax_spec(name)
    assert (got.name, got.seed, got.duration_s, got.phase_bounds) == \
        (want.name, want.seed, want.duration_s, want.phase_bounds)
    assert [a.to_row() for a in got.arrivals] == \
        [a.to_row() for a in want.arrivals]
    assert got.counts_by_phase() == want.counts_by_phase()
    assert [got.phase_at(t) for t in np.linspace(0, got.duration_s, 13)] \
        == [want.phase_at(t) for t in np.linspace(0, want.duration_s, 13)]


def test_trace_refusals_match_jax():
    bad = [("poisson_trace", (0.0, 1.0), {}),
           ("diurnal_trace", (5.0, 1.0, 1.0), {}),
           ("spike_trace", (1.0, 2.0, 5.0),
            dict(spike_start=4.0, spike_duration=2.0))]
    for fn, args, kw in bad:
        with pytest.raises(ValueError) as want:
            getattr(js, fn)(*args, **kw)
        with pytest.raises(ValueError) as got:
            getattr(ps, fn)(*args, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_traces_replay_across_packages(writer, tmp_path):
    spec = _jax_spec("spike")
    path = str(tmp_path / "trace.jsonl")
    (js if writer == "jax" else ps).save_trace(spec, path)
    other = ps if writer == "jax" else js
    replayed = other.replay_trace(path)
    mine = (js if writer == "jax" else ps).replay_trace(path)
    assert replayed.phase_bounds == mine.phase_bounds == spec.phase_bounds
    assert [a.to_row() for a in replayed.arrivals] == \
        [a.to_row() for a in spec.arrivals]
    assert (replayed.name, replayed.seed, replayed.duration_s) == \
        (spec.name, spec.seed, spec.duration_s)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": "other"}\n')
    for mod in (js, ps):
        with pytest.raises(ValueError, match="not a dktpu-trace/v1"):
            mod.replay_trace(str(bad))


def test_build_prompt_matches_jax():
    spec = _jax_spec("diurnal")
    for idx, a in enumerate(spec.arrivals[:200]):
        np.testing.assert_array_equal(
            ps.build_prompt(a, idx, 64, 16), js.build_prompt(a, idx, 64, 16))


def _snap(reg_cls, values):
    reg = reg_cls()
    e2e = reg.histogram("serve.e2e_seconds", TIME_BUCKETS)
    ttft = reg.histogram("serve.ttft_seconds", TIME_BUCKETS)
    for v in values:
        e2e.observe(v)
        ttft.observe(v / 2)
    return reg.snapshot()


def test_phase_accountant_matches_jax():
    rng = np.random.default_rng(5)
    values = list(rng.lognormal(-1.0, 1.0, 60))
    cuts = [("a", 20, 2.0), ("b", 45, 1.0), ("c", 45, 0.5), ("d", 60, 3.0)]
    reports = []
    for mod, reg_cls in ((js, JRegistry), (ps, Registry)):
        acct = mod.PhaseAccountant(mod.SLOTarget(ttft_s=0.25, e2e_s=1.0))
        acct.open(_snap(reg_cls, []))
        for i, (phase, n, wall) in enumerate(cuts):
            acct.cut(phase, _snap(reg_cls, values[:n]), wall,
                     {"offered": n + i, "completed": n, "rejected": i,
                      "timeouts": 0, "slo_met": n // 2,
                      "goodput_tokens": 7 * n})
        reports.append(([r.to_row() for r in acct.reports], acct.misses(),
                        [r.meets(acct.target) for r in acct.reports]))
    assert reports[1] == reports[0]
    for v in (0.25, 0.3, 1.0, 100.0):
        snap = _snap(Registry, values)["serve.e2e_seconds"]
        assert ps.hist_fraction_le(snap, v) == js.hist_fraction_le(snap, v)
    with pytest.raises(RuntimeError, match="before open"):
        ps.PhaseAccountant(ps.SLOTarget()).cut("x", {}, 1.0, {})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscaler_decides_as_jax_does(seed):
    rng = np.random.default_rng(seed)
    policy = dict(bench.SCENARIO_POLICY, up_after=2, down_after=3)
    stream = []
    for _ in range(40):  # segments: pressure, slack or noise
        mode = rng.choice(["hot", "idle", "noise"])
        alive = int(rng.integers(1, 4))
        for _ in range(int(rng.integers(2, 8))):
            if mode == "hot":
                q, att = 9.0 * alive, float(rng.uniform(0.5, 1.0))
            elif mode == "idle":
                q, att = 0.0, (None if rng.random() < 0.5 else 0.99)
            else:
                q = float(rng.choice([0.0, 0.2, 1.0, 3.0, 9.0]))
                att = None if rng.random() < 0.3 else \
                    float(rng.uniform(0.5, 1.0))
            stream.append((alive, q, att, float(rng.uniform(0, 0.3))))
    decisions = []
    for mod in (js, ps):
        reg_cls = JRegistry if mod is js else Registry
        scaler = mod.AutoScaler(None, mod.AutoscalePolicy(**policy),
                                target=mod.SLOTarget(), registry=reg_cls())
        now, out = 0.0, []
        for alive, q, att, dt in stream:
            now += dt
            out.append(scaler.decide(mod.Signals(alive=alive, queue_depth=q,
                                                 attainment=att), now))
        decisions.append(out)
    assert decisions[1] == decisions[0]
    assert {"up", "down"} <= set(decisions[1])


def test_precreated_metrics_match_jax():
    assert ps.SCENARIO_COUNTERS == js.SCENARIO_COUNTERS
    assert ps.SCENARIO_HISTOGRAMS == js.SCENARIO_HISTOGRAMS
    assert ps.precreate_metrics(Registry()).snapshot() == \
        js.precreate_metrics(JRegistry()).snapshot()


# ---------------------------------------------------------------------------
# against live fleets on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return zoo.gpt_lm(**LM).init(0, device="cpu")


def test_smoke_scenario_against_a_port_fleet(model):
    """``bench.scenario_run("smoke")``: one engine behind the port's
    router with the baseline's alert rules, the committed trace, exact
    three-way accounting, no retrace, the alert engine evaluated, K1's
    plain version at every cold join (no launch counts on the CPU)."""
    seen = {}

    def before(servers):
        seen["servers"] = len(servers)

    row, part, servers = bench.scenario_run(
        "smoke", model, ps.SLOTarget(**bench.SCENARIO_SLO),
        before_traffic=before)
    c = row["counts"]
    assert row["accounting_exact"] and seen["servers"] == 1
    assert c["dispatched"] == len(_jax_spec("smoke").arrivals)
    assert c["dispatched"] == c["completed"] + c["rejected"] + c["timeouts"]
    assert row["jit_retraces"] == 0 and row["alert_rules_evaluated"]
    assert row["alerts"] == {"fired": 0, "resolved": 0, "firing": 0}
    assert part["scenario.dispatch_skew_seconds"]["count"] == c["dispatched"]
    assert [p["phase"] for p in row["phases"]] == ["steady"]
    assert row["scale_up"] == row["scale_down"] == 0


def test_jax_runner_against_the_port_router_accounts_alike(model):
    """The JAX package's ``ScenarioRunner`` and the port's fire the same
    light trace at one port router fleet: both settle every arrival as
    completed, with the same counts."""
    import copy
    cfg = ServeConfig(slots=2, max_queue=32, max_new_tokens=8,
                      prefill_buckets=(16, 48), prefix_cache=True,
                      prefix_cache_mb=4.0, prefix_block=8)
    servers = [ServeServer(DecodeEngine(copy.deepcopy(model), cfg,
                                        registry=Registry(),
                                        device="cpu").warmup()).start()
               for _ in range(2)]
    router = ServeRouter([("127.0.0.1", s.port) for s in servers],
                         config=RouterConfig(affinity_block=8,
                                             stats_interval_s=30.0,
                                             kv_fabric=False)).start()
    rows = {}
    try:
        for name, mod, client in (("jax", js, JClient),
                                  ("port", ps, ServeClient)):
            spec = mod.poisson_trace(
                15.0, 1.0, seed=4, mix=mod.PrefixMix(groups=3, share=0.6),
                lengths=mod.LengthModel(prompt_median=8, new_median=4))
            reg_cls = JRegistry if mod is js else Registry
            stats = client("127.0.0.1", router.port)
            try:
                runner = mod.ScenarioRunner(
                    spec, lambda c=client, r=reg_cls: c(
                        "127.0.0.1", router.port, registry=r()),
                    snap=lambda s=stats: s.stats()["stats"],
                    registry=reg_cls(), workers=4, deadline_s=30.0,
                    target=mod.SLOTarget(ttft_s=2.5, e2e_s=10.0),
                    vocab=LM["vocab_size"], prefix_len=8)
                rows[name] = runner.run()
            finally:
                stats.close()
    finally:
        router.stop()
        for s in servers:
            s.stop()
    for name, row in rows.items():
        c = row["counts"]
        assert row["accounting_exact"], name
        assert c["dispatched"] == c["completed"] == row["arrivals"], name
    keys = ("dispatched", "completed", "rejected", "timeouts")
    assert {k: rows["port"]["counts"][k] for k in keys} == \
        {k: rows["jax"]["counts"][k] for k in keys}
    assert rows["port"]["arrivals"] == rows["jax"]["arrivals"]


def test_a_server_stopped_twice_returns_at_once(model):
    """The chaos scenario's teardown stops its killed engine's server a
    second time: a stopped engine has nothing left to drain, so the
    second stop does not wait out ``drain_timeout_s``."""
    import time
    srv = ServeServer(DecodeEngine(model, ServeConfig(slots=1,
                                                      max_new_tokens=4),
                                   registry=Registry(), device="cpu")
                      .warmup()).start()
    with ServeClient("127.0.0.1", srv.port) as c:
        assert c.generate(np.arange(5), max_new_tokens=3)["ok"]
    srv.stop(drain=False)
    t0 = time.perf_counter()
    srv.stop()
    assert time.perf_counter() - t0 < 5.0
    assert srv.engine.drain(timeout=60.0)
