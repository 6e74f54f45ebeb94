"""The port's obs plane against the JAX package's, on the CPU: the same
inputs through both packages give the same outputs.

* ``Histogram.merge``, ``detect_from_heartbeats`` and
  ``to_prometheus_text`` on the same snapshots and records;
* the drift differ: ``psi``, ``diff_docs`` / ``diff_files`` report lines
  for every committed ``BENCH_*_OBS.json`` (against its siblings and a
  perturbed copy, under ``OBS_BASELINE.json``'s thresholds), and
  ``classify_window`` on the JAX tests' golden sequences;
* the alert rules: ``parse_rules`` on ``OBS_BASELINE.json`` and its
  refusals, ``AlertEngine`` state documents and transitions at the same
  clock readings (threshold, rate, burn rate, hysteresis, flapping),
  ``hist_fraction_le``, and a ``FrameServer``'s ``alerts`` action;
* ``records_to_chrome_trace`` on the same records, the profiler knobs on
  the trainers, and ``scripts/obsview.py`` reading files the port wrote.
"""

import copy
import glob
import importlib.util
import io
import json
import logging
import math
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from distkeras_tpu.obs import alerts as jalerts
from distkeras_tpu.obs import drift as jdrift
from distkeras_tpu.obs import export as jexport
from distkeras_tpu.obs import exposition as jexpo
from distkeras_tpu.obs import registry as jreg
from distkeras_tpu.obs import stragglers as jstrag
from distkeras_tpu.obs.timeseries import TimeSeriesStore as JStore
from distkeras_tpu.ps import servers as jsrv

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs import alerts as palerts
from distkeras_tpu_torch.obs import drift as pdrift
from distkeras_tpu_torch.obs import export as pexport
from distkeras_tpu_torch.obs import exposition as pexpo
from distkeras_tpu_torch.obs import registry as preg
from distkeras_tpu_torch.obs import stragglers as pstrag
from distkeras_tpu_torch.obs.profile import TRACE_FILE, device_trace
from distkeras_tpu_torch.obs.timeseries import TimeSeriesStore as PStore
from distkeras_tpu_torch.ps import client as pcli
from distkeras_tpu_torch.ps import servers as psrv
from distkeras_tpu_torch.utils.metrics import StepTimer, profile_trace

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASELINE = os.path.join(_ROOT, "OBS_BASELINE.json")
_SNAPSHOTS = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(_ROOT, "BENCH_*_OBS*.json")))


def _both_registries(fill):
    """``fill(registry)`` run on a fresh registry of each package."""
    out = []
    for mod in (jreg, preg):
        r = mod.Registry()
        fill(r)
        out.append(r)
    return out


def _fill(reg):
    rng = np.random.default_rng(3)
    reg.counter("ps.commits").inc(17)
    reg.counter("ps.commits", labels={"worker": 2}).inc(5)
    reg.gauge("serve.queue_depth").set(3.5)
    h = reg.histogram("serve.e2e_seconds")
    for v in rng.lognormal(-2.0, 1.0, size=40):
        h.observe(float(v))
    c = reg.histogram("ps.staleness", jreg.COUNT_BUCKETS)
    for v in rng.integers(0, 9, size=25):
        c.observe(int(v))


# ---------------------------------------------------------------------------
# registry, stragglers, exposition
# ---------------------------------------------------------------------------

def test_histogram_merge_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.exponential(0.1, 30), rng.exponential(1.0, 20)
    snaps = []
    for mod in (jreg, preg):
        h, other = mod.Histogram("x"), mod.Histogram("x")
        for v in a:
            h.observe(float(v))
        for v in b:
            other.observe(float(v))
        h.merge(other)
        h.merge(other.snapshot())
        snaps.append(h.snapshot())
        with pytest.raises(ValueError, match="cannot merge bounds"):
            h.merge(mod.Histogram("y", (1.0, 2.0)))
    assert snaps[0] == snaps[1]


def test_detect_from_heartbeats_matches_jax():
    rng = np.random.default_rng(1)
    records = [{"event": "epoch", "ts": 0.0}, {"event": "heartbeat"}]
    for i in range(60):
        w = i % 4
        gap = 0.02 * (1 + 0.1 * rng.random()) * (6.0 if w == 3 else 1.0)
        rec = {"event": "heartbeat", "worker_id": w, "gap_s": gap}
        if i % 5 == 0:
            rec["link_rtt_s"] = 0.001 * (1 + rng.random())
            rec["link_downshifts"] = i // 5
        records.append(rec)
    want = jstrag.detect_from_heartbeats(records)
    got = pstrag.detect_from_heartbeats(records)
    assert got == want and got["stragglers"] == [3]
    assert pstrag.detect_from_heartbeats([]) == \
        jstrag.detect_from_heartbeats([])


def test_prometheus_text_matches_jax():
    jr, pr = _both_registries(_fill)
    assert pexpo.to_prometheus_text(pr) == jexpo.to_prometheus_text(jr)
    snap = jr.snapshot()
    assert pexpo.to_prometheus_text(snap) == jexpo.to_prometheus_text(snap)
    assert pexpo.to_prometheus_text({}) == ""


# ---------------------------------------------------------------------------
# the drift differ
# ---------------------------------------------------------------------------

def _perturbed(doc):
    """A copy of a snapshot document with counters scaled 1.4x and every
    histogram's mass moved one bucket up (drift the differ must see)."""
    doc = copy.deepcopy(doc)
    for reg in jdrift.named_registries(doc).values():
        for s in reg.values():
            if s["type"] == "counter":
                s["value"] = float(s["value"]) * 1.4
            elif s["type"] == "histogram":
                s["counts"] = [0] + list(s["counts"][:-1])
                s["count"] = sum(s["counts"])
    return doc


def _cases():
    out = [(name, "perturbed") for name in _SNAPSHOTS]
    ps = [n for n in _SNAPSHOTS if n.startswith("BENCH_PS_OBS")]
    out += [(ps[0], other) for other in ps[1:]]
    return out


@pytest.mark.parametrize("base,cand", _cases())
def test_diff_files_report_lines_match_jax(base, cand, tmp_path):
    base_path = os.path.join(_ROOT, base)
    if cand == "perturbed":
        with open(base_path) as f:
            doc = _perturbed(json.load(f))
        cand_path = str(tmp_path / f"perturbed_{base}")
        with open(cand_path, "w") as f:
            json.dump(doc, f)
    else:
        cand_path = os.path.join(_ROOT, cand)
    jbl, pbl = jdrift.load_baseline(_BASELINE), pdrift.load_baseline(
        _BASELINE)
    assert pbl == jbl
    want = jdrift.diff_files(base_path, cand_path, baseline=jbl)
    got = pdrift.diff_files(base_path, cand_path, baseline=pbl)
    assert got.lines() == want.lines()
    assert got.drifted == want.drifted
    assert got.drifted_metrics == want.drifted_metrics
    if cand == "perturbed":
        assert got.drifted
    # the per-histogram PSI, value for value
    with open(base_path) as f:
        bdoc = json.load(f)
    with open(cand_path) as f:
        cdoc = json.load(f)
    for reg, snaps in jdrift.named_registries(bdoc).items():
        other = jdrift.named_registries(cdoc).get(reg, {})
        for name, s in snaps.items():
            c = other.get(name)
            if s["type"] == "histogram" and c and \
                    list(c["bounds"]) == list(s["bounds"]):
                assert pdrift.psi(s, c) == jdrift.psi(s, c)


def test_find_baseline_and_refusals_match_jax(tmp_path):
    assert pdrift.find_baseline(os.path.join(_ROOT, "tests")) == \
        jdrift.find_baseline(os.path.join(_ROOT, "tests")) == _BASELINE
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope"}))
    for mod in (jdrift, pdrift):
        with pytest.raises(ValueError, match="not an obs baseline"):
            mod.load_baseline(str(bad))
    rec = tmp_path / "records.json"
    rec.write_text(json.dumps([{"event": "epoch"}]))
    for mod in (jdrift, pdrift):
        with pytest.raises(ValueError, match="no registry snapshot"):
            mod.diff_files(str(rec), str(rec))
    assert pdrift.DEFAULT_THRESHOLDS == jdrift.DEFAULT_THRESHOLDS
    assert pdrift.WINDOW_KINDS == jdrift.WINDOW_KINDS
    assert pdrift.BASELINE_SCHEMA == jdrift.BASELINE_SCHEMA


def _ctr(v):
    return {"type": "counter", "value": float(v)}


def _loss_interval(mod, values):
    reg = mod.Registry()
    h = reg.histogram("continual.loss", (0.001, 0.0025, 0.005, 0.01, 0.025,
                                         0.05, 0.1, 0.25, 0.5, 1.0, 1.5, 2.0,
                                         3.0, 4.0, 6.0, 10.0))
    for v in values:
        h.observe(float(v))
    return reg.snapshot()


#: the JAX package's golden sequences (``tests/test_continual.py``)
_GOLDEN = {
    "stable": [100, 105, 98, 103, 101],
    "thin": [100],
    "empty": [],
    "step": [100, 100, 100, 100, 180],
    "trend": [100, 115, 132, 152, 175],
    "step_in_window": [100, 180, 180, 180],
    "step_slid_out": [180, 180, 180, 181],
}


@pytest.mark.parametrize("name", sorted(_GOLDEN) + ["loss_quiet",
                                                    "loss_jump"])
def test_classify_window_goldens_match_jax(name):
    if name.startswith("loss"):
        quiet = [np.linspace(0.011, 0.049, 32)] * 3
        seq = quiet + ([np.linspace(2.5, 3.5, 32)] if name == "loss_jump"
                       else [])
        jint = [_loss_interval(jreg, v) for v in seq]
        pint = [_loss_interval(preg, v) for v in seq]
        assert pint == jint
    else:
        jint = pint = [{"continual.loss_rate": _ctr(v)}
                       for v in _GOLDEN[name]]
    want = jdrift.classify_window(jint)
    got = pdrift.classify_window(pint)
    assert dict(got) == dict(want)
    assert (got.kind, got.clean, got.dirty_metrics) == \
        (want.kind, want.clean, want.dirty_metrics)


# ---------------------------------------------------------------------------
# alert rules and the engine
# ---------------------------------------------------------------------------

def test_parse_rules_of_the_baseline_match_jax():
    with open(_BASELINE) as f:
        doc = json.load(f)
    want = jalerts.parse_rules(doc)
    got = palerts.parse_rules(doc)
    assert [r.__dict__ for r in got] == [r.__dict__ for r in want]
    assert [r.flat_metric() for r in got] == [r.flat_metric() for r in want]
    assert palerts.KNOWN_LABEL_KEYS == jalerts.KNOWN_LABEL_KEYS


_MALFORMED = [
    [{"name": "x", "kind": "threshold", "metric": "m", "max_value": 0,
      "max_valu": 1}],
    [{"name": "x", "kind": "threshold", "metric": "m", "max_value": 0}] * 2,
    [{"name": "x", "kind": "threshold", "metric": "m"}],
    [{"name": "x", "kind": "burn_rate", "metric": "m"}],
    [{"name": "x", "kind": "burn_rate", "metric": "m", "bound_s": 1.0,
      "attainment": 1.0}],
    [{"name": "x", "kind": "burn_rate", "metric": "m", "bound_s": 1.0,
      "short_s": 9.0, "long_s": 1.0}],
    [{"name": "x", "kind": "wat", "metric": "m"}],
    [{"name": "x", "kind": "threshold", "metric": "m", "max_value": 0,
      "labels": {"wrker": 1}}],
    [{"kind": "threshold", "metric": "m", "max_value": 0}],
    ["not a rule"],
]


@pytest.mark.parametrize("i", range(len(_MALFORMED)))
def test_parse_rules_refuses_what_jax_refuses(i):
    with pytest.raises(ValueError) as want:
        jalerts.parse_rules(_MALFORMED[i])
    with pytest.raises(ValueError) as got:
        palerts.parse_rules(_MALFORMED[i])
    assert str(got.value) == str(want.value)


def _counter_delta(v):
    return {"type": "counter", "value": v}


def _hist_delta(counts, bounds=(1.0,), s=0.0):
    return {"type": "histogram", "bounds": list(bounds),
            "counts": list(counts), "sum": s, "count": sum(counts)}


def _square(level_of):
    return lambda i: {"g": {"type": "gauge", "value": level_of(i)}}


#: (rules, [(clock, {source: delta}), ...]) scripts fed to both engines
_SCRIPTS = {
    "threshold_for_s": (
        [{"name": "r", "kind": "threshold", "metric": "c", "max_value": 0,
          "for_s": 1.0}],
        [(0.0, {"w": {"c": _counter_delta(1)}}), (1.5, {})]),
    "rate_fires_and_resolves": (
        [{"name": "r", "kind": "threshold", "metric": "c", "max_rate": 1.0,
          "window_s": 2.0, "clear_s": 0.5}],
        [(0.0, {"w": {"c": _counter_delta(10)}}),
         (3.0, {"w": {"c": _counter_delta(1)}}), (3.6, {})]),
    "burn_rate_fires_and_resolves": (
        [{"name": "slo", "kind": "burn_rate", "metric": "e2e",
          "bound_s": 1.0, "attainment": 0.9, "short_s": 2.0, "long_s": 6.0,
          "max_burn": 2.0, "min_samples": 4, "clear_s": 0.5}],
        [(0.0, {"w": {"e2e": _hist_delta([0, 8], s=16.0)}}),
         (7.0, {"w": {"e2e": _hist_delta([8, 0], s=0.8)}}), (7.6, {})]),
    "burn_rate_holds_below_min_samples": (
        [{"name": "slo", "kind": "burn_rate", "metric": "e2e",
          "bound_s": 1.0, "min_samples": 8, "short_s": 2.0,
          "long_s": 4.0}],
        [(0.0, {"w": {"e2e": _hist_delta([0, 3], s=6.0)}})]),
    "no_flap_inside_hysteresis": (
        [{"name": "r", "kind": "threshold", "metric": "g", "max_value": 5,
          "for_s": 1.0, "clear_s": 1.0}],
        [(i * 0.1, {"w": _square(lambda k: 10.0 if k % 2 else 0.0)(i)})
         for i in range(20)]),
    "flapping": (
        [{"name": "r", "kind": "threshold", "metric": "g", "max_value": 5,
          "for_s": 0.0, "clear_s": 0.0}],
        [(float(i), {"w": _square(lambda k: 0.0 if k % 2 else 10.0)(i)})
         for i in range(6)]),
    "nonfinite_rejected": (
        [{"name": "r", "kind": "threshold", "metric": "c", "max_value": 0}],
        [(0.0, {"evil": {"c": _counter_delta(float("nan"))}})]),
}


def _run_script(alerts_mod, store_cls, reg_mod, rules, script):
    clk = [0.0]
    store = store_cls(clock=lambda: clk[0])
    reg = reg_mod.Registry()
    eng = alerts_mod.AlertEngine(store, alerts_mod.parse_rules(rules),
                                 registry=reg, eval_interval_s=0.0,
                                 clock=lambda: clk[0])
    trail = []
    for now, frames in script:
        clk[0] = now
        for src, delta in frames.items():
            store.ingest_delta(src, delta)
        trail.append((now, eng.evaluate(force=True), eng.firing(),
                      eng.counts(), eng.state_doc()))
    return trail, reg.snapshot()


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_alert_engine_matches_jax(name):
    rules, script = _SCRIPTS[name]
    want = _run_script(jalerts, JStore, jreg, rules, script)
    got = _run_script(palerts, PStore, preg, rules, script)
    assert got == want
    if name == "flapping":
        assert got[1]["obs.alerts.flaps"]["value"] >= 1
    if name in ("threshold_for_s", "burn_rate_fires_and_resolves"):
        assert got[1]["obs.alerts.fired"]["value"] == 1


def test_attainment_signal_keeps_the_last_measured_attainment():
    """Once a burn-rate rule's windows hold too few samples,
    ``attainment_signal`` still returns the last busy window's
    attainment in both packages: an idle fleet reads the attainment of
    its last busy seconds."""
    rules, script = _SCRIPTS["burn_rate_fires_and_resolves"]
    results = {}
    for mod, store_cls in ((jalerts, JStore), (palerts, PStore)):
        clk = [0.0]
        store = store_cls(clock=lambda: clk[0])
        eng = mod.AlertEngine(store, mod.parse_rules(rules),
                              eval_interval_s=0.0, clock=lambda: clk[0])
        store.ingest_delta("w", {"e2e": _hist_delta([1, 7], s=9.0)})
        eng.evaluate(force=True)
        busy = eng.attainment_signal()
        clk[0] = 20.0                      # both windows emptied
        eng.evaluate(force=True)
        results[mod] = (busy, eng.attainment_signal())
    assert results[jalerts] == (0.125, 0.125)
    assert results[palerts] == (0.125, 0.125)


@pytest.mark.parametrize("bound", [0.0, 0.5, 1.0, 1.5, 2.0, 99.0])
def test_hist_fraction_le_matches_jax(bound):
    snap = _hist_delta([2, 3, 5], bounds=(1.0, 2.0))
    got = palerts.hist_fraction_le(snap, bound)
    assert got == jalerts.hist_fraction_le(snap, bound)
    assert got == {0.0: 0.0, 0.5: 0.0, 1.0: 0.2, 1.5: 0.2, 2.0: 0.5,
                   99.0: 0.5}[bound]  # the +Inf bucket never counts
    assert palerts.hist_fraction_le(None, bound) is None
    assert palerts.hist_fraction_le({"type": "histogram", "count": 0},
                                    bound) is None


def _center():
    rng = np.random.default_rng(0)
    return {"params": [{"kernel": rng.normal(size=(4, 3)).astype(
        np.float32)}], "state": [{}]}


def test_alerts_action_answers_the_jax_document():
    """A PS front end of each package with the baseline's rules enabled,
    polled over the wire by the port's client: the same document (rules,
    counts and the store summary but its wall-clock age)."""
    with open(_BASELINE) as f:
        rules = json.load(f)["alerts"]
    docs = []
    for srv_mod in (jsrv, psrv):
        ps = srv_mod.DeltaParameterServer(_center())
        with srv_mod.SocketParameterServer(ps) as srv:
            with pcli.PSClient("127.0.0.1", srv.port) as c:
                bare = c._rpc({"action": "alerts"})
                srv.enable_alerts(rules, eval_interval_s=0.0)
                doc = c._rpc({"action": "alerts"})
        docs.append((bare, doc))
    for bare, doc in docs:
        assert bare == {"ok": True, "alerts": None, "telemetry": None}
        assert doc["ok"]
        # the sources map names to their seconds since the last frame
        for summary in (doc["telemetry"], doc["alerts"]["store"]):
            summary["sources"] = sorted(summary["sources"])
    assert docs[1] == docs[0]
    assert [r["name"] for r in docs[1][1]["alerts"]["rules"]] == \
        [r["name"] for r in rules]


# ---------------------------------------------------------------------------
# chrome export, profiler knobs, obsview
# ---------------------------------------------------------------------------

def _records():
    recs = [
        {"event": "epoch", "ts": 10.5, "epoch": 0, "trainer": "T",
         "epoch_seconds": 0.5, "mean_loss": 1.0, "live_bytes": 1024},
        {"event": "span", "name": "ps.commit", "ts": 11.0, "seconds": 0.2,
         "trace_id": "w1", "span_id": "a1", "path": "ps.commit", "depth": 0,
         "worker": 1},
        {"event": "span", "name": "ps.apply", "ts": 11.1, "seconds": 0.05,
         "trace_id": "w1", "span_id": "b1", "parent_span": "a1",
         "path": "ps.apply", "depth": 0},
        {"event": "span", "name": "train", "ts": 12.0, "seconds": 2.0,
         "trace_id": "t0", "span_id": "c1", "path": "train", "depth": 0,
         "error": True},
        {"event": "heartbeat", "ts": 11.5, "worker_id": 10, "window": 3,
         "gap_s": 0.1, "live_bytes": "NaN"},
        {"event": "heartbeat", "ts": 11.6, "worker_id": 2, "window": 1},
        {"event": "span", "name": "bad", "ts": "Infinity", "seconds": 1.0},
    ]
    return recs


def test_chrome_trace_matches_jax(tmp_path):
    recs = _records()
    want = jexport.records_to_chrome_trace(recs)
    assert pexport.records_to_chrome_trace(recs) == want
    doc = pexport.write_chrome_trace(recs, str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(want)) == \
            json.loads(json.dumps(doc))
    assert pexport.records_to_chrome_trace([]) == \
        jexport.records_to_chrome_trace([])


def _load_obsview():
    spec = importlib.util.spec_from_file_location(
        "obsview", os.path.join(_ROOT, "scripts", "obsview.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obsview_reads_files_the_port_wrote(tmp_path):
    """``scripts/obsview.py`` unchanged on the port's files: a snapshot
    document diffs clean against itself and flags its perturbed copy, a
    continual document renders, and a JSONL run file (spans and epochs of
    a port trainer) summarizes and exports a trace."""
    obsview = _load_obsview()
    reg = preg.Registry()
    _fill(reg)
    reg.counter("jit.retraces")
    doc = {"config": {"mode": "port"}, "server": reg.snapshot()}
    base, cand = tmp_path / "a.json", tmp_path / "b.json"
    base.write_text(json.dumps(doc))
    cand.write_text(json.dumps(_perturbed(doc)))
    with redirect_stdout(io.StringIO()) as out:
        assert obsview.main(["--diff", str(base), str(base),
                             "--thresholds", _BASELINE]) == 0
        assert obsview.main(["--diff", str(base), str(cand),
                             "--thresholds", _BASELINE]) == 1
    assert "DRIFT" in out.getvalue()
    from distkeras_tpu_torch.continual import DeployGate
    gate = DeployGate(history=2, min_history=1, registry=reg, watch=("x",))
    gate.decide(gate.observe({"x": _ctr(1)}), interval=0)
    cont = tmp_path / "c.json"
    cont.write_text(json.dumps({"config": {"mode": "continual"},
                                "continual": reg.snapshot(),
                                "verdicts": gate.history_log()}))
    with redirect_stdout(io.StringIO()) as out:
        assert obsview.run_continual(str(cont)) in (0, 1)
    assert "verdict" in out.getvalue().lower()
    run = tmp_path / "run.jsonl"
    t = dkt.SingleTrainer(zoo.gpt_lm(vocab_size=16, dim=16, num_heads=2,
                                     num_blocks=1, seq_len=16,
                                     attention_impl="flash"),
                          "sgd", "sparse_categorical_crossentropy",
                          num_epoch=2, batch_size=4, metrics=str(run),
                          device="cpu")
    from distkeras_tpu_torch.data import load_lm_corpus
    t.train(load_lm_corpus(n_train=8, seq_len=16, vocab_size=16)[0])
    t.metrics.close()
    trace = tmp_path / "trace.json"
    with redirect_stdout(io.StringIO()):
        assert obsview.main([str(run)]) == 0
        assert obsview.main([str(run), "--export-trace", str(trace)]) == 0
    with open(trace) as f:
        exported = json.load(f)
    with open(run) as f:
        records = [json.loads(line) for line in f]
    assert exported == json.loads(json.dumps(
        pexport.records_to_chrome_trace(records)))


def test_trainer_profile_knobs_on_the_cpu(tmp_path, caplog):
    """``profile={"trace_dir", "trace_epochs", "step_split"}``: the chosen
    epoch is captured into ``<trace_dir>/epoch<k>/trace.json``, the split
    holds one observation per warm window call (device time 0 on a CPU
    device), and ``device_trace`` / ``profile_trace`` announce their
    directory once and stop on an exception."""
    lm = dict(vocab_size=16, dim=16, num_heads=2, num_blocks=1, seq_len=16,
              attention_impl="flash")
    from distkeras_tpu_torch.data import load_lm_corpus
    ds = load_lm_corpus(n_train=8, seq_len=16, vocab_size=16)[0]
    tdir = tmp_path / "tr"
    t = dkt.SingleTrainer(zoo.gpt_lm(**lm), "sgd",
                          "sparse_categorical_crossentropy", num_epoch=3,
                          batch_size=4, device="cpu",
                          profile={"trace_dir": str(tdir),
                                   "trace_epochs": (1,), "step_split": True})
    reg = preg.Registry()
    t.tracer.registry = reg
    t.train(ds)
    assert os.path.exists(tdir / "epoch1" / TRACE_FILE)
    assert not os.path.exists(tdir / "epoch0")
    snap = reg.snapshot()
    assert snap["step.host_seconds"]["count"] == 2
    assert snap["step.device_seconds"]["count"] == 2
    assert snap["step.device_seconds"]["sum"] == 0.0
    d = str(tmp_path / "cap")
    with caplog.at_level(logging.INFO, logger="distkeras_tpu_torch"):
        with device_trace(d):
            torch.ones(4).sum()
        with profile_trace(d):
            pass
    assert sum(d in r.getMessage() for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="boom"):
        with device_trace(str(tmp_path / "x")):
            raise RuntimeError("boom")
    with device_trace(str(tmp_path / "y")):
        pass
    assert os.path.exists(tmp_path / "y" / TRACE_FILE)
    timer = StepTimer()
    timer.mark()
    timer.mark()
    assert len(timer.laps) == 2 and timer.rate(4) > 0
    assert StepTimer().rate(4) == 0.0
    assert math.isfinite(timer.rate(4))
