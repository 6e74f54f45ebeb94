"""Drift detection over registry snapshots — the port's copy of
``distkeras_tpu.obs.drift``, with the same thresholds, verdicts and
report lines, so a snapshot either package wrote diffs alike.

* **counters** — relative delta ``|cand − base| / base`` against a
  ``counter_rel`` threshold (commit/pull/byte counts are deterministic
  for a fixed config, so these are tight);
* **histograms** — bucket-wise **PSI** (population stability index,
  ``Σ (q_i − p_i)·ln(q_i/p_i)`` over smoothed bucket probabilities; 0.1
  ≈ moderate, 0.25 ≈ major) plus interpolated **p50/p99 shift
  factors**, each with its own threshold;
* **gauges** — levels have no meaningful cross-run delta; skipped unless
  a per-metric ``gauge_abs`` threshold opts one in.

Thresholds resolve in three layers: built-in defaults ← the committed
``OBS_BASELINE.json``'s global ``thresholds`` ← its per-metric
``metrics`` overrides (fnmatch patterns, later entries winning;
``ignore`` patterns drop metrics entirely).  The baseline file schema is
``dktpu-obs-baseline/v1`` (``BASELINE_SCHEMA``).

The **windowed diff** over a rolling window of snapshots from ONE live
run is the continual deploy gate's: cumulative registry snapshots taken
at interval edges are differenced into per-interval deltas
(:func:`snapshot_delta` — counters/histograms subtract so each interval
describes what happened *during* it), then :func:`classify_window` tells
a **step change** (some consecutive interval pair drifts) from a
**gradual trend** (no consecutive pair drifts, but the window's
first→last diff does).  A window is *stable* only when neither fires;
that is the drift-clean condition continual deploys gate on.
"""

from __future__ import annotations

import fnmatch
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .registry import snapshot_quantile

BASELINE_SCHEMA = "dktpu-obs-baseline/v1"

#: built-in thresholds — deliberately forgiving for wall-clock-shaped
#: metrics (the committed baseline tightens/loosens per metric)
DEFAULT_THRESHOLDS: Dict[str, float] = {
    "counter_rel": 0.25,   # counters: |cand-base|/base beyond this drifts
    "counter_abs": 0.0,    # counters: absolute deltas <= this never drift
                           # (the only way to tolerate a 0 -> small change,
                           # where the relative delta is infinite)
    "psi": 0.25,           # histograms: PSI beyond this drifts
    "p50_factor": 3.0,     # histograms: p50 shift factor (either way)
    "p99_factor": 4.0,     # histograms: p99 shift factor (either way)
    "min_count": 16,       # histograms thinner than this are skipped
}

_EPS = 1e-9


def is_registry_snapshot(d) -> bool:
    """True for a plain-data ``Registry.snapshot()`` dict."""
    return isinstance(d, dict) and bool(d) and all(
        isinstance(v, dict) and "type" in v for v in d.values())


def named_registries(doc: dict) -> Dict[str, dict]:
    """A persisted snapshot document -> {registry name: snapshot}.  Both
    shapes the harness writes are accepted: a multi-registry document
    (``{"config": ..., "client": <snap>, "server": <snap>}``) and a bare
    registry snapshot (``{"ps.commits": {...}, ...}``)."""
    named = {k: v for k, v in doc.items() if is_registry_snapshot(v)}
    if not named and is_registry_snapshot(doc):
        named = {"registry": doc}
    return named


def load_baseline(path: str) -> dict:
    """Read + validate an ``OBS_BASELINE.json`` config."""
    with open(path) as f:
        cfg = json.load(f)
    if not isinstance(cfg, dict) or cfg.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{path}: not an obs baseline (want schema={BASELINE_SCHEMA!r}, "
            f"got {cfg.get('schema') if isinstance(cfg, dict) else type(cfg).__name__!r})")
    return cfg


def find_baseline(start_dir: str) -> Optional[str]:
    """Walk up from ``start_dir`` to the repo root looking for the
    committed ``OBS_BASELINE.json`` (same discovery rule as
    ``dklint_baseline.json``).  The walk stops at the first ``.git``
    marker: snapshots outside any repo must not silently adopt a stray
    config from an unrelated ancestor directory."""
    d = os.path.abspath(start_dir)
    while True:
        p = os.path.join(d, "OBS_BASELINE.json")
        if os.path.exists(p):
            return p
        if os.path.exists(os.path.join(d, ".git")):
            return None  # repo root reached without a baseline
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


class _Thresholds:
    """Three-layer threshold resolution: defaults <- baseline globals <-
    per-metric fnmatch overrides; plus ignore patterns."""

    def __init__(self, baseline: Optional[dict] = None):
        baseline = baseline or {}
        self.base = dict(DEFAULT_THRESHOLDS)
        self.base.update(baseline.get("thresholds") or {})
        self.per_metric: Dict[str, dict] = dict(baseline.get("metrics") or {})
        self.ignore: List[str] = list(baseline.get("ignore") or [])

    def ignored(self, metric: str) -> bool:
        names = (metric, metric.split("/", 1)[-1])
        return any(fnmatch.fnmatch(n, pat)
                   for pat in self.ignore for n in names)

    def for_metric(self, metric: str) -> dict:
        th = dict(self.base)
        names = (metric, metric.split("/", 1)[-1])
        # authoring-order layering: a later entry in the config file
        # overrides an earlier one, so specificity is expressed by
        # writing broad patterns first (JSON object order is preserved).
        # Lexical sorting could never let a part-scoped pattern like
        # "scenario_*/serve.*" override an exact "serve.*" name.
        for pat in self.per_metric:
            if any(fnmatch.fnmatch(n, pat) for n in names):
                th.update(self.per_metric[pat])
        return th


def psi(base: dict, cand: dict) -> float:
    """Bucket-wise population stability index between two histogram
    snapshots with identical bounds.  Bucket probabilities are Laplace-
    smoothed so empty buckets never produce infinities."""
    bc, cc = base["counts"], cand["counts"]
    nb, nc = max(1, base["count"]), max(1, cand["count"])
    k = len(bc)
    score = 0.0
    for b, c in zip(bc, cc):
        p = (b + 0.5) / (nb + 0.5 * k)
        q = (c + 0.5) / (nc + 0.5 * k)
        score += (q - p) * math.log(q / p)
    return score


def _shift_factor(base_q: float, cand_q: float) -> float:
    """Symmetric quantile shift factor ≥ 1 (1 = no shift)."""
    b, c = base_q + _EPS, cand_q + _EPS
    return max(b / c, c / b)


class Finding(dict):
    """One per-metric comparison result — a dict (JSON-friendly) with
    attribute sugar for the fields every consumer reads."""

    @property
    def drifted(self) -> bool:
        return bool(self.get("drifted"))


def _compare_metric(metric: str, b: dict, c: dict, th: dict) -> Finding:
    if b["type"] != c["type"]:
        return Finding(metric=metric, kind="type", drifted=True,
                       detail=f"type {b['type']} -> {c['type']}")
    if b["type"] == "counter":
        bv, cv = float(b["value"]), float(c["value"])
        if abs(cv - bv) <= th.get("counter_abs", 0.0):
            return Finding(metric=metric, kind="counter", drifted=False,
                           rel=0.0, base=bv, cand=cv)
        rel = abs(cv - bv) / abs(bv) if bv else math.inf
        return Finding(metric=metric, kind="counter", base=bv, cand=cv,
                       rel=rel, threshold=th["counter_rel"],
                       drifted=rel > th["counter_rel"],
                       detail=f"{bv:g} -> {cv:g} "
                              f"(Δ{rel * 100 if math.isfinite(rel) else math.inf:.0f}% "
                              f"vs {th['counter_rel'] * 100:.0f}%)")
    if b["type"] == "gauge":
        gauge_abs = th.get("gauge_abs")
        if gauge_abs is None:
            return Finding(metric=metric, kind="gauge", drifted=False,
                           skipped=True, detail="gauges skipped by default")
        delta = abs(float(c["value"]) - float(b["value"]))
        return Finding(metric=metric, kind="gauge", base=b["value"],
                       cand=c["value"], threshold=gauge_abs,
                       drifted=delta > gauge_abs,
                       detail=f"{b['value']:g} -> {c['value']:g}")
    # histogram
    if list(b["bounds"]) != list(c["bounds"]):
        return Finding(metric=metric, kind="bounds", drifted=True,
                       detail="bucket bounds differ (schema change)")
    if b["count"] < th["min_count"] or c["count"] < th["min_count"]:
        return Finding(metric=metric, kind="histogram", drifted=False,
                       skipped=True,
                       detail=f"too thin (n={b['count']}/{c['count']} < "
                              f"{th['min_count']})")
    score = psi(b, c)
    p50b, p50c = snapshot_quantile(b, 0.5), snapshot_quantile(c, 0.5)
    p99b, p99c = snapshot_quantile(b, 0.99), snapshot_quantile(c, 0.99)
    f50, f99 = _shift_factor(p50b, p50c), _shift_factor(p99b, p99c)
    reasons = []
    if score > th["psi"]:
        reasons.append(f"psi={score:.3f}>{th['psi']:g}")
    if f50 > th["p50_factor"]:
        reasons.append(f"p50 {p50b:.3g}->{p50c:.3g} "
                       f"({f50:.1f}x>{th['p50_factor']:g}x)")
    if f99 > th["p99_factor"]:
        reasons.append(f"p99 {p99b:.3g}->{p99c:.3g} "
                       f"({f99:.1f}x>{th['p99_factor']:g}x)")
    return Finding(metric=metric, kind="histogram", psi=score,
                   p50=(p50b, p50c), p99=(p99b, p99c),
                   p50_factor=f50, p99_factor=f99,
                   drifted=bool(reasons),
                   detail="  ".join(reasons) if reasons else
                          f"psi={score:.3f} p50x{f50:.2f} p99x{f99:.2f}")


class DriftReport:
    """Comparison of two snapshot documents: per-metric findings plus a
    render for humans; ``drifted`` drives the CI exit code."""

    def __init__(self, base_name: str, cand_name: str,
                 findings: List[Finding], notes: List[str]):
        self.base_name = base_name
        self.cand_name = cand_name
        self.findings = findings
        self.notes = notes

    @property
    def drifted(self) -> bool:
        return any(f.drifted for f in self.findings)

    @property
    def drifted_metrics(self) -> List[str]:
        return [f["metric"] for f in self.findings if f.drifted]

    def lines(self) -> List[str]:
        out = [f"== Obs drift: {self.base_name} -> {self.cand_name} =="]
        out.extend(f"note  {n}" for n in self.notes)
        width = max((len(f["metric"]) for f in self.findings), default=0)
        compared = skipped = 0
        for f in sorted(self.findings,
                        key=lambda f: (not f.drifted, f["metric"])):
            if f.get("skipped"):
                skipped += 1
                continue
            compared += 1
            tag = "DRIFT" if f.drifted else "ok   "
            out.append(f"{tag} {f['metric']:<{width}}  {f.get('detail', '')}"
                       .rstrip())
        n_drift = len(self.drifted_metrics)
        out.append(f"{compared} compared, {n_drift} drifted, "
                   f"{skipped} skipped")
        return out

    def render(self) -> str:
        return "\n".join(self.lines())


def diff_docs(base_doc: dict, cand_doc: dict,
              baseline: Optional[dict] = None,
              base_name: str = "base", cand_name: str = "candidate"
              ) -> DriftReport:
    """Diff two persisted snapshot documents (multi-registry or bare).

    Metrics are keyed ``<registry>/<instrument>``; a metric missing from
    the candidate (instrumentation removed) or newly appearing (added) is
    a note, not drift — the gate is about distributions moving, schema
    evolution is reviewed in the diff that changes it."""
    th = _Thresholds(baseline)
    base_regs, cand_regs = named_registries(base_doc), named_registries(cand_doc)
    findings: List[Finding] = []
    notes: List[str] = []

    bcfg, ccfg = base_doc.get("config"), cand_doc.get("config")
    if isinstance(bcfg, dict) and isinstance(ccfg, dict) and bcfg != ccfg:
        diff_keys = sorted(k for k in set(bcfg) | set(ccfg)
                           if bcfg.get(k) != ccfg.get(k))
        notes.append("config differs (" + ", ".join(
            f"{k}: {bcfg.get(k)!r}->{ccfg.get(k)!r}" for k in diff_keys)
            + ") — deltas may reflect the config, not a regression")

    for reg in sorted(set(base_regs) | set(cand_regs)):
        if reg not in cand_regs:
            notes.append(f"registry {reg!r} missing from {cand_name}")
            continue
        if reg not in base_regs:
            notes.append(f"registry {reg!r} new in {cand_name}")
            continue
        b, c = base_regs[reg], cand_regs[reg]
        prefix = f"{reg}/" if len(base_regs) > 1 or reg != "registry" else ""
        for name in sorted(set(b) | set(c)):
            metric = prefix + name
            if th.ignored(metric):
                continue
            if name not in c:
                notes.append(f"{metric} missing from {cand_name}")
                continue
            if name not in b:
                notes.append(f"{metric} new in {cand_name}")
                continue
            findings.append(
                _compare_metric(metric, b[name], c[name],
                                th.for_metric(metric)))
    return DriftReport(base_name, cand_name, findings, notes)


# ---------------------------------------------------------------------------
# windowed diff over one live run (the continual deploy gate)
# ---------------------------------------------------------------------------

#: the three windowed-diff outcomes, in increasing order of alarm
WINDOW_KINDS = ("stable", "step", "trend")


def _instrument_delta(base: dict, cand: dict) -> dict:
    """One instrument's interval delta (see :func:`snapshot_delta`)."""
    if base.get("type") != cand.get("type"):
        return dict(cand)  # instrument re-registered as a new kind
    if cand["type"] == "counter":
        d = float(cand["value"]) - float(base["value"])
        # a negative delta means the process restarted mid-window; the
        # cand value IS that fresh process's interval
        return {"type": "counter", "value": d if d >= 0 else cand["value"]}
    if cand["type"] == "gauge":
        return dict(cand)  # levels have no meaningful subtraction
    if list(base["bounds"]) != list(cand["bounds"]):
        return dict(cand)  # schema change: start the series over
    counts = [c - b for b, c in zip(base["counts"], cand["counts"])]
    if any(c < 0 for c in counts):
        return dict(cand)  # restart mid-window
    return {"type": "histogram", "bounds": list(cand["bounds"]),
            "counts": counts, "sum": cand["sum"] - base["sum"],
            "count": cand["count"] - base["count"]}


def snapshot_delta(base: dict, cand: dict) -> dict:
    """Interval delta between two cumulative ``Registry.snapshot()``s of
    the SAME live registry taken at t0 < t1: counters and histograms
    subtract (the delta describes what happened *during* [t0, t1]),
    gauges keep the later level.  Metrics born mid-interval enter at
    their cand value; metrics that vanished are dropped.  This is what
    makes a long-running process's snapshots comparable as a series —
    raw cumulative counters only ever grow, so consecutive raw snapshots
    would always "drift"."""
    out = {}
    for name, c in cand.items():
        b = base.get(name)
        out[name] = _instrument_delta(b, c) if b is not None else dict(c)
    return out


class WindowVerdict(dict):
    """One windowed-diff classification — a plain dict (JSON-friendly,
    rides obs documents and the deploy log) with the sugar consumers
    read: ``kind`` ∈ :data:`WINDOW_KINDS`, ``clean`` gates deploys."""

    @property
    def kind(self) -> str:
        return self.get("kind", "stable")

    @property
    def clean(self) -> bool:
        return self.kind == "stable"

    @property
    def dirty_metrics(self) -> List[str]:
        return sorted(set(self.get("step_metrics", []))
                      | set(self.get("trend_metrics", [])))


def classify_window(intervals: Sequence[dict], baseline: Optional[dict] = None
                    ) -> WindowVerdict:
    """Classify a rolling window of per-interval snapshots (the outputs
    of :func:`snapshot_delta`, oldest first) as ``stable`` / ``step`` /
    ``trend``:

    * **step** — some *consecutive* interval pair drifts under the
      normal :func:`diff_docs` thresholds: an abrupt jump.  The verdict
      stays dirty until the offending pair slides out of the window —
      i.e. until every retained interval is post-jump and mutually
      stable again.
    * **trend** — no consecutive pair drifts, but the window's first →
      last cumulative diff does: gradual creep, each step under
      threshold, the sum over the window past it (the drift item's
      long-open step-vs-trend distinction).
    * **stable** — neither; the drift-clean condition deploys gate on.

    Fewer than 2 intervals classify ``stable`` with ``intervals`` naming
    how thin the evidence is — warm-up gating is the deploy gate's job
    (``min_history``), not the classifier's."""
    intervals = list(intervals)
    n = len(intervals)
    verdict = WindowVerdict(kind="stable", intervals=n,
                            step_metrics=[], trend_metrics=[], details=[])
    if n < 2:
        verdict["details"] = ["fewer than 2 intervals: nothing to compare"]
        return verdict
    step: Dict[str, str] = {}
    for i in range(n - 1):
        rep = diff_docs(intervals[i], intervals[i + 1], baseline=baseline,
                        base_name=f"interval[{i}]",
                        cand_name=f"interval[{i + 1}]")
        for f in rep.findings:
            if f.drifted and f["metric"] not in step:
                step[f["metric"]] = (f"step {i}->{i + 1}: "
                                     f"{f.get('detail', '')}".rstrip())
    cum = diff_docs(intervals[0], intervals[-1], baseline=baseline,
                    base_name="interval[0]", cand_name=f"interval[{n - 1}]")
    trend = {f["metric"]: f"trend 0->{n - 1}: {f.get('detail', '')}".rstrip()
             for f in cum.findings
             if f.drifted and f["metric"] not in step}
    verdict["step_metrics"] = sorted(step)
    verdict["trend_metrics"] = sorted(trend)
    verdict["details"] = [step[m] for m in sorted(step)] + \
                         [trend[m] for m in sorted(trend)]
    verdict["kind"] = "step" if step else ("trend" if trend else "stable")
    return verdict


def diff_files(base_path: str, cand_path: str,
               baseline: Optional[dict] = None) -> DriftReport:
    """Diff two snapshot JSON files (the ``obsview --diff`` body)."""
    docs = []
    for p in (base_path, cand_path):
        with open(p) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or not named_registries(doc):
            raise ValueError(f"{p}: no registry snapshot found "
                             "(is this a JSONL record stream?)")
        docs.append(doc)
    return diff_docs(docs[0], docs[1], baseline=baseline,
                     base_name=os.path.basename(base_path),
                     cand_name=os.path.basename(cand_path))
