"""The port's dklint (``distkeras_tpu_torch.analysis``) against the JAX
package's, and its own gate, on the CPU.

* **Parity.**  Every rule the port keeps as the JAX one gives the JAX
  rule's findings — rule, relative path, line, column and message, the
  inline-suppressed ones too — over ``distkeras_tpu/``, over
  ``distkeras_tpu_torch/`` and on every source snippet that
  ``tests/test_analysis.py`` and ``tests/test_analysis_v2.py`` lint.
  Tolerance: none, the lists are equal.
* **The twin rule.**  ``hot-path-purity`` flags host syncs and
  global-generator draws in ``# dklint: hot`` functions and their
  by-name callees, and nothing in cold code or on explicit generators.
* **Metric-contract** over ``distkeras_tpu_torch/`` against the committed
  ``OBS_BASELINE.json`` and ``scripts/obsview.py``.
* **The gate.**  ``distkeras_tpu_torch/`` is clean under the port's
  baseline, whose every entry still matches a finding.
* **Racecheck** over the port's PS: a seeded unguarded write and a
  write-after-publish are caught; the install raises on a missing class.
"""

import ast
import io
import os
import textwrap
import threading
import tokenize

import numpy as np
import pytest
import torch

from distkeras_tpu.analysis import analyze_source as jax_analyze
from distkeras_tpu.analysis import run_paths as jax_run_paths
from distkeras_tpu.analysis.rules import RULES_BY_ID as JAX_RULES

from distkeras_tpu_torch.analysis import analyze_source, racecheck, run_paths
from distkeras_tpu_torch.analysis import cli, core
from distkeras_tpu_torch.analysis.rules import RULES_BY_ID

# one torch intra-op pool per xdist worker, not one per core each
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the rules the port keeps as the JAX package's
KEPT = ("lock-discipline", "swallow-guard", "thread-shutdown", "bare-print",
        "staleness-protocol", "shm-lifecycle", "wire-seam",
        "kv-version-guard", "lock-order-cycle", "handoff-protocol")


def _rows(report):
    return ([(f.rule, f.rel, f.line, f.col, f.message)
             for f in report.findings],
            sorted((f.rule, f.rel, f.line, f.col, f.message)
                   for f in report.inline_suppressed))


def test_the_rule_sets():
    assert set(RULES_BY_ID) == (set(JAX_RULES) - {"jit-purity"}) | {
        "hot-path-purity"}
    assert all(RULES_BY_ID[r].description == JAX_RULES[r].description
               for r in KEPT)


def _without_pragmas(source: str) -> str:
    """``source`` with every ``# dklint:`` comment cut off its line."""
    lines = source.split("\n")
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.COMMENT and "dklint:" in tok.string:
            row, col = tok.start
            lines[row - 1] = lines[row - 1][:col].rstrip()
    return "\n".join(lines)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Both packages' kept rules over copies of both packages' sources
    with every ``# dklint:`` pragma taken out, so the rules have findings
    to agree on (the sources as committed are clean)."""
    base = tmp_path_factory.mktemp("stripped")
    (base / ".git").mkdir()  # the anchor: paths relative to the copy
    out = {}
    for pkg in ("distkeras_tpu", "distkeras_tpu_torch"):
        for path, rel in core.iter_py_files(os.path.join(ROOT, pkg)):
            dst = base / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            with open(path) as f:
                dst.write_text(_without_pragmas(f.read()))
        path = str(base / pkg)
        out[pkg] = (
            run_paths([path], rules=[RULES_BY_ID[r] for r in KEPT]),
            jax_run_paths([path], rules=[JAX_RULES[r] for r in KEPT]))
    return out


@pytest.mark.parametrize("pkg", ["distkeras_tpu", "distkeras_tpu_torch"])
@pytest.mark.parametrize("rule", KEPT)
def test_kept_rules_find_what_the_jax_rules_find(scans, pkg, rule):
    mine, ref = scans[pkg]
    pick = lambda rows: [r for r in rows if r[0] == rule]  # noqa: E731
    assert pick(_rows(mine)[0]) == pick(_rows(ref)[0])
    assert pick(_rows(mine)[1]) == pick(_rows(ref)[1])
    assert not mine.errors and not ref.errors


def test_the_scans_see_something(scans):
    """Parity over findings is only as good as the findings: without
    their pragmas both packages' lock contracts (``holds=``) turn into
    lock-discipline findings to agree on."""
    for pkg in scans:
        mine, _ = scans[pkg]
        assert sum(f.rule == "lock-discipline"
                   for f in mine.findings) >= 5, pkg


def _snippets():
    """Every string constant of the JAX analysis tests that parses as a
    Python module with a definition in it (the linted fixtures)."""
    found = []
    for name in ("test_analysis.py", "test_analysis_v2.py"):
        with open(os.path.join(ROOT, "tests", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and "\n" in node.value:
                src = textwrap.dedent(node.value)
                try:
                    body = ast.parse(src).body
                except SyntaxError:
                    continue
                if any(isinstance(b, (ast.FunctionDef, ast.ClassDef,
                                      ast.Assign, ast.Expr, ast.Try,
                                      ast.With, ast.For))
                       for b in body) and not all(
                        isinstance(b, ast.Expr) and
                        isinstance(b.value, ast.Constant) for b in body):
                    found.append((f"{name}:{node.lineno}", src))
    return found


SNIPPETS = _snippets()


def test_the_jax_fixtures_were_found():
    assert len(SNIPPETS) >= 60


@pytest.mark.parametrize("where,src", SNIPPETS,
                         ids=[w for w, _ in SNIPPETS])
def test_kept_rules_agree_on_the_jax_fixture_snippets(where, src):
    for rel in (None, "distkeras_tpu/ps/networking.py",
                "distkeras_tpu/serve/kvfabric.py"):
        mine = analyze_source(src, rel=rel,
                              rules=[RULES_BY_ID[r] for r in KEPT])
        ref = jax_analyze(src, rel=rel, rules=[JAX_RULES[r] for r in KEPT])
        assert _rows(mine) == _rows(ref), (where, rel)


# -- the twin rule --------------------------------------------------------

def _hot(src):
    report = analyze_source(textwrap.dedent(src),
                            rules=[RULES_BY_ID["hot-path-purity"]])
    return [f.message.split(" on the hot path")[0] for f in report.findings]


def test_hot_path_purity_flags_syncs_and_global_draws():
    got = _hot("""
        import torch
        import numpy as np

        def step(x, w, gen):  # dklint: hot
            loss = (x @ w).sum()
            print_me = loss.item()
            rows = x.tolist()
            host = x.cpu()
            arr = x.numpy()
            scale = float(loss)
            torch.cuda.synchronize()
            noise = torch.randn(3)
            mask = torch.rand_like(x)
            idx = torch.randperm(4)
            w.normal_()
            d = torch.nn.functional.dropout(x, 0.1)
            k = np.random.rand(3)
            return loss
        """)
    assert got == [
        "device->host sync `.item()`", "device->host sync `.tolist()`",
        "device->host sync `.cpu()`", "device->host sync `.numpy()`",
        "host concretization `float(...)`",
        "device sync `torch.cuda.synchronize()`",
        "global-generator draw `torch.randn()` (pass an explicit generator=)",
        "global-generator draw `torch.rand_like()` (pass an explicit "
        "generator=)",
        "global-generator draw `torch.randperm()` (pass an explicit "
        "generator=)",
        "global-generator draw `.normal_()` (pass an explicit generator=)",
        "global-generator draw `torch.nn.functional.dropout()` (no "
        "generator= exists: draw the mask from an explicit generator)",
        "global-state RNG `np.random.rand()` (use an explicit generator)"]


def test_hot_path_purity_follows_one_call_edge_and_multiline_defs():
    got = _hot("""
        def helper(t):
            return t.item()

        def deeper(t):
            return t.tolist()

        def via(t):
            return deeper(t)

        def step(x,  # dklint: hot
                 y):
            return helper(x) + via(y)
        """)
    assert got == ["device->host sync `.item()`"]


def test_hot_path_purity_negatives():
    assert _hot("""
        import torch

        def cold(x):
            torch.cuda.synchronize()
            return x.item(), torch.rand(3)

        def step(x, gen, n):  # dklint: hot
            b = int(x.shape[0]) + int(len(n)) + int(x.numel()) + int(3)
            noise = torch.randn(3, generator=gen)
            x.uniform_(generator=gen)
            rng = np.random.default_rng(0)
            y = x.to("cpu", non_blocking=True)
            z = x.item()  # dklint: disable=hot-path-purity
            return b
        """) == []


def test_the_port_marks_its_hot_paths():
    """The step functions carry the pragma: ``make_local_step`` /
    ``make_window_fn``, ``SingleTrainer``'s epoch loops, the decode
    engine's step and the kernel wrappers."""
    want = {"parallel/sync.py": {"make_local_step", "make_window_fn"},
            "trainers.py": {"_train", "_train_stream"},
            "serve/engine.py": {"_step"},
            "ops/flash_attention.py": {"flash_fwd_cuda", "flash_bwd_dq_cuda",
                                       "flash_bwd_dkv_cuda"}}
    for rel, names in want.items():
        path = os.path.join(ROOT, "distkeras_tpu_torch", rel)
        with open(path) as f:
            ctx = core.FileContext(path, f.read())
        hot = {n.name for n in ast.walk(ctx.tree)
               if isinstance(n, ast.FunctionDef) and ctx.hot(n)}
        assert names <= hot, (rel, hot)


# -- metric-contract and the gate -----------------------------------------

def test_metric_contract_over_the_port():
    """The port keeps the JAX metric names: every threshold, ignore entry,
    alert rule and obsview read of the committed files matches a creation
    site in ``distkeras_tpu_torch/`` — but for the two ``bench.*``
    families, which the JAX root ``bench.py`` creates (its PS sweep; the
    port's ``bench.py`` has no such mode)."""
    report = run_paths([os.path.join(ROOT, "distkeras_tpu_torch")],
                       rules=[RULES_BY_ID["metric-contract"]])
    assert not report.errors
    assert sorted((f.rel, f.snippet) for f in report.findings) == [
        ("OBS_BASELINE.json", '"bench.*": {'),
        ("OBS_BASELINE.json", '"bench.ps.*": {')]


def test_metric_contract_flags_a_dead_threshold_in_a_port_tree(tmp_path):
    (tmp_path / ".git").mkdir()
    pkg = tmp_path / "distkeras_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "def f(reg):\n    reg.counter('ps.commits')\n")
    (tmp_path / "OBS_BASELINE.json").write_text(
        '{"metrics": {"ps.commits": {"counter_rel": 0.5},\n'
        '             "ps.gone": {"counter_rel": 0.5}}}\n')
    report = run_paths([str(pkg)], rules=[RULES_BY_ID["metric-contract"]])
    assert [f.message.split(":")[0] for f in report.findings] == [
        "dead threshold"]
    assert "'ps.gone'" in report.findings[0].message


def test_the_port_is_dklint_clean_under_its_baseline():
    """The port's gate: every rule over ``distkeras_tpu_torch/`` finds
    nothing the port's baseline does not hold, and the baseline holds no
    entry that matches nothing."""
    report = run_paths([os.path.join(ROOT, "distkeras_tpu_torch")])
    assert not report.errors
    baseline = core.load_baseline(cli.DEFAULT_BASELINE)
    assert {f.fingerprint for f in report.findings} == baseline
    core.apply_baseline(report, baseline)
    assert report.findings == []
    assert os.path.dirname(cli.DEFAULT_BASELINE).endswith(
        os.path.join("distkeras_tpu_torch", "analysis"))


def test_the_cli_reads_the_port_baseline(capsys):
    """``python -m distkeras_tpu_torch.analysis.cli PATH`` exits 0 on a
    clean path under the port's baseline, 1 on a finding, 2 on a bad
    rule; ``--list-rules`` names the twin rule."""
    path = os.path.join(ROOT, "distkeras_tpu_torch", "ops")
    assert cli.main([path, "--rules", "hot-path-purity,bare-print"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert cli.main(["--list-rules"]) == 0
    assert "hot-path-purity" in capsys.readouterr().out
    assert cli.main([path, "--rules", "jit-purity"]) == 2
    capsys.readouterr()


def test_the_cli_reports_a_finding(tmp_path, capsys):
    (tmp_path / ".git").mkdir()
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    print('x')\n")
    assert cli.main([str(bad), "--rules", "bare-print",
                     "--format", "json"]) == 1
    out = capsys.readouterr().out
    assert '"rule": "bare-print"' in out and '"baseline": 0' in out


# -- racecheck ------------------------------------------------------------

def test_racecheck_catches_an_unguarded_write_on_the_port_ps():
    from distkeras_tpu_torch.ps.servers import DeltaParameterServer
    with racecheck.enabled() as violations:
        ps = DeltaParameterServer(
            {"params": {"w": np.zeros(4, np.float32)}, "state": {}})
        assert isinstance(ps.mutex, racecheck.TrackedLock)
        with ps.mutex:
            ps.commits_by_worker[0] = 1

        def rogue():
            ps.commits_by_worker[1] = 1  # no mutex

        t = threading.Thread(target=rogue)
        t.start()
        t.join()
        found = [(v["dict"], v["key"]) for v in violations]
        assert ("DeltaParameterServer.commits_by_worker", 1) in found
    assert not racecheck.installed()


def test_racecheck_catches_write_after_publish_on_the_port_ps():
    from distkeras_tpu_torch.ps.servers import DeltaParameterServer
    from distkeras_tpu_torch.ps.shard import (ShardedParameterServer,
                                              ShardedPSClient)
    center = {"params": [{"w": np.zeros(n, np.float32)} for n in (64, 32)],
              "state": [{}, {}]}
    ones = {"params": [{"w": np.ones(n, np.float32)} for n in (64, 32)],
            "state": [{}, {}]}
    with racecheck.enabled() as violations:
        with ShardedParameterServer(center, 2, DeltaParameterServer) as sps:
            with ShardedPSClient(sps.addrs(), center) as cl:
                cl.pull()
                cl.commit(ones)
                cl.pull()
                assert not violations, violations  # replace-style: clean
                victim = sps.shards[0]
                for leaf in victim.get_model().values():
                    np.asarray(leaf)[0] = 99.0  # in place, post-publish
                cl.commit(ones)
        found = [v for v in violations if v["op"] == "write_after_publish"]
        assert found and found[0]["dict"].endswith(".center"), violations


def test_racecheck_fingerprints_tensor_leaves():
    t = torch.zeros(3, dtype=torch.bfloat16)
    before = racecheck._fingerprint(t)
    t[0] = 1.0
    assert racecheck._fingerprint(t) != before
    assert racecheck._fingerprint(np.zeros(3)) == racecheck._fingerprint(
        np.zeros(3))


def test_racecheck_install_raises_on_a_missing_class(monkeypatch):
    """A renamed class must not turn the checker off without notice
    (the JAX install skips it); nothing stays patched."""
    from distkeras_tpu_torch.ps import servers
    from distkeras_tpu_torch.serve import kvfabric
    init = servers.ParameterServer.__init__
    monkeypatch.delattr(kvfabric, "KVFabric")
    with pytest.raises(RuntimeError, match=r"serve\.kvfabric\.KVFabric"):
        racecheck.install()
    assert not racecheck.installed()
    assert servers.ParameterServer.__init__ is init


def test_racecheck_wraps_the_serving_fleet():
    from distkeras_tpu_torch.ps.runner import FleetSupervisor
    from distkeras_tpu_torch.serve.engine import DecodeEngine
    from distkeras_tpu_torch.serve.router import ServeRouter
    from distkeras_tpu_torch.serve.kvfabric import KVFabric
    with racecheck.enabled():
        assert all(getattr(cls.__init__, "__name__", "") == "patched_init"
                   for cls in (ServeRouter, DecodeEngine, KVFabric,
                               FleetSupervisor))
    assert not any(getattr(cls.__init__, "__name__", "") == "patched_init"
                   for cls in (ServeRouter, DecodeEngine, KVFabric,
                               FleetSupervisor))
