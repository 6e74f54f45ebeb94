"""dklint project rules — the rules that need the whole repo.

Per-file rules (``rules.py``) see one AST; these see the
``graph.ProjectGraph`` built over every scanned file and reason across
call, inheritance and configuration edges:

* ``lock-order-cycle`` — the static lock-acquisition-order graph.  An
  edge A→B means some code path takes lock B while holding A (lexical
  ``with`` nesting, ``# dklint: holds=`` entry contracts, and ONE
  call-edge level — the jit-purity precedent).  A cycle is a potential
  deadlock: two threads entering the cycle from different nodes can each
  hold the lock the other needs.  Nested acquisition of a non-reentrant
  ``Lock`` the thread already holds is reported directly (a guaranteed
  self-deadlock); ``RLock`` re-entry is legal and never an edge.
* ``metric-contract`` — cross-checks the three places a metric name
  lives: creation sites in code (``registry.counter/gauge/histogram``
  literals and f-strings, span names), the drift-gate config
  (``OBS_BASELINE.json`` per-metric thresholds / ignore list /
  snapshot files) and the ``scripts/obsview.py`` renderers.  A
  threshold that matches no creation site gates nothing; a renderer
  read nobody emits renders a permanent blank; an exactly-gated counter
  created on first use violates the "0 is present, not missing"
  invariant the drift gate depends on (a missing metric is skipped, a
  present 0 is compared).
* ``handoff-protocol`` — the static analogue of racecheck's
  write-lockset check: handing an object that carries bare mutable
  containers and owns no lock to another thread (``Thread(args=...)``,
  ``queue.put``, callback/hook registration) publishes unguarded state.

All three follow dklint's precedent: conservative resolution, so an
edge we cannot prove is silence (recall cost), never a false positive.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, Rule
from .graph import FuncInfo, LockNode, ProjectGraph


class ProjectRule(Rule):
    """A rule that runs once over the whole scan (``check_project``)
    instead of per file.  ``check`` is a no-op so mixed rule lists keep
    working everywhere a plain ``Rule`` is accepted."""

    project = True

    def check(self, ctx) -> List[Finding]:
        return []

    def check_project(self, graph: ProjectGraph) -> List[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# lock-order-cycle
# ---------------------------------------------------------------------------

class _Edge:
    """First witness for one lock-order edge A -> B."""

    __slots__ = ("src", "dst", "ctx", "node", "how")

    def __init__(self, src: LockNode, dst: LockNode, ctx, node, how: str):
        self.src = src
        self.dst = dst
        self.ctx = ctx
        self.node = node
        self.how = how  # human description of the acquisition


class LockOrderCycleRule(ProjectRule):
    id = "lock-order-cycle"
    description = ("static lock-acquisition-order graph over the whole "
                   "repo; cycles are potential deadlocks, nested "
                   "re-acquisition of a non-reentrant Lock is a "
                   "guaranteed one")

    _MAX_CYCLE = 6

    def check_project(self, graph: ProjectGraph) -> List[Finding]:
        findings: List[Finding] = []
        edges: Dict[Tuple[str, str], _Edge] = {}
        for fn in graph.functions:
            self._walk_function(graph, fn, edges, findings)
        findings.extend(self._cycle_findings(edges))
        return findings

    # -- per-function lexical walk ------------------------------------------
    def _walk_function(self, graph: ProjectGraph, fn: FuncInfo,
                       edges: Dict[Tuple[str, str], _Edge],
                       findings: List[Finding]) -> None:
        local_types = graph._local_types(fn)
        held = list(graph.held_at_entry(fn))
        body = getattr(fn.node, "body", [])
        self._walk_block(graph, fn, body, held, local_types,
                         edges, findings)

    def _walk_block(self, graph, fn, stmts, held, local_types,
                    edges, findings) -> None:
        for stmt in stmts:
            self._walk_stmt(graph, fn, stmt, held, local_types,
                            edges, findings)

    def _walk_stmt(self, graph, fn, stmt, held, local_types,
                   edges, findings) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # a nested def runs later, not under this held set
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: List[LockNode] = []
            for item in stmt.items:
                lock = graph.resolve_lock_ref(fn, item.context_expr,
                                              local_types)
                if lock is None:
                    self._scan_calls(graph, fn, item.context_expr, held,
                                     local_types, edges)
                    continue
                for h in held:
                    if h.id == lock.id:
                        if lock.kind == "Lock":
                            findings.append(self.finding(
                                fn.module.ctx, item.context_expr,
                                f"self-deadlock: {fn.qname} re-acquires "
                                f"non-reentrant lock {lock.label} it "
                                f"already holds (make it an RLock or "
                                f"hoist the outer acquisition)"))
                    else:
                        self._edge(edges, h, lock, fn.module.ctx,
                                   item.context_expr,
                                   f"{fn.qname} takes {lock.label} in a "
                                   f"`with` while holding {h.label}")
                acquired.append(lock)
            self._walk_block(graph, fn, stmt.body,
                             held + acquired, local_types,
                             edges, findings)
            return
        # other statements: recurse into child statement blocks, scan
        # the expression parts for calls made while locks are held
        for field, value in ast.iter_fields(stmt):
            if isinstance(value, list) and value and \
                    isinstance(value[0], ast.stmt):
                self._walk_block(graph, fn, value, held, local_types,
                                 edges, findings)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.excepthandler):
                        self._walk_block(graph, fn, v.body, held,
                                         local_types, edges, findings)
                    elif isinstance(v, ast.AST):
                        self._scan_calls(graph, fn, v, held,
                                         local_types, edges)
            elif isinstance(value, ast.AST):
                self._scan_calls(graph, fn, value, held, local_types,
                                 edges)

    def _scan_calls(self, graph, fn, expr, held, local_types,
                    edges) -> None:
        """ONE call-edge level: while holding ``held``, a resolved
        callee's own direct acquisitions become order edges (witnessed
        at the call site).  Lambda bodies run later — skipped."""
        if not held:
            return
        for node in self._walk_no_lambda(expr):
            if not isinstance(node, ast.Call):
                continue
            callee = graph._resolve_call(fn, node, local_types)
            if callee is None or callee is fn:
                continue
            for lock, _ in callee.acquires:
                for h in held:
                    if h.id == lock.id:
                        continue  # re-entry handled by callee's own walk
                    self._edge(edges, h, lock, fn.module.ctx, node,
                               f"{fn.qname} calls {callee.qname} "
                               f"(which takes {lock.label}) while "
                               f"holding {h.label}")

    @staticmethod
    def _walk_no_lambda(root):
        stack = [root]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, ast.Lambda):
                    stack.append(child)

    @staticmethod
    def _edge(edges, src: LockNode, dst: LockNode, ctx, node,
              how: str) -> None:
        key = (src.id, dst.id)
        if key not in edges:
            edges[key] = _Edge(src, dst, ctx, node, how)

    # -- cycles -------------------------------------------------------------
    def _cycle_findings(self, edges: Dict[Tuple[str, str], _Edge]
                        ) -> List[Finding]:
        adj: Dict[str, List[str]] = {}
        for (u, v) in edges:
            adj.setdefault(u, []).append(v)
        for vs in adj.values():
            vs.sort()
        cycles: List[Tuple[str, ...]] = []

        def dfs(start: str, node: str, path: List[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt == start and len(path) >= 2:
                    cycles.append(tuple(path))
                elif nxt > start and nxt not in path and \
                        len(path) < self._MAX_CYCLE:
                    dfs(start, nxt, path + [nxt])

        # each cycle enumerated exactly once: rooted at its smallest node
        for start in sorted(adj):
            dfs(start, start, [start])

        findings = []
        for cyc in sorted(cycles):
            witnesses = []
            for i, u in enumerate(cyc):
                v = cyc[(i + 1) % len(cyc)]
                e = edges[(u, v)]
                witnesses.append(e)
            label = " -> ".join([edges[(cyc[0], cyc[1])].src.label] +
                                [w.dst.label for w in witnesses])
            detail = "; ".join(
                f"{w.how} at {w.ctx.rel}:{w.node.lineno}"
                for w in witnesses)
            first = witnesses[0]
            findings.append(self.finding(
                first.ctx, first.node,
                f"potential deadlock: lock-order cycle {label} "
                f"({detail}) — pick one acquisition order and hoist or "
                f"drop the inner lock"))
        return findings


# ---------------------------------------------------------------------------
# metric-contract
# ---------------------------------------------------------------------------

#: instrument factories on a registry (or bare constructors)
_CREATE_METHODS = {"counter", "gauge", "histogram"}
_CREATE_CTORS = {"Counter", "Gauge", "Histogram"}
#: span factories — span names render next to metrics in obsview
_SPAN_METHODS = {"span", "_span"}
#: chained-use methods: ``registry.counter("x").inc()`` creates on first
#: use — exactly the shape the present-0 contract forbids on gated names
_USE_METHODS = {"inc", "add", "dec", "set", "observe"}

_METRIC_NAME = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_*]+)+$")


class _Site:
    __slots__ = ("rel", "line", "snippet", "chained", "is_glob", "kind")

    def __init__(self, rel, line, snippet, chained, is_glob, kind):
        self.rel = rel
        self.line = line
        self.snippet = snippet
        self.chained = chained
        self.is_glob = is_glob
        self.kind = kind  # "counter" | "gauge" | "histogram" | "span"


@lru_cache(maxsize=4096)
def _globs_intersect(a: str, b: str) -> bool:
    """Whether two ``*``-wildcard patterns share any concrete string."""
    if not a and not b:
        return True
    if a.startswith("*"):
        return _globs_intersect(a[1:], b) or \
            (bool(b) and _globs_intersect(a, b[1:]))
    if b.startswith("*"):
        return _globs_intersect(a, b[1:]) or \
            (bool(a) and _globs_intersect(a[1:], b))
    return bool(a) and bool(b) and a[0] == b[0] and \
        _globs_intersect(a[1:], b[1:])


def _lcs_len(a: str, b: str) -> int:
    """Longest common substring length (tiny inputs; O(len*len))."""
    best = 0
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0] * (len(b) + 1)
        for j, cb in enumerate(b, start=1):
            if ca == cb:
                cur[j] = prev[j - 1] + 1
                best = max(best, cur[j])
        prev = cur
    return best


def _pattern_matches_site(pattern: str, site_name: str,
                          site_glob: bool) -> bool:
    if not site_glob:
        return fnmatch.fnmatchcase(site_name, pattern)
    if not _globs_intersect(pattern, site_name):
        return False
    if "*" not in pattern:
        return True
    # glob vs glob: pure intersection is weak evidence (any open-ended
    # f-string creation "intersects" any suffix pattern) — additionally
    # require a shared literal fragment, so `*pull_cache_hits` is
    # matched by `*.pull_cache_hits` but not by `continual.verdicts_*`
    return _lcs_len(pattern.replace("*", "\x00"),
                    site_name.replace("*", "\x01")) >= 4


class MetricContractRule(ProjectRule):
    id = "metric-contract"
    description = ("every metric name must agree across creation sites, "
                   "OBS_BASELINE.json thresholds, alert rules and obsview "
                   "renderers; exactly-gated counters must be pre-created "
                   "(0 is present, not missing)")

    #: sources scanned for creation sites IN ADDITION to the lint paths:
    #: the port's package (its ``bench.py`` included), so a partial scan
    #: (``--changed``, a subdirectory) still sees every creation site —
    #: otherwise metrics created outside the scanned subset would all
    #: read as "dead".  The port keeps the JAX package's metric names, so
    #: its sites are held against the same committed ``OBS_BASELINE.json``
    #: and ``scripts/obsview.py``, which it reads and never writes.
    _AUX = ("distkeras_tpu_torch",)

    def check_project(self, graph: ProjectGraph) -> List[Finding]:
        root = self._repo_root(graph)
        if root is None:
            return []
        baseline_path = os.path.join(root, "OBS_BASELINE.json")
        if not os.path.isfile(baseline_path):
            return []
        try:
            with open(baseline_path, encoding="utf-8") as f:
                baseline = json.load(f)
            baseline_lines = open(baseline_path,
                                  encoding="utf-8").read().splitlines()
        except (OSError, json.JSONDecodeError):
            return []

        sites = self._creation_sites(graph, root)
        findings: List[Finding] = []
        self._check_baseline(root, baseline_path, baseline,
                             baseline_lines, sites, findings)
        self._check_alerts(root, baseline_path, baseline,
                           baseline_lines, sites, findings)
        self._check_obsview(root, sites, findings)
        self._check_precreated(baseline, sites, findings)
        return findings

    # -- plumbing -----------------------------------------------------------
    @staticmethod
    def _repo_root(graph: ProjectGraph) -> Optional[str]:
        from . import core
        for ctx in graph.contexts:
            if os.path.isfile(ctx.path):
                return core.find_anchor(ctx.path)
        return None

    def _creation_sites(self, graph: ProjectGraph,
                        root: str) -> Dict[str, List[_Site]]:
        """metric/span name (exact or ``*``-glob) -> creation sites,
        collected from the scanned graph plus the aux sources.

        A creation call carrying ``labels={...}`` registers
        as the glob ``<name>.*`` — the instrument's FLAT name appends
        sorted ``<key><value>`` parts, so baseline patterns and obsview
        reads against the flattened family keep matching.  The literal
        label keys seen per base name land in ``self._labels_at`` for
        the alert-rule typo check."""
        sites: Dict[str, List[_Site]] = {}
        self._labels_at: Dict[str, Set[str]] = {}
        trees: List[Tuple[str, ast.AST]] = [
            (ctx.rel, ctx.tree) for ctx in graph.contexts]
        scanned = {c.rel for c in graph.contexts}
        for aux in self._AUX:
            full = os.path.join(root, aux)
            files = []
            if os.path.isfile(full):
                files = [full]
            elif os.path.isdir(full):
                for dirpath, dirnames, names in os.walk(full):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if not d.startswith(".") and d != "__pycache__")
                    files.extend(os.path.join(dirpath, f)
                                 for f in sorted(names)
                                 if f.endswith(".py"))
            for path in files:
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                if rel in scanned:
                    continue
                try:
                    with open(path, encoding="utf-8") as f:
                        tree = ast.parse(f.read(), filename=path)
                except (OSError, SyntaxError):
                    continue
                trees.append((rel, tree))
        for rel, tree in trees:
            chained_ids = self._chained_creations(tree)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                func = node.func
                kind = None
                if isinstance(func, ast.Attribute):
                    if func.attr in _CREATE_METHODS:
                        kind = func.attr
                    elif func.attr in _SPAN_METHODS:
                        kind = "span"
                elif isinstance(func, ast.Name) and \
                        func.id in _CREATE_CTORS:
                    kind = func.id.lower()
                if kind is None:
                    continue
                name = self._literal_name(node.args[0])
                if name is None or not _METRIC_NAME.match(
                        name.replace("*", "x")):
                    continue
                label_keys = self._label_keys(node)
                if label_keys is not None:
                    # labeled instrument: only flattened names exist at
                    # runtime — register the family glob, not the base
                    self._labels_at.setdefault(name, set()).update(
                        label_keys)
                    sites.setdefault(name + ".*", []).append(_Site(
                        rel, node.lineno, "", id(node) in chained_ids,
                        True, kind))
                    continue
                sites.setdefault(name, []).append(_Site(
                    rel, node.lineno, "", id(node) in chained_ids,
                    "*" in name, kind))
        return sites

    @staticmethod
    def _label_keys(node: ast.Call) -> Optional[Set[str]]:
        """Literal label keys of a creation call's ``labels={...}``
        keyword; ``None`` when the call is unlabeled (no kwarg, or a
        literal ``labels=None``)."""
        for kw in node.keywords:
            if kw.arg != "labels":
                continue
            v = kw.value
            if isinstance(v, ast.Constant) and v.value is None:
                return None
            keys: Set[str] = set()
            if isinstance(v, ast.Dict):
                keys = {k.value for k in v.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
            return keys  # non-literal dicts: labeled, keys unknown
        return None

    @staticmethod
    def _chained_creations(tree: ast.AST) -> Set[int]:
        """ids of creation Calls that are immediately used —
        ``....counter("x").inc()`` — i.e. created on first use."""
        out: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _USE_METHODS and \
                    isinstance(node.func.value, ast.Call):
                inner = node.func.value
                f = inner.func
                if (isinstance(f, ast.Attribute) and
                        f.attr in _CREATE_METHODS) or \
                        (isinstance(f, ast.Name) and
                         f.id in _CREATE_CTORS):
                    out.add(id(inner))
        return out

    @staticmethod
    def _literal_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                else:
                    parts.append("*")
            return "".join(parts)
        return None

    def _file_finding(self, rel_display: str, lines: Sequence[str],
                      needle: str, message: str) -> Finding:
        lineno, snippet = 1, ""
        for i, text in enumerate(lines, start=1):
            if needle in text:
                lineno, snippet = i, text.strip()
                break
        return Finding(rule=self.id, path=rel_display, rel=rel_display,
                       line=lineno, col=0, message=message,
                       snippet=snippet)

    # -- checks -------------------------------------------------------------
    @staticmethod
    def _matches_any(pattern: str, sites: Dict[str, List[_Site]]) -> bool:
        tail = pattern.rsplit("/", 1)[-1]  # part-scoped: match the tail
        return any(_pattern_matches_site(tail, name, s[0].is_glob)
                   for name, s in sites.items())

    def _check_baseline(self, root, baseline_path, baseline,
                        baseline_lines, sites, findings) -> None:
        rel = os.path.relpath(baseline_path, root).replace(os.sep, "/")
        for pattern in baseline.get("metrics", {}):
            if self._matches_any(pattern, sites):
                continue
            findings.append(self._file_finding(
                rel, baseline_lines, f'"{pattern}"',
                f"dead threshold: pattern '{pattern}' matches no metric "
                f"creation site anywhere in the repo — it gates nothing "
                f"(renamed metric? remove or re-point it)"))
        for pattern in baseline.get("ignore", []):
            if self._matches_any(pattern, sites):
                continue
            findings.append(self._file_finding(
                rel, baseline_lines, f'"{pattern}"',
                f"dead ignore entry: '{pattern}' matches no metric "
                f"creation site — it hides nothing"))
        for mode, fname in baseline.get("snapshots", {}).items():
            if not os.path.isfile(os.path.join(root, fname)):
                findings.append(self._file_finding(
                    rel, baseline_lines, f'"{fname}"',
                    f"snapshot file '{fname}' (mode '{mode}') does not "
                    f"exist — the drift gate for that bench is vacuous"))

    def _check_alerts(self, root, baseline_path, baseline,
                      baseline_lines, sites, findings) -> None:
        """Alert rules are part of the metric contract: a
        rule whose metric (flat or labeled) resolves to no creation site
        can never fire — silently.  Structural problems (unknown keys,
        label keys outside the shared vocabulary) surface through the
        same strict parser the live engine uses, so lint and runtime
        reject identical shapes."""
        doc = baseline.get("alerts")
        if not doc:
            return
        rel = os.path.relpath(baseline_path, root).replace(os.sep, "/")
        try:
            from ..obs.alerts import parse_rules
        except ImportError:
            return
        try:
            rules = parse_rules(doc)
        except ValueError as e:
            findings.append(self._file_finding(
                rel, baseline_lines, '"alerts"',
                f"malformed alert rules: {e}"))
            return
        labels_at = getattr(self, "_labels_at", {})
        for rule in rules:
            flat = rule.flat_metric()
            if not self._matches_any(flat, sites):
                findings.append(self._file_finding(
                    rel, baseline_lines, f'"{rule.name}"',
                    f"dead alert rule '{rule.name}': metric '{flat}' "
                    f"matches no creation site anywhere in the repo — "
                    f"it can never fire (renamed metric? label typo?)"))
                continue
            known = labels_at.get(rule.metric)
            for k in (rule.labels or {}):
                if known and k not in known:
                    findings.append(self._file_finding(
                        rel, baseline_lines, f'"{rule.name}"',
                        f"alert rule '{rule.name}': label key '{k}' is "
                        f"never used at a creation site of "
                        f"'{rule.metric}' (sites label by "
                        f"{sorted(known)}) — likely a typo"))

    def _check_obsview(self, root, sites, findings) -> None:
        path = os.path.join(root, "scripts", "obsview.py")
        if not os.path.isfile(path):
            return
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError):
            return
        lines = source.splitlines()
        seen: Set[str] = set()
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant) and
                    isinstance(node.value, str)):
                continue
            name = node.value
            if name in seen or not _METRIC_NAME.match(name):
                continue
            seen.add(name)
            # prefix reads (startswith/filter keys) match like globs
            matched = any(
                _pattern_matches_site(name, s_name, s[0].is_glob) or
                _pattern_matches_site(name + "*", s_name, s[0].is_glob)
                for s_name, s in sites.items())
            if not matched:
                findings.append(self._file_finding(
                    "scripts/obsview.py", lines, f'"{name}"',
                    f"renderer reads metric '{name}' that no code "
                    f"creates — the panel cell is permanently blank "
                    f"(renamed metric?)"))

    def _check_precreated(self, baseline, sites, findings) -> None:
        """Exactly-gated counters must be pre-created somewhere: if
        EVERY creation site for a gated name is chained
        (create-on-first-use), a run where the path never fires omits
        the metric and the gate silently skips instead of comparing 0.
        Counters with exact literal names only — a templated
        per-instance name (``*.worker3``) cannot be pre-created at init,
        and gauges/histograms are not counter-gated."""
        exact_gates = [
            p.rsplit("/", 1)[-1]
            for p, th in baseline.get("metrics", {}).items()
            if isinstance(th, dict) and
            (th.get("counter_abs") == 0 or th.get("counter_rel") == 0)]
        for name, slist in sorted(sites.items()):
            if "*" in name or not all(
                    s.chained and s.kind == "counter" for s in slist):
                continue
            if not any(fnmatch.fnmatchcase(name, g)
                       for g in exact_gates):
                continue
            s = slist[0]
            findings.append(Finding(
                rule=self.id, path=s.rel, rel=s.rel, line=s.line, col=0,
                message=f"exactly-gated metric '{name}' is only created "
                        f"on first use — pre-create it at init so a run "
                        f"that never fires the path reports 0 instead "
                        f"of omitting the metric (the drift gate skips "
                        f"missing metrics; 0 is present, not missing)",
                snippet=""))


# ---------------------------------------------------------------------------
# handoff-protocol
# ---------------------------------------------------------------------------

class HandoffProtocolRule(ProjectRule):
    id = "handoff-protocol"
    description = ("cross-thread handoff (Thread args / queue.put / "
                   "callback registration) of an object carrying bare "
                   "mutable containers and no lock")

    _PUT_METHODS = {"put", "put_nowait"}

    def check_project(self, graph: ProjectGraph) -> List[Finding]:
        findings: List[Finding] = []
        for fn in graph.functions:
            local_types = graph._local_types(fn)
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                for arg, how in self._handoff_args(node):
                    cls = self._arg_class(graph, fn, arg, local_types)
                    if cls is None:
                        continue
                    if cls.has_any_lock() or not cls.mutable_attrs:
                        continue
                    attrs = ", ".join(sorted(cls.mutable_attrs))
                    findings.append(self.finding(
                        fn.module.ctx, node,
                        f"cross-thread handoff of {cls.name} via {how}: "
                        f"it carries bare mutable state ({attrs}) and "
                        f"owns no lock — add a lock (and guard the "
                        f"mutations) or hand off an immutable snapshot"))
        return findings

    def _handoff_args(self, node: ast.Call):
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "args" and isinstance(
                        kw.value, (ast.Tuple, ast.List)):
                    for el in kw.value.elts:
                        yield el, "Thread(args=...)"
        elif isinstance(func, ast.Attribute) and \
                name in self._PUT_METHODS and node.args:
            yield node.args[0], f".{name}()"
        elif ("callback" in name.lower() or "hook" in name.lower()) \
                and node.args:
            for el in node.args:
                yield el, f"{name}(...)"

    @staticmethod
    def _arg_class(graph, fn, arg, local_types):
        from .graph import _dotted
        if isinstance(arg, ast.Name):
            return local_types.get(arg.id)
        if isinstance(arg, ast.Attribute):
            return graph.receiver_class(fn, arg, local_types)
        if isinstance(arg, ast.Call):
            # a fresh `K(...)` handed straight across the boundary
            return graph.resolve_class(fn.module, _dotted(arg.func))
        return None


PROJECT_RULES: Tuple[Rule, ...] = (
    LockOrderCycleRule(),
    MetricContractRule(),
    HandoffProtocolRule(),
)
