"""dklint core — the analysis driver the rules plug into.

A ``Rule`` inspects one parsed file (``FileContext``: source + AST +
comment pragmas) and returns ``Finding``s.  The driver (``analyze_source``
/ ``run_paths``) applies suppression in two layers:

* **inline pragmas** — ``# dklint: disable=rule-a,rule-b`` (or a bare
  ``# dklint: disable``) on the offending line silences that line; a
  ``# dklint: holds=mutex`` pragma on a ``def`` line declares a lock
  contract ("callers hold ``self.mutex``") that the lock-discipline rule
  honors — suppression that *documents* instead of hiding.  A
  ``# dklint: hot`` pragma on a ``def`` line declares the function on
  the per-step hot path, which the ``hot-path-purity`` rule checks.
* **baseline file** — a committed JSON set of finding fingerprints
  (``write_baseline`` / ``load_baseline``): pre-existing debt stays
  visible in the file but does not fail the gate, while any NEW finding
  does.  Fingerprints hash the rule id + file-relative path + the
  offending source line (plus an occurrence index), not line numbers, so
  unrelated edits above a suppressed finding don't invalidate it.

Findings are plain dataclasses (``as_dict`` is JSON-safe) so the CLI's
``--format json`` and the tests consume the same objects.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: pragma grammar: ``# dklint: disable=a,b`` / ``# dklint: disable`` /
#: ``# dklint: holds=mutex`` / ``# dklint: hot`` — anywhere in a line's
#: trailing comment
_PRAGMA = re.compile(
    r"#\s*dklint:\s*(disable|holds|hot)\s*(?:=\s*([\w.,\- ]+))?")


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str          # path as scanned (display)
    rel: str           # path relative to the scan root (stable fingerprints)
    line: int
    col: int
    message: str
    snippet: str       # the offending source line, stripped
    fingerprint: str = ""   # assigned by the driver (baseline identity)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}"


class FileContext:
    """One parsed file handed to every rule: source, AST, line table and
    the ``# dklint:`` pragmas keyed by line number."""

    def __init__(self, path: str, source: str, rel: Optional[str] = None):
        self.path = path
        self.rel = rel if rel is not None else os.path.basename(path)
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self._disable: Dict[int, Optional[Set[str]]] = {}
        self._holds: Dict[int, Set[str]] = {}
        self._hot: Set[int] = set()
        for lineno, text in enumerate(self.lines, start=1):
            for kind, arg in _PRAGMA.findall(text):
                names = {a.strip() for a in (arg or "").split(",") if a.strip()}
                if kind == "disable":
                    # None = every rule disabled on this line
                    self._disable[lineno] = names or None
                elif kind == "hot":
                    self._hot.add(lineno)
                else:
                    self._holds.setdefault(lineno, set()).update(names)

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def disabled(self, lineno: int, rule: str) -> bool:
        if lineno not in self._disable:
            return False
        names = self._disable[lineno]
        return names is None or rule in names

    def holds(self, lineno: int) -> Set[str]:
        """Lock names a ``# dklint: holds=...`` pragma declares held for
        the scope opened at ``lineno`` (normally a ``def`` line)."""
        names = self._holds.get(lineno, set())
        return {n.split(".")[-1] for n in names}  # accept self.mutex / mutex

    def hot(self, node: ast.AST) -> bool:
        """Whether a ``# dklint: hot`` pragma marks the function ``node``
        (on its ``def`` line, or on the line its signature closes)."""
        first = node.lineno
        last = node.body[0].lineno - 1 if node.body else first
        return any(n in self._hot for n in range(first, max(first, last) + 1))


class Rule:
    """Base rule: subclasses set ``id``/``description`` and implement
    ``check(ctx) -> [Finding]``."""

    id: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=self.id, path=ctx.path, rel=ctx.rel,
                       line=line, col=getattr(node, "col_offset", 0),
                       message=message, snippet=ctx.source_line(line))


@dataclasses.dataclass
class Report:
    """Driver output: active findings plus everything suppressed (kept so
    the CLI can show honest counts) and any files that failed to parse."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    inline_suppressed: List[Finding] = dataclasses.field(default_factory=list)
    baseline_suppressed: List[Finding] = dataclasses.field(default_factory=list)
    errors: List[Tuple[str, str]] = dataclasses.field(default_factory=list)


#: markers that anchor stable finding paths (and baseline discovery): the
#: nearest ancestor directory holding one of these is "the repo root"
ANCHOR_MARKERS = ("dklint_baseline.json", "pyproject.toml", ".git")


def find_anchor(start: str) -> Optional[str]:
    """Nearest ancestor of ``start`` containing an anchor marker."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        if any(os.path.exists(os.path.join(cur, m)) for m in ANCHOR_MARKERS):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def anchor_base(root: str) -> str:
    """The directory finding paths are made relative to, resolved ONCE
    per scan root: the root's anchor (see ``find_anchor``), else the root
    itself — so ``dklint distkeras_tpu_torch/``, ``dklint .`` and
    ``dklint distkeras_tpu_torch/ps/servers.py`` all fingerprint a finding as
    ``distkeras_tpu_torch/ps/servers.py`` and the baseline keeps matching."""
    base = find_anchor(root)
    if base is None:
        base = os.path.abspath(root)
        if os.path.isfile(base):
            base = os.path.dirname(base)
    return base


def iter_py_files(path: str) -> Iterable[Tuple[str, str]]:
    """Yield ``(full_path, anchored_rel_path)`` for every ``.py`` under
    ``path`` (or ``path`` itself), skipping caches/hidden directories.
    The anchor lookup happens once for the whole walk — every file under
    one root shares it."""
    base = anchor_base(path)
    if os.path.isfile(path):
        yield path, os.path.relpath(os.path.abspath(path),
                                    base).replace(os.sep, "/")
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(os.path.abspath(full),
                                            base).replace(os.sep, "/")


def _split_rules(rules: Optional[Sequence[Rule]]
                 ) -> Tuple[List[Rule], List[Rule]]:
    """(per-file rules, project rules).  Project rules (``project=True``,
    see ``rules_project.ProjectRule``) run ONCE over the whole scan's
    graph instead of per file."""
    from .rules import ALL_RULES
    all_rules = list(rules if rules is not None else ALL_RULES)
    file_rules = [r for r in all_rules if not getattr(r, "project", False)]
    project_rules = [r for r in all_rules if getattr(r, "project", False)]
    return file_rules, project_rules


def _check_project(contexts: Sequence["FileContext"],
                   project_rules: Sequence[Rule],
                   report: "Report") -> None:
    """Run the interprocedural rules over the graph of every parsed
    file; inline ``# dklint: disable`` pragmas still apply, keyed by the
    file each finding anchors in (findings in non-Python files — e.g.
    OBS_BASELINE.json — have no pragma channel and pass through)."""
    if not project_rules or not contexts:
        return
    from .graph import build_graph
    graph = build_graph(contexts)
    ctx_by_rel = {c.rel: c for c in contexts}
    for rule in project_rules:
        for f in rule.check_project(graph):
            ctx = ctx_by_rel.get(f.rel)
            if ctx is not None and ctx.disabled(f.line, f.rule):
                report.inline_suppressed.append(f)
            else:
                report.findings.append(f)


def analyze_source(source: str, path: str = "<string>",
                   rel: Optional[str] = None,
                   rules: Optional[Sequence[Rule]] = None,
                   _finalize: bool = True) -> Report:
    """Run ``rules`` over one source string; inline pragmas applied.
    Project rules see a single-file graph (fixture tests exercise the
    interprocedural rules through the same door).  ``_finalize=False``
    skips the sort + fingerprint pass (``run_paths`` does both once over
    the aggregate instead)."""
    file_rules, project_rules = _split_rules(rules)
    report = Report()
    try:
        ctx = FileContext(path, source, rel=rel)
    except SyntaxError as e:
        report.errors.append((path, f"syntax error: {e}"))
        return report
    for rule in file_rules:
        for f in rule.check(ctx):
            if ctx.disabled(f.line, f.rule):
                report.inline_suppressed.append(f)
            else:
                report.findings.append(f)
    _check_project([ctx], project_rules, report)
    if _finalize:
        report.findings.sort(key=lambda f: (f.rel, f.line, f.col, f.rule))
        _assign_fingerprints(report.findings)
    return report


def run_paths(paths: Sequence[str],
              rules: Optional[Sequence[Rule]] = None,
              jobs: int = 1) -> Report:
    """Run ``rules`` over files/directories; findings carry fingerprints
    relative to each scan root so the baseline survives repo moves.
    ``jobs > 1`` parses and per-file-checks files on a thread pool (the
    interprocedural pass still runs once, over every parsed file);
    output is deterministic either way — merge order is the sorted walk
    order, not completion order."""
    file_rules, project_rules = _split_rules(rules)
    report = Report()
    work: List[Tuple[str, str]] = []
    for root in paths:
        if not os.path.exists(root):
            report.errors.append((root, "no such file or directory"))
            continue
        work.extend(iter_py_files(root))

    def _one(item: Tuple[str, str]):
        full, rel = item
        try:
            with open(full, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            return None, [(full, f"unreadable: {e}")], [], []
        try:
            ctx = FileContext(full, source, rel=rel)
        except SyntaxError as e:
            return None, [(full, f"syntax error: {e}")], [], []
        found, suppressed = [], []
        for rule in file_rules:
            for f in rule.check(ctx):
                (suppressed if ctx.disabled(f.line, f.rule)
                 else found).append(f)
        return ctx, [], found, suppressed

    if jobs > 1 and len(work) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            results = list(pool.map(_one, work))
    else:
        results = [_one(item) for item in work]

    contexts: List[FileContext] = []
    for ctx, errors, found, suppressed in results:
        if ctx is not None:
            contexts.append(ctx)
        report.errors.extend(errors)
        report.findings.extend(found)
        report.inline_suppressed.extend(suppressed)
    _check_project(contexts, project_rules, report)
    report.findings.sort(key=lambda f: (f.rel, f.line, f.col, f.rule))
    _assign_fingerprints(report.findings)
    return report


def _assign_fingerprints(findings: List[Finding]) -> None:
    """Line-number-independent identity: hash of (rule, rel path, stripped
    source line, k-th occurrence of that triple in the file)."""
    seen: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        key = (f.rule, f.rel, f.snippet)
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        payload = "\x00".join([f.rule, f.rel, f.snippet, str(idx)])
        f.fingerprint = hashlib.sha1(payload.encode()).hexdigest()[:16]


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> Set[str]:
    """Baseline file -> set of suppressed fingerprints."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"{path}: not a dklint baseline "
                         f"(expected a mapping with a 'findings' list)")
    return {entry["fingerprint"] for entry in doc["findings"]}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Persist ``findings`` as the accepted-debt baseline (sorted, with
    location context so the file reviews like code)."""
    doc = {
        "version": 1,
        "note": "accepted pre-existing dklint findings; regenerate with "
                "`python -m distkeras_tpu_torch.analysis.cli "
                "--write-baseline` after deliberate changes",
        "findings": [
            {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.rel,
             "message": f.message, "snippet": f.snippet}
            for f in sorted(findings, key=lambda f: (f.rel, f.line, f.col))
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")


def apply_baseline(report: Report, fingerprints: Set[str]) -> Report:
    """Move baseline-matched findings out of the active list (in place)."""
    active, suppressed = [], []
    for f in report.findings:
        (suppressed if f.fingerprint in fingerprints else active).append(f)
    report.findings = active
    report.baseline_suppressed.extend(suppressed)
    return report
