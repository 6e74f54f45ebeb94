"""dklint command line for the port —
``python -m distkeras_tpu_torch.analysis.cli [paths...]``.

Exit codes: 0 = clean (no unsuppressed findings), 1 = findings,
2 = usage/IO error.  ``--format json`` emits a machine-readable report;
``--write-baseline`` accepts the current findings as debt (see
``core.write_baseline``).  With no ``--baseline`` flag the port's own
baseline, ``distkeras_tpu_torch/analysis/baseline.json``, applies — never
the repo root's ``dklint_baseline.json``, which is the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from ..obs.logging import emit
from . import core
from .rules import ALL_RULES, RULES_BY_ID

#: the port's baseline (not an anchor marker: finding paths stay
#: relative to the repo root)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def _changed_files(base: str, paths: List[str]) -> Optional[List[str]]:
    """``git diff --name-only <base>`` filtered to Python files that
    still exist AND fall under one of the requested ``paths`` — the
    fast pre-commit loop (``--changed``) shares every other flag with
    the repo-wide gate.  None on git failure (caller reports usage
    error)."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "-z", base, "--"],
            capture_output=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    roots = [os.path.abspath(p) for p in paths]
    picked = []
    for name in out.stdout.decode("utf-8", "replace").split("\0"):
        if not name.endswith(".py") or not os.path.exists(name):
            continue
        full = os.path.abspath(name)
        if any(full == r or full.startswith(r + os.sep) for r in roots):
            picked.append(name)
    return picked


def _select_rules(spec: Optional[str]) -> List[core.Rule]:
    if not spec:
        return list(ALL_RULES)
    rules = []
    for rid in (s.strip() for s in spec.split(",") if s.strip()):
        if rid not in RULES_BY_ID:
            raise KeyError(rid)
        rules.append(RULES_BY_ID[rid])
    return rules


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.analysis.cli",
        description="static analysis for the distkeras_tpu_torch stack "
                    "(hot-path-purity, lock-discipline, swallow-guard, "
                    "thread-shutdown, bare-print, ...; --list-rules)")
    ap.add_argument("paths", nargs="*", default=["distkeras_tpu_torch"],
                    help="files/directories to analyze "
                         "(default: distkeras_tpu_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", metavar="ID[,ID...]",
                    help="run only these rules (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--baseline", metavar="FILE",
                    help="suppression baseline (default: the port's "
                         "distkeras_tpu_torch/analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the baseline "
                         "and write them to the baseline file")
    ap.add_argument("--changed", nargs="?", const="HEAD", metavar="REF",
                    help="lint only files changed vs REF (git diff "
                         "--name-only; default HEAD), intersected with "
                         "the given paths")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="parse and per-file-check N files in parallel "
                         "(interprocedural rules still run once, over "
                         "the whole set)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            emit(f"{r.id:16s} {r.description}")
        return 0

    try:
        rules = _select_rules(args.rules)
    except KeyError as e:
        emit(f"dklint: unknown rule {e.args[0]!r} "
             f"(known: {', '.join(sorted(RULES_BY_ID))})", err=True)
        return 2

    baseline_path = args.baseline or DEFAULT_BASELINE

    scan_paths = list(args.paths)
    if args.changed is not None:
        changed = _changed_files(args.changed, scan_paths)
        if changed is None:
            emit(f"dklint: git diff against {args.changed!r} failed "
                 f"(not a git checkout, or unknown ref)", err=True)
            return 2
        if not changed:
            emit("dklint: no changed Python files under the given paths")
            return 0
        scan_paths = changed

    write_target = None
    if args.write_baseline and args.rules:
        # a subset run would overwrite the baseline with only ITS
        # findings, silently dropping every other rule's accepted debt
        emit("dklint: --write-baseline requires the full rule set "
             "(drop --rules)", err=True)
        return 2
    if args.write_baseline and args.changed is not None:
        # same trap, file axis: a changed-only scan would overwrite the
        # baseline with only the changed files' findings
        emit("dklint: --write-baseline requires a full scan "
             "(drop --changed)", err=True)
        return 2
    if args.write_baseline:
        write_target = baseline_path

    report = core.run_paths(scan_paths, rules=rules,
                            jobs=max(1, args.jobs))
    if report.errors:
        for path, msg in report.errors:
            emit(f"dklint: {path}: {msg}", err=True)
        return 2

    if write_target is not None:
        core.write_baseline(write_target, report.findings)
        emit(f"dklint: wrote {len(report.findings)} finding(s) to "
             f"{write_target}")
        return 0

    if os.path.exists(baseline_path) or args.baseline:
        try:
            core.apply_baseline(report, core.load_baseline(baseline_path))
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            emit(f"dklint: bad baseline {baseline_path}: {e}", err=True)
            return 2

    if args.format == "json":
        emit(json.dumps({
            "findings": [f.as_dict() for f in report.findings],
            "suppressed": {
                "inline": len(report.inline_suppressed),
                "baseline": len(report.baseline_suppressed),
            },
        }, indent=2))
    else:
        for f in report.findings:
            emit(f"{f.location()}: [{f.rule}] {f.message}")
            if f.snippet:
                emit(f"    {f.snippet}")
        n = len(report.findings)
        supp = len(report.inline_suppressed) + len(report.baseline_suppressed)
        tail = f" ({supp} suppressed)" if supp else ""
        emit(f"dklint: {n} finding(s){tail}")
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
