"""dklint for the port — static analysis and runtime race checking of
``distkeras_tpu_torch`` (the port of ``distkeras_tpu.analysis``).

An asynchronous parameter-server stack is exactly the shape of code where
Python-side hazards corrupt training without failing a test: an instance
attribute written outside the mutex is a silent lost update, a bare
``except:`` turns a wire error into NaN weights three epochs later, a
host sync on the per-step path stalls the card every step.  This package:

* ``core``      — rule/finding framework, inline-pragma + baseline
  suppression, the ``run_paths`` driver.
* ``rules``     — the per-file rules: ``hot-path-purity`` (the port's
  twin of the JAX package's ``jit-purity``: host syncs and global-RNG
  draws in functions marked ``# dklint: hot``), lock-discipline,
  swallow-guard, thread-shutdown, bare-print, staleness-protocol,
  shm-lifecycle, wire-seam, kv-version-guard.
* ``rules_project`` — the whole-repo rules over ``graph``:
  lock-order-cycle, metric-contract, handoff-protocol.
* ``racecheck`` — opt-in runtime proxies (tracked locks + guarded
  containers) that fail threaded tests on unguarded shared-state writes.
* ``cli``       — ``python -m distkeras_tpu_torch.analysis.cli [paths]``.

The gate (``tests/test_torch_analysis.py``) runs the full rule set over
``distkeras_tpu_torch/`` under the port's own baseline
(``analysis/baseline.json``) — any new finding fails it unless
deliberately suppressed.
"""

from .core import (  # noqa: F401
    FileContext, Finding, Report, Rule, analyze_source, apply_baseline,
    iter_py_files, load_baseline, run_paths, write_baseline)
from .rules import ALL_RULES, RULES_BY_ID  # noqa: F401
