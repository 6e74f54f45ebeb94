"""The port stands alone: ``distkeras_tpu_torch``, ``chip_smoke.py`` and
``kernel_ab.py`` import neither JAX nor the JAX package, nor ``optax``,
``msgpack`` or ``yaml`` (the card's machine has none of them) — checked
by importing every submodule in a subprocess whose import system refuses
them, and by an AST scan of every import statement."""

import ast
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "distkeras_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "distkeras_tpu", "optax", "msgpack", "yaml")

_IMPORT_ALL = """
import importlib, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import distkeras_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    distkeras_tpu_torch.__path__, "distkeras_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not leaked, leaked
print(" ".join(names))
"""

#: modules the walk must reach (the slices' entry points among them)
_MUST_WALK = ("bench", "chaos", "data.datasets", "data.streaming",
              "data.transformers", "evaluators", "models.layers",
              "models.generation", "models.zoo", "obs.drift",
              "obs.stragglers", "obs.timeseries", "parallel.sync",
              "ops.moe", "predictors", "ps", "ps.client", "ps.cluster",
              "ps.codecs", "ps.networking", "ps.runner", "ps.servers",
              "ps.shard", "ps.shard.client", "ps.shard.plan",
              "ps.shard.server", "ps.shard.shard_main", "ps.state",
              "ps.worker_main", "ps.workers", "serve.client",
              "serve.config", "serve.engine", "serve.kvfabric",
              "serve.prefix", "serve.router", "serve.server",
              "serve.spec", "trainers",
              "utils.checkpoint", "utils.native", "utils.serde",
              "utils.weights")


def _sources():
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(_ROOT, "chip_smoke.py")
    yield os.path.join(_ROOT, "kernel_ab.py")


def test_every_submodule_imports_with_jax_refused():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=_FORBIDDEN)],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert len(walked) >= 50   # every module was walked
    assert {f"distkeras_tpu_torch.{m}" for m in _MUST_WALK} <= walked


def test_no_import_statement_names_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, _ROOT)}:{node.lineno} "
                          f"{n}" for n in names
                          if n.split(".")[0] in _FORBIDDEN]
    assert not offenders, offenders
