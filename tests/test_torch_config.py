"""The port's config layer (``distkeras_tpu_torch.config`` and its YAML
subset reader ``utils._yaml``) against the JAX package's
(``distkeras_tpu.config`` over ``yaml.safe_load``), on the CPU.

* The reader gives ``yaml.safe_load``'s value on
  ``configs/bench_all.yaml``, and on generated documents of the subset
  (scalars drawn to hit PyYAML's YAML 1.1 quirks) it gives
  ``safe_load``'s value or raises — never a different value.
* ``load_file`` gives the JAX ``load_file``'s ``RunConfig``s field for
  field; ``build`` gives each of the file's eight trainers its class and
  hyperparameters.
* ``run`` on the MLP and the flash-LM ``quick`` configs (cut further in
  rows) against the JAX ``run``, on the same data, the port's model
  starting from the JAX model's ``init(seed)`` weights
  (``load_jax_variables``).  Tolerances: the MLP (f32) per-step losses
  within rtol 1e-5 and the accuracy exactly equal (a prediction flips
  only on a near-tie); the flash LM in bf16 compute within rtol 2e-2,
  the bound ``tests/test_torch_train.py`` holds the bf16 window to (the
  two packages round the bf16 casts of the same f32 masters alike, but
  sum attention in other orders).
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from distkeras_tpu import config as jcfg
from distkeras_tpu.models import zoo as jzoo

from distkeras_tpu_torch import config as pcfg
from distkeras_tpu_torch.models import zoo as pzoo
from distkeras_tpu_torch.utils import _yaml
from distkeras_tpu_torch.utils import load_jax_variables

# one torch intra-op pool per xdist worker, not one per core each
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_YAML = os.path.join(ROOT, "configs", "bench_all.yaml")


def _same(a, b) -> bool:
    """Equality of loaded documents, NaN equal to NaN and types exact
    (``1 == 1.0 == True`` in Python)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            _same(k1, k2) and _same(a[k1], b[k2]) for k1, k2 in zip(a, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# -- the reader -----------------------------------------------------------

def test_reader_equals_safe_load_on_the_bench_yaml():
    with open(BENCH_YAML) as f:
        text = f.read()
    assert _same(_yaml.safe_load(text), yaml.safe_load(text))


#: scalars that exercise PyYAML's YAML 1.1 resolution
QUIRKS = ["1e-3", "1.0e-3", "1.0e3", "1E+3", "3.", ".5", "+.5", "-1.5e+2",
          "yes", "no", "on", "off", "Yes", "NO", "True", "FALSE", "y", "n",
          "~", "null", "Null", "NULL", "", "1_000", "0b101", "0x1F", "017",
          "0o17", "08", "-0", "+12", "1:20", "1:20.5", ".inf", "-.Inf",
          ".nan", ".NaN", "T=256 (bf16)", "ResNet-50/96px", "auto",
          "flash", "a b", "x#y", "a, b", "a]b", "2001-12-14", "<<", "=",
          "-", "-x", "?x", ":x", "0.", "1..2", "12e3", "_1", "1_", "0_0",
          "a:b", "don't", 'say "hi"', "é", "x: y", "#c", "[a]", "{a}",
          "&a", "*a", "!t", "|", ">", "%d", "@x", "`x"]

_plain = st.sampled_from(QUIRKS) | st.text(
    alphabet="abcxyzAB0189._-+:#,[]{}'\" !~", max_size=8)


@st.composite
def _scalar(draw):
    """``(text in the document, kind)``: plain, single- or double-quoted."""
    s = draw(_plain)
    style = draw(st.sampled_from(["plain", "plain", "single", "double"]))
    if style == "single":
        return "'" + s.replace("'", "''") + "'"
    if style == "double":
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


def _flow(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k}: {_flow(v)}" for k, v in node.items()) \
            + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_flow(v) for v in node) + "]"
    return node


def _block(node, indent: int, out: list, rng) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(v, (dict, list)) and v and rng.draw(st.booleans()):
                out.append(f"{pad}{k}:")
                _block(v, indent + 2, out, rng)
            else:
                text = _flow(v)
                # a flow collection may continue on the next line
                if isinstance(v, dict) and len(v) > 1 and \
                        rng.draw(st.booleans()):
                    first, rest = text.split(", ", 1)
                    out.append(f"{pad}{k}: {first},")
                    out.append(f"{pad}  {rest}")
                else:
                    out.append(f"{pad}{k}: {text}".rstrip(" ") +
                               rng.draw(st.sampled_from(["", "  # c"])))
    elif isinstance(node, list):
        for v in node:
            if isinstance(v, dict) and v:
                lines: list = []
                _block(v, indent + 2, lines, rng)
                lines[0] = f"{pad}- " + lines[0][indent + 2:]
                out.extend(lines)
            else:
                out.append(f"{pad}- {_flow(v)}".rstrip(" "))
    else:
        out.append(pad + node)


_node = st.recursive(
    _scalar(),
    lambda children: st.lists(children, max_size=3) | st.dictionaries(
        _scalar(), children, max_size=3),
    max_leaves=8)


@settings(max_examples=400, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(doc=st.dictionaries(_scalar(), _node, min_size=1, max_size=4),
       data=st.data())
def test_reader_gives_safe_loads_value_or_raises(doc, data):
    lines: list = ["# generated"]
    _block(doc, 0, lines, data)
    text = "\n".join(lines) + "\n"
    try:
        mine = _yaml.safe_load(text)
    except ValueError:
        return  # outside the subset (or not YAML): raising is allowed
    ref = yaml.safe_load(text)  # a value from the reader must be valid YAML
    assert _same(mine, ref), (text, mine, ref)


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  text", "a: >\n  text",
    "%YAML 1.1\n---\na: 1", "a: 1\n---\nb: 2", "? a\n: 1", "a: 2001-12-14",
    "a: multi\n  line", "a: 'open", "a:\tb", "<<: {a: 1}"])
def test_reader_raises_outside_the_subset_with_a_line(text):
    with pytest.raises(_yaml.YamlSubsetError, match=r"line \d+"):
        _yaml.safe_load(text)


# -- loading and building -------------------------------------------------

def test_load_file_equals_the_jax_run_configs():
    mine, ref = pcfg.load_file(BENCH_YAML), jcfg.load_file(BENCH_YAML)
    assert len(mine) == 8
    for a, b in zip(mine, ref):
        assert _same(dataclasses.asdict(a), dataclasses.asdict(b)), a.name
        assert _same(dataclasses.asdict(a.with_quick()),
                     dataclasses.asdict(b.with_quick())), a.name


def test_build_gives_each_config_its_trainer_and_hyperparameters():
    """Every config of the file (``quick``) builds a trainer of its class
    with its hyperparameters; ``num_workers: auto`` is 8 — as the JAX
    package resolves it on the 8 fake devices of this suite
    (``min(8, len(jax.devices()))``)."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.data.streaming import ShardedFileDataset
    cfgs = [c.with_quick() for c in pcfg.load_file(BENCH_YAML)]
    assert [c.trainer for c in cfgs] == [
        "SingleTrainer", "ADAG", "DOWNPOUR", "AEASGD", "DynSGD",
        "SingleTrainer", "ADAG", "SingleTrainer"]
    for c in cfgs:
        trainer, train, test = pcfg.build(c, device="cpu")
        assert type(trainer) is getattr(dkt, c.trainer)
        assert trainer.device == torch.device("cpu")
        kw = {**pcfg._DEFAULT_TRAINER_KW, **c.trainer_kwargs}
        for key in ("num_epoch", "batch_size", "learning_rate",
                    "communication_window", "loss", "label_col"):
            if key in kw:
                assert getattr(trainer, key) == kw[key], (c.name, key)
        if "num_workers" in kw:
            assert trainer.num_workers == 8
        assert isinstance(train, ShardedFileDataset) == bool(c.streaming)
        if c.streaming:
            assert len(train.shards) == 256 // c.streaming
        else:
            assert train.num_rows == c.dataset_kwargs["n_train"]
        assert (test is None) == (c.test_take is None)
        if test is not None:
            assert test.num_rows == c.test_take
    jt, jtrain, _ = jcfg.build(jcfg.load_file(BENCH_YAML)[1].with_quick())
    assert jt.num_workers == 8 == pcfg.AUTO_WORKERS
    assert jtrain.num_rows == 2048


def test_build_refuses_streaming_for_a_trainer_without_a_disk_path():
    c = pcfg.RunConfig(name="x", trainer="PipelineTrainer",
                       dataset_kwargs={"n_train": 64}, streaming=True)
    with pytest.raises(ValueError, match="no ShardedFileDataset path"):
        pcfg.build(c, device="cpu")


def test_entry_points_name_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    c = pcfg.RunConfig(name="x", dataset_kwargs={"n_train": 64})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcfg.build(c)


# -- running against the JAX package --------------------------------------

def _capture_build(monkeypatch, module):
    """Record the trainer every ``module.build`` call makes."""
    made = []
    real = module.build

    def build(*a, **kw):
        out = real(*a, **kw)
        made.append(out[0])
        return out

    monkeypatch.setattr(module, "build", build)
    return made


def _port_zoo_from_jax(monkeypatch, name):
    """Make the port's ``zoo.<name>`` build a model whose ``init(seed)``
    loads the JAX model's ``init(seed)`` weights (the two packages'
    generators differ), so both runs start alike."""
    real = getattr(pzoo, name)

    def factory(**kw):
        model, jm = real(**kw), getattr(jzoo, name)(**kw)
        build = model.init

        def init(seed=0, device=None):
            build(seed, device=device)
            load_jax_variables(model, jax_tree_np(jm.init(seed)))
            return model

        model.init = init
        return model

    monkeypatch.setattr(pzoo, name, factory)


def jax_tree_np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name,rows,epochs,loss_rtol", [
    ("SingleTrainer MLP/MNIST", 512, 2, 1e-5),
    ("GPT-LM flash T=256 (bf16)", 128, 1, 2e-2)])
def test_run_matches_the_jax_run(monkeypatch, name, rows, epochs, loss_rtol):
    """``run`` of a config's ``quick`` variant (rows cut to ``rows``,
    ``epochs`` epochs) against the JAX ``run``: per-step losses, the
    accuracy, the row's shape."""
    cfg = {c.name: c for c in pcfg.load_file(BENCH_YAML)}[name].with_quick()
    cfg = dataclasses.replace(
        cfg, dataset_kwargs={**cfg.dataset_kwargs, "n_train": rows},
        test_take=cfg.test_take and 256,
        trainer_kwargs={**cfg.trainer_kwargs, "num_epoch": epochs})
    jc = jcfg.RunConfig(**dataclasses.asdict(cfg))
    _port_zoo_from_jax(monkeypatch, cfg.model)
    mine_t = _capture_build(monkeypatch, pcfg)
    ref_t = _capture_build(monkeypatch, jcfg)
    mine = pcfg.run(cfg, device="cpu")
    ref = jcfg.run(jc)
    assert set(mine) == set(ref)
    assert mine["name"] == ref["name"] and mine["note"] == ref["note"]
    assert mine["samples_per_sec"] > 0 and mine["spread"] is None
    got = np.concatenate(mine_t[0].get_history())
    want = np.concatenate([np.asarray(h) for h in ref_t[0].get_history()])
    assert got.shape == want.shape == (epochs * (rows // 64 if "LM" in name
                                                 else rows // 128),)
    np.testing.assert_allclose(got, want, rtol=loss_rtol)
    assert mine["accuracy"] == ref["accuracy"]


def test_run_repeat_reports_the_warm_median_and_spread():
    cfg = pcfg.RunConfig(
        name="rep", trainer="SingleTrainer", model="mlp_mnist",
        model_kwargs={"hidden": 32}, dataset="load_mnist",
        dataset_kwargs={"n_train": 512}, onehot=10, test_take=None,
        trainer_kwargs={"num_epoch": 2, "batch_size": 64})
    row = pcfg.run(cfg, repeat=3, device="cpu")
    lo, hi = row["spread"]
    assert lo <= row["samples_per_sec"] <= hi
    assert row["note"] == "median of 2 warm runs"
    assert len(row["rates"]) == 3
    row = pcfg.run(cfg, repeat=2, device="cpu")
    assert row["note"] == "single warm run, cold excluded"
    assert row["spread"] is None


def test_streaming_config_trains_from_disk_and_removes_its_spill():
    from distkeras_tpu_torch.data.streaming import ShardedFileDataset
    c = pcfg.RunConfig(name="stream tiny", trainer="SingleTrainer",
                       model="mlp_mnist", model_kwargs={"hidden": 32},
                       dataset="load_mnist", dataset_kwargs={"n_train": 1024},
                       onehot=10, test_take=256, streaming=256,
                       trainer_kwargs={"num_epoch": 2, "batch_size": 64,
                                       "learning_rate": 0.1})
    trainer, train, _ = pcfg.build(c, device="cpu")
    assert isinstance(train, ShardedFileDataset) and len(train.shards) == 4
    spills = []
    real = ShardedFileDataset.write

    def write(*a, **kw):
        out = real(*a, **kw)
        spills.append(out.directory)
        return out

    ShardedFileDataset.write = staticmethod(write)
    try:
        row = pcfg.run(c, device="cpu")
    finally:
        ShardedFileDataset.write = staticmethod(real)
    assert row["accuracy"] > 0.7
    assert spills and not os.path.exists(spills[0])


# -- the CLI --------------------------------------------------------------

def test_cli_prints_the_table_and_packages_the_jax_job(tmp_path, capsys):
    p = tmp_path / "one.yaml"
    p.write_text(yaml.safe_dump({
        "name": "cli tiny", "trainer": "SingleTrainer",
        "model": "mlp_mnist", "model_kwargs": {"hidden": 32},
        "dataset": "load_mnist", "dataset_kwargs": {"n_train": 512},
        "onehot": 10, "test_take": 256,
        "trainer_kwargs": {"num_epoch": 1, "batch_size": 64}}))
    assert pcfg.main([str(p), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == list(pcfg.TABLE_HEADER)
    assert len(out) == 3 and out[2].startswith("| cli tiny | ")
    assert out[2].endswith("s |") and "(incl. compile)" in out[2]
    mine, ref = tmp_path / "mine.job", tmp_path / "ref.job"
    assert pcfg.main([str(p), "--job", str(mine)]) == 0
    assert jcfg.main([str(p), "--job", str(ref)]) == 0
    assert mine.read_bytes() == ref.read_bytes()
    assert pcfg.main([BENCH_YAML, "--job", str(mine)]) == 2
