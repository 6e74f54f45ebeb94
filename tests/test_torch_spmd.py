"""The port's ``SpmdTrainer`` (``parallel.spmd``: dp × mp with the
port's own collectives) against the JAX package's GSPMD trainer, on the
CPU.

The port's ranks are four gloo child processes spawned once
(``tests/test_torch_mesh_child.py``), a ``{"dp": 2, "mp": 2}`` mesh; the
JAX reference trains on the same mesh shape over the fake devices of
``tests/conftest.py``, from the same ``init(seed)`` (handed to the port
as numpy) and the same data.  Three models: the MLP toy problem (SGD), a
small flash ``gpt_lm`` (Adam: its g² would expose an unreduced
gradient; held against JAX's ``SingleTrainer``, see ``_jax_train``) and
``resnet20(width=32)`` (BatchNorm over the dp-split batch, conv channels
on ``mp``; held to a float64 witness, see the parity test).  Losses within rtol 1e-4, trained parameters
within 1e-4 of each leaf's largest |value|, the same on every rank;
``sharding_report`` key for key; the collectives counted by
``mesh.collective_stats()`` (the port's reading of what JAX's tests grep
from the compiled HLO); resume and the streamed path; and the attention
kernels' plain versions fed plain local tensors.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.streaming import ShardedFileDataset as JaxSFD
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.parallel import spmd as jax_spmd
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh

from distkeras_tpu_torch.parallel import spmd
from test_torch_mesh_child import run_ranks

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

MESH = {"dp": 2, "mp": 2}
#: the JAX package's f32 SpmdTrainer on the ResNet case strays from the
#: float64 witness by this much of a leaf's largest |value| (read 0.073,
#: at a BatchNorm bias: its statistics summed in f32; the port's f32 run
#: reads 0.0070 there); held at its reading
JAX_F32_WITNESS_REL = 0.08


def _mlp():
    # a 10×256 kernel: large enough for the rule to split it over mp
    return dk.Model(JaxSequential([JaxDense(256, "relu"),
                                   JaxDense(3, "softmax")]),
                    input_shape=(10,))


def _lm():
    return dk.zoo.gpt_lm(vocab_size=64, dim=32, num_heads=2, num_blocks=2,
                         seq_len=16, attention_impl="flash")


def _resnet():
    return dk.zoo.resnet20(width=32)


def _data(name):
    rng = np.random.default_rng(7)
    if name == "mlp":
        x = rng.normal(size=(96, 10)).astype(np.float32)
        w = rng.normal(size=(10, 3)).astype(np.float32)
        return x, np.eye(3, dtype=np.float32)[np.argmax(x @ w, -1)]
    if name == "lm":
        x = rng.integers(0, 64, size=(32, 16)).astype(np.int32)
        return x, np.roll(x, -1, axis=1)
    x = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]


CASES = {
    "mlp": (_mlp, "sgd", dict(loss="categorical_crossentropy", num_epoch=2,
                               batch_size=16, learning_rate=0.05, seed=11)),
    "lm": (_lm, "adam", dict(loss="sparse_categorical_crossentropy",
                             num_epoch=2, batch_size=8, learning_rate=3e-3,
                             seed=5)),
    "resnet": (_resnet, "sgd", dict(loss="categorical_crossentropy",
                                     num_epoch=1, batch_size=8,
                                     learning_rate=0.05, seed=3)),
}
COLS = dict(features_col="features", label_col="label")


def _close(got, ref, rtol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.allclose(got, ref, rtol=rtol, atol=0), \
        float(np.max(np.abs(got - ref)))


def _close_leaves(got, want, rel=1e-4, over_tree=False):
    """Leaf by leaf within ``rel`` of the reference leaf's largest |value|
    (``over_tree``: of the whole tree's)."""
    got, want = (jax.tree_util.tree_leaves(t) for t in (got, want))
    assert len(got) == len(want)
    top = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        bound = rel * (top if over_tree else
                       max(float(np.max(np.abs(w))), 1e-30))
        assert float(np.max(np.abs(g - w))) <= bound, \
            (i, float(np.max(np.abs(g - w))), bound)


def _jax_ds(name):
    x, y = _data(name)
    return dk.Dataset({"features": x, "label": y})


def _jax_train(name, ds=None):
    """The JAX reference run.  Its ``SpmdTrainer`` pins each carry's
    sharding for its compiled window and refuses an optimizer state with
    an unplaced scalar (adam's step count: "incompatible devices"), so
    the Adam case runs JAX's ``SingleTrainer``: the same function on one
    device, which GSPMD's placement must not change."""
    make, opt, kw = CASES[name]
    cls = dk.SingleTrainer if opt == "adam" else \
        lambda *a, **k: dk.SpmdTrainer(*a, mesh_shape=MESH, **k)
    t = cls(make(), opt, **kw, **COLS)
    m = t.train(ds if ds is not None else _jax_ds(name))
    return t, m


def _jax_report(name):
    """``sharding_report`` of the JAX trainer's placement of
    ``init(seed)`` (``SpmdTrainer._train``'s own three calls)."""
    make, _, kw = CASES[name]
    mesh = jax_make_mesh(axis_names=tuple(MESH), shape=tuple(MESH.values()))
    params = make().init(kw["seed"])["params"]
    specs = jax_spmd.infer_param_specs(params, mesh)
    return jax_spmd.sharding_report(jax_spmd.place(params, mesh, specs))


@pytest.fixture(scope="module")
def inits():
    out = {}
    for name, (make, _, kw) in CASES.items():
        m = make()
        out[name] = (m.config(), {kw["seed"]: jax.tree_util.tree_map(
            np.asarray, m.init(kw["seed"]))})
    return out


@pytest.fixture(scope="module")
def ranks(inits, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spmd"))
    cases = []
    for name, (_, opt, kw) in CASES.items():
        x, y = _data(name)
        cfg, init = inits[name]
        extra = {"ckpt": tmp, "stream": tmp} if name == "mlp" else {}
        cases.append((name, "spmd_train",
                      dict(config=cfg, inits=init, x=x, y=y,
                           kw={**kw, **COLS}, mesh_shape=MESH,
                           optimizer=opt, spy=name == "lm", **extra)))
    x, y = _data("resnet")
    cfg, init = inits["resnet"]
    cases.append(("resnet64", "spmd_train",
                  dict(config=cfg, inits=init, x=x.astype(np.float64),
                       y=y.astype(np.float64),
                       kw={**CASES["resnet"][2], **COLS}, mesh_shape=MESH,
                       double=True)))
    return run_ranks(4, cases)


@pytest.fixture(scope="module")
def jax_runs(monkeypatch_module):
    return {name: _jax_train(name) for name in CASES}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setattr("distkeras_tpu.data.streaming._has_tf", lambda: False)
    yield mp
    mp.undo()


def test_infer_param_specs_equals_jax():
    """The JAX rule on the shapes of ``tests/test_spmd.py``: big kernels
    split along their largest divisible dim, 1-D / small / indivisible
    leaves whole, 4-D conv kernels on channel dims only."""
    mesh = types.SimpleNamespace(axis_names=("dp", "mp"),
                                 shape={"dp": 2, "mp": 4})
    jmesh = jax_make_mesh(axis_names=("dp", "mp"), shape=(2, 4))
    params = {
        "big": np.zeros((128, 256), np.float32),
        "bias": np.zeros((256,), np.float32),
        "tiny": np.zeros((4, 4), np.float32),
        "odd": np.zeros((130, 70), np.float32),
        "conv": np.zeros((3, 3, 64, 128), np.float32),
        "spatial_trap": np.zeros((8, 8, 6, 6), np.float32),
        "conv_in": np.zeros((3, 3, 64, 66), np.float32),
    }
    got = spmd.infer_param_specs(params, mesh, min_size=1024)
    want = jax_spmd.infer_param_specs(params, jmesh, min_size=1024)
    assert {k: spmd.spec_str(v) for k, v in got.items()} == \
        {k: str(v) for k, v in want.items()}
    no_mp = types.SimpleNamespace(axis_names=("dp",), shape={"dp": 8})
    assert all(s == spmd.P() for s in
               spmd.infer_param_specs(params, no_mp).values())


def _rel_err(got, want) -> float:
    """The largest leaf error over that leaf's largest |value|."""
    return max(float(np.max(np.abs(np.asarray(g, np.float64)
                                   - np.asarray(w, np.float64))))
               / max(float(np.max(np.abs(np.asarray(w)))), 1e-30)
               for g, w in zip(*(jax.tree_util.tree_leaves(t)
                                 for t in (got, want))))


@pytest.mark.parametrize("name", list(CASES))
def test_spmd_trainer_matches_jax_on_a_dp_mp_mesh(ranks, jax_runs,
                                                  resnet_witness, name):
    """Losses within rtol 1e-4 and parameters within 1e-4 of each leaf's
    largest |value|, on every rank.  On the ResNet the variables are held
    to the float64 witness (``resnet_witness``) instead, within 1e-4 of
    the whole tree's largest |value| (the BatchNorm biases and means
    start at 0 and hold two steps of f32 sums alone): JAX's f32 run sums
    its BatchNorm statistics in f32 (E[x²] − E[x]²) and strays from the
    witness by ``JAX_F32_WITNESS_REL`` of a leaf's largest |value| (its
    reading, as ``tests/test_torch_zoo.py`` holds the JAX ResNet-20)."""
    t, m = jax_runs[name]
    hist = [np.asarray(h) for h in t.get_history()]
    for res in ranks:
        got = res[name]
        assert len(got["history"]) == len(hist)
        for g, h in zip(got["history"], hist):
            _close(g, h)
        if name == "resnet":
            _close_leaves(got["variables"], resnet_witness[1],
                          over_tree=True)
        else:
            _close_leaves(got["variables"], m.variables)
    if name == "resnet":
        assert _rel_err(m.variables, resnet_witness[1]) <= \
            JAX_F32_WITNESS_REL
    a, b = (jax.tree_util.tree_leaves(r[name]["variables"]) for r in
            (ranks[0], ranks[3]))
    assert all(np.array_equal(u, v) for u, v in zip(a, b))


def test_put_place_and_batch_sharding_take_this_ranks_block():
    """``put`` / ``place`` / ``replicate`` keep the block of the whole
    host array that the rank's coordinates name, as JAX's
    ``make_array_from_callback`` hands each device ``x[index]``;
    ``batch_sharding`` is JAX's spec."""
    mesh = types.SimpleNamespace(
        procs=lambda a: {"dp": 2, "mp": 2}[a],
        coord=lambda a: {"dp": 1, "mp": 0}[a], device=torch.device("cpu"))
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(spmd.put(x, mesh, spmd.P("dp", "mp")),
                                  x[2:, :3])
    tree = {"a": x, "b": [x[0]]}
    got = spmd.place(tree, mesh, {"a": spmd.P(None, "mp"), "b": [spmd.P()]})
    np.testing.assert_array_equal(got["a"], x[:, :3])
    np.testing.assert_array_equal(got["b"][0], x[0])
    assert all(torch.is_tensor(t) for t in
               jax.tree_util.tree_leaves(spmd.replicate(tree, mesh)))
    for dim in (0, 1):
        want = jax_spmd.batch_sharding(
            jax_make_mesh(axis_names=("dp",), shape=(2,)), "dp", dim).spec
        assert spmd.spec_str(spmd.batch_sharding(mesh, "dp", dim)) == \
            str(want)
    with pytest.raises(ValueError, match="does not split"):
        spmd.put(np.zeros((3, 2)), mesh, spmd.P("dp"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharding_report_equals_jax_key_for_key(ranks, name):
    want = _jax_report(name)
    for res in ranks:
        assert res[name]["report"] == want
    assert want["per_device_bytes"] < want["global_bytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_are_the_dp_all_reduce_and_mp_gathers(ranks, name):
    """Every step all-reduces the gradients over dp and gathers the split
    parameters over mp; nothing goes through the host on the CPU.  The
    eager port compiles no program: ``compiled_step`` is None."""
    for res in ranks:
        stats = res[name]["stats"]
        assert stats["calls"].get("all_reduce", 0) > 0
        assert stats["calls"].get("all_gather", 0) > 0
        assert not stats["host_calls"]
        assert res[name]["compiled_step"] is None


@pytest.mark.parametrize("name,column,row", [("mlp", 1, 0), ("lm", 3, 2),
                                              ("resnet", 0, 0)])
def test_split_dense_kernels_split_their_products(ranks, name, column,
                                                  row):
    """Dense kernels split over mp multiply as column or row blocks: the
    MLP's (10, 256) kernel by columns; the LM's FF kernels by columns
    then rows and its vocab head by columns; the ResNet's head is too
    small to split.  Counted a forward: (steps a run) × (split layers)."""
    steps = {n: kw["num_epoch"] * len(_data(n)[0]) // kw["batch_size"]
             for n, (_, _, kw) in CASES.items()}
    for res in ranks:
        assert res[name]["products"] == {"column": column * steps[name],
                                         "row": row * steps[name]}


def test_resume_equals_the_straight_run(ranks):
    """The counterpart of ``tests/test_spmd_resume.py``: one epoch, a
    checkpoint, then a resumed run to the end equals the straight run
    (split leaves gathered into the file and cut again on restore)."""
    for res in ranks:
        got, straight = res["mlp"]["resumed"], res["mlp"]
        assert len(got["history"]) == 1
        np.testing.assert_array_equal(got["history"][0],
                                      straight["history"][-1])
        for g, w in zip(jax.tree_util.tree_leaves(got["variables"]),
                        jax.tree_util.tree_leaves(straight["variables"])):
            np.testing.assert_array_equal(g, w)


def test_streamed_run_equals_jax(ranks, monkeypatch_module, tmp_path):
    ds = JaxSFD.write(_jax_ds("mlp"), str(tmp_path / "shards"),
                      rows_per_shard=48)
    t, m = _jax_train("mlp", ds)
    for res in ranks:
        got = res["mlp"]["streamed"]
        for g, h in zip(got["history"], t.get_history()):
            _close(g, np.asarray(h))
        _close_leaves(got["variables"]["params"], m.variables["params"])
        rep = res["mlp"]["streamed_report"]
        assert rep == t.sharding_report == _jax_report("mlp")
        assert rep["per_device_bytes"] < rep["global_bytes"]


def test_flash_plain_versions_see_plain_local_tensors(ranks):
    """The attention kernels (their plain versions on the CPU) run on
    plain tensors of this rank's batch block: (B/dp·H, T, Dh)."""
    _, _, kw = CASES["lm"]
    for res in ranks:
        seen = res["lm"]["seen"]
        assert {s[0] for s in seen} == {"fwd", "bwd"}
        for _, types_, shape in seen:
            assert set(types_) == {"Tensor"}
            assert shape == (kw["batch_size"] // MESH["dp"] * 2, 16, 16)


@pytest.fixture(scope="module")
def resnet_witness(inits):
    """The port's one-process ``SingleTrainer`` run of the ResNet case in
    float64: the witness of both f32 runs."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.utils import load_jax_variables
    from distkeras_tpu_torch.utils import to_numpy_variables
    cfg, init = inits["resnet"]
    model = Model.from_config(cfg)
    build = model.init

    def init64(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, init[int(seed)])
        return model.double()
    model.init = init64
    x, y = _data("resnet")
    t = dkt.SingleTrainer(model, "sgd", device="cpu",
                          **CASES["resnet"][2], **COLS)
    t.train(dkt.Dataset({"features": x.astype(np.float64),
                         "label": y.astype(np.float64)}))
    return t.get_history(), to_numpy_variables(model)


def test_spmd_resnet_is_exact_in_float64(ranks, resnet_witness):
    """The dp × mp run's math is the one-process run's: in float64 the
    port's ResNet-20 on ``{"dp": 2, "mp": 2}`` (BatchNorm statistics
    ``pmean``ed over dp, conv channels gathered over mp) equals its
    ``SingleTrainer`` run within 1e-9 of each leaf's largest |value|."""
    hist, want = resnet_witness
    for res in ranks:
        got = res["resnet64"]
        for g, h in zip(got["history"], hist):
            np.testing.assert_allclose(g, h, rtol=1e-12)
        _close_leaves(got["variables"], want, rel=1e-9)
