"""The port's model zoo, ``SingleTrainer`` on the conv, MLP and LSTM
models, ``ModelPredictor`` and the evaluators against the JAX package's,
on the CPU.

Every ``BASELINE.json`` model is built from the JAX package's config
JSON (``Model.from_config``); the two packages hold the same weights
(the port's init, handed to JAX as a variables tree of ``jm.init``'s
structure) and give the same forward on the same seeded numpy input,
at narrow widths (``resnet20(width=4)``; ``resnet50`` by its config JSON
at full width and one forward at a 32-pixel input).
Forwards agree within 1e-5 of the reference's largest |value|, and of
the port's own float64 evaluation (the witness); trainer trajectories
within rtol 1e-4 on losses and atol 1e-4 on parameters and state, against
the port's trainer in float64 and against the JAX trainer, save where the
JAX trainer's own f32 run strays further from the witness
(``JAX_F32_WITNESS_ATOL``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu import evaluators as jev
from distkeras_tpu.data.datasets import load_cifar10 as jax_load_cifar10
from distkeras_tpu.data.datasets import load_mnist as jax_load_mnist
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.predictors import ModelPredictor as JaxModelPredictor

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import evaluators as ev
from distkeras_tpu_torch.data import Dataset, load_cifar10, load_mnist
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.predictors import ModelPredictor
from distkeras_tpu_torch.utils import to_numpy_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

REL_TOL = 1e-5
#: the JAX package's f32 SingleTrainer on resnet20(width=4) at lr 0.1
#: strays from the float64 witness by up to 1.15e-3 in its trained
#: parameters (the first conv kernel; 2.4% of its change): its BatchNorm
#: statistics are summed in f32.  With them in float64 under x64 it equals
#: the witness (test_jax_trainer_in_float64_equals_the_witness); the port's
#: f32 run stays within 5e-7 of it.  The reference is held at its reading.
JAX_F32_WITNESS_ATOL = 1.5e-3

#: name -> (constructor over a zoo module, input kind)
MODELS = {
    "mlp_mnist": (lambda z: z.mlp_mnist(hidden=32), "float"),
    "convnet_mnist": (lambda z: z.convnet_mnist(), "float"),
    "convnet_cifar10": (lambda z: z.convnet_cifar10(), "float"),
    "resnet20": (lambda z: z.resnet20(width=4), "float"),
    "lstm_imdb": (lambda z: z.lstm_imdb(vocab_size=50, embed_dim=8,
                                        lstm_units=6, seq_len=12), "tokens"),
}


def _close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), err


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _shared(jm, seed=0):
    """(the port's model of ``jm``'s config built from ``seed``, its
    variables as a JAX tree for ``jm``).  The tree has the structure,
    shapes and dtypes of ``jm.init``'s (checked abstractly: initialising
    the JAX model eagerly costs seconds per model on the CPU)."""
    pm = Model.from_config(jm.config()).init(seed, device="cpu")
    jv = jax.tree_util.tree_map(jnp.asarray, to_numpy_variables(pm))
    want = jax.eval_shape(lambda: jm.init(0))
    assert jax.tree_util.tree_structure(jv) == \
        jax.tree_util.tree_structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree_util.tree_leaves(jv)] == \
        [(a.shape, a.dtype) for a in jax.tree_util.tree_leaves(want)]
    return pm, jv


def _inputs(jm, kind, n=4, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "tokens":
        return rng.integers(0, 50, size=(n, *jm.input_shape)).astype(
            np.int32)
    return rng.uniform(0, 1, size=(n, *jm.input_shape)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_forward_matches_jax(name, train):
    make, kind = MODELS[name]
    jm = make(jax_zoo)
    pm_direct = make(zoo)
    assert pm_direct.config() == jm.config()
    pm, jv = _shared(jm)
    if train:
        # the two packages' dropout draws differ (test_torch_layers.py
        # holds dropout to its law): both run it at rate 0 here
        for lyr in (*jm.layer.iter_layers(), *pm.modules()):
            if type(lyr).__name__ == "Dropout":
                lyr.rate = 0.0
    x = _inputs(jm, kind)
    y_ref, _ = jax.jit(lambda v, x: jm.layer.apply(
        v["params"], v["state"], x, train=train,
        rng=jax.random.PRNGKey(0)))(jv, jnp.asarray(x))
    pm.train(train)
    with torch.no_grad():
        y = pm(torch.from_numpy(x))
    _close(y.numpy(), y_ref)
    # the witness: the port's model in float64
    with torch.no_grad():
        pm.double()
        y64 = pm(torch.from_numpy(x if kind == "tokens" else
                                  x.astype(np.float64)))
    _close(y.numpy(), y64.numpy())
    assert sum(p.numel() for p in pm.parameters()) == sum(
        a.size for a in _leaves(jv["params"]))


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_resnet50_config_and_forward(stem):
    """Full width: the config JSON equals the JAX package's, parameter
    counts agree, and one eval forward at a 32-pixel input matches."""
    jm = jax_zoo.resnet50(num_classes=10, input_size=32, stem=stem)
    assert zoo.resnet50(num_classes=10, input_size=32,
                        stem=stem).config() == jm.config()
    assert zoo.resnet50(stem=stem).config() == \
        jax_zoo.resnet50(stem=stem).config()
    pm, jv = _shared(jm)
    x = _inputs(jm, "float", n=2)
    y_ref = jax.jit(jm.predict_fn())(jv, jnp.asarray(x))
    with torch.no_grad():
        y = pm(torch.from_numpy(x))
    _close(y.numpy(), y_ref)


def test_resnet50_rejects_unknown_stem():
    with pytest.raises(ValueError, match="stem"):
        zoo.resnet50(stem="conv5")


@pytest.fixture(scope="module")
def mnist():
    return (jax_load_mnist(n_train=256)[0], load_mnist(n_train=256)[0])


@pytest.fixture(scope="module")
def cifar():
    return (jax_load_cifar10(n_train=64)[0], load_cifar10(n_train=64)[0])


def _float64(model):
    """``model`` whose ``init`` (the one a trainer calls) also casts it to
    float64: the witness of an f32 run from the same weights."""
    build = model.init
    model.init = lambda seed=0, device=None: build(
        seed, device=device).double()
    return model


def _trajectories(name, lr, mnist, cifar):
    """(the JAX trainer, the port's trainer, the port's trainer on the
    model in float64), SGD at ``lr`` from the port's init of seed 0 on
    the same surrogate rows: ``mlp_mnist`` 2 epochs of batch 64,
    ``resnet20(width=4)`` two steps of batch 16."""
    if name == "mlp_mnist":
        make = lambda z: z.mlp_mnist(hidden=64)  # noqa: E731
        (jds, ds), kw = mnist, dict(num_epoch=2, batch_size=64)
    else:
        make = lambda z: z.resnet20(width=4)  # noqa: E731
        (jds, ds), kw = cifar, dict(num_epoch=1, batch_size=16)
        jds, ds = jds.take(32), ds.take(32)
    kw.update(learning_rate=lr)
    loss = "sparse_categorical_crossentropy"
    jm = make(jax_zoo)
    model, jv = _shared(jm, seed=0)
    init = _leaves(jv)   # before training: the JAX trainer donates jv
    jm.init = lambda rng=0: jv
    jt = dk.SingleTrainer(jm, "sgd", loss, **kw)
    jt.train(jds, shuffle=True)
    t = dkt.SingleTrainer(model, "sgd", loss, device="cpu", **kw)
    assert t.train(ds, shuffle=True) is model
    assert not model.training   # back in eval mode after the window
    wt = dkt.SingleTrainer(_float64(Model.from_config(jm.config())), "sgd",
                           loss, device="cpu", **kw)
    wt.train(Dataset({"features": ds["features"].astype(np.float64),
                      "label": ds["label"]}), shuffle=True)
    return jt, t, wt, init


def _max_abs(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - y)))
               for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("name,lr", [("mlp_mnist", 0.1), ("resnet20", 0.1),
                                     ("resnet20", 0.01)])
def test_single_trainer_matches_jax_trainer(name, lr, mnist, cifar):
    """Per-step losses against the JAX trainer's (rtol 1e-4); trained
    parameters and BatchNorm state against the float64 witness and, where
    the reference's f32 run is as close to the witness, against the JAX
    trainer's (atol 1e-4).  At ResNet-20's lr 0.1 (the bench's) the
    reference is held to the witness at its own reading
    (``JAX_F32_WITNESS_ATOL``)."""
    jt, t, wt, init = _trajectories(name, lr, mnist, cifar)
    np.testing.assert_allclose(np.concatenate(t.get_history()),
                               np.concatenate(jt.get_history()), rtol=1e-4)
    np.testing.assert_allclose(np.concatenate(t.get_history()),
                               np.concatenate(wt.get_history()), rtol=1e-4)
    got, ref, wit = (t.trained_variables, jt.trained_variables,
                     wt.trained_variables)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, ref))
    assert _max_abs(got, wit) <= 1e-4
    if name == "resnet20" and lr == 0.1:
        assert _max_abs(ref, wit) <= JAX_F32_WITNESS_ATOL
    else:
        assert _max_abs(got, ref) <= 1e-4
    if name == "resnet20":   # the BatchNorm state moved, as JAX's did
        state = _leaves(got["state"])
        assert any(not np.allclose(a, b) for a, b in
                   zip(state, init[-len(state):]))


def test_jax_trainer_in_float64_equals_the_witness(monkeypatch, cifar):
    """The JAX trainer under x64, its BatchNorm statistics summed in
    float64 instead of f32 (its ``jnp.float32`` read as float64 in that
    module alone), trains ResNet-20 at lr 0.1 to the port's float64
    witness within 1e-12: where the two f32 runs part, the reference's
    f32 batch statistics are the cause, not a difference of the step."""
    import distkeras_tpu.models.layers as jax_layers

    class _Wide:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    jds, ds = (d.take(32) for d in cifar)
    kw = dict(num_epoch=1, batch_size=16, learning_rate=0.1)
    loss = "sparse_categorical_crossentropy"
    jm = jax_zoo.resnet20(width=4)
    wt = dkt.SingleTrainer(_float64(Model.from_config(jm.config())), "sgd",
                           loss, device="cpu", **kw)
    wt.train(Dataset({"features": ds["features"].astype(np.float64),
                      "label": ds["label"]}), shuffle=True)
    init = to_numpy_variables(Model.from_config(jm.config()).init(
        0, device="cpu"))
    monkeypatch.setattr(jax_layers, "jnp", _Wide())
    with jax.enable_x64(True):
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    init)
        jm.init = lambda rng=0: jv
        jt = dk.SingleTrainer(jm, "sgd", loss, **kw)
        jt.train(dk.Dataset({"features": np.asarray(jds["features"],
                                                    np.float64),
                             "label": np.asarray(jds["label"])}),
                 shuffle=True)
        ref = jax.tree_util.tree_map(np.asarray, jt.trained_variables)
    assert all(a.dtype == np.float64 for a in _leaves(ref))
    assert _max_abs(ref, wt.trained_variables) <= 1e-12


def _convnet_with_dropout():
    from distkeras_tpu_torch.models import (Activation, BatchNorm, Conv2D,
                                            Dense, Dropout, Flatten,
                                            Sequential)
    return Model(Sequential([
        Conv2D(4, 3, strides=2, use_bias=False), BatchNorm(),
        Activation("relu"), Flatten(), Dropout(0.5),
        Dense(10, "softmax")]), input_shape=(8, 8, 3))


def test_remat_replays_dropout_and_commits_state_once():
    """``remat=True`` recomputes the forward in the backward: the same
    dropout draws (from the trainer's generator, not the global RNG) and
    one state update per step, so it trains exactly as without."""
    rng = np.random.default_rng(0)
    ds = Dataset({"features": rng.uniform(size=(64, 8, 8, 3)).astype(
        np.float32), "label": rng.integers(0, 10, size=64)})
    runs = []
    for remat in (False, True):
        t = dkt.SingleTrainer(_convnet_with_dropout(), "sgd",
                              "sparse_categorical_crossentropy",
                              batch_size=16, num_epoch=2, learning_rate=0.1,
                              remat=remat, seed=3, device="cpu")
        torch.manual_seed(remat)   # the global RNG must not matter
        t.train(ds)
        runs.append((np.concatenate(t.get_history()),
                     _leaves(t.trained_variables)))
    (l0, v0), (l1, v1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for a, b in zip(v1, v0):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_single_trainer_draws_dropout_from_seed_plus_one():
    """Two trainers of one seed give equal losses through dropout; a
    different seed gives different draws (and different losses)."""
    rng = np.random.default_rng(1)
    ds = Dataset({"features": rng.uniform(size=(32, 8, 8, 3)).astype(
        np.float32), "label": rng.integers(0, 10, size=32)})
    hist = []
    for seed in (5, 5, 6):
        t = dkt.SingleTrainer(_convnet_with_dropout(), "sgd",
                              "sparse_categorical_crossentropy",
                              batch_size=16, learning_rate=0.1, seed=seed,
                              device="cpu")
        model = t.train(ds)
        hist.append(t.get_history()[0])
    np.testing.assert_array_equal(hist[0], hist[1])
    assert not np.array_equal(hist[0], hist[2])
    assert model.layer.layers[4].generator is t.generator


@pytest.fixture(scope="module")
def trained_mlp(mnist):
    jds, ds = mnist
    jm = jax_zoo.mlp_mnist(hidden=32)
    pm, jv = _shared(jm)
    return jm, jv, pm, jds, ds


@pytest.mark.parametrize("batch_size", [64, 100, 512])
def test_model_predictor_matches_jax(trained_mlp, batch_size):
    """Predictions (padded to a fixed batch; 256 rows, so 100 pads) equal
    the JAX predictor's, in eval mode, and the model's mode is kept."""
    jm, jv, pm, jds, ds = trained_mlp
    ref = JaxModelPredictor(jm, variables=jv, batch_size=batch_size)\
        .predict(jds)["prediction"]
    pm.train(True)
    pred = ModelPredictor(pm, batch_size=batch_size).predict(ds)
    assert pm.training
    pm.train(False)
    assert pred["prediction"].dtype == np.float32
    _close(pred["prediction"], ref)
    assert pred.column_names == ["features", "label", "prediction"]


def test_model_predictor_loads_variables_and_handles_empty(trained_mlp):
    jm, jv, _, jds, ds = trained_mlp
    pm = zoo.mlp_mnist(hidden=32).init(9, device="cpu")
    host = jax.tree_util.tree_map(np.asarray, jv)
    pred = ModelPredictor(pm, variables=host).predict(ds.take(10))
    _close(pred["prediction"], JaxModelPredictor(jm, variables=jv)
           .predict(jds.take(10))["prediction"])
    empty = ModelPredictor(pm).predict(ds.take(0))
    assert empty["prediction"].shape == (0, 10)
    with pytest.raises(ValueError, match="no variables"):
        ModelPredictor(zoo.mlp_mnist(hidden=8))


def _eval_columns():
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(5), size=40).astype(np.float32)
    ids = rng.integers(0, 5, size=40)
    onehot = np.eye(5, dtype=np.int64)[ids]
    sig = rng.uniform(size=(40, 1)).astype(np.float32)
    return {"probs": probs, "ids": ids, "onehot": onehot, "sig": sig,
            "bin": rng.integers(0, 2, size=40),
            "seq_ids": rng.integers(0, 5, size=(40, 6))}


@pytest.mark.parametrize("pred,label", [("probs", "ids"),
                                        ("probs", "onehot"),
                                        ("sig", "bin"), ("ids", "ids"),
                                        ("seq_ids", "seq_ids")])
@pytest.mark.parametrize("kind", ["AccuracyEvaluator", "F1Evaluator"])
def test_evaluators_match_jax(kind, pred, label):
    cols = _eval_columns()
    ds = Dataset({"prediction": cols[pred], "label": cols[label]})
    got = getattr(ev, kind)().evaluate(ds)
    ref = getattr(jev, kind)().evaluate(dk.Dataset(
        {"prediction": cols[pred], "label": cols[label]}))
    assert got == ref


@pytest.mark.parametrize("loss,label", [
    ("categorical_crossentropy", "onehot_f"),
    ("sparse_categorical_crossentropy", "ids")])
def test_loss_evaluator_matches_jax(loss, label):
    cols = _eval_columns()
    cols["onehot_f"] = cols["onehot"].astype(np.float64)
    data = {"prediction": cols["probs"], "label": cols[label]}
    got = ev.LossEvaluator(loss).evaluate(Dataset(data))
    ref = jev.LossEvaluator(loss).evaluate(dk.Dataset(data))
    assert abs(got - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("kind", ["auto", "ids", "onehot"])
def test_to_class_index_matches_jax(kind):
    cols = _eval_columns()
    for a in (cols["probs"], cols["ids"], cols["onehot"], cols["sig"],
              cols["seq_ids"]):
        if kind == "onehot" and a.ndim == 1:
            continue
        np.testing.assert_array_equal(ev._to_class_index(a, kind=kind),
                                      jev._to_class_index(a, kind=kind))
    with pytest.raises(ValueError):
        ev.Evaluator(prediction_kind="logits")


def test_trained_mlp_reaches_high_accuracy_through_the_predictor():
    """The pipeline end to end on the MNIST surrogate: train on 256 rows,
    predict and evaluate 1000 rows of the test split (0.999 when this
    test was written)."""
    train, test, _ = load_mnist(n_train=256)
    t = dkt.SingleTrainer(zoo.mlp_mnist(hidden=64), "adam",
                          "sparse_categorical_crossentropy", batch_size=32,
                          learning_rate=1e-3, num_epoch=4, device="cpu")
    model = t.train(train)
    pred = ModelPredictor(model, batch_size=64).predict(test.take(1000))
    assert ev.AccuracyEvaluator().evaluate(pred) > 0.95
    assert np.allclose(to_numpy_variables(model)["params"][0]["kernel"],
                       t.trained_variables["params"][0]["kernel"])


def test_bench_rows_run_on_the_cpu_at_a_tiny_size(monkeypatch):
    """``distkeras_tpu_torch.bench``'s two rows, shrunk and on the CPU
    (the numbers mean nothing here; the control flow is what is held):
    the ResNet-20 row times only its timed epochs; the MNIST row stops at
    the first epoch that reaches the target, and its one-epoch calls are
    the k-epoch run (the same test accuracy as one ``train()`` of k
    epochs)."""
    from distkeras_tpu_torch import bench
    for name, value in (("BATCH", 8), ("WIDTH", 4), ("STEPS_PER_EPOCH", 2),
                        ("WARMUP_EPOCHS", 1), ("TIMED_EPOCHS", 2),
                        ("MNIST_ROWS", 1024), ("MNIST_TARGET", 0.95)):
        monkeypatch.setattr(bench, name, value)
    row = bench.resnet20_row(device="cpu")
    assert len(row["timed_epoch_seconds"]) == 2
    assert row["value"] == pytest.approx(
        2 * 2 * 8 / sum(row["timed_epoch_seconds"]))
    assert len(row["epoch_mean_loss"]) == 3
    row = bench.mnist_row(device="cpu")
    assert row["reached"] and row["value"] == row["checks"][-1][
        "train_wall_s"]
    assert row["epochs"] > 1 and all(
        c["test_accuracy"] < 0.95 for c in row["checks"][:-1])
    train, test, _ = load_mnist(n_train=1024)
    t = dkt.SingleTrainer(zoo.mlp_mnist(), "sgd",
                          "sparse_categorical_crossentropy",
                          num_epoch=row["epochs"], batch_size=128,
                          learning_rate=0.1, compute_dtype="bfloat16",
                          device="cpu")
    assert ev.AccuracyEvaluator().evaluate(ModelPredictor(
        t.train(train)).predict(test)) == row["checks"][-1]["test_accuracy"]
    monkeypatch.setattr(bench, "MNIST_ROWS", 256)
    monkeypatch.setattr(bench, "MNIST_TARGET", 1.01)
    monkeypatch.setattr(bench, "MNIST_MAX_EPOCHS", 2)
    row = bench.mnist_row(device="cpu")
    assert not row["reached"] and row["value"] is None
    assert [c["epochs"] for c in row["checks"]] == [1, 2]
    assert row["checks"][1]["train_wall_s"] > row["checks"][0][
        "train_wall_s"]


def test_bench_needs_a_card(monkeypatch, capsys):
    from distkeras_tpu_torch import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert capsys.readouterr().out == ""
