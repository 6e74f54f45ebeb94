"""The port's Keras adapter (``distkeras_tpu_torch.models.keras_adapter``,
Keras 3 on its torch backend) against the JAX package's (Keras on JAX),
on the CPU; mirrors ``tests/test_keras_adapter.py``'s cases.

``tests/conftest.py`` pins ``KERAS_BACKEND=jax`` for this process, so the
port's side runs in ONE subprocess (``tests/test_torch_keras_child.py``,
``KERAS_BACKEND=torch``).  Weights cross as the ``trainable_variables``
/ ``non_trainable_variables`` lists of the Keras-JAX models built here.
Tolerances (f32, the same weights): a forward within rtol 1e-5 plus
1e-6 (XLA and torch sum the products in other orders), BatchNorm's
training forward and new statistics the same; 4 SGD steps of batch 32:
per-step losses within rtol 1e-4 and every variable within 1e-5.  The
Dropout cases and the trainers' runs are held to accuracy anchors as the
JAX test holds them, on its data sizes (the two backends' random streams
differ).  The card's machine has no ``keras``: the adapter is held here
only.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.transformers import OneHotTransformer
from tests.test_torch_keras_child import (COMMON, DATA, STEP_ROWS, STEPS,
                                          builders)
from tests.test_trainers_sync import toy_problem

keras = pytest.importorskip("keras")
if keras.backend.backend() != "jax":
    pytest.skip("keras is not on the JAX backend in this process",
                allow_module_level=True)

from distkeras_tpu.models.keras_adapter import KerasAdapter  # noqa: E402

# one torch intra-op pool per xdist worker, not one per core each
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mlp", "dropout", "convbn", "lstm", "transformer")
STEPPED = ("mlp", "convbn", "lstm", "transformer")


def _image_problem(n=2048, seed=0):
    """Class = which half of a 6x6 image is brighter."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6, 6, 1)).astype(np.float32)
    bias = rng.integers(0, 2, size=n)
    x[bias == 0, :3] += 1.0
    x[bias == 1, 3:] += 1.0
    ds = dk.Dataset({"features": x, "label": bias.astype(np.int64)})
    return OneHotTransformer(2, "label", "label_onehot").transform(ds)


def _seq_problem(n=1024, seed=4):
    """The majority of (token % 3) over 12 tokens."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, size=(n, 12)).astype(np.float32)
    y = np.array([np.bincount(r, minlength=3).argmax()
                  for r in x.astype(np.int64) % 3])
    ds = dk.Dataset({"features": x, "label": y})
    return OneHotTransformer(3, "label", "label_onehot").transform(ds)


def _columns(ds):
    return {k: np.asarray(ds[k]) for k in ("features", "label",
                                            "label_onehot")}


@pytest.fixture(scope="module")
def jax_side():
    """The Keras-JAX models' weights, forwards and 4-step trajectories."""
    data = {"toy": toy_problem(), "img": _image_problem(),
            "seq": _seq_problem()}
    build = builders(keras)
    weights, forward, steps, train_forward = {}, {}, {}, None
    for name in ARCHS:
        keras.utils.set_random_seed(0)
        model = KerasAdapter(build[name]())
        v = model.init(0)
        weights[name] = {k: [np.asarray(a) for a in v[k]]
                         for k in ("params", "state")}
        x = data[DATA[name]]["features"][:16]
        forward[name] = np.asarray(model.apply(v, x)[0])
        if name == "convbn":
            y, state = model.apply(v, x, train=True)
            train_forward = (np.asarray(y), [np.asarray(s) for s in state])
        if name in STEPPED:
            kw = {k: v for k, v in {**COMMON, **STEPS}.items()
                  if k != "device"}
            t = dk.SingleTrainer(model, "sgd", **kw)
            trained = t.train(data[DATA[name]].take(STEP_ROWS))
            steps[name] = (np.concatenate([np.asarray(h) for h in
                                           t.get_history()]),
                           trained.variables)
    return {"data": {k: _columns(d) for k, d in data.items()},
            "weights": weights, "forward": forward, "steps": steps,
            "train_forward": train_forward}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """The one subprocess: the same models on Keras-torch through the
    port."""
    work = tmp_path_factory.mktemp("keras_torch")
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"data": jax_side["data"],
                     "weights": jax_side["weights"]}, f)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    env = dict(os.environ, KERAS_BACKEND="torch", PYTHONPATH=ROOT,
               DKT_TEST_THREADS=str(max(1, os.cpu_count() // workers)))
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "test_torch_keras_child.py"),
         str(work)], env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-6000:]
    with open(work / "results.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ARCHS)
def test_variable_lists_are_the_jax_adapters(jax_side, port_side, name):
    want = {k: [a.shape for a in v]
            for k, v in jax_side["weights"][name].items()}
    assert port_side["shapes"][name] == want


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_keras_on_jax(jax_side, port_side, name):
    np.testing.assert_allclose(port_side["forward"][name],
                               jax_side["forward"][name],
                               rtol=1e-5, atol=1e-6)


def test_batchnorm_training_forward_and_statistics(jax_side, port_side):
    y, state = port_side["train_forward"]["convbn"]
    ry, rstate = jax_side["train_forward"]
    np.testing.assert_allclose(y, ry, rtol=1e-5, atol=1e-6)
    assert len(state) == len(rstate)
    for a, b in zip(state, rstate):
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", STEPPED)
def test_f32_steps_match_keras_on_jax(jax_side, port_side, name):
    losses, variables = port_side["steps"][name]
    ref_losses, ref_vars = jax_side["steps"][name]
    assert losses.shape == (STEP_ROWS // STEPS["batch_size"],)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for kind in ("params", "state"):
        for a, b in zip(variables[kind], ref_vars[kind]):
            b = np.asarray(b)
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, atol=1e-5)


def test_keras_model_trains_single(port_side):
    assert port_side["accuracy"]["mlp_single"] > 0.9


def test_keras_model_trains_distributed(port_side):
    acc = port_side["accuracy"]
    assert acc["mlp_adag"] > acc["mlp_single"] - 0.10, acc


def test_keras_ensemble_decorrelated(port_side):
    e = port_side["ensemble"]
    assert e["init_ignores_seed"] and e["reinit_differs"]
    assert e["reinit_deterministic"]
    assert e["members"] == 8 and e["all_adapters"] and e["members_differ"]


def test_keras_serde_roundtrip(port_side):
    name, y1, y2 = port_side["serde"]
    assert name == "KerasAdapter"
    np.testing.assert_array_equal(y1, y2)


def test_keras_conv_batchnorm_single(port_side):
    assert port_side["accuracy"]["convbn_single"] > 0.9
    assert port_side["convbn_state_moved"]


def test_keras_conv_batchnorm_distributed(port_side):
    assert port_side["accuracy"]["convbn_adag"] > 0.85


def test_keras_dropout_single(port_side):
    acc = port_side["accuracy"]
    assert acc["dropout_single"] > acc["mlp_single"] - 0.05, acc
    assert port_side["dropout_eval_repeats"]


def test_keras_dropout_distributed(port_side):
    acc = port_side["accuracy"]
    assert acc["dropout_adag"] > acc["mlp_single"] - 0.12, acc


def test_keras_dropout_async_elastic(port_side):
    """The elastic async rule leaves integer state leaves (Keras' seed
    generator counter) integer."""
    assert port_side["accuracy"]["dropout_aeasgd_async"] > 0.4
    assert any("int" in d for d in port_side["async_state_dtypes"])


def test_keras_transformer_single(port_side):
    assert port_side["accuracy"]["transformer_single"] > 0.8
    hist = port_side["transformer_history"]
    assert hist[-1] < hist[0]


def test_keras_transformer_distributed(port_side):
    assert port_side["accuracy"]["transformer_adag"] > 0.7


def test_keras_lstm_single(port_side):
    assert port_side["accuracy"]["lstm_single"] > 0.7


def test_job_runner_rebuilds_a_keras_adapter_job(port_side):
    name, epochs, acc = port_side["job"]
    assert name == "KerasAdapter" and epochs == COMMON["num_epoch"]
    assert acc > 0.6
