"""The port's layers against the JAX package's, on the CPU: every layer
of the image, BatchNorm, Dropout and LSTM families at ``train=False`` and
``train=True``, with BatchNorm's state update, stride-2 SAME convs on
even and odd inputs, and SAME max and average pools.

Each case wraps one layer in a ``Sequential`` model of the JAX package,
builds the port's model from its config JSON and loads the JAX
variables into it (``load_jax_variables``); the same seeded numpy input
goes through both.  Outputs agree within 1e-5 of the reference's largest
|value| (f32, where the two frameworks sum in different orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import layers as jl
from distkeras_tpu.models.model import Model as JaxModel

from distkeras_tpu_torch.models import (LSTM, Dropout, Model, commit_state,
                                        set_generator)
from distkeras_tpu_torch.utils import load_jax_variables, to_numpy_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

#: outputs within this share of the reference's largest |value|
REL_TOL = 1e-5


def _close(got, ref, rel=REL_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _pair(layer, in_shape, seed=0):
    """(JAX model, its variables, the port's model holding them)."""
    jm = JaxModel(jl.Sequential([layer]), input_shape=in_shape)
    jv = jm.init(jax.random.PRNGKey(seed))
    pm = Model.from_config(jm.config()).init(0, device="cpu")
    load_jax_variables(pm, jax.tree_util.tree_map(np.asarray, jv))
    return jm, jv, pm


def _run_both(layer, in_shape, train, batch=3, seed=0, state=None):
    """The layer's output (and new state) from both packages on one input.
    ``state`` replaces the JAX initial state (BatchNorm's statistics)."""
    jm, jv, pm = _pair(layer, in_shape, seed)
    if state is not None:
        jv = {"params": jv["params"], "state": [state]}
        load_jax_variables(pm, jax.tree_util.tree_map(np.asarray, jv))
    x = np.random.default_rng(seed + 1).normal(
        size=(batch, *in_shape)).astype(np.float32)
    apply = jax.jit(lambda v, x: jm.layer.apply(
        v["params"], v["state"], x, train=train,
        rng=jax.random.PRNGKey(7)))
    y_ref, state_ref = apply(jv, jnp.asarray(x))
    pm.train(train)
    with torch.no_grad():
        y = pm(torch.from_numpy(x))
    commit_state(pm)
    return (y.numpy(), to_numpy_variables(pm)["state"]), \
        (np.asarray(y_ref), jax.tree_util.tree_map(np.asarray, state_ref))


CASES = {
    # stride-1 SAME, bias and activation
    "conv3_s1_same": (lambda: jl.Conv2D(4, 3, activation="relu"), (8, 8, 3)),
    # stride-2 SAME on an even input: XLA pads (0, 1)
    "conv3_s2_same_even": (lambda: jl.Conv2D(5, 3, strides=2), (8, 8, 3)),
    # ... on an odd input: (1, 1)
    "conv3_s2_same_odd": (lambda: jl.Conv2D(5, 3, strides=2), (9, 9, 2)),
    # resnet50's stem shape in small: 7x7/s2, pads (2, 3)
    "conv7_s2_same": (lambda: jl.Conv2D(4, 7, strides=2, use_bias=False),
                      (16, 16, 3)),
    "conv_rect_valid": (lambda: jl.Conv2D(3, (3, 2), strides=(1, 2),
                                          padding="VALID"), (7, 9, 2)),
    "conv1_s2": (lambda: jl.Conv2D(6, 1, strides=2, use_bias=False),
                 (8, 8, 4)),
    "maxpool2": (lambda: jl.MaxPool2D(2), (8, 8, 3)),
    # resnet50's stem pool in small: 3x3/s2 SAME, pads (0, 1) and (1, 1)
    "maxpool3_s2_same_even": (lambda: jl.MaxPool2D(3, strides=2,
                                                   padding="SAME"),
                              (8, 8, 3)),
    "maxpool3_s2_same_odd": (lambda: jl.MaxPool2D(3, strides=2,
                                                  padding="SAME"),
                             (9, 7, 2)),
    "avgpool2": (lambda: jl.AvgPool2D(2), (8, 8, 3)),
    "avgpool3_s2_same_even": (lambda: jl.AvgPool2D(3, strides=2,
                                                   padding="SAME"),
                              (8, 8, 3)),
    "avgpool3_s1_same_odd": (lambda: jl.AvgPool2D(3, strides=1,
                                                  padding="SAME"),
                             (7, 5, 2)),
    "space_to_depth": (lambda: jl.SpaceToDepth(2), (8, 6, 3)),
    "global_avg_pool": (lambda: jl.GlobalAvgPool2D(), (5, 6, 4)),
    "flatten": (lambda: jl.Flatten(), (4, 3, 5)),
    "reshape": (lambda: jl.Reshape((6, 10)), (4, 3, 5)),
    "batchnorm_nhwc": (lambda: jl.BatchNorm(), (4, 4, 3)),
    "batchnorm_flat": (lambda: jl.BatchNorm(momentum=0.8, epsilon=1e-3),
                       (5,)),
    "lstm_last": (lambda: jl.LSTM(6), (7, 4)),
    "lstm_sequences": (lambda: jl.LSTM(5, return_sequences=True), (6, 3)),
    "dropout_rate0": (lambda: jl.Dropout(0.0), (4, 5)),
    "dense": (lambda: jl.Dense(7, "tanh"), (5,)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name, train):
    make, in_shape = CASES[name]
    (y, state), (y_ref, state_ref) = _run_both(make(), in_shape, train,
                                               batch=8)
    _close(y, y_ref)
    for got, ref in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(state_ref)):
        _close(got, ref)
    if name == "dropout_rate0":   # rate 0 is the identity, exactly
        np.testing.assert_array_equal(y, y_ref)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_from_a_moved_state(train):
    """Eval normalizes by the loaded statistics, train moves them by
    0.1 of the batch's (biased) ones."""
    rng = np.random.default_rng(3)
    state = {"mean": rng.normal(size=3).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=3).astype(np.float32)}
    (y, got), (y_ref, ref) = _run_both(jl.BatchNorm(), (4, 4, 3), train,
                                       batch=6, state=state)
    _close(y, y_ref)
    for k in ("mean", "var"):
        _close(got[0][k], ref[0][k])
    moved = not np.allclose(got[0]["mean"], state["mean"])
    assert moved == train


def test_batchnorm_stats_accumulate_in_f32_for_bf16():
    """bf16 activations: statistics in f32, the affine in bf16, as the
    reference's (within bf16 rounding of the output)."""
    jm, jv, pm = _pair(jl.BatchNorm(), (4, 4, 8))
    x = (np.random.default_rng(5).normal(size=(16, 4, 4, 8)) * 3 + 1
         ).astype(np.float32)
    y_ref, s_ref = jm.layer.apply(jv["params"], jv["state"],
                                  jnp.asarray(x, jnp.bfloat16), train=True)
    pm.train(True)
    y = pm(torch.from_numpy(x).to(torch.bfloat16))
    commit_state(pm)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().detach().numpy(),
                               np.asarray(y_ref, np.float32), atol=0.05)
    got = to_numpy_variables(pm)["state"][0]
    assert got["mean"].dtype == np.float32
    _close(got["mean"], s_ref[0]["mean"])
    _close(got["var"], s_ref[0]["var"])


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_keep_fraction_and_scale(rate):
    """The two packages' generators differ, so training-mode dropout is
    held to its law: kept entries are x / keep exactly, the rest 0, and
    the kept share is keep within 4 standard deviations."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        1.0, 2.0, size=(64, 128)).astype(np.float32))
    layer = Dropout(rate)
    layer.train(True)
    with pytest.raises(ValueError, match="generator"):
        layer(x)
    gen = torch.Generator().manual_seed(0)
    set_generator(layer, gen)
    y = layer(x)
    keep = 1.0 - rate
    kept = y != 0
    np.testing.assert_array_equal(y[kept].numpy(), (x / keep)[kept].numpy())
    share, n = float(kept.float().mean()), x.numel()
    assert abs(share - keep) <= 4 * (keep * rate / n) ** 0.5
    # a second draw differs; the same seed gives the same mask
    assert not torch.equal(layer(x), y)
    gen.manual_seed(0)
    assert torch.equal(layer(x), y)
    layer.train(False)
    assert torch.equal(layer(x), x)


def test_lstm_gate_layout_and_forget_bias():
    """Parameters are (in, 4h) and (h, 4h) with gates i, f, g, o and the
    forget gate's bias 1, as the JAX package lays them out."""
    jm, jv, pm = _pair(jl.LSTM(4), (3, 2))
    lstm = pm.layer.layers[0]
    assert isinstance(lstm, LSTM)
    assert tuple(lstm.kernel.shape) == (2, 16)
    assert tuple(lstm.recurrent.shape) == (4, 16)
    fresh = Model.from_config(jm.config()).init(0, device="cpu")
    np.testing.assert_array_equal(
        fresh.layer.layers[0].bias.detach().numpy(),
        np.asarray(jv["params"][0]["bias"]))


def test_variables_round_trip_with_state():
    """``to_numpy_variables`` returns the buffers as ``state``; loading
    that tree back is bit-exact, and a mismatched state is refused."""
    layer = jl.Sequential([jl.Conv2D(3, 3), jl.BatchNorm(),
                           jl.Activation("relu")])
    jm = JaxModel(jl.Sequential([jl.Residual(
        layer, jl.Sequential([jl.Conv2D(3, 1), jl.BatchNorm()]))]),
        input_shape=(5, 5, 2))
    jv = jax.tree_util.tree_map(np.asarray, jm.init(0))
    pm = Model.from_config(jm.config()).init(1, device="cpu")
    load_jax_variables(pm, jv)
    back = to_numpy_variables(pm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jv)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jv)
    bad = {"params": jv["params"], "state": [{"inner": [{}, {}, {}],
                                              "shortcut": [{}, {}]}]}
    with pytest.raises(ValueError, match="state"):
        load_jax_variables(pm, bad)
