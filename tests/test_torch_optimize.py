"""The port's ``models.optimize`` (``fold_batchnorm``, ``ZigzagStripe``,
``zigzag_wrap``) and ``num_params`` against the JAX package's, on the
CPU.

``fold_batchnorm`` on a ResNet-20 whose BatchNorm statistics were moved
off their init: the folded layers and leaves equal JAX's (the affine in
float64, stored in f32: within 1 f32 ulp-scale of the leaf), the folded
forward equals JAX's folded forward and the port's unfolded one within
1e-5 of the largest |logit|.  ``zigzag_wrap`` of a flash ``gpt_lm`` on
an ``sp`` mesh of 2 (gloo child ranks, ``tests/test_torch_mesh_child.
py``: two replicas in one spawn of 4): the insert positions, logits and
gradients equal JAX's wrapped model's (the fake devices of
``tests/conftest.py``) within 1e-5 of the largest |value|, and the
unwrapped zigzag ring's; the original model keeps its flags; a wrapped
model refuses ``config()``.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.models.model import num_params as jax_num_params
from distkeras_tpu.models.optimize import fold_batchnorm as jax_fold
from distkeras_tpu.models.optimize import zigzag_wrap as jax_zigzag_wrap
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh

from distkeras_tpu_torch.models import (Model, ZigzagStripe, fold_batchnorm,
                                        num_params, zigzag_wrap)
from distkeras_tpu_torch.models.layers import LAYER_REGISTRY
from distkeras_tpu_torch.ops.attention import MultiHeadAttention
from distkeras_tpu_torch.utils import load_jax_variables, to_numpy_variables
from distkeras_tpu_torch.utils.weights import jax_leaf_names
from test_torch_mesh_child import run_ranks

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

LM = dict(vocab_size=64, dim=32, num_heads=2, num_blocks=2, seq_len=16,
          attention_impl="flash")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / \
        max(float(np.max(np.abs(want))), 1e-30)


@pytest.fixture(scope="module")
def resnet():
    """A ResNet-20 (width 8) with its BatchNorm statistics moved off their
    init (mean 0, var 1), the JAX variables and the port model holding
    them."""
    jm = dk.zoo.resnet20(width=8)
    pm = Model.from_config(jm.config()).init(0, device="cpu")
    v = to_numpy_variables(pm)
    rng = np.random.default_rng(0)

    def move(tree):
        if isinstance(tree, dict):
            return {k: (rng.normal(0, 0.2, np.shape(a)).astype(np.float32)
                        if k == "mean" else
                        rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
                        if k == "var" else move(a))
                    for k, a in tree.items()}
        if isinstance(tree, list):
            return [move(t) for t in tree]
        return tree
    v["state"] = move(v["state"])
    v["params"] = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        if a.ndim == 1 else a, v["params"])
    load_jax_variables(pm, v)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    return jm, v, pm, x


def test_fold_batchnorm_equals_jax_on_resnet20(resnet):
    jm, v, pm, x = resnet
    jfm, jfv = jax_fold(jm, v)
    fm = fold_batchnorm(pm)
    assert fm.config()["layer"] == jfm.config()["layer"]
    assert fm.name == jfm.name
    got = to_numpy_variables(fm)
    want = jax.tree_util.tree_map(np.asarray, jfv)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert _rel(g, w) <= 1e-6
    # no BatchNorm is left in the folded stack
    assert not any(type(lyr).__name__ == "BatchNorm"
                   for lyr in fm.iter_layers())
    with torch.no_grad():
        y = fm(torch.from_numpy(x)).numpy()
        y_unfolded = pm(torch.from_numpy(x)).numpy()
    jy, _ = jax.jit(jfm.apply)(jfv, jnp.asarray(x))
    assert _rel(y, np.asarray(jy)) <= 1e-5
    assert _rel(y, y_unfolded) <= 1e-5
    # the original keeps its BatchNorm layers and weights
    assert _rel(to_numpy_variables(pm)["params"][0]["kernel"],
                v["params"][0]["kernel"]) == 0.0


def test_fold_batchnorm_refuses_a_non_sequential_model():
    from distkeras_tpu_torch.models.layers import Dense, Residual, Sequential
    m = Model(Residual(Sequential([Dense(4)])), input_shape=(4,))
    with pytest.raises(ValueError, match="Sequential"):
        fold_batchnorm(m)


def test_num_params_equals_jax():
    for jm in (dk.zoo.resnet20(width=8), dk.zoo.gpt_lm(**LM)):
        pm = Model.from_config(jm.config()).init(0, device="cpu")
        v = to_numpy_variables(pm)
        want = jax_num_params(jax.eval_shape(lambda: jm.init(0)))
        assert num_params(pm) == num_params(v) == want


def test_zigzag_stripe_is_registered_and_round_trips():
    assert LAYER_REGISTRY["ZigzagStripe"] is ZigzagStripe
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    s, u = ZigzagStripe(2), ZigzagStripe(2, inverse=True)
    assert torch.equal(u(s(x)), x) and not torch.equal(s(x), x)
    assert s.config() == {"class": "ZigzagStripe",
                          "config": {"p_size": 2, "inverse": False}}


def test_zigzag_wrap_copies_the_attention_and_refuses_config():
    """The wrap's positions are JAX's; the flags land on shallow copies
    holding the original's parameters; a wrapped model refuses
    ``config()``; shapes the stripe cannot take are refused."""
    jm = dk.zoo.gpt_lm(**LM)
    pm = Model.from_config(jm.config()).init(0, device="cpu")
    mesh = types.SimpleNamespace(shape={"sp": 2})
    wrapped, pos = zigzag_wrap(pm, mesh)
    _, jpos = jax_zigzag_wrap(jm, jax_make_mesh(2, ("sp",)))
    assert pos == jpos
    for lyr in pm.iter_layers():
        if isinstance(lyr, MultiHeadAttention):
            assert lyr.mesh is None and not lyr.ring_pre_shuffled
    copies = [lyr for lyr in wrapped.iter_layers()
              if isinstance(lyr, MultiHeadAttention)]
    assert copies and all(c.mesh is mesh and c.ring_pre_shuffled
                          for c in copies)
    assert {id(p) for p in wrapped.parameters()} == \
        {id(p) for p in pm.parameters()}
    with pytest.raises(ValueError, match="cannot serialize"):
        wrapped.config()
    with pytest.raises(ValueError, match="divisible"):
        zigzag_wrap(pm, types.SimpleNamespace(shape={"sp": 3}))
    dense = Model.from_config(dk.zoo.mlp_mnist(hidden=8).config())
    with pytest.raises(ValueError, match="attention"):
        zigzag_wrap(dense, mesh)


@pytest.fixture(scope="module")
def lm():
    jm = dk.zoo.gpt_lm(**LM)
    v = jax.tree_util.tree_map(np.asarray, jm.init(0))
    rng = np.random.default_rng(4)
    x = rng.integers(0, LM["vocab_size"], (2, LM["seq_len"])).astype(
        np.int32)
    ct = rng.normal(size=(2, LM["seq_len"], LM["vocab_size"])).astype(
        np.float32)
    return jm, v, x, ct


@pytest.fixture(scope="module")
def ranks(lm):
    jm, v, x, ct = lm
    return run_ranks(4, [("zigzag", "zigzag_wrap",
                          dict(config=jm.config(), inits={0: v}, x=x, ct=ct,
                               mesh_shape=(2,), axis_names=("sp",)))])


def test_zigzag_wrap_equals_jax_on_sp2(lm, ranks):
    jm, v, x, ct = lm
    mesh = jax_make_mesh(2, ("sp",))
    m2, pos = jax_zigzag_wrap(jm, mesh)
    a, b = pos
    params = list(v["params"])
    state = list(v["state"])
    for i in (a, b):
        params.insert(i, {})
        state.insert(i, {})

    @jax.jit
    def run(p):
        def f(p):
            y, _ = m2.apply({"params": p, "state": state}, jnp.asarray(x))
            return jnp.sum(y * jnp.asarray(ct)), y
        return jax.grad(f, has_aux=True)(p)
    g, y = run(params)
    g = [leaf for i, leaf in enumerate(g) if i not in (a, b)]
    names = jax_leaf_names(Model.from_config(jm.config()))[0]
    want = dict(zip(names, jax.tree_util.tree_leaves(g)))
    for res in ranks:
        got = res["zigzag"]
        assert tuple(got["positions"]) == pos
        assert got["original_flags"] == [(True, False)] * LM["num_blocks"]
        assert _rel(got["logits"], np.asarray(y)) <= 1e-5
        assert _rel(got["ring_logits"], got["logits"]) <= 1e-5
        for name, w in want.items():
            assert _rel(got["grads"][name], np.asarray(w)) <= 1e-5, name
            assert _rel(got["ring_grads"][name], got["grads"][name]) <= 1e-5
