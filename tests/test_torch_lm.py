"""The port's layers, ``Model`` and ``gpt_lm`` against the JAX package on
the same weights (carried across with ``load_jax_variables``): layer by
layer, the full-sequence logits, the cached prefill and decode, the
config JSON and the weight round trip.  Both sides run f32 with
different summation orders, hence rtol = atol = 1e-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import layers as jl
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.model import Model as JaxModel
from distkeras_tpu.ops import attention as ja
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.ops.attention import apply_rope
from distkeras_tpu_torch.utils.weights import (load_jax_variables,
                                               to_numpy_variables)

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, DIM, SEQ = 32, 32, 32
#: gpt_lm variants: learned positions at two blocks; rope and
#: multi-query (one K/V head) at one block, which keeps the file cheap
VARIANTS = {
    "learned": {"num_blocks": 2},
    "rope": {"num_blocks": 1, "positional": "rope"},
    "mqa": {"num_blocks": 1, "num_kv_heads": 1},
}


def _np_vars(jax_model, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_model.init(seed))


def _port(jax_model, variables):
    """The port's model for ``jax_model``, built from its config JSON and
    loaded with its weights."""
    model = Model.from_config(json.loads(json.dumps(jax_model.config())))
    model.init(0, device="cpu")
    load_jax_variables(model, variables)
    return model


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def lm(request):
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_heads=4, seq_len=SEQ,
                     attention_impl="flash", **VARIANTS[request.param])
    v = _np_vars(jm)
    return jm, v, _port(jm, v)


def _tokens(b=2, t=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


LAYERS = {
    "dense_gelu": (lambda: jl.Dense(24, "gelu"), (5, 16), "float"),
    "gelu": (lambda: jl.Activation("gelu"), (5, 16), "float"),
    "layernorm": (lambda: ja.LayerNorm(), (5, 16), "float"),
    "embedding": (lambda: jl.Embedding(VOCAB, 16), (7,), "int"),
    "positional": (lambda: ja.PositionalEmbedding(8), (6, 16), "float"),
    "mha_dense": (lambda: ja.MultiHeadAttention(2, causal=True), (16, 32),
                  "float"),
    "mha_flash": (lambda: ja.MultiHeadAttention(2, causal=True,
                                                impl="flash"),
                  (16, 32), "float"),
    "mha_flash_bidirectional": (
        lambda: ja.MultiHeadAttention(4, impl="flash", num_kv_heads=2),
        (16, 32), "float"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make, in_shape, kind = LAYERS[name]
    jm = JaxModel(make(), input_shape=in_shape)
    v = _np_vars(jm, seed=3)
    tm = _port(jm, v)
    rng = np.random.default_rng(1)
    if kind == "int":
        x = rng.integers(0, VOCAB, (3, *in_shape)).astype(np.int32)
    else:
        x = rng.normal(size=(3, *in_shape)).astype(np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x))[0])
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = (rng.integers(0, 300, (2, 5)) if per_row
           else np.arange(5) + 40).astype(np.int32)
    ref = np.asarray(ja.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_full_sequence_logits(lm):
    jm, v, tm = lm
    x = _tokens()
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))[0])
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(out, ref, **TOL)


def _assert_tree_close(got, ref):
    """``got`` (the port's cache: dicts/lists of tensors, None leaves)
    against the JAX cache pytree."""
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = [t for t in _leaves(got)]
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_then_decode_matches_jax(lm, per_row):
    """``apply_prefill`` logits and K/V caches, then 8 cached
    ``apply_decode`` steps (uniform scalar positions, or per-row (B,)
    positions as a ragged batch decodes)."""
    jm, v, tm = lm
    b, prompt = 2, 12
    x = _tokens(b, SEQ, seed=4)
    x[:, prompt:] = 0
    params, state = v["params"], v["state"]
    jy, jcache = jax.jit(jm.layer.apply_prefill)(
        params, state, jnp.asarray(x), jm.layer.init_cache(b, jm.input_shape))
    decode = jax.jit(jm.layer.apply_decode)
    with torch.no_grad():
        ty, tcache = tm.layer.apply_prefill(
            torch.from_numpy(x).long(), tm.layer.init_cache(b, tm.input_shape))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _assert_tree_close(tcache, jcache)

    start = np.array([prompt, prompt - 5]) if per_row else np.array(prompt)
    toks = _tokens(8, b, seed=5)             # one (B,) column per step
    for i in range(8):
        pos = start + i
        jlog, jcache = decode(
            params, state, jnp.asarray(toks[i]), jcache,
            jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tlog, tcache = tm.layer.apply_decode(
                torch.from_numpy(toks[i]).long(), tcache,
                torch.from_numpy(pos) if per_row else int(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_tree_close(tcache, jcache)


def test_config_json_round_trip(lm):
    jm, _, tm = lm
    assert json.dumps(tm.config(), sort_keys=True) == \
        json.dumps(jm.config(), sort_keys=True)
    again = Model.from_config(tm.config())
    assert again.config() == jm.config()
    assert again.output_shape == tuple(jm.output_shape)


def test_weights_round_trip_is_bit_exact(lm):
    _, v, tm = lm
    back = to_numpy_variables(tm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_load_rejects_mismatched_trees():
    jm = jzoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_heads=4, num_blocks=1,
                     seq_len=SEQ)
    v = _np_vars(jm)
    tm = _port(jm, v)
    wider = _np_vars(jzoo.gpt_lm(vocab_size=VOCAB, dim=2 * DIM, num_heads=4,
                                 num_blocks=1, seq_len=SEQ))
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tm, wider)
    deeper = _np_vars(jzoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_heads=4,
                                  num_blocks=2, seq_len=SEQ))
    with pytest.raises(ValueError, match="entry params/state"):
        load_jax_variables(tm, deeper)


def test_unported_options_raise():
    # the switch-MoE FF block is ported; a mesh on it is item 8's
    moe_lm = zoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_heads=4,
                        num_blocks=1, seq_len=SEQ,
                        moe_experts=2).init(0, device="cpu")
    moe_layer = [lyr for lyr in moe_lm.iter_layers()
                 if type(lyr).__name__ == "MoEDense"][0]
    moe_layer.mesh = object()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        moe_lm(torch.zeros((1, SEQ), dtype=torch.long))
    model = zoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_heads=4, num_blocks=1,
                       seq_len=SEQ).init(0, device="cpu")
    mha = [lyr for lyr in model.iter_layers()
           if type(lyr).__name__ == "MultiHeadAttention"][0]
    mha.mesh = object()
    with pytest.raises(NotImplementedError, match="ring attention"):
        model(torch.zeros((1, SEQ), dtype=torch.long))


def test_init_is_seeded_and_needs_a_device():
    a = zoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_blocks=1, seq_len=SEQ)
    b = zoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_blocks=1, seq_len=SEQ)
    sa = a.init(7, device="cpu").state_dict()
    sb = b.init(7, device="cpu").state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.gpt_lm(vocab_size=VOCAB, dim=DIM, num_blocks=1,
                   seq_len=SEQ).init(0)
