"""The port's msgpack codec and serde against ``msgpack`` and the JAX
package's ``utils.serde``, on the CPU.

``utils._msgpack.packb`` must write what ``msgpack.packb(...,
use_bin_type=True)`` writes, byte for byte, and ``unpackb`` read what it
writes; ``utils.serde``'s v1 blobs and v2 frames must equal the JAX
package's byte for byte, and each package must decode the other's bit
for bit (bfloat16 compared by its uint16 bits).  Model blobs of a zoo
MLP, ConvNet and flash ``gpt_lm`` cross both ways with the same config
JSON, the same parameter bits and forwards within the zoo's parity bound
(1e-5 of the reference's largest |value|, ``tests/test_torch_zoo.py``).
"""

import json
import math
import os
import string

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.utils import serde as jax_serde

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data import load_mnist
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.utils import _msgpack, serde
from distkeras_tpu_torch.utils.weights import (load_jax_variables,
                                               to_numpy_variables)

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

BF16 = jnp.bfloat16.dtype


def _ref_packb(obj, default=None):
    return msgpack.packb(obj, default=default, use_bin_type=True)


def _ref_unpackb(data, object_hook=None):
    return msgpack.unpackb(data, object_hook=object_hook, raw=False,
                           strict_map_key=False)


# -- the codec ------------------------------------------------------------------

_INT_EDGES = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
              0x100000000, 0xFFFFFFFFFFFFFFFF, -1, -0x20, -0x21, -0x80,
              -0x81, -0x8000, -0x8001, -0x80000000, -0x80000001,
              -0x8000000000000000]
_LENGTHS = [0, 31, 32, 255, 256, 65535, 65536]
_COUNTS = [0, 15, 16, 65535, 65536]
BOUNDARY_CASES = {
    "nil_bool": [None, True, False],
    "ints": _INT_EDGES,
    "floats": [0.0, -0.0, 1.5, float("nan"), float("inf"), float("-inf"),
               5e-324, 1.7976931348623157e308, np.float64(2.5)],
    "str": ["x" * n for n in _LENGTHS] + ["héllo ✓", "\x00"],
    "bin": [b"y" * n for n in _LENGTHS] + [bytearray(b"ab"),
                                           memoryview(b"abc")],
    "array": [list(range(n)) for n in _COUNTS] + [(1, "a", None)],
    "map": [{str(i): i for i in range(n)} for n in _COUNTS]
    + [{1: "int key", "s": [1.5, {"nested": b"z"}]}],
}


@pytest.mark.parametrize("kind", sorted(BOUNDARY_CASES))
def test_codec_boundaries_match_msgpack(kind):
    for obj in BOUNDARY_CASES[kind]:
        want = _ref_packb(obj)
        assert _msgpack.packb(obj) == want, (kind, repr(obj)[:40])
        got, ref = _msgpack.unpackb(want), _ref_unpackb(want)
        assert repr(got) == repr(ref), (kind, repr(obj)[:40])


_leaf = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(max_size=40), st.binary(max_size=300))
_trees = st.recursive(
    _leaf, lambda kids: st.one_of(
        st.lists(kids, max_size=20),
        st.dictionaries(st.one_of(st.text(string.ascii_letters, max_size=8),
                                  st.integers(-5, 5)), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_trees)
def test_codec_matches_msgpack_on_random_trees(tree):
    want = _ref_packb(tree)
    assert _msgpack.packb(tree) == want
    assert repr(_msgpack.unpackb(want)) == repr(_ref_unpackb(want))


def test_codec_default_hook_and_its_limits():
    class Point:
        def __init__(self, x):
            self.x = x

    def default(o):
        if isinstance(o, Point):
            return {"pt": o.x}
        if isinstance(o, int):  # an int past 64 bits
            return str(o)
        raise TypeError(type(o))

    obj = [Point(3), {"k": Point(b"b")}, 2 ** 70, -(2 ** 70)]
    assert _msgpack.packb(obj, default) == _ref_packb(obj, default)
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)
    with pytest.raises(TypeError):
        _msgpack.packb(object())
    with pytest.raises(TypeError):  # default's result is still unknown
        _msgpack.packb(object(), default=lambda o: o)


def test_unpackb_reads_float32_and_calls_the_hook_on_every_map():
    data = msgpack.packb({"a": [1.5, 0.1], "b": {"c": -2.0}},
                         use_single_float=True, use_bin_type=True)
    assert data.count(b"\xca") == 3
    got = _msgpack.unpackb(data)
    assert got == _ref_unpackb(data)
    assert got["a"][1] == float(np.float32(0.1))
    seen = []
    _msgpack.unpackb(data, object_hook=lambda d: seen.append(d) or d)
    assert [sorted(d) for d in seen] == [["c"], ["a", "b"]]


@pytest.mark.parametrize("data,match", [
    (b"", "truncated"), (b"\x92\x01", "truncated"),
    (b"\xda\x00\x05ab", "truncated"), (b"\xc5\x01", "truncated"),
    (b"\xcb\x00\x00", "truncated"), (b"\x01\x02", "bytes after"),
    (_ref_packb({"a": 1}) + b"\xc0", "bytes after"),
    (b"\xd4\x01\x00", "ext type"), (b"\xc7\x01\x05\x00", "ext type"),
    (b"\xc1", "invalid")])
def test_unpackb_refuses_truncated_trailing_and_ext_input(data, match):
    with pytest.raises(ValueError, match=match):
        _msgpack.unpackb(data)


# -- serde: v1 blobs and v2 frames --------------------------------------------------

_DTYPES = ["<f4", "<f8", "<f2", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2",
           "<u4", "<u8", "|b1"]


def _mixed_tree(seed=0):
    """A tree of every dtype serde carries, 0-d and empty leaves
    included (bfloat16 as ``ml_dtypes``' numpy type)."""
    rng = np.random.default_rng(seed)
    leaves = {}
    for i, dt in enumerate(_DTYPES):
        dt = np.dtype(dt)
        shape = [(3, 2), (), (0, 4), (5,)][i % 4]
        if dt.kind == "b":
            a = rng.integers(0, 2, size=shape).astype(dt)
        elif dt.kind in "iu":
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, size=shape, dtype=dt,
                             endpoint=True)
        else:
            a = rng.normal(size=shape).astype(dt)
        leaves[f"x{i}_{dt.str}"] = a
    bf = rng.normal(size=(4, 3)).astype(np.float32).astype(BF16)
    return {"leaves": leaves, "bf16": bf, "bf16_0d": np.asarray(1.5, BF16),
            "bf16_empty": np.zeros((0,), BF16),
            "meta": {"epoch": 3, "lr": 0.1, "name": "m", "tags": (1, "a"),
                     "np_int": np.int64(7), "np_float": np.float32(0.25)},
            "list": [np.arange(3, dtype=np.int32), None, True]}


def _bits(x):
    """A decoded leaf's bits: bfloat16 (torch or ml_dtypes) as uint16."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == BF16 else x


def _assert_same_tree(got, ref):
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for k in ref:
            _assert_same_tree(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_same_tree(a, b)
    elif isinstance(ref, (np.ndarray, jax.Array)) or torch.is_tensor(ref):
        a, b = _bits(got), _bits(ref)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(got) is type(ref) and repr(got) == repr(ref)


def _as_torch(tree):
    """``tree`` with every array leaf a CPU torch tensor (bfloat16 by its
    bits; uint16–64 stay numpy: torch has no such tensors to hand)."""
    def conv(x):
        if isinstance(x, np.ndarray):
            if x.dtype == BF16:
                return torch.from_numpy(x.view(np.int16).copy()).view(
                    torch.bfloat16)
            if x.dtype.kind != "u" or x.dtype.itemsize == 1:
                return torch.from_numpy(x.copy())
        return x
    def walk(t):   # keeps dict order (jax.tree_util would sort it)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return conv(t)
    return walk(tree)


def test_tree_to_bytes_equals_jax_and_decodes_both_ways():
    tree = _mixed_tree()
    blob = jax_serde.tree_to_bytes(tree)
    assert serde.tree_to_bytes(tree) == blob
    # torch leaves write the same bytes as numpy leaves
    assert serde.tree_to_bytes(_as_torch(tree)) == blob
    mine, ref = serde.tree_from_bytes(blob), jax_serde.tree_from_bytes(blob)
    _assert_same_tree(mine, ref)
    assert isinstance(mine["bf16"], torch.Tensor) and \
        mine["bf16"].dtype == torch.bfloat16
    assert isinstance(mine["leaves"]["x0_<f4"], np.ndarray)
    # the JAX package decodes the port's blob bit for bit
    _assert_same_tree(jax_serde.tree_from_bytes(serde.tree_to_bytes(mine)),
                      ref)


def test_non_contiguous_leaves_and_a_strided_tensor():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]
    t = torch.arange(24.0).reshape(4, 6).t()
    tree = {"a": a, "t": t.numpy()}
    assert serde.tree_to_bytes({"a": a, "t": t}) == \
        jax_serde.tree_to_bytes(tree)
    h1, s1 = serde.tree_to_frames({"a": a, "t": t})
    h2, s2 = jax_serde.tree_to_frames(tree)
    assert h1 == h2
    assert [bytes(memoryview(x)) for x in s1] == \
        [bytes(memoryview(x)) for x in s2]


def test_tree_to_frames_equals_jax_and_decodes_both_ways():
    tree = _mixed_tree(1)
    header, segs = serde.tree_to_frames(tree)
    jheader, jsegs = jax_serde.tree_to_frames(tree)
    assert header == jheader and len(segs) == len(jsegs)
    for a, b in zip(segs, jsegs):
        assert bytes(memoryview(a)) == bytes(memoryview(b))
    # segments are views of the leaves' own memory, not copies
    assert np.shares_memory(segs[0], tree["leaves"]["x0_<f4"])
    th, ts = serde.tree_to_frames(_as_torch(tree))
    assert th == jheader
    # decode from bytearrays, as off a socket
    raw = [bytearray(memoryview(s)) for s in jsegs]
    mine = serde.tree_from_frames(jheader, raw)
    ref = jax_serde.tree_from_frames(jheader, jsegs)
    _assert_same_tree(mine, ref)
    leaf = mine["leaves"]["x0_<f4"]
    assert np.shares_memory(leaf, np.frombuffer(raw[0], np.uint8))
    # the JAX package decodes the port's frames of its decoded tree
    ph, ps = serde.tree_to_frames(mine)
    _assert_same_tree(jax_serde.tree_from_frames(ph, ps), ref)


# -- model blobs ----------------------------------------------------------------------

BLOB_MODELS = {
    "mlp_mnist": (lambda z: z.mlp_mnist(hidden=32), "float"),
    "convnet_cifar10": (lambda z: z.convnet_cifar10(), "float"),
    "gpt_lm": (lambda z: z.gpt_lm(vocab_size=17, dim=32, num_heads=2,
                                  num_blocks=2, seq_len=32,
                                  attention_impl="flash"), "tokens"),
}


def _inputs(model, kind, n=2):
    rng = np.random.default_rng(0)
    if kind == "tokens":
        return rng.integers(0, 17, size=(n, *model.input_shape)).astype(
            np.int32)
    return rng.uniform(0, 1, size=(n, *model.input_shape)).astype(
        np.float32)


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) <= \
        rel * float(np.max(np.abs(ref)))


@pytest.mark.parametrize("name", sorted(BLOB_MODELS))
def test_model_blobs_cross_both_ways(name):
    make, kind = BLOB_MODELS[name]
    jm = make(jax_zoo)
    # the port's init as the shared weights (a JAX conv init costs seconds)
    src = make(zoo).init(0, device="cpu")
    variables = to_numpy_variables(src)
    x = _inputs(jm, kind)

    # JAX blob -> port
    blob = jax_serde.serialize_model(jm, variables)
    model, got = serde.deserialize_model(blob)
    assert json.dumps(model.config()) == json.dumps(jm.config())
    _assert_same_tree(got, variables)
    model.init(0, device="cpu")
    load_jax_variables(model, got)
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    y_ref = np.asarray(jax.jit(jm.predict_fn())(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    _close(y, y_ref)
    # the port re-serializes the same blob
    assert serde.serialize_model(model, to_numpy_variables(model)) == blob

    # port blob -> JAX
    jmodel, jvars = jax_serde.deserialize_model(
        serde.serialize_model(src, variables))
    assert json.dumps(jmodel.config()) == json.dumps(jm.config())
    _assert_same_tree(jvars, variables)
    y_j = np.asarray(jax.jit(jmodel.predict_fn())(
        jax.tree_util.tree_map(jnp.asarray, jvars), jnp.asarray(x)))
    _close(y_j, y)


def test_trainer_serialize_equals_the_jax_blob_of_its_variables():
    ds = load_mnist(n_train=256)[0]
    from distkeras_tpu_torch.data.transformers import OneHotTransformer
    ds = OneHotTransformer(10, "label", "label_onehot").transform(ds)
    t = dkt.SingleTrainer(zoo.mlp_mnist(hidden=16), "adam",
                          label_col="label_onehot", batch_size=64,
                          device="cpu")
    t.train(ds)
    blob = t.serialize()
    # the JAX trainer's trees are jax.tree_util's: dict keys sorted
    jv = jax.tree_util.tree_map(np.asarray, t.trained_variables)
    assert blob == jax_serde.serialize_model(jax_zoo.mlp_mnist(hidden=16),
                                             jv)
    model, v = serde.deserialize_model(blob)
    _assert_same_tree(v, jv)


def test_bf16_variables_load_into_a_port_model():
    src = zoo.mlp_mnist(hidden=8).init(0, device="cpu")
    v = to_numpy_variables(src)
    v16 = jax.tree_util.tree_map(lambda a: a.astype(BF16), v)
    model, got = serde.deserialize_model(jax_serde.serialize_model(
        jax_zoo.mlp_mnist(hidden=8), v16))
    model.init(1, device="cpu")
    load_jax_variables(model, got)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy_variables(model)),
                    jax.tree_util.tree_leaves(v16)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_a_keras_config_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        serde.model_from_config({"keras_json": "{}"})
    assert isinstance(serde.model_from_config(
        zoo.mlp_mnist(hidden=4).config()), Model)
    assert math.isnan(serde.tree_from_bytes(
        serde.tree_to_bytes(float("nan"))))
