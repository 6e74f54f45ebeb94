"""The port's checkpoints and resume against the JAX package's, on the CPU.

A checkpoint is the JAX package's file: a v1 serde blob of the trainer
state's leaves in ``jax.tree_util`` order.  The port's files must have
the JAX trainers' leaf count, order, shapes and dtypes (held by training
both from the same init, one epoch, and comparing every leaf but the rng
key within ``test_torch_dist.py``'s bound); 3 epochs straight must equal
1 epoch plus a resume to 3 bit for bit, on a model with ``Dropout`` (the
generators' states resume too); and a checkpoint either package wrote
must resume in the other, finishing within ``test_torch_train.py``'s
bounds of the other package's straight run (losses rtol 1e-4, parameters
atol 1e-5).
"""

import logging
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.transformers import OneHotTransformer as JaxOneHot
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Dropout as JaxDropout
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.utils import checkpoint as jax_ckpt
from distkeras_tpu.utils import serde as jax_serde

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.utils import checkpoint
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

W = 4
COMMON = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", batch_size=32, learning_rate=0.05)
DIST = dict(communication_window=2)


def _toy(n=512, d=10, k=3, seed=0):
    """``tests/test_trainers_sync.py:toy_problem`` at n rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(n, k)), axis=-1)
    return x, y


@pytest.fixture(scope="module")
def data():
    x, y = _toy()
    jds = JaxOneHot(3, "label", "label_onehot").transform(
        dk.Dataset({"features": x, "label": y}))
    pds = OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))
    return jds, pds


def _jax_mlp(dropout=False):
    mid = [JaxDropout(0.5)] if dropout else []
    return dk.Model(JaxSequential([JaxDense(16, "relu"), *mid,
                                   JaxDense(3, "softmax")]),
                    input_shape=(10,))


def _port_twin(jm):
    """The port's model of ``jm``'s config, whose ``init(seed)`` loads
    ``jm.init(seed)`` (the two packages' generators differ)."""
    model = Model.from_config(jm.config())
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jm.init(seed)))
        return model
    model.init = init
    return model


def _trainer(pkg, name, model, **kw):
    if name == "SingleTrainer":
        extra = {}
    elif name == "EnsembleTrainer":
        extra = dict(num_ensembles=W, **DIST)
    else:
        extra = dict(num_workers=W, **DIST)
    if pkg is dkt:
        extra["device"] = "cpu"
    return getattr(pkg, name)(model, **{**COMMON, **extra, **kw})


def _payload(directory):
    mgr = checkpoint.CheckpointManager(directory)
    with open(mgr.path(mgr.latest_step()), "rb") as f:
        return jax_serde.tree_from_bytes(f.read())


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _final_leaves(t, res=None):
    """Every trained leaf: the members' for an ensemble (``res``, the
    list ``train`` returned), else the center's."""
    trees = [t.trained_variables] if not isinstance(res, list) else \
        [dkt.utils.to_numpy_variables(m) if isinstance(m, torch.nn.Module)
         else m.variables for m in res]
    return [np.asarray(a) for tree in trees
            for a in jax.tree_util.tree_leaves(tree)]


# -- the file and the manager -----------------------------------------------------

def test_save_load_round_trip_rolling_keep_and_mismatch(tmp_path):
    tree = {"b": [torch.arange(6.0).reshape(2, 3), None],
            "a": (np.int32(3), np.arange(4, dtype=np.int64)),
            "c": torch.ones(2, dtype=torch.bfloat16)}
    path = str(tmp_path / "x.ckpt")
    checkpoint.save_tree(path, tree, {"epoch": 2})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # the JAX package reads the same leaves in the same order
    jleaves = jax_serde.tree_from_bytes(open(path, "rb").read())["leaves"]
    assert [np.asarray(x).tolist() for x in jleaves[:2]] == [3, [0, 1, 2, 3]]
    like = {"b": [torch.zeros(2, 3, dtype=torch.float64), None],
            "a": (0, np.zeros(4, np.int64)),
            "c": torch.zeros(2, dtype=torch.bfloat16)}
    got, meta = checkpoint.load_tree(path, like)
    assert meta == {"epoch": 2} and list(got) == ["b", "a", "c"]
    assert got["b"][0].dtype == torch.float64 and got["b"][1] is None
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert got["a"][0] == 3 and type(got["a"][0]) is int
    assert got["c"].dtype == torch.bfloat16 and got["c"].tolist() == [1, 1]
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_tree(path, {"a": like["a"]})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_tree(path, {**like, "c": torch.zeros(3)})

    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"), keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(like)
    for step in range(5):
        mgr.save(step, {"x": np.full(2, step, np.float32)}, {"epoch": step})
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    tree3, meta3 = mgr.restore({"x": np.zeros(2, np.float32)}, step=3)
    assert meta3 == {"epoch": 3, "step": 3} and tree3["x"].tolist() == [3, 3]
    # the JAX manager reads the port's directory, and the reverse
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "run"), keep=2)
    assert jmgr.restore({"x": 0})[1]["epoch"] == 4
    jmgr.save(5, {"x": np.full(2, 5, np.float32)}, {"epoch": 5})
    assert mgr.restore({"x": np.zeros(2, np.float32)})[0]["x"].tolist() == \
        [5, 5]


def test_rng_key_and_optimizer_leaves_follow_optax():
    assert checkpoint.rng_key(1).tolist() == \
        np.asarray(jax.random.PRNGKey(1)).tolist()
    key = checkpoint.rng_key(7, 3)
    assert key.dtype == np.uint32 and key.shape == (3, 2)
    assert key.tolist() == [[0, 7], [1, 7], [2, 7]]
    from distkeras_tpu.ops.optimizers import get_optimizer as jax_opt
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    model = Model.from_config(_jax_mlp().config()).init(0, device="cpu")
    names = dkt.utils.weights.jax_leaf_names(model)
    params = dict(model.named_parameters())
    jparams = dkt.utils.to_numpy_variables(model)["params"]
    for opt in ("sgd", "momentum", "nesterov", "adagrad", "adadelta",
                "rmsprop", "adam"):
        state = get_optimizer(opt, 0.1).init(params)
        if opt == "adam":
            state["count"] = 5
        leaves = checkpoint.opt_state_leaves(state, names[0])
        want = jax.tree_util.tree_leaves(jax_opt(opt, 0.1).init(jparams))
        if opt == "adam":
            want[0] = np.int32(5)
        assert [(np.shape(_np(a)), _np(a).dtype) for a in leaves] == \
            [(np.shape(b), np.asarray(b).dtype) for b in want], opt
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        back = checkpoint.opt_state_from_leaves(state, leaves, names[0])
        assert list(back) == list(state)
        stacked = checkpoint.stacked_opt_state_leaves([state, state],
                                                      names[0])
        vmapped = jax.tree_util.tree_leaves(
            jax.vmap(jax_opt(opt, 0.1).init)(jax.tree_util.tree_map(
                lambda a: np.stack([a, a]), jparams)))
        assert [tuple(np.shape(_np(a))) for a in stacked] == \
            [tuple(np.shape(b)) for b in vmapped], opt
        assert len(checkpoint.unstacked_opt_states(
            [state, state], stacked, names[0])) == 2


# -- the trainers' files against the JAX trainers' --------------------------------------

@pytest.mark.parametrize("name,opt", [
    ("SingleTrainer", "sgd"), ("SingleTrainer", "momentum"),
    ("SingleTrainer", "adam"), ("ADAG", "adam"), ("EnsembleTrainer", "sgd")])
def test_checkpoint_has_the_jax_trainers_leaves(name, opt, data, tmp_path):
    jm = _jax_mlp()
    jt = _trainer(dk, name, jm, worker_optimizer=opt, num_epoch=1,
                  checkpoint_dir=str(tmp_path / "jax"))
    jt.train(data[0])
    pt = _trainer(dkt, name, _port_twin(jm), worker_optimizer=opt,
                  num_epoch=1, checkpoint_dir=str(tmp_path / "port"))
    pt.train(data[1])
    want, got = _payload(tmp_path / "jax"), _payload(tmp_path / "port")
    assert got["meta"]["epoch"] == want["meta"]["epoch"] == 0
    assert got["meta"]["step"] == 0 and checkpoint.GENERATORS in got["meta"]
    a, b = got["leaves"], want["leaves"]
    assert [(x.shape, x.dtype) for x in a] == [(x.shape, x.dtype) for x in b]
    # the same values in the same places: both trained from one init
    for x, y in zip(a[:-1], b[:-1]):
        np.testing.assert_allclose(x, y, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(y).max()))
    rng = a[-1]
    assert rng.dtype == np.uint32
    assert rng.tolist() == checkpoint.rng_key(
        1, None if name == "SingleTrainer" else W).tolist()


# -- resume ------------------------------------------------------------------------------------

@pytest.mark.parametrize("name,opt", [("SingleTrainer", "adam"),
                                      ("ADAG", "momentum"),
                                      ("EnsembleTrainer", "adam")])
def test_resume_is_bit_identical_to_a_straight_run(name, opt, data,
                                                   tmp_path):
    """With Dropout: the generators' states resume with the weights."""
    jm = _jax_mlp(dropout=True)
    straight = _trainer(dkt, name, Model.from_config(jm.config()),
                        worker_optimizer=opt, num_epoch=3)
    res = straight.train(data[1])
    ckpt = str(tmp_path / "ckpt")
    first = _trainer(dkt, name, Model.from_config(jm.config()),
                     worker_optimizer=opt, num_epoch=1, checkpoint_dir=ckpt,
                     checkpoint_keep=1)
    first.train(data[1])
    blind_dir = str(tmp_path / "blind")
    shutil.copytree(ckpt, blind_dir)
    resumed = _trainer(dkt, name, Model.from_config(jm.config()),
                       worker_optimizer=opt, num_epoch=3, checkpoint_dir=ckpt,
                       checkpoint_keep=1, seed=5)   # the seed is restored
    res2 = resumed.train(data[1], resume=True)
    assert len(resumed.get_history()) == 2
    for a, b in zip(resumed.get_history(), straight.get_history()[1:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_final_leaves(resumed, res2),
                    _final_leaves(straight, res)):
        np.testing.assert_array_equal(a, b)
    assert checkpoint.CheckpointManager(ckpt).steps() == [2]
    # control: epoch 0's file without the generators' states (as the JAX
    # package writes it) resumes with fresh generators, whose dropout
    # draws differ from the straight run's second epoch
    payload = _payload(blind_dir)
    meta = payload["meta"]
    meta.pop(checkpoint.GENERATORS)
    checkpoint.save_tree(os.path.join(blind_dir, "step-0.ckpt"),
                         payload["leaves"], meta)
    blind = _trainer(dkt, name, Model.from_config(jm.config()),
                     worker_optimizer=opt, num_epoch=2,
                     checkpoint_dir=blind_dir)
    blind.train(data[1], resume=True)
    assert not np.array_equal(blind.get_history()[0],
                              straight.get_history()[1])


def test_resume_without_checkpoints_trains_from_the_start(data, tmp_path):
    t = _trainer(dkt, "SingleTrainer", Model.from_config(
        _jax_mlp().config()), num_epoch=2,
        checkpoint_dir=str(tmp_path / "empty"))
    t.train(data[1], resume=True)
    assert len(t.get_history()) == 2
    before = _final_leaves(t)
    # every epoch saved: a resume has nothing left to train
    t.train(data[1], resume=True)
    assert len(t.get_history()) == 2
    for a, b in zip(_final_leaves(t), before):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["SingleTrainer", "ADAG"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_resumes_in_the_other_package(name, writer, data,
                                                   tmp_path, caplog):
    jm = _jax_mlp()
    ckpt = str(tmp_path / "ckpt")
    opt = "adam"
    reader_pkg = dkt if writer == "jax" else dk
    writer_pkg = dk if writer == "jax" else dkt

    def make(pkg, epochs, **kw):
        model = jm if pkg is dk else _port_twin(jm)
        return _trainer(pkg, name, model, worker_optimizer=opt,
                        num_epoch=epochs, **kw)

    ref = make(reader_pkg, 3)
    ref.train(data[0] if reader_pkg is dk else data[1])
    make(writer_pkg, 1, checkpoint_dir=ckpt).train(
        data[0] if writer_pkg is dk else data[1])
    t = make(reader_pkg, 3, checkpoint_dir=ckpt)
    with caplog.at_level(logging.INFO, logger="distkeras_tpu_torch"):
        t.train(data[0] if reader_pkg is dk else data[1], resume=True)
    if writer == "jax":
        assert "holds no generator states" in caplog.text
    assert len(t.get_history()) == 2
    for a, b in zip(t.get_history(), ref.get_history()[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    for a, b in zip(_final_leaves(t), _final_leaves(ref)):
        np.testing.assert_allclose(a, b, atol=1e-5)
