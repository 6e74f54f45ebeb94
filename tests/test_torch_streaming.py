"""The port's disk streaming against the JAX package's, on the CPU:
``ShardedFileDataset`` (shard directories either package wrote, the same
batches for the same seed), the worker partition, ``window_batches``,
the prefetch thread's teardown, the trainers streaming from disk
(against their in-memory runs, bit for bit, and against the JAX
package's ``SingleTrainer`` within ``test_torch_train.py``'s bounds:
losses rtol 1e-4, parameters atol 1e-5), streaming resume and
``StreamingPredictor`` against ``ModelPredictor``.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data import streaming as jax_streaming
from distkeras_tpu.data.transformers import OneHotTransformer as JaxOneHot
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data import streaming
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.obs import default_registry
from distkeras_tpu_torch.predictors import ModelPredictor, StreamingPredictor
from distkeras_tpu_torch.utils.weights import load_jax_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

W = 4
ROWS = 512
COMMON = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", batch_size=16, learning_rate=0.05,
              device="cpu")


def _toy(n=ROWS, d=10, k=3, seed=0):
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


@pytest.fixture(scope="module")
def shards(data, tmp_path_factory):
    """The same rows spilled by each package: 100 rows a shard (a ragged
    last shard), and ROWS / W rows a shard (the workers' partition)."""
    root = tmp_path_factory.mktemp("shards")
    out = {}
    for rows in (100, ROWS // W):
        out[("jax", rows)] = jax_streaming.ShardedFileDataset.write(
            data[0], str(root / f"jax{rows}"), rows_per_shard=rows)
        out[("port", rows)] = streaming.ShardedFileDataset.write(
            data[1], str(root / f"port{rows}"), rows_per_shard=rows)
    return out


def _jax_mlp():
    return dk.Model(JaxSequential([JaxDense(16, "relu"),
                                   JaxDense(3, "softmax")]),
                    input_shape=(10,))


def _port_twin(jm):
    model = Model.from_config(jm.config())
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jm.init(seed)))
        return model
    model.init = init
    return model


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


# -- the dataset -------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 3])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_shards(shards, writer, seed):
    directory = shards[(writer, 100)].directory
    mine = streaming.ShardedFileDataset(directory)
    ref = jax_streaming.ShardedFileDataset(directory)
    assert mine.shards == ref.shards and mine.num_rows == ref.num_rows
    assert mine.column_names == ref.column_names
    assert sorted(os.listdir(directory)) == sorted(
        os.listdir(shards[("jax" if writer == "port" else "port",
                           100)].directory))
    cols = ["features", "label_onehot"]
    _same_batches(mine.batches(cols, 32, seed=seed),
                  ref.batches(cols, 32, engine="thread", seed=seed))
    _same_batches(mine.worker_batches(cols, 16, 1, 3, seed=seed),
                  ref.worker_batches(cols, 16, 1, 3, seed=seed))
    _same_batches(mine.worker_batches(cols, 16, 2, 3, engine="raw",
                                      seed=seed),
                  ref.worker_batches(cols, 16, 2, 3, engine="raw",
                                     seed=seed))


def test_shard_rows_probe_and_the_worker_partition(shards, tmp_path):
    src = shards[("port", 100)]
    # another writer's directory: meta without shard_rows
    for name in src.shards:
        os.link(os.path.join(src.directory, name), tmp_path / name)
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"shards": src.shards, "num_rows": src.num_rows,
                   "columns": src.column_names}, f)
    probed = streaming.ShardedFileDataset(str(tmp_path))
    assert probed.shard_rows() == src.shard_rows() == [100] * 5 + [12]
    ref = jax_streaming.ShardedFileDataset(str(tmp_path))
    for p in (1, 2, 3, 6):
        for k in range(p):
            assert probed.worker_shard_indices(k, p) == \
                ref.worker_shard_indices(k, p)
            assert probed.worker_rows(k, p) == ref.worker_rows(k, p)
        assert probed.worker_steps_per_epoch(16, p) == \
            ref.worker_steps_per_epoch(16, p)
    assert probed.steps_per_epoch(16) == ROWS // 16
    with pytest.raises(ValueError, match="outside"):
        probed.worker_shard_indices(3, 3)
    with pytest.raises(ValueError, match="cannot feed 7 workers"):
        probed.worker_shard_indices(0, 7)
    with pytest.raises(ValueError, match="engine must be"):
        probed.worker_batches(["features"], 16, 0, 2, engine="x")
    with pytest.raises(ValueError, match="TensorFlow"):
        probed.batches(["features"], 16, engine="tfdata")


def test_window_batches_and_the_worker_windows(shards):
    src = shards[("port", ROWS // W)]
    ref = jax_streaming.ShardedFileDataset(src.directory)
    cols = ["features", "label"]
    _same_batches(streaming.window_batches(src.batches(cols, 16), 3),
                  jax_streaming.window_batches(
                      ref.batches(cols, 16, engine="thread"), 3))
    assert streaming.worker_windows_per_epoch(src, 16, W, 2) == \
        jax_streaming.worker_windows_per_epoch(ref, 16, W, 2) == 4
    with pytest.raises(ValueError, match="exceeds the 8 steps"):
        streaming.worker_windows_per_epoch(src, 16, W, 9)
    for shuffle in (False, True):
        mine = streaming.worker_window_factory(src, cols, 16, 2, W, 2, 7,
                                               shuffle)
        theirs = jax_streaming.worker_window_factory(ref, cols, 16, 2, W, 2,
                                                     7, shuffle)
        _same_batches(mine(1), theirs(1))


def test_an_abandoned_prefetch_thread_exits_within_its_join(shards):
    src = shards[("port", 100)]
    reg = default_registry()
    leaks = reg.counter("stream.producer_leaks").value
    batches = reg.counter("stream.batches").value
    depths = reg.histogram("stream.prefetch_depth",
                           streaming.DEPTH_BUCKETS).snapshot()["count"]
    before = set(threading.enumerate())
    it = src.batches(["features"], 8, prefetch=1)
    next(it)
    next(it)
    producers = set(threading.enumerate()) - before
    assert len(producers) == 1
    it.close()   # the producer is blocked on a full queue
    assert not any(t.is_alive() for t in producers)
    assert reg.counter("stream.producer_leaks").value == leaks
    assert reg.counter("stream.batches").value == batches + 2
    # every hand-over's depth is kept: 2 batches and no end-of-stream
    assert reg.histogram("stream.prefetch_depth").snapshot()["count"] \
        == depths + 2
    # a window generator closes the source it groups
    before = set(threading.enumerate())
    it = streaming.window_batches(src.batches(["features"], 8), 2)
    next(it)
    producers = set(threading.enumerate()) - before
    it.close()
    assert producers and not any(t.is_alive() for t in producers)
    assert reg.gauge("stream.prefetch_occupancy").value >= 0
    assert reg.counter("stream.stall_seconds").value >= 0


def test_a_producer_error_reaches_the_consumer():
    def broken():
        yield (np.zeros(1),)
        raise OSError("shard unreadable")

    it = streaming._prefetched(broken(), 2)
    next(it)
    with pytest.raises(OSError, match="shard unreadable"):
        next(it)


# -- the trainers from disk -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SingleTrainer", "ADAG", "EnsembleTrainer"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_streaming_equals_the_in_memory_run(name, shuffle, data, shards):
    """Unshuffled, the stream reads the in-memory order, so the runs are
    the same ops on the same batches; shuffled, the stream reads its own
    per-epoch order and is held to the stream resumed from a checkpoint
    (the next test) instead, here only to a falling loss."""
    jm = _jax_mlp()
    kw = dict(num_epoch=2, **COMMON)
    if name == "EnsembleTrainer":
        kw.update(num_ensembles=W, communication_window=2)
    elif name == "ADAG":
        kw.update(num_workers=W, communication_window=2)
    src = shards[("port", ROWS // W)]
    disk = getattr(dkt, name)(_port_twin(jm), **kw)
    res = disk.train(src, shuffle=shuffle)
    hist = disk.get_averaged_history()
    assert hist[-1] < hist[0]
    if shuffle:
        return
    ram = getattr(dkt, name)(_port_twin(jm), **kw)
    res_ram = ram.train(data[1])
    for a, b in zip(disk.get_history(), ram.get_history()):
        np.testing.assert_array_equal(a, b)
    if name == "EnsembleTrainer":
        pairs = zip(res, res_ram)
        for m, n in pairs:
            for a, b in zip(m.parameters(), n.parameters()):
                np.testing.assert_array_equal(a.detach(), b.detach())
    for a, b in zip(jax.tree_util.tree_leaves(disk.trained_variables),
                    jax.tree_util.tree_leaves(ram.trained_variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
def test_single_trainer_stream_matches_jax(shuffle, shards, monkeypatch):
    # the JAX trainer's "auto" engine on its thread engine (the port's
    # only one), not tf.data
    monkeypatch.setattr(jax_streaming, "_has_tf", lambda: False)
    jm = _jax_mlp()
    directory = shards[("jax", 100)].directory
    kw = dict(COMMON, num_epoch=2)
    kw.pop("device")
    jt = dk.SingleTrainer(jm, **kw)
    jt.train(jax_streaming.ShardedFileDataset(directory), shuffle=shuffle)
    pt = dkt.SingleTrainer(_port_twin(jm), device="cpu", **kw)
    pt.train(streaming.ShardedFileDataset(directory), shuffle=shuffle)
    assert len(pt.get_history()) == 2
    for a, b in zip(pt.get_history(), jt.get_history()):
        assert a.shape == b.shape == (32,)
        np.testing.assert_allclose(a, b, rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(pt.trained_variables),
                    jax.tree_util.tree_leaves(jt.trained_variables)):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("name", ["SingleTrainer", "ADAG"])
def test_streaming_resume_is_bit_identical(name, shards, tmp_path):
    jm = _jax_mlp()
    kw = dict(COMMON, worker_optimizer="adam")
    if name == "ADAG":
        kw.update(num_workers=W, communication_window=2)
    src = shards[("port", ROWS // W)]
    straight = getattr(dkt, name)(_port_twin(jm), num_epoch=3, **kw)
    straight.train(src, shuffle=True)
    ckpt = str(tmp_path / "ckpt")
    getattr(dkt, name)(_port_twin(jm), num_epoch=1, checkpoint_dir=ckpt,
                       **kw).train(src, shuffle=True)
    resumed = getattr(dkt, name)(_port_twin(jm), num_epoch=3,
                                 checkpoint_dir=ckpt, **kw)
    resumed.train(src, shuffle=True, resume=True)
    for a, b in zip(resumed.get_history(), straight.get_history()[1:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(resumed.trained_variables),
                    jax.tree_util.tree_leaves(straight.trained_variables)):
        np.testing.assert_array_equal(a, b)


# -- StreamingPredictor -----------------------------------------------------------------------

def test_streaming_predictor_equals_the_model_predictor(data):
    model = Model.from_config(_jax_mlp().config()).init(0, device="cpu")
    x = data[1]["features"][:45]
    want = ModelPredictor(model, batch_size=16).predict(
        dkt.Dataset({"features": x}))["prediction"]
    sp = StreamingPredictor(model, batch_size=8)
    # single rows and batches of several sizes, mixed
    feed = [x[0], x[1:4], x[4], x[5:20], x[20:21], x[21], x[22:45]]
    got = list(sp.predict_stream(iter(feed)))
    assert len(got) == 45
    assert all(torch.is_tensor(g) and g.device == model.device and
               g.dtype == torch.float32 and g.shape == (3,) for g in got)
    np.testing.assert_allclose(torch.stack(got).numpy(), want, rtol=1e-6,
                               atol=1e-7)
    assert len(sp._sentinel._sigs) == 1   # one batch shape: no retrace
    assert list(sp.predict_stream(iter([]))) == []
