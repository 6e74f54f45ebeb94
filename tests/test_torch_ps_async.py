"""The port's ``mode="async"`` against the JAX package's, on the CPU: with
one worker an async run is deterministic (pull, train a window, commit;
no other worker interleaves), so ``DOWNPOUR``, ``ADAG``, ``DynSGD``,
``AEASGD`` and ``EAMSGD`` on the tiny MLP and on a 1-block flash LM (Dh
16; JAX runs its Pallas kernels in interpret mode, the port the plain
versions) must give the JAX run's trained center and loss history.

Both start from the JAX model's ``init(seed)`` (``_init_from_jax``) and
see the same numpy data.  Tolerance: the sync trainers' bound
(``tests/test_torch_dist.py``), rtol 1e-5 plus 1e-6 of the largest
|value|: of each leaf of the trained center on the MLP, as there (the
worst leaf read 0.055 of its bound: AEASGD's second bias, 9.0e-10 at a
largest |value| of 0.0125), and of each epoch's row for the losses.  On
the LM the attention's sums run in another order (Pallas' blocked
online softmax against the plain dense one), and two small leaves next
to it move by more than their own share: the attention block's
LayerNorm bias by 5.2e-8 at a largest |value| of 0.0126 (3.0 times its
per-leaf bound) and the MLP's first Dense bias by 2.9e-8 at 0.0112 (1.05
times), under DOWNPOUR, ADAG and DynSGD.  So the LM's trained center is
held to 1e-6 of the whole center's largest |value| (1.03) instead;
DOWNPOUR's largest gap there read 2.4e-7, the losses' 9.5e-7 at a
largest loss of 3.36.
No Dropout: the two packages' generators differ.

Also here: the kernel launch counts stay exact when several threads
launch at once (a stub stands in for the CUDA launch).
"""

import importlib
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.datasets import load_lm_corpus as jax_load_lm_corpus
from distkeras_tpu.data.transformers import OneHotTransformer as JaxOneHot
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data import load_lm_corpus
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.utils import load_jax_variables

fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ALGOS = {"DOWNPOUR": {}, "ADAG": {}, "DynSGD": {},
         "AEASGD": dict(rho=1.0), "EAMSGD": dict(rho=1.0)}
MLP_KW = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", num_epoch=2, batch_size=32,
              learning_rate=0.05, communication_window=2, num_workers=1,
              mode="async")
VOCAB, SEQ = 17, 32
LM = dict(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=1, seq_len=SEQ,
          attention_impl="flash")
LM_KW = dict(loss="sparse_categorical_crossentropy", num_epoch=1,
             batch_size=8, learning_rate=0.1, communication_window=2,
             num_workers=1, mode="async")


def _close(got, ref, rtol=1e-5, atol_of_max=1e-6, largest=None):
    """|got − ref| ≤ rtol·|ref| + atol_of_max·largest, ``largest`` the
    largest |value| of ``ref`` unless given (a whole tree's)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if largest is None:
        largest = float(np.max(np.abs(ref)))
    bound = atol_of_max * largest + rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _init_from_jax(model, jax_init):
    """Make ``model.init(seed)`` load ``jax_init(seed)``, so the async
    runner's center starts where the JAX trainer's does."""
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jax_init(seed)))
        return model
    model.init = init
    return model


@pytest.fixture(scope="module")
def mlp_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.argmax(x @ w, axis=-1)
    jds = JaxOneHot(3, "label", "label_onehot").transform(
        dk.Dataset({"features": x, "label": y}))
    pds = OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))
    return jds, pds


@pytest.fixture(scope="module")
def lm_data():
    kw = dict(n_train=64, seq_len=SEQ, vocab_size=VOCAB)
    return jax_load_lm_corpus(**kw)[0], load_lm_corpus(**kw)[0]


def _pair(name, jm, jds, pds, kw):
    jt = getattr(dk, name)(jm, **kw, **ALGOS[name])
    jt.train(jds)
    pm = _init_from_jax(Model.from_config(jm.config()), jm.init)
    pt = getattr(dkt, name)(pm, device="cpu", **kw, **ALGOS[name])
    assert pt.train(pds) is pm
    return jt, pt


def _check(jt, pt, windows, whole_center=False):
    assert pt.ps_stats["num_updates"] == jt.ps_stats["num_updates"] \
        == windows
    assert pt.ps_stats["commits_by_worker"] == {0: windows}
    assert len(pt.get_history()) == len(jt.get_history())
    for a, b in zip(pt.get_history(), jt.get_history()):
        _close(a, b)
    ref = _leaves(jt.trained_variables)
    largest = max(float(np.max(np.abs(b))) for b in ref) \
        if whole_center else None
    for a, b in zip(_leaves(pt.trained_variables), ref):
        _close(a, b, largest=largest)


@pytest.mark.parametrize("name", list(ALGOS))
def test_one_worker_async_mlp_matches_jax(name, mlp_data):
    """2 epochs of 4 windows of 2 steps, batch 32."""
    jm = dk.Model(JaxSequential([JaxDense(32, "relu"),
                                 JaxDense(3, "softmax")]), input_shape=(10,))
    jt, pt = _pair(name, jm, *mlp_data, MLP_KW)
    _check(jt, pt, windows=8)
    # DynSGD: one worker never sees a commit between its pull and its
    # commit
    if name == "DynSGD":
        assert pt.ps_stats["staleness_seen"] == \
            jt.ps_stats["staleness_seen"] == [0] * 8


@pytest.mark.parametrize("name", list(ALGOS))
def test_one_worker_async_flash_lm_matches_jax(name, lm_data):
    """The 1-block flash LM (Dh 16, T 32): 1 epoch of 4 windows of 2
    steps, batch 8."""
    jt, pt = _pair(name, jax_zoo.gpt_lm(**LM), *lm_data, LM_KW)
    _check(jt, pt, windows=4, whole_center=True)


def test_launch_counts_are_exact_under_threads():
    """Eight threads each count 2000 launches of every kernel wrapper at
    once through ``_count`` (a stub stands in for the CUDA launch, which
    ctypes runs with the GIL dropped): no count is lost.  The counts are
    kept under one lock: a count waits while another thread holds it
    (CPython rarely switches threads inside ``+=``, so the hammering
    alone would miss an unguarded count most of the time)."""
    fa.reset_launches()
    with fa._COUNT_LOCK:
        waiter = threading.Thread(target=fa._count, args=(
            fa.flash_fwd_cuda, "fwd_stub", torch.bfloat16, 64))
        waiter.start()
        waiter.join(0.2)
        assert waiter.is_alive() and fa.flash_fwd_cuda.launches == 0
    waiter.join()
    assert fa.flash_fwd_cuda.launches == 1
    fa.reset_launches()
    start = threading.Barrier(8)
    wrappers = (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda,
                fa.flash_bwd_dkv_cuda)
    names = {fa.flash_fwd_cuda: "fwd_stub", fa.flash_bwd_dq_cuda: "dq_stub",
             fa.flash_bwd_dkv_cuda: "dkv_stub"}
    # a tiny switch interval makes the interpreter swap threads between
    # the read and the write of an unguarded ``+=``
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def launch():
            start.wait()
            for _ in range(2000):
                for w in wrappers:
                    fa._count(w, names[w], torch.bfloat16, 64)

        ts = [threading.Thread(target=launch) for _ in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
    finally:
        sys.setswitchinterval(before)
    counts = fa.launch_counts()
    assert counts["wrappers"] == {"flash_fwd_cuda": 16000,
                                  "flash_bwd_dq_cuda": 16000,
                                  "flash_bwd_dkv_cuda": 16000}
    assert counts["kernels"] == [[k, "bfloat16", 64, 16000] for k in
                                 ("dkv_stub", "dq_stub", "fwd_stub")]
    # a worker process's counts fold into these
    fa.add_launches(counts)
    assert fa.flash_fwd_cuda.launches == 32000
    assert fa.KERNEL_LAUNCHES[("fwd_stub", "bfloat16", 64)] == 32000
    fa.reset_launches()
    assert fa.launch_counts() == {"wrappers": dict.fromkeys(
        counts["wrappers"], 0), "kernels": []}
