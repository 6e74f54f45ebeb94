"""The port's mesh, collectives and multi-process bring-up
(``distkeras_tpu_torch.parallel.mesh`` / ``multihost``) against the JAX
package's, on the CPU.

The port's ranks are gloo child processes (``tests/test_torch_mesh_child.
py``: the port alone, no JAX); the JAX reference runs here, in
``shard_map`` over the fake devices of ``tests/conftest.py``
(``check_vma=False``, as the JAX package's own calls).  Each collective
runs inside a whole-array ``shard_map`` at 2 and 4 shards (one spawn of 4
ranks: a mesh of 2 runs as two replicas under an axis no spec names, so
the boundary's replicated-axis transposes are held too): its output and
the gradient of sum(out·w) through it and through the boundary, within
rtol 1e-6 plus 1e-6 of the largest |value| (f32; the sums run in another
order).  ``pmean``'s transpose inside a rank's own loss (what the sync
trainers' per-worker step sees) is held the same way.
"""

import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.parallel import multihost as jax_multihost
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distkeras_tpu.parallel.mesh import shard_map as jax_shard_map
from distkeras_tpu.parallel.sync import _shard_map_kw
from jax.sharding import PartitionSpec as JP

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.parallel import mesh as M
from distkeras_tpu_torch.parallel import multihost
from test_torch_mesh_child import ROOT, free_port, run_ranks

OPS = ("psum", "pmean", "ppermute", "all_to_all", "all_gather")


def _close(got, ref, rtol=1e-6, atol_of_max=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bound = atol_of_max * float(np.max(np.abs(ref))) + rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


def _inputs(op, p, seed=0):
    rng = np.random.default_rng(seed + p)
    n, m = 2 * p, 3 if op != "all_to_all" else 2 * p
    x = rng.normal(size=(n, m)).astype(np.float32)
    out_rows = {"psum": n // p, "pmean": n, "ppermute": n,
                "all_to_all": n * p, "all_gather": n}[op]
    out_cols = m // p if op == "all_to_all" else m
    w = rng.normal(size=(out_rows, out_cols)).astype(np.float32)
    return x, w


def _jax_collective(op, x, w, p):
    mesh = jax_make_mesh(p, ("i",))
    perm = [(j, (j + 1) % p) for j in range(p)]
    fns = {
        "psum": (lambda a: jax.lax.psum(a, "i") ** 2, JP()),
        "pmean": (lambda a: jax.lax.pmean(a, "i") * a, JP("i")),
        "ppermute": (lambda a: jax.lax.ppermute(a, "i", perm) * a, JP("i")),
        "all_to_all": (lambda a: jax.lax.all_to_all(
            a, "i", 1, 0, tiled=True) ** 2, JP("i")),
        "all_gather": (lambda a: jax.lax.all_gather(
            a, "i", tiled=True) * 2.0, JP()),
    }
    fn, out_spec = fns[op]
    f = jax_shard_map(fn, mesh=mesh, in_specs=JP("i"), out_specs=out_spec,
                      **_shard_map_kw())

    @jax.jit
    def run(x):
        out, vjp = jax.vjp(f, x)
        return out, vjp(jnp.asarray(w))[0]
    out, grad = run(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


def _jax_inner_pmean(x, p):
    mesh = jax_make_mesh(p, ("i",))

    def per(a):
        def loss(a):
            m = jax.lax.pmean(a, "i")
            return (m ** 2).sum() + (m * a).sum()
        return jax.grad(loss)(a)
    f = jax_shard_map(per, mesh=mesh, in_specs=JP("i"), out_specs=JP("i"),
                      **_shard_map_kw())
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def _cases(p):
    cases = [(f"{op}-{p}", "collective",
              dict(op=op, x=_inputs(op, p)[0], w=_inputs(op, p)[1],
                   mesh_shape=(p,)))
             for op in OPS]
    cases.append((f"inner_pmean-{p}", "inner_pmean_grad",
                  dict(x=_inputs("pmean", p)[0], mesh_shape=(p,))))
    cases.append((f"init-{p}", "initialize", dict(p=p)))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """Every case of this file on one spawn of 4 gloo ranks (a mesh of 2
    runs as two replicas of it)."""
    return run_ranks(4, _cases(2) + _cases(4))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_collective_and_its_gradient_match_shard_map(ranks, op, p):
    x, w = _inputs(op, p)
    ref_out, ref_grad = _jax_collective(op, x, w, p)
    for res in ranks:
        _close(res[f"{op}-{p}"]["out"], ref_out)
        _close(res[f"{op}-{p}"]["grad"], ref_grad)


@pytest.mark.parametrize("p", [2, 4])
def test_pmean_transposes_to_pmean_inside_a_ranks_loss(ranks, p):
    x = _inputs("pmean", p)[0]
    ref = _jax_inner_pmean(x, p)
    n = x.shape[0] // p
    for r, res in enumerate(ranks):
        got = res[f"inner_pmean-{p}"]
        i = got["index"]
        assert i == r % p
        _close(got["grad"], ref[i * n:(i + 1) * n])


@pytest.mark.parametrize("p", [2, 4])
def test_initialize_forms_a_gloo_group_of_cpu_ranks(ranks, p):
    for r, res in enumerate(ranks):
        got = res[f"init-{p}"]
        assert (got["count"], got["index"], got["backend"]) == (4, r, "gloo")
        assert got["reason"] == "ranks on cpu: gloo"
        assert (got["procs"], got["coord"]) == (p, r % p)


def test_initialize_reads_the_jax_environment_names():
    """``initialize()`` with no arguments forms the group from
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, as the JAX one."""
    code = textwrap.dedent("""
        import sys
        from distkeras_tpu_torch.parallel import multihost
        multihost.initialize(device="cpu", timeout_s=60)
        import torch, torch.distributed as dist
        t = torch.tensor([float(multihost.process_index() + 1)])
        dist.all_reduce(t)
        print("ENV_OK", multihost.process_index(),
              multihost.process_count(), float(t))
        multihost.shutdown()
        assert "jax" not in sys.modules
    """)
    addr = f"127.0.0.1:{free_port()}"
    procs = []
    for k in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, COORDINATOR_ADDRESS=addr,
                   NUM_PROCESSES="2", PROCESS_ID=str(k))
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    for k, p in enumerate(procs):
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()
        assert f"ENV_OK {k} 2 3.0" in out.decode()


def test_initialize_no_op_and_refusals(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    # auto mode with nothing configured: one process, no group
    multihost.initialize()
    assert multihost.process_count() == jax_multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert not torch.distributed.is_initialized()
    # an explicit configuration that cannot work raises
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", 2)
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize("127.0.0.1:1", 2, 5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.initialize("127.0.0.1:1", 2, 0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.make_mesh(2)
    assert not torch.distributed.is_initialized()


def test_backend_rule(monkeypatch):
    assert M.choose_backend(torch.device("cpu"), 2) == \
        ("gloo", "ranks on cpu: gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    backend, reason = M.choose_backend(torch.device("cuda", 0), 2)
    assert backend == "gloo" and "share 1 card" in reason
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert M.choose_backend(torch.device("cuda", 1), 4)[0] == "nccl"
    # ranks on another host don't take this host's cards
    assert M.choose_backend(torch.device("cuda", 0), 8, 4)[0] == "nccl"
    assert M.choose_backend(torch.device("cuda", 0), 8, 8)[0] == "gloo"


@pytest.mark.parametrize("p,k", [(2, 0), (2, 1), (3, 2), (4, 3)])
def test_local_shard_is_the_jax_packages_row_split(monkeypatch, p, k):
    rng = np.random.default_rng(0)
    cols = {"features": rng.normal(size=(10, 3)).astype(np.float32),
            "label": np.arange(10)}
    monkeypatch.setattr(jax, "process_count", lambda: p)
    monkeypatch.setattr(jax, "process_index", lambda: k)
    monkeypatch.setattr(multihost, "process_count", lambda: p)
    monkeypatch.setattr(multihost, "process_index", lambda: k)
    want = jax_multihost.local_shard(dk.Dataset(cols, num_partitions=4))
    got = multihost.local_shard(dkt.Dataset(cols, num_partitions=4))
    assert got.num_partitions == want.num_partitions
    for name in cols:
        np.testing.assert_array_equal(got[name], want[name])


def test_make_mesh_lays_slots_out_on_one_process():
    mesh = M.make_mesh(4, devices="cpu")
    assert mesh.shape == {"workers": 4} and mesh.size == 4
    assert (mesh.procs("workers"), mesh.slots("workers")) == (1, 4)
    assert list(mesh.local_slots()) == [0, 1, 2, 3]
    assert mesh.group("workers") is None and mesh.world == 1
    with pytest.raises(ValueError, match="only the 'workers' axis"):
        M.make_mesh(axis_names=("sp",), shape=(2,), devices="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh(axis_names=("dp", "sp"), shape=(2,), devices="cpu")
    one = M.make_mesh(axis_names=("sp",), shape=(1,), devices="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    # one rank on the axis: the collectives are the identity
    for fn in (partial(M.psum, axis_name="sp"),
               partial(M.pmean, axis_name="sp")):
        assert torch.equal(fn(x, mesh=one), x)
    assert torch.equal(M.all_gather(x, "sp", tiled=True, mesh=one), x)
    with pytest.raises(ValueError, match="slots of the 'workers' axis"):
        M.psum(x, "workers", mesh=mesh)
    rows = M.host_to_mesh(mesh, {"a": np.arange(8.0).reshape(4, 2)})
    assert rows["a"].shape == (4, 2) and rows["a"].device.type == "cpu"
