"""The rank side of the port's multi-process tests: holds no tests.

``run_ranks(world, cases)`` starts ``world`` child processes of this
file, each a rank of a gloo group on the CPU (``multihost.initialize``
with a group timeout), which runs every case with the port alone — it
imports neither JAX nor the JAX package — and hands back each rank's
results: ``[{case id: numpy tree}, ...]`` by rank.  A case is
``(id, function name, kwargs)``; the function is one of the ``case_*``
below, called with ``mesh_shape`` / ``axis_names`` to build its mesh.

    python tests/test_torch_mesh_child.py WORKDIR RANK WORLD ADDRESS [DEVICE]
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a rank's collective waits for a peer before every rank raises
GROUP_TIMEOUT_S = 90.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


#: what a rank prints when the port ``free_port`` picked was taken by
#: another process before rank 0's store bound it
_PORT_TAKEN = ("address already in use", "eaddrinuse")


def run_ranks(world: int, cases, timeout: float = 300.0, env=None,
              device: str = "cpu"):
    """Run ``cases`` on ``world`` gloo ranks on ``device`` ("cpu", or
    "cuda": every rank on ``cuda:{rank % device_count}``); returns each
    rank's results (a dict by case id) — fails with every rank's output
    when a rank exits non-zero or hangs past ``timeout``.  The group's
    port is picked free and then bound by rank 0's store, so another
    process may take it in between: only that start is tried again."""
    for _ in range(3):
        results, outs = _run_ranks_once(world, cases, timeout, env, device)
        if results is not None:
            return results
        if not any(m in out.lower() for out in outs for m in _PORT_TAKEN):
            break
    raise AssertionError("a rank failed:\n" + "\n".join(
        f"--- rank {r}: {out}" for r, out in enumerate(outs)))


def _run_ranks_once(world, cases, timeout, env, device):
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "cases.pkl"), "wb") as f:
            pickle.dump(list(cases), f)
        addr = f"127.0.0.1:{free_port()}"
        child_env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
        for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "COORDINATOR_ADDRESS",
                  "NUM_PROCESSES", "PROCESS_ID"):
            child_env.pop(k, None)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), td, str(r),
             str(world), addr, device], cwd=ROOT, env=child_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out.decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            return None, [f"exit {p.returncode}\n{out}"
                          for p, out in zip(procs, outs)]
        results = []
        for r in range(world):
            with open(os.path.join(td, f"out{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results, outs


# ---------------------------------------------------------------------------
# helpers (rank side)
# ---------------------------------------------------------------------------

def _np(tree):
    import torch
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def _t(x, grad=False):
    import torch
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_(True) if grad else t


def _mesh(mesh_shape, axis_names):
    """The case's mesh; in a world larger than it, under an outer
    ``replica`` axis that no spec names (each replica computes the same
    whole arrays, and the ``shard_map`` boundary's replicated-axis
    transposes keep the gradients exact), so cases of P = 2 and 4 share
    one spawn of 4 ranks."""
    import math

    from distkeras_tpu_torch.parallel import multihost
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    reps = multihost.process_count() // math.prod(mesh_shape)
    if reps > 1:
        mesh_shape, axis_names = (reps, *mesh_shape), ("replica",
                                                       *axis_names)
    return make_mesh(axis_names=tuple(axis_names), shape=tuple(mesh_shape),
                     devices="cpu")


def _init_from(model, inits):
    """``model.init(seed)`` loads ``inits[seed]`` (the JAX model's
    ``init(seed)``, handed in as numpy), as the parity tests do."""
    from distkeras_tpu_torch.utils import load_jax_variables
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, inits[int(seed)])
        return model
    model.init = init
    return model


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_collective(op, x, w, mesh_shape, axis_names=("i",)):
    """One collective inside ``shard_map`` over the whole ``x``: the
    output and d(sum(out·w))/dx."""
    from distkeras_tpu_torch.parallel import mesh as M
    mesh = _mesh(mesh_shape, axis_names)
    p = mesh.procs("i")
    fns = {
        "psum": (lambda a: M.psum(a, "i") ** 2, M.P()),
        "pmean": (lambda a: M.pmean(a, "i") * a, M.P("i")),
        "ppermute": (lambda a: M.ppermute(
            a, "i", [(j, (j + 1) % p) for j in range(p)]) * a, M.P("i")),
        "all_to_all": (lambda a: M.all_to_all(
            a, "i", 1, 0, tiled=True) ** 2, M.P("i")),
        "all_gather": (lambda a: M.all_gather(a, "i", tiled=True) * 2.0,
                       M.P()),
    }
    fn, out_spec = fns[op]
    xt = _t(x, grad=True)
    out = M.shard_map(fn, mesh, M.P("i"), out_spec)(xt)
    (out * _t(w)).sum().backward()
    return {"out": _np(out), "grad": _np(xt.grad)}


def case_inner_pmean_grad(x, mesh_shape, axis_names=("i",)):
    """The gradient of this rank's own loss through ``pmean`` (the
    transpose the sync trainers' per-worker step sees)."""
    import torch

    from distkeras_tpu_torch.parallel import mesh as M
    mesh = _mesh(mesh_shape, axis_names)
    n = x.shape[0] // mesh.procs("i")
    a = _t(x[mesh.coord("i") * n:(mesh.coord("i") + 1) * n], grad=True)
    with mesh:
        m = M.pmean(a, "i")
        loss = (m ** 2).sum() + (m * a).sum()
    (g,) = torch.autograd.grad(loss, [a])
    return {"grad": _np(g), "index": mesh.axis_index("i")}


def case_ring(q, k, v, do, mesh_shape, axis_names, impl, causal, layout,
              batch_axis=None, pre_shuffled=False, inner=None):
    """``ring_attention_sharded`` (or an inner function through the port's
    ``shard_map``): the output and the gradients of sum(out·do)."""
    from functools import partial

    from distkeras_tpu_torch.parallel import ring
    from distkeras_tpu_torch.parallel.mesh import P, shard_map
    mesh = _mesh(mesh_shape, axis_names)
    qt, kt, vt = (_t(a, grad=True) for a in (q, k, v))
    if inner is None:
        out = ring.ring_attention_sharded(
            mesh, qt, kt, vt, axis="sp", batch_axis=batch_axis,
            causal=causal, impl=impl, layout=layout,
            pre_shuffled=pre_shuffled)
    else:
        fn = {"ring_attention": partial(ring.ring_attention, impl=impl,
                                        causal=causal),
              "zigzag_ring_attention": partial(ring.zigzag_ring_attention,
                                               impl=impl),
              "ulysses_attention": partial(ring.ulysses_attention,
                                           causal=causal,
                                           impl="dense")}[inner]
        spec = P(batch_axis, "sp")
        out = shard_map(partial(fn, axis_name="sp"), mesh,
                        (spec, spec, spec), spec)(qt, kt, vt)
    (out * _t(do)).sum().backward()
    return {"out": _np(out), "dq": _np(qt.grad), "dk": _np(kt.grad),
            "dv": _np(vt.grad)}


def case_mha_grad(config, inits, x, mesh_shape, axis_names, layout=None):
    """A mesh-attached model's loss gradient (every parameter), to hold
    against the mesh-free model's."""
    import torch

    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.ops.attention import MultiHeadAttention
    mesh = _mesh(mesh_shape, axis_names)
    model = _init_from(Model.from_config(config), inits).init(0, "cpu")
    for lyr in model.iter_layers():
        if isinstance(lyr, MultiHeadAttention):
            lyr.mesh = mesh
            lyr.ring_layout = layout
    out = model(_t(x))
    loss = (out.float() ** 2).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return {"loss": float(loss), "grads": dict(zip(names, _np(grads)))}


def case_lm_train(config, inits, x, y, mesh_shape, axis_names, trainer_kw,
                  layout=None):
    """A mesh-attached LM trained a few ``SingleTrainer`` steps: the
    losses and the trained variables (JAX tree)."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.ops.attention import MultiHeadAttention
    from distkeras_tpu_torch.utils import to_numpy_variables
    mesh = _mesh(mesh_shape, axis_names)
    model = _init_from(Model.from_config(config), inits)
    model.init(0, "cpu")
    for lyr in model.iter_layers():
        if isinstance(lyr, MultiHeadAttention):
            lyr.mesh = mesh
            lyr.ring_layout = layout
    t = dkt.SingleTrainer(model, device="cpu", **trainer_kw)
    t.train(dkt.Dataset({"features": x, "label": y}))
    return {"history": [np.asarray(h) for h in t.get_history()],
            "variables": to_numpy_variables(model)}


def case_moe(params, x, w, aux_weight, capacity_factor, mesh_shape,
             axis_names=("ep",)):
    """``switch_moe_sharded``: out, aux and the gradients of
    sum(out·w) + aux_weight·aux."""
    import torch

    from distkeras_tpu_torch.ops.moe import switch_moe_sharded
    mesh = _mesh(mesh_shape, axis_names)
    pt = {g: {k: _t(v, grad=True) for k, v in d.items()}
          for g, d in params.items()}
    xt = _t(x, grad=True)
    out, aux = switch_moe_sharded(mesh, pt, xt,
                                  capacity_factor=capacity_factor)
    ((out * _t(w)).sum() + aux_weight * aux).backward()
    del torch
    return {"out": _np(out), "aux": _np(aux), "dx": _np(xt.grad),
            "dparams": {g: {k: _np(v.grad) for k, v in d.items()}
                        for g, d in pt.items()}}


def case_moe_layer(config, inits, x, mesh_shape, axis_names=("ep",)):
    """A model whose ``MoEDense`` holds this rank's experts of an ``ep``
    mesh: its output, aux loss and its gradients (experts: this rank's
    rows), and the variables it keeps."""
    import torch

    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.ops.moe import MoEDense
    from distkeras_tpu_torch.parallel.sync import aux_losses
    mesh = _mesh(mesh_shape, axis_names)
    model = Model.from_config(config)
    for lyr in model.iter_layers():
        if isinstance(lyr, MoEDense):
            lyr.mesh = mesh
    _init_from(model, inits).init(0, "cpu")
    model.train(True)
    out = model(_t(x))
    aux = sum(aux_losses(model))
    loss = (out ** 2).mean() + 0.01 * aux
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return {"out": _np(out), "aux": float(aux), "rank": mesh.coord("ep"),
            "grads": dict(zip(names, _np(grads))),
            "shapes": {n: tuple(p.shape)
                       for n, p in model.named_parameters()}}


def case_bn(x, w, scale, bias, mesh_shape, axis_names=("workers",)):
    """``BatchNorm(axis_name="workers")`` on this rank's batch, in train
    mode: its output, new state and the gradients of this rank's loss
    sum(out·w) with respect to x, scale and bias."""
    import torch

    from distkeras_tpu_torch.models.layers import BatchNorm
    mesh = _mesh(mesh_shape, axis_names)
    bn = BatchNorm(axis_name="workers")
    bn.build(x.shape[2:], None)
    with torch.no_grad():
        bn.scale.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    r = mesh.coord("workers")
    xt = _t(x[r], grad=True)
    bn.train(True)
    with mesh:
        out = bn(xt)
    gx, gs, gb = torch.autograd.grad((out * _t(w[r])).sum(),
                                     [xt, bn.scale, bn.bias])
    return {"out": _np(out), "state": _np(bn.new_state), "dx": _np(gx),
            "dscale": _np(gs), "dbias": _np(gb)}


def _data(x, y):
    import distkeras_tpu_torch as dkt
    return dkt.Dataset({"features": x, "label_onehot": y})


def case_sync_train(name, config, inits, x, y, mesh_shape, kw,
                    axis_names=("workers",), ckpt=None, stream=None):
    """A sync trainer over a ``workers`` mesh of every rank: the trained
    center (or every ensemble member), the history and, with ``ckpt``, the
    checkpoint steps this rank wrote."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.data.streaming import ShardedFileDataset
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.utils import to_numpy_variables
    mesh = _mesh(mesh_shape, axis_names)
    model = _init_from(Model.from_config(config), inits)
    extra = {}
    if ckpt is not None:
        extra["checkpoint_dir"] = os.path.join(ckpt, f"rank{mesh.rank}")
    cls = getattr(dkt, name)
    if name == "EnsembleTrainer":
        t = cls(model, num_ensembles=mesh_shape[0], mesh=mesh, **kw, **extra)
    else:
        t = cls(model, num_workers=mesh_shape[0], mesh=mesh, **kw, **extra)
    ds = _data(x, y)
    if stream is not None:
        ds = ShardedFileDataset.write(
            ds, os.path.join(stream, f"shards{mesh.rank}"),
            rows_per_shard=64)
    out = t.train(ds)
    res = {"history": [np.asarray(h) for h in t.get_history()]}
    if isinstance(out, list):
        res["members"] = [to_numpy_variables(m) for m in out]
    else:
        res["center"] = to_numpy_variables(out)
    if ckpt is not None:
        res["ckpt_steps"] = sorted(os.listdir(extra["checkpoint_dir"]))
    return res


def case_cluster(config, inits, x, y, kw, port, fail_rank=None):
    """``run_cluster_async_training`` with one DOWNPOUR worker a process:
    the center every process returns and process 0's PS counts; with
    ``fail_rank`` that process's worker crashes and the error every
    process raised is returned."""
    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.parallel import multihost
    from distkeras_tpu_torch.ps import workers
    from distkeras_tpu_torch.ps.cluster import run_cluster_async_training
    from distkeras_tpu_torch.utils import to_numpy_variables
    model = _init_from(Model.from_config(config), inits)
    pid = multihost.process_index()
    run = workers.PullCommitWorker.run
    if fail_rank == pid:
        def boom(self):
            self.error = RuntimeError("injected worker crash")
        workers.PullCommitWorker.run = boom
    try:
        t = dkt.DOWNPOUR(model, num_workers=multihost.process_count(),
                         device="cpu", **kw)
        m = run_cluster_async_training(t, _data(x, y),
                                       ps_address=("127.0.0.1", port))
    except RuntimeError as e:
        return {"error": f"{type(e).__name__}: {e}"}
    finally:
        workers.PullCommitWorker.run = run
    res = {"center": to_numpy_variables(m),
           "history": [np.asarray(h) for h in t.get_history()]}
    if pid == 0:
        res["commits_by_worker"] = dict(t.ps_stats["commits_by_worker"])
        res["num_updates"] = t.ps_stats["num_updates"]
    return res


def case_initialize(p):
    """What ``multihost`` reports once the group is formed, that a second
    ``initialize`` is a no-op, and this rank's place on a mesh of ``p``
    ranks along ``i``."""
    from distkeras_tpu_torch.parallel import multihost
    world = multihost.process_count()
    multihost.initialize("127.0.0.1:1", world, 0)  # already formed: no-op
    import torch.distributed as dist
    mesh = _mesh((p,), ("i",))
    return {"count": multihost.process_count(),
            "index": multihost.process_index(),
            "backend": dist.get_backend(),
            "reason": multihost.backend_reason(),
            "procs": mesh.procs("i"), "coord": mesh.coord("i")}


def case_card_collectives(x):
    """Each collective on this rank's card over a gloo group: its route
    (direct or through a host copy), its result against the same
    collective on CPU tensors, and this rank's counters."""
    import torch

    from distkeras_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(axis_names=("i",), shape=(M.multihost.process_count(),))
    p, r = mesh.procs("i"), mesh.coord("i")
    mine = torch.from_numpy(np.array(x[r]))
    M.reset_collective_stats()
    out = {}
    for name, fn in (
            ("psum", lambda a: M.psum(a, "i", mesh)),
            ("all_gather", lambda a: M.all_gather(a, "i", tiled=True,
                                                  mesh=mesh)),
            ("all_to_all", lambda a: M.all_to_all(a, "i", 0, 0, tiled=True,
                                                  mesh=mesh)),
            ("ppermute", lambda a: M.ppermute(
                a, "i", [(j, (j + 1) % p) for j in range(p)], mesh)),
            ("broadcast", lambda a: M.broadcast(a, "i", 0, mesh))):
        card = fn(mine.to(mesh.device))
        out[name] = {"device": str(card.device),
                     "equal": bool(torch.equal(card.cpu(), fn(mine)))}
    stats = M.collective_stats()
    return {"ops": out, "stats": stats,
            "routes": {op: M.route(op, mine.to(mesh.device),
                                   mesh.group("i"))
                       for op in ("all_reduce", "broadcast", "all_gather",
                                  "all_to_all", "ppermute")}}


def case_card_ring(q, k, v, causal, layout):
    """A two-rank ring forward (the flash hops: K1 on the card) against K1
    over the whole T in this process; its K1 launches."""
    import torch

    from distkeras_tpu_torch.ops.flash_attention import (
        flash_attention, flash_fwd_cuda, reset_launches)
    from distkeras_tpu_torch.parallel import mesh as M
    from distkeras_tpu_torch.parallel.ring import ring_attention_sharded
    mesh = M.make_mesh(axis_names=("sp",), shape=(M.multihost.process_count(),))
    qt, kt, vt = (torch.from_numpy(np.array(a)).to(mesh.device)
                  for a in (q, k, v))
    reset_launches()
    out = ring_attention_sharded(mesh, qt, kt, vt, causal=causal,
                                 impl="flash", layout=layout)
    torch.cuda.synchronize()
    ring_launches = flash_fwd_cuda.launches
    whole = flash_attention(qt, kt, vt, causal)
    return {"max_abs_err": float((out - whole).abs().max()),
            "ref_max": float(whole.abs().max()),
            "launches": ring_launches}


def _spmd_model(config, inits, double=False):
    """The model of ``config`` whose ``init(seed)`` loads ``inits[seed]``
    (cast to float64 with ``double``: the exactness witness)."""
    from distkeras_tpu_torch.models import Model
    model = _init_from(Model.from_config(config), inits)
    if double:
        init = model.init
        model.init = lambda seed=0, device=None: init(seed, device).double()
    return model


def _cols(x, y):
    import distkeras_tpu_torch as dkt
    return dkt.Dataset({"features": x, "label": y})


def _trained(t, model):
    from distkeras_tpu_torch.utils import to_numpy_variables
    return {"history": [np.asarray(h) for h in t.get_history()],
            "variables": to_numpy_variables(model)}


def case_spmd_train(config, inits, x, y, kw, mesh_shape, optimizer="sgd",
                    ckpt=None, stream=None, spy=False, double=False):
    """``SpmdTrainer`` on ``mesh_shape``: the history, the trained
    variables, the sharding report, this rank's collective counts and,
    with ``ckpt``, a run resumed after its first epoch beside the straight
    one; with ``stream``, a run streamed from shard files; with ``spy``,
    the types and shapes ``flash_fwd_plain`` / ``flash_bwd_plain`` saw;
    and the calls of the column- and row-split ``Dense`` products."""
    import importlib
    from distkeras_tpu_torch.data.streaming import ShardedFileDataset
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    from distkeras_tpu_torch.trainers import SpmdTrainer
    from distkeras_tpu_torch.parallel import spmd
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    seen = []
    products = {"column": 0, "row": 0}
    split_dense = spmd._split_dense

    def count_products(lyr, dim, *a):
        products["column" if dim == 1 else "row"] += 1
        return split_dense(lyr, dim, *a)
    spmd._split_dense = count_products
    if spy:
        fwd, bwd = fa.flash_fwd_plain, fa.flash_bwd_plain

        def fwd_spy(q, k, v, *a):
            seen.append(("fwd", [type(t).__name__ for t in (q, k, v)],
                         tuple(q.shape)))
            return fwd(q, k, v, *a)

        def bwd_spy(q, k, v, lse, do, dvec, *a):
            seen.append(("bwd", [type(t).__name__ for t in (q, do)],
                         tuple(q.shape)))
            return bwd(q, k, v, lse, do, dvec, *a)
        fa.flash_fwd_plain, fa.flash_bwd_plain = fwd_spy, bwd_spy
    try:
        model = _spmd_model(config, inits, double)
        t = SpmdTrainer(model, optimizer, mesh_shape=mesh_shape,
                        device="cpu", **kw)
        mesh_lib.reset_collective_stats()
        t.train(_cols(x, y))
        res = _trained(t, model)
        res["stats"] = mesh_lib.collective_stats()
        res["report"] = t.sharding_report
        res["compiled_step"] = t.compiled_step
        res["seen"] = seen
        res["products"] = products
    finally:
        spmd._split_dense = split_dense
        if spy:
            fa.flash_fwd_plain, fa.flash_bwd_plain = fwd, bwd
    rank = t._mesh.rank
    if ckpt is not None:
        cdir = os.path.join(ckpt, f"rank{rank}")
        first = SpmdTrainer(_spmd_model(config, inits), optimizer,
                            mesh_shape=mesh_shape, device="cpu",
                            **{**kw, "num_epoch": 1}, checkpoint_dir=cdir)
        first.train(_cols(x, y))
        m2 = _spmd_model(config, inits)
        second = SpmdTrainer(m2, optimizer, mesh_shape=mesh_shape,
                             device="cpu", **kw, checkpoint_dir=cdir)
        second.train(_cols(x, y), resume=True)
        res["resumed"] = _trained(second, m2)
    if stream is not None:
        src = ShardedFileDataset.write(
            _cols(x, y), os.path.join(stream, f"shards{rank}"),
            rows_per_shard=48)
        m3 = _spmd_model(config, inits)
        st = SpmdTrainer(m3, optimizer, mesh_shape=mesh_shape, device="cpu",
                         **kw)
        st.train(src)
        res["streamed"] = _trained(st, m3)
        res["streamed_report"] = st.sharding_report
    return res


def _pipe_stage(params, x):
    import torch
    # the residual MLP block of tests/test_pipeline.py
    return x + torch.tanh(x.to(params["w"].dtype) @ params["w"]
                          + params["b"])


def case_pipe_apply(w, b, x, ct, mesh_shape, axis_names, num_microbatches,
                    dp_axis=None, bf16=False):
    """``pipeline_apply_sharded`` over the whole (S, …) stage stack:
    the output and the gradients of ``sum(out · ct)`` with respect to
    the stack and the input, and this rank's ``ppermute`` count."""
    import torch
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    from distkeras_tpu_torch.parallel.pipeline import pipeline_apply_sharded
    mesh = _mesh(mesh_shape, axis_names)
    params = {"w": _t(w, True), "b": _t(b, True)}
    xt = _t(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    xt.requires_grad_(True)
    mesh_lib.reset_collective_stats()
    out = pipeline_apply_sharded(mesh, _pipe_stage, params, xt,
                                 num_microbatches=num_microbatches,
                                 dp_axis=dp_axis)
    gw, gb, gx = torch.autograd.grad((out * _t(ct).to(out.dtype)).sum(),
                                     [params["w"], params["b"], xt])
    return {"out": _np(out.float()), "dw": _np(gw), "db": _np(gb),
            "dx": _np(gx.float()), "dtype": str(out.dtype),
            "ppermutes": mesh_lib.collective_stats()["calls"].get(
                "ppermute", 0)}


def case_pipe_train(config, inits, x, y, kw, mesh_shape, optimizer="adam",
                    num_microbatches=None, ckpt=None):
    """``PipelineTrainer`` on ``mesh_shape``: the history, the trained
    variables, the bytes of this rank's stage parameters, the calls of
    the attention's plain forward and backward, and, with ``ckpt``, a
    run resumed after its first epoch (the checkpoint directory by
    rank)."""
    import importlib
    from distkeras_tpu_torch.trainers import PipelineTrainer
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_fwd_plain, fa.flash_bwd_plain

    def fwd_count(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def bwd_count(*a):
        calls["bwd"] += 1
        return bwd(*a)
    fa.flash_fwd_plain, fa.flash_bwd_plain = fwd_count, bwd_count
    try:
        model = _spmd_model(config, inits)
        t = PipelineTrainer(model, optimizer, mesh_shape=mesh_shape,
                            num_microbatches=num_microbatches,
                            device="cpu", **kw)
        t.train(_cols(x, y))
        res = _trained(t, model)
        res["calls"] = dict(calls)
        res["stage_bytes"] = sum(
            t._params[k].numel() * t._params[k].element_size()
            for k in t._stage_keys)
        res["params_dtypes"] = sorted({str(p.dtype)
                                       for p in model.parameters()})
    finally:
        fa.flash_fwd_plain, fa.flash_bwd_plain = fwd, bwd
    if ckpt is not None:
        cdir = os.path.join(ckpt, f"pipe_rank{t._mesh.rank}")
        PipelineTrainer(_spmd_model(config, inits), optimizer,
                        mesh_shape=mesh_shape,
                        num_microbatches=num_microbatches, device="cpu",
                        **{**kw, "num_epoch": 1},
                        checkpoint_dir=cdir).train(_cols(x, y))
        m2 = _spmd_model(config, inits)
        second = PipelineTrainer(m2, optimizer, mesh_shape=mesh_shape,
                                 num_microbatches=num_microbatches,
                                 device="cpu", **kw, checkpoint_dir=cdir)
        second.train(_cols(x, y), resume=True)
        res["resumed"] = _trained(second, m2)
        res["ckpt_dir"] = cdir
    return res


def case_zigzag_wrap(config, inits, x, ct, mesh_shape, axis_names):
    """``zigzag_wrap`` of a causal LM on an ``sp`` mesh: the wrapped
    model's logits and the gradients of sum(logits · ct) by parameter
    name, its insert positions, the original's attention flags after the
    wrap, and the same of the unwrapped zigzag ring (each attention
    layer on the mesh, striping its own inputs)."""
    import torch

    from distkeras_tpu_torch.models import Model, zigzag_wrap
    from distkeras_tpu_torch.ops.attention import MultiHeadAttention
    mesh = _mesh(mesh_shape, axis_names)
    model = _init_from(Model.from_config(config), inits).init(0, "cpu")
    names = [n for n, _ in model.named_parameters()]

    def run(m):
        out = m(_t(x))
        grads = torch.autograd.grad((out * _t(ct)).sum(),
                                    [p for _, p in model.named_parameters()])
        return _np(out), dict(zip(names, _np(grads)))

    wrapped, pos = zigzag_wrap(model, mesh)
    logits, grads = run(wrapped)
    mhas = [lyr for lyr in model.iter_layers()
            if isinstance(lyr, MultiHeadAttention)]
    flags = [(lyr.mesh is None, lyr.ring_pre_shuffled) for lyr in mhas]
    for lyr in mhas:
        lyr.mesh = mesh
        lyr.ring_layout = "zigzag"
    ring_logits, ring_grads = run(model)
    return {"logits": logits, "grads": grads, "positions": list(pos),
            "original_flags": flags, "ring_logits": ring_logits,
            "ring_grads": ring_grads}


def case_card_trainers():
    """``SpmdTrainer`` on ``{"dp": 1, "mp": 2}`` and ``PipelineTrainer`` on
    ``{"pp": 2}`` training a small flash LM on the card: the device types
    of every parameter block, optimizer-state tensor and gradient the
    SPMD run held, of the pipeline's stage, the plain attention's calls
    on CUDA tensors (none may run) and each run's K1–K3 launches."""
    import importlib

    import torch

    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch.models import zoo
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    plain_on_cuda = []
    fwd, bwd = fa.flash_fwd_plain, fa.flash_bwd_plain

    def spy(fn, name):
        def call(*a):
            if any(torch.is_tensor(t) and t.is_cuda for t in a):
                plain_on_cuda.append(name)
            return fn(*a)
        return call
    fa.flash_fwd_plain = spy(fwd, "fwd")
    fa.flash_bwd_plain = spy(bwd, "bwd")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, size=(16, 128)).astype(np.int32)
    ds = dkt.Dataset({"features": x, "label": np.roll(x, -1, axis=1)})
    lm = dict(vocab_size=64, dim=128, num_heads=2, num_blocks=2,
              seq_len=128, attention_impl="flash")
    kw = dict(loss="sparse_categorical_crossentropy", batch_size=8,
              learning_rate=1e-3, num_epoch=1)
    out = {}
    try:
        seen = set()
        t = dkt.SpmdTrainer(zoo.gpt_lm(**lm), "adam",
                            mesh_shape={"dp": 1, "mp": 2}, **kw)
        start = t._start

        def spy_start(optimizer):
            params, opt_state, ckpt, first = start(optimizer)
            for p in params.values():
                seen.add(str(p.device))
                p.register_hook(lambda g: seen.add(str(g.device)))
            for v in opt_state.values():
                if isinstance(v, dict):
                    seen.update(str(a.device) for a in v.values())
            return params, opt_state, ckpt, first
        t._start = spy_start
        fa.reset_launches()
        t.train(ds)
        out["spmd"] = {"devices": sorted(seen),
                       "split": t.sharding_report["per_device_bytes"]
                       < t.sharding_report["global_bytes"],
                       "launches": fa.flash_fwd_cuda.launches}
        fa.reset_launches()
        p = dkt.PipelineTrainer(zoo.gpt_lm(**lm), "adam",
                                mesh_shape={"pp": 2}, **kw)
        p.train(ds)
        out["pipe"] = {"devices": sorted({str(a.device)
                                          for a in p._params.values()}),
                       "launches": fa.flash_fwd_cuda.launches}
    finally:
        fa.flash_fwd_plain, fa.flash_bwd_plain = fwd, bwd
    out["plain_on_cuda"] = plain_on_cuda
    return out


# ---------------------------------------------------------------------------
# the rank's main
# ---------------------------------------------------------------------------

def main(argv) -> int:
    td, rank, world, addr = argv[1], int(argv[2]), int(argv[3]), argv[4]
    device = argv[5] if len(argv) > 5 else "cpu"
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    from distkeras_tpu_torch.parallel import multihost
    multihost.initialize(addr, world, rank,
                         device="cpu" if device == "cpu" else None,
                         timeout_s=GROUP_TIMEOUT_S)
    with open(os.path.join(td, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {}
    for cid, fn, kw in cases:
        try:
            results[cid] = globals()[f"case_{fn}"](**kw)
        except Exception:  # noqa: BLE001 — a failed rank fails its test
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(3)
    with open(os.path.join(td, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist
    dist.barrier()
    multihost.shutdown()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "distkeras_tpu"))
    assert not leaked, leaked
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
