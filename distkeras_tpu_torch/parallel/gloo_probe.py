"""Which collectives a gloo group runs on CUDA tensors, asked of the card.

    python -m distkeras_tpu_torch.parallel.gloo_probe [--timeout S]

For each collective, two fresh processes on ``cuda:0`` form a gloo group
and call it directly on CUDA tensors (no host copy), then check the
result: the ``torch.distributed`` calls, the functional collectives
DTensor issues (``funcol_*``), and a DTensor Megatron pair (``dtensor``:
a column- then a row-sharded kernel on a ``"cuda"`` DeviceMesh at mp 2
and at dp 2, loss and gradients against the dense ones).  Each
collective gets its own pair, so one that crashes or hangs costs only
its own row.  Prints one JSON line per collective —
``{"collective", "result": "direct" | "refused" | "wrong" | "timeout",
"detail"}`` — and a last line with the set that ran directly, which
``mesh.GLOO_CUDA_DIRECT`` records.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_to_all",
               "send_recv", "reduce_scatter", "all_gather_into_tensor",
               "funcol_all_reduce", "funcol_all_gather",
               "funcol_reduce_scatter", "funcol_all_to_all", "dtensor")

_CHILD = r"""
import sys, datetime, json
import torch, torch.distributed as dist
op, rank, addr = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="tcp://" + addr, world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds=20))
dev = torch.device("cuda", 0)
x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
try:
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = x.tolist() == [10.0, 12.0, 14.0, 16.0]
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        ok = x.tolist() == [0.0, 1.0, 2.0, 3.0]
    elif op == "all_gather":
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        ok = torch.cat(out).tolist() == [0.0, 1, 2, 3, 10, 11, 12, 13]
    elif op == "all_to_all":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        ok = out.tolist() == ([0.0, 1, 10, 11] if rank == 0
                              else [2.0, 3, 12, 13])
    elif op == "send_recv":
        buf = torch.empty_like(x)
        reqs = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, 1 - rank),
             dist.P2POp(dist.irecv, buf, 1 - rank)])
        for r in reqs:
            r.wait()
        ok = buf.tolist() == (x - 10 * rank + 10 * (1 - rank)).tolist()
    elif op == "reduce_scatter":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        ok = out.tolist() == ([10.0, 12.0] if rank == 0 else [14.0, 16.0])
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = out.tolist() == [0.0, 1, 2, 3, 10, 11, 12, 13]
    elif op.startswith("funcol_"):
        # the functional collectives DTensor issues for its redistributions
        import torch.distributed._functional_collectives as funcol
        world = dist.group.WORLD
        if op == "funcol_all_reduce":
            out, want = funcol.all_reduce(x, "sum", world), [10.0, 12, 14, 16]
        elif op == "funcol_all_gather":
            out = funcol.all_gather_tensor(x, 0, world)
            want = [0.0, 1, 2, 3, 10, 11, 12, 13]
        elif op == "funcol_reduce_scatter":
            out = funcol.reduce_scatter_tensor(x, "sum", 0, world)
            want = [10.0, 12.0] if rank == 0 else [14.0, 16.0]
        else:
            out = funcol.all_to_all_single(x, None, None, world)
            want = [0.0, 1, 10, 11] if rank == 0 else [2.0, 3, 12, 13]
        out = funcol.wait_tensor(out)
        ok = out.is_cuda and out.tolist() == want
    elif op == "dtensor":
        # a Megatron pair on a "cuda" DeviceMesh over this gloo group, at
        # mp 2 and at dp 2: loss and gradients against the dense ones,
        # every local shard on the card
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        g = torch.Generator().manual_seed(0)
        w1, w2, xb = (torch.randn(*s, generator=g).to(dev)
                      for s in ((16, 32), (32, 4), (8, 16)))
        r1, r2 = w1.clone().requires_grad_(), w2.clone().requires_grad_()
        ref = (torch.relu(xb @ r1) @ r2).square().mean()
        ref.backward()
        ok = True
        for shape in ((1, 2), (2, 1)):
            mesh = DeviceMesh("cuda", torch.arange(2).reshape(shape),
                              mesh_dim_names=("dp", "mp"))
            put = lambda t, pl: distribute_tensor(t, mesh, pl,
                                                  src_data_rank=None)
            d1 = torch.nn.Parameter(put(w1, [Replicate(), Shard(1)]))
            d2 = torch.nn.Parameter(put(w2, [Replicate(), Shard(0)]))
            xd = put(xb, [Shard(0), Replicate()])
            loss = (torch.relu(xd @ d1) @ d2).square().mean()
            loss.backward()
            g1 = d1.grad.redistribute(mesh, d1.placements).full_tensor()
            g2 = d2.grad.redistribute(mesh, d2.placements).full_tensor()
            ok = ok and bool(abs(loss.full_tensor() - ref) < 1e-4 * ref) \
                and all(torch.allclose(a, b.grad, rtol=1e-4, atol=1e-5)
                        for a, b in ((g1, r1), (g2, r2))) \
                and all(t.to_local().is_cuda
                        for t in (d1, d2, d1.grad, d2.grad))
    torch.cuda.synchronize()
    print(json.dumps({"result": "direct" if ok else "wrong"}))
except Exception as e:  # noqa: BLE001 - the refusal is the finding
    print(json.dumps({"result": "refused",
                      "detail": f"{type(e).__name__}: {str(e)[:200]}"}))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def probe(op: str, timeout: float) -> dict:
    """One collective on a fresh pair of ranks."""
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, op, str(r), addr],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ))
             for r in range(2)]
    rows = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            return {"collective": op, "result": "timeout", "detail": ""}
        line = next((ln for ln in out.splitlines() if ln.startswith("{")),
                    None)
        rows.append(json.loads(line) if line else
                    {"result": "refused",
                     "detail": f"rc {p.returncode}: {err.strip()[-200:]}"})
    worst = next((r for r in rows if r["result"] != "direct"), rows[0])
    return {"collective": op, "result": worst["result"],
            "detail": worst.get("detail", "")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    import torch

    from ..obs.logging import emit
    if not torch.cuda.is_available():
        emit("gloo_probe: no CUDA device", err=True)
        return 1
    direct = []
    for op in COLLECTIVES:
        row = probe(op, args.timeout)
        emit(json.dumps(row))
        if row["result"] == "direct":
            direct.append(op)
    emit(json.dumps({"gloo_cuda_direct": direct,
                     "device": torch.cuda.get_device_name(0),
                     "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
