"""One shard-server OS process:
``python -m distkeras_tpu_torch.ps.shard.shard_main SPEC`` — the port of
``distkeras_tpu.ps.shard.shard_main``.

This process rebuilds the center from a spec file, derives the shard
plan (the same pure function every worker runs), hosts ITS slice behind
a :class:`~.server.ShardFrontend`, writes the bound port to
``port_file`` for the spawner, and serves until killed.  A shard is host
code: it never opens a CUDA context (the spec's ``device`` must be
``"cpu"``; :class:`~.server.ProcessShardFleet` also hides the card from
the process).

The spec is a ``utils.serde`` tree::

    {"center_blob": tree_to_bytes(full center tree),
     "num_shards": int, "shard_index": int, "epoch": int,
     "ps_class": "delta" | "adag" | "dynsgd",
     "num_workers": int, "host": str (default 127.0.0.1),
     "port": int (0 = ephemeral), "port_file": path, "device": "cpu"}

Used by :class:`~.server.ProcessShardFleet`; also runnable by hand for a
fleet over several hosts — the same spec on every host, ``shard_index``
varied.
"""

from __future__ import annotations

import os
import sys
import time


def run_spec(spec_path: str) -> None:
    from ...utils import serde
    from ..servers import (ADAGParameterServer, DeltaParameterServer,
                           DynSGDParameterServer)
    from .plan import ShardPlan
    from .server import ShardFrontend

    classes = {"delta": DeltaParameterServer, "adag": ADAGParameterServer,
               "dynsgd": DynSGDParameterServer}
    with open(spec_path, "rb") as f:
        spec = serde.tree_from_bytes(f.read())
    device = spec.get("device", "cpu")
    if device != "cpu":
        raise ValueError(f"a shard process runs on the host; its spec "
                         f"names device {device!r}")
    center = serde.tree_from_bytes(spec["center_blob"])
    plan = ShardPlan.build(center, int(spec["num_shards"]),
                           epoch=int(spec.get("epoch", 0)))
    i = int(spec["shard_index"])
    ps = classes[spec.get("ps_class", "delta")](
        plan.split(center)[i], num_workers=int(spec.get("num_workers", 1)))
    server = ShardFrontend(ps, plan, i,
                           host=spec.get("host", "127.0.0.1"),
                           port=int(spec.get("port", 0))).start()
    if spec.get("port_file"):
        tmp = spec["port_file"] + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        # atomic: the spawner never reads a half-written port
        os.replace(tmp, spec["port_file"])
    try:
        while True:  # serve until the spawner kills us
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


def main(argv=None) -> int:
    from ...obs import emit
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        emit("usage: python -m distkeras_tpu_torch.ps.shard.shard_main SPEC",
             err=True)
        return 2
    run_spec(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
