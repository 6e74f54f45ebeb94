"""Async parameter-server training across processes on several hosts —
the place of ``distkeras_tpu.ps.cluster`` in the port.

The JAX module forms its process group with ``jax.distributed`` and
broadcasts the trained center with ``jax.experimental.multihost_utils``:
multi-host ground, which the port takes up with the rest of its
parallelism beyond one card.  Until then :func:`run_cluster_async_training`
raises, naming where it is planned.
"""

from __future__ import annotations

from typing import Tuple

#: where the multi-host async runner is ported
CLUSTER_ITEM = ("ROADMAP Queue 1 item 8 (parallelism beyond one card: "
                "ps/cluster.py, multi-host)")


def run_cluster_async_training(trainer, dataset,
                               ps_address: Tuple[str, int],
                               fault_injector=None):
    """One async worker per process of a multi-host group, the PS on
    process 0: not ported yet."""
    raise NotImplementedError(
        f"run_cluster_async_training (async training across the processes "
        f"of a multi-host group) is not ported yet: {CLUSTER_ITEM}")
