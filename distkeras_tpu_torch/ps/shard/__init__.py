"""Sharded parameter server — the port of ``distkeras_tpu.ps.shard``:
the center tree partitioned across a fleet of single-shard servers (each
with its own lock, accept loop, pull cache, codec state and registry),
with **consistent-cut pulls** so a worker never trains on a half-applied
center.

* :class:`ShardPlan` — deterministic per-tensor placement, its digest
  the JAX package's for the same tree, checked between workers and
  shards in the ``hello`` negotiation.
* :class:`ShardedParameterServer` — hosts N shards in this process;
  supervisor-facing facade (evict, respawn and join fan out; a dead shard
  is a named fatal error).  :class:`ProcessShardFleet` runs one process
  per shard.
* :class:`ShardedPSClient` — the ``PSClient`` surface over pipelined
  fan-out; pulls retry lagging shards until the per-worker commit-count
  version vectors agree across the fleet.
"""

from .plan import ShardPlan  # noqa: F401
from .server import (  # noqa: F401
    ProcessShardFleet,
    ShardedParameterServer,
    ShardFleetError,
    ShardFrontend,
)
from .client import (  # noqa: F401
    ConsistentCutError,
    ShardedPSClient,
    ShardPlanMismatch,
    merge_fleet_stats,
)
