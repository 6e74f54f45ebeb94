"""Online inference serving on the port: the continuous-batching decode
service and its fleet (the port of ``distkeras_tpu.serve``).

* ``config``  — ``ServeConfig``: batch slots, prefill length buckets,
  sampling controls, admission bounds, the decode accelerators.
* ``engine``  — ``DecodeEngine``: the scheduler/batcher (join = prefill +
  row write into a slot, warm join over the prefix cache, step = one
  token — or a speculative window — for every active slot), each
  program behind its own retrace sentinel.
* ``prefix`` / ``spec`` — the prefix KV cache and speculative decoding.
* ``server``  — ``ServeServer``: TCP front-end speaking the PS wire
  framing with v1/v2 negotiation.
* ``client``  — ``ServeClient``: the caller-side connection.
* ``router``  — ``ServeRouter``: the engine-fleet front door —
  prefix-affinity + least-loaded routing, fleet-merged stats, fan-out
  ``promote`` with roll-forward, evict/requeue/rejoin, and the KV fabric
  (``kvfabric``) moving cached prefix KV between engines.
"""

from .config import ServeConfig  # noqa: F401
from .engine import DecodeEngine, ServeRejected, ServeRequest  # noqa: F401
from .server import ServeServer  # noqa: F401
from .client import ServeClient  # noqa: F401
from .router import RouterConfig, ServeRouter  # noqa: F401
