"""Asynchronous parameter server — the port of ``distkeras_tpu.ps``.

The sync engine (``parallel.sync``) is the synchronous limit of each
algorithm: staleness is identically zero.  The reference's defining
behaviors — true asynchrony, per-commit update rules, DynSGD's staleness
scaling — need a real shared center variable that workers hit at their
own pace.  This package provides it: a host-side TCP parameter server
(star topology, mutex-guarded commits, per-connection threads —
structurally the reference's ``distkeras/parameter_servers.py`` +
``distkeras/networking.py``) speaking the JAX package's length-prefixed
**msgpack** wire byte for byte, with workers running the window loop on
the card between pulls and commits.  ``ps.shard`` partitions the center
across a fleet of shard servers with consistent-cut pulls.
``ps.cluster`` runs one async worker per process of a
``torch.distributed`` group, the PS on process 0.
"""

from .networking import (  # noqa: F401
    WIRE_VERSION,
    connect,
    determine_host_address,
    pack_msg,
    recv_msg,
    send_msg,
    send_packed,
)
from .codecs import Codec, decode_tree, get_codec  # noqa: F401
from .servers import (  # noqa: F401
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServer,
    SocketParameterServer,
)
from .client import PSClient, WorkerEvicted  # noqa: F401
