"""Multi-process scale-out: process groups for the SPMD mesh programs,
and a distributed shuffle service with kudo as
the inter-process wire format, byte-compatible with the JAX package's.

Modules:
  * transport: framed kudo streams over TCP/unix sockets with ACK/NAK
    delivery, dedup, and RetryPolicy-driven link retry;
  * service: :class:`ShuffleService`, rank-ordered all-to-all /
    allgather / barrier and the elastic part protocol; plugs into
    ``parallel.exchange`` as the process's table transport;
  * mesh: process groups (``Mesh``, ``form_group``) for the SPMD mesh
    programs, and the runner's mesh attempt (``try_form_mesh``);
  * pool: ``RankPool``, rank processes in one group that run what a
    single-process caller sends them;
  * dryrun: the hash aggregate and the distributed join over R gloo
    CPU ranks (``python -m spark_rapids_tpu_torch.distributed.dryrun``);
  * runner: distributed q5/q72 workers (the per-query entry points
    are importable for in-process tests);
  * launcher: spawn/babysit N worker processes.
"""

from spark_rapids_tpu_torch.distributed.service import ShuffleService  # noqa: F401
from spark_rapids_tpu_torch.distributed.transport import (  # noqa: F401
    Inbox, Listener, PeerLink, clear_link_faults, set_link_fault)
