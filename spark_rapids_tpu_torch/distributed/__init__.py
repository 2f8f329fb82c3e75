"""Multi-process scale-out: a distributed shuffle service with kudo as
the inter-process wire format, byte-compatible with the JAX package's.

Modules:
  * transport: framed kudo streams over TCP/unix sockets with ACK/NAK
    delivery, dedup, and RetryPolicy-driven link retry;
  * service: :class:`ShuffleService`, rank-ordered all-to-all /
    allgather / barrier and the elastic part protocol; plugs into
    ``parallel.exchange`` as the process's table transport;
  * mesh: the process-per-shard harness's mode report (no process
    group until ROADMAP A10(b));
  * runner: distributed q5/q72 workers (the per-query entry points
    are importable for in-process tests);
  * launcher: spawn/babysit N worker processes.
"""

from spark_rapids_tpu_torch.distributed.service import ShuffleService  # noqa: F401
from spark_rapids_tpu_torch.distributed.transport import (  # noqa: F401
    Inbox, Listener, PeerLink, clear_link_faults, set_link_fault)
