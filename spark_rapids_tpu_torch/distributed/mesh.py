"""Process-group formation: the process-per-shard harness.

The JAX package may try a genuine multi-process ``jax.distributed``
mesh here (behind ``SPARK_RAPIDS_TPU_DIST_MESH``).  The port runs in
the harness only: every rank computes its shard locally, and ALL
cross-rank table movement rides the kudo shuffle service (the contract
under test: shuffle bytes cross the process boundary however the local
step was run).  No caller uses a process group yet; the fixed-capacity
collective exchange that would is ROADMAP A10(b), which brings the
group in.
"""

from __future__ import annotations

from typing import Optional


def mesh_mode() -> str:
    return "harness"


def _local_devices() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def try_form_mesh(rank: int, world: int,
                  coordinator: Optional[str] = None,
                  timeout_s: float = 10.0) -> dict:
    """The JAX package's signature; never raises.  Returns
    ``{"mode": "harness", "detail": str, "local_devices": n}``
    (``local_devices``: CUDA devices this process sees): callers shard
    and reduce through the shuffle service."""
    return {"mode": "harness",
            "detail": "process-per-shard harness (no process group)",
            "local_devices": _local_devices()}
