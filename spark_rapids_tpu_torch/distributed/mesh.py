"""Process groups: the port's device mesh.

The JAX package runs a mesh program as ONE controller over many
devices: columns stay device arrays and move by ``lax.all_to_all`` /
``lax.psum`` inside ``shard_map``.  The port runs the same program as
SPMD over a ``torch.distributed`` process group: one process per rank,
``all_to_all_single`` for the exchange, ``all_reduce`` for each psum.
A :class:`Mesh` is one rank's handle on its group; the factories that
take a ``jax.sharding.Mesh`` in the JAX package take one of these, and
each rank calls the returned step with its own contiguous shard of the
sharded inputs (``P(axis)`` gives rank r rows ``[r n/R, (r+1) n/R)``)
and the replicated inputs whole.

Backends: NCCL when every rank owns its own GPU, gloo on the CPU and
for ranks that share one card (gloo runs its collectives on CUDA
tensors itself, through the host).  A caller that asks for NCCL with
ranks sharing a card gets NCCL's own error.

:func:`try_form_mesh` is the distributed runner's attempt, behind
``SPARK_RAPIDS_TPU_DIST_MESH``:
  * ``0`` (default): don't attempt; harness mode (every rank computes
    its shard locally and all cross-rank tables ride the kudo shuffle
    service);
  * ``auto``/``1``: try ``init_process_group`` against the
    coordinator with a bounded timeout; any failure falls back to
    harness mode and says why.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch


def mesh_mode() -> str:
    v = os.environ.get("SPARK_RAPIDS_TPU_DIST_MESH", "0").lower()
    return "attempt" if v in ("1", "auto", "true") else "harness"


def _local_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class MeshStats:
    """What one rank's eager collectives moved: calls, and the bytes
    this rank sent through ``all_to_all``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.all_to_all = 0
        self.all_to_all_bytes = 0
        self.all_reduce = 0

    def as_dict(self) -> dict:
        return {"all_to_all": self.all_to_all,
                "all_to_all_bytes": self.all_to_all_bytes,
                "all_reduce": self.all_reduce}


class Mesh:
    """One rank's handle on a process group of ``size`` ranks.

    ``device`` is where this rank's tensors live (``cuda:<local rank>``
    or ``cpu``); ``backend`` is the group's (``nccl`` or ``gloo``).
    The collectives count themselves in ``stats`` when run eagerly; a
    compiled program counts its own (plan/catalog._mesh_program)."""

    def __init__(self, group, rank: int, size: int, device, backend: str):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.stats = MeshStats()

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    # ------------------------------------------------------ sharding

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a sharded input (``P(axis)``
        on axis 0); the rows must split evenly, as shard_map needs."""
        rows = int(x.shape[0])
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split evenly over "
                             f"{self.size} ranks")
        per = rows // self.size
        return x[self.rank * per:(self.rank + 1) * per]

    # ---------------------------------------------------- collectives

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(split_axis=0, concat_axis=0)``: block j of
        axis 0 goes to rank j, and block i of the result came from rank
        i (equal splits).  Booleans travel as uint8."""
        import torch.distributed as dist
        if x.shape[0] % self.size:
            raise ValueError(f"axis 0 of {tuple(x.shape)} does not split "
                             f"into {self.size} blocks")
        is_bool = x.dtype == torch.bool
        send = (x.to(torch.uint8) if is_bool else x).contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        self.stats.all_to_all += 1
        self.stats.all_to_all_bytes += send.numel() * send.element_size()
        return out.to(torch.bool) if is_bool else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum over ranks, on every rank.  Under
        torch.compile a functional collective, which traces into the
        graph (an in-place ``dist.all_reduce`` would break it); eagerly
        ``dist.all_reduce`` on a copy (the functional form's first call
        imports torch.distributed's tensor and FSDP modules, seconds)."""
        import torch.distributed as dist
        if torch.compiler.is_compiling():
            from torch.distributed import _functional_collectives as fc
            return fc.all_reduce(x, "sum", self.group)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        self.stats.all_reduce += 1
        return out

    def pany(self, b: torch.Tensor) -> torch.Tensor:
        """Any over ranks of a boolean: an int32 psum, then ``> 0``."""
        return self.psum(b.to(torch.int32)) > 0

    def agree(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any (an int32
        all_reduce MAX; a group of one rank answers alone)."""
        if self.size == 1:
            return bool(flag)
        return bool(self.pmax(torch.tensor(
            [int(bool(flag))], dtype=torch.int32, device=self.device)))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ranks (eager only)."""
        import torch.distributed as dist
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        self.stats.all_reduce += 1
        return out


def default_backend(device, world: int) -> str:
    """NCCL when every rank can own a GPU, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and world <= _local_devices():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: ``cuda:<rank mod cards>`` for ``cuda`` (ranks
    share cards when there are fewer cards than ranks), else as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % max(1, _local_devices()))
    return device


def form_group(rank: int, world: int, init_method: str, *,
               device, backend: Optional[str] = None,
               timeout_s: float = 60.0) -> Mesh:
    """Join the default process group of ``world`` ranks at
    ``init_method`` (a ``file://`` store, or the launcher's
    ``tcp://host:port``) and return this rank's :class:`Mesh` on
    ``device`` (``cuda``, a card, or ``cpu``: asked for, never
    assumed).
    ``timeout_s`` bounds the rendezvous and every collective.  The
    backend defaults to :func:`default_backend`; an explicit one is
    used as asked."""
    import torch.distributed as dist
    dev = rank_device(device, rank)
    backend = backend or default_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(dist.group.WORLD, rank, world, dev, backend)


def leave_group() -> None:
    """Destroy this process's default group, if it has one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def try_form_mesh(rank: int, world: int,
                  coordinator: Optional[str] = None,
                  timeout_s: float = 10.0, *, device=None) -> dict:
    """The distributed runner's mesh attempt; never raises.  Returns
    ``{"mode": "mesh"|"harness", "detail": str, "local_devices": n,
    "backend": str or None}`` (``local_devices``: CUDA devices this
    process sees).  In harness mode callers shard and reduce through
    the shuffle service; in mesh mode the process also holds the
    default group (``backend`` names it)."""
    local = _local_devices()
    if mesh_mode() != "attempt":
        return {"mode": "harness",
                "detail": "mesh attempt disabled "
                          "(SPARK_RAPIDS_TPU_DIST_MESH=0)",
                "local_devices": local, "backend": None}
    if coordinator is None:
        return {"mode": "harness", "detail": "no coordinator address",
                "local_devices": local, "backend": None}
    if device is None:
        device = "cuda" if local else "cpu"
    try:
        mesh = form_group(rank, world, coordinator, device=device,
                          timeout_s=max(1.0, timeout_s))
        return {"mode": "mesh",
                "detail": f"{world} ranks over {mesh.backend} on "
                          f"{mesh.device.type}",
                "local_devices": local, "backend": mesh.backend}
    except Exception as e:  # noqa: BLE001 — degradation is the contract
        return {"mode": "harness",
                "detail": f"mesh init failed: "
                          f"{type(e).__name__}: {e}",
                "local_devices": local, "backend": None}
