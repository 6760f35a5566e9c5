"""The data-parallel layout: one process per device, a batch axis over them.

The counterpart of the JAX package's ``parallel/mesh.py``.  Where JAX names
a device mesh with a ``data`` axis, here a ``Mesh`` names the process group
(one process per device), this process's rank in it and its device: the
environment batch is split over the ranks along ``DATA_AXIS``, and
parameters, optimizer state and the opponent bank are replicated.

Every collective of the data-parallel path is an ``all_reduce`` or a
``broadcast``, so one code runs over NCCL and over gloo with CUDA tensors
(gloo's CUDA support has both, but not ``all_gather`` in every build).  A
gather is an ``all_reduce`` SUM of slices padded with zeros: each element
is one rank's value plus zeros, which is that value bit for bit (floats are
padded with -0.0, the exact identity of float addition, so a -0.0 survives
too; bools travel as uint8).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from hex_gym_env_tpu_torch.parallel.bootstrap import local_rank
from hex_gym_env_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group.  ``group`` is None
    when no process group is initialized (one process, no collective).
    ``issued`` counts the collectives this mesh has issued, by kind."""

    world_size: int
    rank: int
    device: torch.device
    group: Any = None
    issued: dict = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "broadcast": 0}, compare=False)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (bools as uint8)."""
        if self.group is not None:
            dist.all_reduce(_wire(t), op=dist.ReduceOp.SUM, group=self.group)
            self.issued["all_reduce"] += 1
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        if self.group is not None:
            dist.broadcast(_wire(t), src=0, group=self.group)
            self.issued["broadcast"] += 1
        return t

    def barrier(self) -> None:
        """Wait for every rank: an ``all_reduce`` of one element on the
        mesh's device (NCCL has no CPU tensors)."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def gather_rows(self, x: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) tensor whose rows ``rows`` are this rank's ``x``,
        every rank's rows filled in, exactly: an ``all_reduce`` SUM of
        zero-padded slices.  Each row must come from exactly one rank."""
        out = torch.full((n,) + tuple(x.shape[1:]), _pad(x.dtype), dtype=x.dtype,
                         device=x.device)
        out[rows.to(x.device)] = x
        return self.all_reduce(out)


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _pad(dtype: torch.dtype):
    return -0.0 if dtype.is_floating_point else 0


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialized process group, or of this process alone
    when none is initialized.  ``device=None`` means ``cuda:LOCAL_RANK``
    (which must exist) and makes it the current CUDA device; pass
    ``device="cpu"`` for gloo on the CPU."""
    dev = torch.device("cuda", local_rank()) if device is None else torch.device(device)
    if dev.type == "cuda":
        resolve_device(None)  # raises where no CUDA device exists
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        return Mesh(world_size=1, rank=0, device=dev)
    return Mesh(world_size=dist.get_world_size(), rank=dist.get_rank(), device=dev,
                group=dist.group.WORLD)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dataclasses, dicts, tuples and
    NamedTuples; other leaves (ints, generators) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a leading axis of ``n``, which must divide over
    the ranks."""
    if n % mesh.world_size:
        raise ValueError(f"a leading axis of {n} does not divide over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch_tree(tree, mesh: Mesh):
    """Every tensor's leading axis cut to this rank's rows."""
    return tree_map(lambda x: x[local_rows(x.shape[0], mesh)], tree)


def gather_batch_tree(tree, mesh: Mesh):
    """The inverse of ``shard_batch_tree``: every rank's rows of each
    tensor, concatenated in rank order on every rank (``Mesh.gather_rows``)."""
    def gather(x):
        n = x.shape[0] * mesh.world_size
        rows = torch.arange(n)[local_rows(n, mesh)]
        return mesh.gather_rows(x, rows, n)

    return tree_map(gather, tree)


def replicate_tree(tree, mesh: Mesh):
    """Every tensor set to rank 0's value on every rank (a broadcast each)."""
    return tree_map(lambda x: mesh.broadcast(x.clone()), tree)
