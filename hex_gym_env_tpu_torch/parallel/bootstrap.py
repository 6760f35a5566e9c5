"""Multi-process runtime bootstrap on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/bootstrap.py``.  One call
to ``init_distributed`` per process joins the process group; every process
then runs the same program (``parallel/distributed.py``), and host-side
side effects such as metrics and checkpoints are written by rank 0 only.

Typical use in each process::

    from hex_gym_env_tpu_torch.parallel import bootstrap, make_mesh
    bootstrap.init_distributed()           # torchrun's environment, or a no-op
    mesh = make_mesh()                     # this rank's device and the group
    ...DistributedSelfplayPPO(cfg, mesh)...

Started by ``torchrun``, every argument comes from its environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
Without it, pass the coordinator's ``host:port``, the number of processes
and this process's rank explicitly (tests and the graft entry's dry run).
The backend is ``nccl`` for CUDA devices and ``gloo`` for the CPU.
"""

from __future__ import annotations

import os
import signal
import socket
import time
from typing import Callable, Optional

import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> bool:
    """Join the process group; returns True when one is initialized.

    An explicit ``coordinator_address`` (``host:port`` or ``tcp://host:port``)
    initializes a TCP-store group of ``num_processes`` with this process as
    ``process_id``, and its failures propagate.  With no arguments, torchrun's
    environment initializes the group where one of its variables is set;
    with none set this is a no-op that returns False, as in the JAX package.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        address = coordinator_address
        if not address.startswith("tcp://"):
            address = f"tcp://{address}"
        dist.init_process_group(backend, init_method=address, world_size=num_processes,
                                rank=process_id)
        return True
    if not any(v in os.environ for v in TORCHRUN_VARS):
        return False
    dist.init_process_group(backend, init_method="env://")
    return True


def local_rank() -> int:
    """This process's index among those on its host: torchrun's
    ``LOCAL_RANK``, else the group rank (one host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, n: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes (``spawn`` start
    method) and wait for them; raises where a rank fails or the run outlasts
    ``timeout`` seconds, killing any rank still running by its PID."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGKILL)


def is_main_process() -> bool:
    """True unless ``torch.distributed`` is initialized with a rank other
    than 0."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
