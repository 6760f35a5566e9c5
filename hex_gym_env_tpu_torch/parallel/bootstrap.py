"""Multi-process runtime bootstrap.

The counterpart of the JAX package's ``parallel/bootstrap.py``.  A
multi-process run initializes ``torch.distributed`` itself (address, world
size and rank given explicitly); every process runs the same program, and
host-side side effects such as metrics are written by rank 0 only.
"""

from __future__ import annotations

import torch.distributed as dist


def is_main_process() -> bool:
    """True unless ``torch.distributed`` is initialized with a rank other
    than 0."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
