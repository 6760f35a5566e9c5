"""Profiling harness: steady-state timing and ``torch.profiler`` traces.

The counterpart of the JAX package's ``utils/profiling.py``.  ``time_fn``
times a callable to completion (it synchronises the CUDA device, where
there is one, after the warm-up and after every call), ``trace`` records a
CPU + CUDA profile and writes a Chrome trace, and ``annotate`` names a
region in that timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, repeats: int = 5) -> dict:
    """Seconds per call of ``fn(*args)`` in the steady state.

    Every call is waited for, so the figure includes one host round trip
    per call; time a multi-step call to amortise it."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
        _sync()
    dt = (time.perf_counter() - t0) / repeats
    return {"seconds_per_call": dt, "calls_per_s": 1.0 / dt}


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the block (CPU, and CUDA where present) and write
    ``logdir/trace.json``, a Chrome trace: ``with trace("log/profile"): step()``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return record_function(name)
