"""Profiling harness: steady-state timing and ``torch.profiler`` traces.

The counterpart of the JAX package's ``utils/profiling.py``.  ``time_fn``
times a callable to completion (it synchronises the CUDA device, where
there is one, after the warm-up and after every call), ``trace`` records a
CPU + CUDA profile and writes a Chrome trace, and ``annotate`` names a
region in that timeline.  ``phase_split`` reads a kernel's phase clock:
the ``clock64`` stamps that K4 and K6 write, when given a ``timers``
buffer, at the start of each step and at the end of each phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
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


def phase_split(stamps, names: Sequence[str], total_ms: Optional[float] = None) -> list[dict]:
    """Per-phase split of a kernel's phase clock.

    ``stamps`` is (units, steps, len(names) + 1): for each CTA (or game) and
    step, the clock at the step's start and at the end of each phase.  The
    clock is per unit (an SM's ``clock64``), so only differences within one
    unit are taken: the units' rows may come in any order and with any
    offset.  A stamp earlier than the one before it in the same unit raises.

    Returns one dict per phase: ``median`` and ``max`` over the units of the
    phase's clocks per step, and ``share``, its median over the sum of the
    medians.  With ``total_ms``, the wall time of the timed call, each also
    gets ``median_us`` and ``max_us``: clocks are turned into time at the
    rate that the median unit's first-to-last span over ``total_ms`` gives.
    """
    st = np.asarray(stamps, dtype=np.int64)
    if st.ndim != 3 or st.shape[2] != len(names) + 1:
        raise ValueError(f"stamps must be (units, steps, {len(names) + 1}), got {st.shape}")
    dur = np.diff(st, axis=2)
    if (dur < 0).any():
        unit, step, k = np.argwhere(dur < 0)[0]
        raise ValueError(f"unit {unit} step {step}: phase {names[k]!r} ends before it starts")
    per_step = dur.sum(axis=1) / st.shape[1]  # (units, phases)
    med = np.median(per_step, axis=0)
    top = per_step.max(axis=0)
    total = med.sum()
    rows = [
        {"name": name, "median": float(med[k]), "max": float(top[k]),
         "share": float(med[k] / total) if total > 0 else 0.0}
        for k, name in enumerate(names)
    ]
    if total_ms is not None:
        span = np.median(st[:, -1, -1] - st[:, 0, 0])
        per_us = span / (total_ms * 1e3)
        for row in rows:
            row["median_us"] = row["median"] / per_us
            row["max_us"] = row["max"] / per_us
    return rows


def format_split(rows: list[dict]) -> str:
    """One line of a ``phase_split``: name, median (max) per step, share."""
    unit = "us" if "median_us" in rows[0] else ""
    key = "median_us" if unit else "median"
    top = "max_us" if unit else "max"
    return "; ".join(
        f"{r['name']} {r[key]:.3f} ({r[top]:.3f}){unit} {100 * r['share']:.1f}%" for r in rows
    )
