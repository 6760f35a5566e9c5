"""Profiling harness: steady-state timing, ``torch.profiler`` traces, and
the program's own spans and counters.

The counterpart of the JAX package's ``utils/profiling.py``.  ``time_fn``
times a callable to completion (it synchronises the CUDA device, where
there is one, after the warm-up and after every call), ``trace`` records a
CPU + CUDA profile and writes a Chrome trace.  ``phase_split`` reads a
kernel's phase clock: the ``clock64`` stamps that K4 and K6 write, when
given a ``timers`` buffer, at the start of each step and at the end of each
phase.

Spans name the parts of a call (``with span("match.ply"): ...``).  Off,
the default, a span is one shared no-op object: no clock is read and
nothing is kept, except that a span opened while a ``torch.profiler``
session records marks the trace with a range ``hex.<name>``.  Inside
``tracing(True)`` (``trace`` turns it on for its block) each span also
keeps a ``Span`` record in memory, on ``time.perf_counter_ns``, with the
index of the span open around it and the id of its unit (given to the root
span, e.g. a match's number); ``take_spans`` hands the records out and
clears them.  Spans are for one thread.

Counters are always on: ``count(name, n)`` adds to the module's
``counters`` dict and ``take_counters`` returns it and zeroes it.  The
kernels' launches count there as ``launch.<kernel>`` (``ops/cuda_lib``);
``to_device`` counts ``h2d_bytes`` and ``h2d_copies`` of a copy from the
CPU to the card, and ``to_host`` counts ``host_syncs`` of a copy from the
card, each around the same ``.to``/``.cpu()`` as the code would make.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
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
    """Profile the block (CPU, and CUDA where present) with the spans on,
    and write ``logdir/trace.json``, a Chrome trace in which each span is a
    ``hex.<name>`` range: ``with trace("log/profile"): step()``.  The spans'
    records stay for ``take_spans``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(True), profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# -- spans ---------------------------------------------------------------------

_on = False
_records: list = []  # Span records in start order
_open: list = []  # indices into _records of the open spans, innermost last
_OFF = contextlib.nullcontext()
# a torch.profiler session records while ``_autograd_profiler._is_profiler_enabled``


class Span:
    """One span's record: ``name``; ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``; ``parent``, the index (in the same list) of
    the span open around it, or None; ``unit``, the id its root span was
    given, or None."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "unit")

    def __init__(self, name: str, parent: Optional[int], unit):
        self.name, self.parent, self.unit = name, parent, unit
        self.start_ns = self.end_ns = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Kept:
    """An open span while tracing is on: its record, and its profiler range
    where a session records."""

    __slots__ = ("name", "unit", "index", "range")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self) -> Span:
        parent = _open[-1] if _open else None
        unit = self.unit if self.unit is not None or parent is None else _records[parent].unit
        rec = Span(self.name, parent, unit)
        self.index = len(_records)
        _records.append(rec)
        _open.append(self.index)
        self.range = (record_function("hex." + self.name)
                      if _autograd_profiler._is_profiler_enabled else None)
        if self.range is not None:
            self.range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        _records[self.index].end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.pop()
        return False


def span(name: str, unit=None):
    """A context manager that names the block ``name``; ``unit`` is the id of
    a root span's unit (its children take their root's).  See the module's
    docstring for what it costs off and what it keeps on."""
    if _on:
        return _Kept(name, unit)
    if _autograd_profiler._is_profiler_enabled:
        return record_function("hex." + name)
    return _OFF


@contextlib.contextmanager
def tracing(on: bool = True) -> Iterator[None]:
    """Spans keep their records inside the block (``on``) or not; the switch
    as it was comes back after it."""
    global _on
    was, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = was


def take_spans() -> list:
    """The records kept since the last call, in start order, and clear them.
    Call it with no span open: a parent is an index into this list."""
    if _open:
        raise RuntimeError(f"take_spans with {len(_open)} span(s) open")
    out = list(_records)
    _records.clear()
    return out


def self_ms(records: Sequence[Span]) -> list:
    """Each record's milliseconds less its children's (which, on one thread,
    never overlap)."""
    out = [r.ms for r in records]
    for r in records:
        if r.parent is not None:
            out[r.parent] -= r.ms
    return out


def span_table(records: Sequence[Span]) -> dict:
    """``{name: {"calls", "total_ms", "self_ms"}}`` of ``records``, in order
    of first start."""
    table: dict = {}
    for r, own in zip(records, self_ms(records)):
        row = table.setdefault(r.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["calls"] += 1
        row["total_ms"] += r.ms
        row["self_ms"] += own
    return table


# -- counters ------------------------------------------------------------------

counters: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    counters[name] = counters.get(name, 0) + n


def take_counters() -> dict:
    """A snapshot of the counters, which are then zeroed."""
    out = dict(counters)
    counters.clear()
    return out


def to_device(t: torch.Tensor, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``t.to(device=device, dtype=dtype)``, counting ``h2d_bytes`` (``t``'s)
    and ``h2d_copies`` where it copies a CPU tensor to a CUDA device."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        count("h2d_bytes", t.numel() * t.element_size())
        count("h2d_copies")
    return t.to(device=device, dtype=dtype)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counting ``host_syncs`` where ``t`` is on a CUDA device
    (the host waits for the copy)."""
    if t.is_cuda:
        count("host_syncs")
    return t.cpu()


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
