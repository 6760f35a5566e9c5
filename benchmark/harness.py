"""What every cell shares: finding a cell's files by name, the benchmark's
spans around calls into the program, the device trace and its reduction,
the weights made from the seed, the comparison against limits, and the
result line.

Nothing here knows a cell, a configuration or a metric by name: the manifest
(``BENCHMARK.json``) names them, and each lives in a file of its own
(``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hex_gym_env_tpu")


class HarnessError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, JAX loaded)."""


# -- files found by name -----------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise HarnessError(f"{path} is missing")
    return load_json(path)


def entry(items: list, name: str, kind: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise HarnessError(f"no {kind} named {name!r} in BENCHMARK.json")


def workload_file(name: str) -> Path:
    return HERE / "workloads" / f"{name}.json"


def driver_file(name: str) -> Path:
    return HERE / "drivers" / f"{name}.py"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def load_module(path: Path, name: str):
    if not path.is_file():
        raise HarnessError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def cell_metrics(man: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it, and those that list no cells."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check_imports() -> None:
    found = forbidden_modules()
    if found:
        raise HarnessError(f"modules that must not be loaded are: {', '.join(found)}")


# -- the run's context ---------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell and its configuration as read from
    their files, the run's arguments, the device, and a directory under
    ``$TMPDIR`` for what the program writes.  ``hook``, where set, gets the
    system under test after it is built (the fault tests plant faults
    through it)."""

    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: object
    run_dir: str
    hook: Optional[Callable] = None

    def log(self, *parts) -> None:
        print(f"[{self.name}]", *parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """A driver's result.  ``end_to_end`` maps metric names to values;
    ``readings`` is what the per-layer readers read; ``checks`` maps each
    compared number to ``(value, limit)``."""

    end_to_end: dict
    readings: "Readings"
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None

    @property
    def correct(self) -> bool:
        return all(within(v, lim) for v, lim in self.checks.values() if lim is not None)


def within(value, limit) -> bool:
    return value is not None and not math.isnan(value) and value <= limit


# -- the per-layer metrics' formulas, each read by a file of metrics/ ------------


def span_ms(r: "Readings", span: str, clock: str = "cuda"):
    """Mean milliseconds of a span's calls outside the profiled part, by its
    CUDA events or (``clock="host"``) by the host clock."""
    calls = (r.cuda_ms if clock == "cuda" else r.host_ms).get(span)
    return sum(calls) / len(calls) if calls else None


def roofline(r: "Readings", span: str):
    """A span's least time (``work.py``) over the device time of the
    kernels launched inside its calls in the profiled part, in percent."""
    calls, device_s = r.traced_calls.get(span), r.device_s.get(span)
    if not calls or not device_s or span not in r.least_s:
        return None
    return 100.0 * r.least_s[span] * calls / device_s


def idle(r: "Readings", kind: str):
    """The device's idle share of a unit (an iteration or a match) of
    ``kind``, in percent: 100 minus the device's busy seconds per unit in
    the profiled part (the union of its kernel, copy and set intervals)
    over the unit's median wall time outside it."""
    if r.kind != kind or r.busy_s is None or not r.traced_units or not r.unit_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.traced_units / r.unit_s)


def mfu(r: "Readings", kind: str):
    """The operations a unit of ``kind`` needs (``work.py``) over its median
    wall time outside the profiled part, as a percent of one H100's float32
    peak."""
    from benchmark import work

    if r.kind != kind or not r.unit_s or not r.unit_flops:
        return None
    return 100.0 * r.unit_flops / r.unit_s / work.PEAK_FLOPS_FP32


def program_span_ms(r: "Readings", kind: str, name: str):
    """Mean milliseconds of the program's own span ``name`` (host clock),
    over the units of ``kind`` played inside the program's tracing."""
    row = (r.program_spans or {}).get(name) if r.kind == kind else None
    return row["total_ms"] / row["calls"] if row and row["calls"] else None


@dataclasses.dataclass
class Readings:
    """What a traced run measured, for the per-layer readers:

    - ``cuda_ms[span]``: CUDA-event milliseconds of each call of a span
      outside the profiled part of the window;
    - ``host_ms[span]``: host-clock milliseconds of those calls;
    - ``device_s[span]``: device seconds of the kernels launched inside the
      span's calls in the profiled part of the window, ``traced_calls[span]``
      how many calls that part holds;
    - ``least_s[span]``: the least time one call could take (``work.py``);
    - ``busy_s`` and ``window_s`` of the profiled part, ``traced_units``
      the iterations or matches it holds;
    - ``unit_flops`` the operations one iteration or match needs
      (``work.py``), ``unit_s`` its median wall time outside the profiled
      part; ``kind`` is "train" or "match";
    - ``program_spans``: the program's own span table (``utils/profiling``
      ``span_table``: calls, total and self milliseconds by span name) over
      units played after the window inside the program's tracing, or
      None."""

    kind: str
    cuda_ms: dict = dataclasses.field(default_factory=dict)
    host_ms: dict = dataclasses.field(default_factory=dict)
    device_s: dict = dataclasses.field(default_factory=dict)
    traced_calls: dict = dataclasses.field(default_factory=dict)
    least_s: dict = dataclasses.field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    traced_units: Optional[int] = None
    unit_flops: Optional[float] = None
    unit_s: Optional[float] = None
    program_spans: Optional[dict] = None


# -- spans around calls into the program -----------------------------------


class Spans:
    """Spans around calls into the program: the host clock always, and on a
    CUDA device a pair of CUDA events and a ``torch.profiler`` range named
    ``bench.<span>``.  ``wrap`` replaces an attribute of an object (an
    instance's method or a callable it holds) and ``unwrap_all`` puts every
    one back.  Each call keeps its host-clock start, so that the readers
    can leave out the calls that ran under the profiler, which slows the
    host."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.calls = collections.defaultdict(list)  # name -> [(start, host ms, events)]
        self._undo = []

    def wrap(self, obj, attr: str, name: str) -> None:
        import torch

        inner = getattr(obj, attr)
        had_own = attr in vars(obj)

        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            events = None
            with torch.profiler.record_function(f"bench.{name}"):
                if self.cuda:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                out = inner(*args, **kwargs)
                if self.cuda:
                    events[1].record()
            self.calls[name].append((t, (time.perf_counter() - t) * 1e3, events))
            return out

        setattr(obj, attr, wrapped)
        self._undo.append((obj, attr, inner if had_own else None))

    def unwrap_all(self) -> None:
        for obj, attr, inner in reversed(self._undo):
            if inner is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, inner)
        self._undo.clear()

    def host_ms(self, after: Optional[float] = None) -> dict:
        """Host-clock milliseconds of each call that started after ``after``."""
        return {k: [ms for t, ms, _ in v if after is None or t > after]
                for k, v in self.calls.items()}

    def cuda_ms(self, after: Optional[float] = None) -> dict:
        """CUDA-event milliseconds of each call that started after ``after``."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        return {k: [ev[0].elapsed_time(ev[1]) for t, _, ev in v
                    if ev is not None and (after is None or t > after)]
                for k, v in self.calls.items()}


def wrap_call(obj, attr: str, before=None, after=None) -> Callable[[], None]:
    """Replace ``obj.attr`` by a call that runs ``before(*args, **kwargs)``,
    the original, then ``after(out)``; returns the function that puts the
    original back."""
    inner = getattr(obj, attr)
    had_own = attr in vars(obj)

    def wrapped(*args, **kwargs):
        if before is not None:
            before(*args, **kwargs)
        out = inner(*args, **kwargs)
        if after is not None:
            after(out)
        return out

    setattr(obj, attr, wrapped)

    def undo():
        if had_own:
            setattr(obj, attr, inner)
        else:
            delattr(obj, attr)

    return undo


# -- the device trace ----------------------------------------------------------


class Trace:
    """``torch.profiler`` over a part of the window, and its reduction: the
    union of the device's busy intervals, each of ``spans``' kernel time (a
    kernel belongs to the span whose range holds the host call that
    launched it), the operations that took most device time, and the idle
    gaps by what the host was doing.  ``stop`` reduces the trace at once and
    lets the profiler go, so that the rest of the window does not carry its
    events (``result``)."""

    DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
    LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
    HOST_CATS = ("cpu_op", "user_annotation", "python_function")
    LABELLED_GAPS = 500  # the longest idle gaps, each labelled by the innermost host op over it

    def __init__(self, run_dir: str, spans: list):
        self.path = os.path.join(run_dir, "trace.json")
        self.spans = spans
        self.prof = self.result = None
        self.t_start = self.t_stop = None

    @staticmethod
    def _profile():
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Profile one small operation, so that the profiler's own start-up
        (CUPTI's) falls in set-up and not in the window."""
        import torch

        with self._profile():
            torch.ones(8, device="cuda").sum().item()

    def after_stop(self, t: float) -> bool:
        """``t`` lies after the profiled part (or nothing was profiled)."""
        return self.t_stop is not None and t > self.t_stop

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if self.prof is not None and self.t_stop is None:
            self.prof.stop()
            self.t_stop = time.perf_counter()
            self.result = self._reduce(self.spans)
            self.prof = None

    def _reduce(self, spans: list) -> dict:
        """``busy_s``, ``window_s``, ``device_s`` and ``calls`` per span,
        and the breakdown."""
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        device, launch_ts, ranges, host = [], {}, collections.defaultdict(list), []
        for e in events:
            cat, ph = e.get("cat", ""), e.get("ph")
            if ph != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in self.DEVICE_CATS:
                device.append((ts, ts + dur, e.get("name", "?"),
                               e.get("args", {}).get("correlation")))
            elif cat in self.LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = ts
            elif cat in self.HOST_CATS:
                name = e.get("name", "?")
                if cat == "user_annotation" and name.startswith("bench."):
                    ranges[name[len("bench."):]].append((ts, ts + dur))
                host.append((ts, ts + dur, name))
        merged = _union((a, b) for a, b, _, _ in device)
        busy_us = sum(b - a for a, b in merged)
        device_s, calls = {}, {}
        for span in spans:
            rs = sorted(ranges.get(span, []))
            calls[span] = len(rs)
            tot = 0.0
            for a, b, _, corr in device:
                t = launch_ts.get(corr)
                if t is not None and _inside(rs, t):
                    tot += b - a
            device_s[span] = tot * 1e-6
        by_name = collections.Counter()
        for a, b, name, _ in device:
            by_name[name] += (b - a) * 1e-6
        gaps = collections.Counter()
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
        holes = sorted(((a1 - b0, 0.5 * (b0 + a1)) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                       reverse=True)[: self.LABELLED_GAPS]
        for length, mid in holes:
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (host[cover[np.argmin(ends[cover] - starts[cover])]][2] if cover.size
                     else "host, outside any op")
            gaps[label] += length * 1e-6
        attributed = sum(1 for _, _, _, c in device if c in launch_ts)
        return {
            "busy_s": busy_us * 1e-6,
            "window_s": self.t_stop - self.t_start,
            "device_s": device_s,
            "calls": calls,
            "device_events": len(device),
            "attributed": attributed,
            "breakdown": {
                "device_ops": [[n, s] for n, s in by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
            },
        }


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(ranges: list, t: float) -> bool:
    import bisect

    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def derive_seed(seed: int, *ids) -> int:
    """A 63-bit seed for the stream ``ids`` under the run's ``seed``."""
    import hashlib

    digest = hashlib.sha256(repr((int(seed),) + ids).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


# -- weights made from the seed --------------------------------------------------


def make_weights(shapes: dict, scales: dict, generator, device, zero: tuple = (),
                 ones: tuple = ()) -> dict:
    """One normal draw on the device for every tensor at once, cut into
    ``shapes`` (name -> shape) and scaled by ``scales`` (name -> std); the
    names in ``zero`` and ``ones`` are filled with those values instead."""
    import torch

    drawn = [k for k in shapes if k not in zero and k not in ones]
    total = sum(math.prod(shapes[k]) for k in drawn)
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k in shapes:
        if k in zero:
            out[k] = torch.zeros(shapes[k], device=device)
        elif k in ones:
            out[k] = torch.ones(shapes[k], device=device)
        else:
            size = math.prod(shapes[k])
            out[k] = flat[at:at + size].reshape(shapes[k]) * scales[k]
            at += size
    return out


# -- the result line ---------------------------------------------------------------


def device_block(outcome: Outcome, trace: bool, chips: int) -> dict:
    import torch

    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
         "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace:
        d["busy_s"] = outcome.busy_s
        d["window_s"] = outcome.window_s
    return d


def checks_block(checks: dict) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def compared(ctx: Context, numbers: dict, limits: dict) -> dict:
    """``(value, limit)`` of the numbers that the cell's workload file gives
    a limit; the others are logged as read and not compared."""
    for k in numbers:
        if k not in limits:
            ctx.log(f"not compared: {k} = {numbers[k]!r}")
    return {k: (numbers[k], limits[k]) for k in numbers if k in limits}
