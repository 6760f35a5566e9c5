"""The program's spans and counters (``utils/profiling``): nesting, parents,
units and self time; the shared no-op object when off; what ``take_spans``
and ``take_counters`` clear; the ``hex.*`` ranges in a profiler's trace;
the launch counts read through the registry; and ``scripts/match.run_match``
instrumented on the CPU, with the same play whether tracing is on or off."""

import json
import sys

import pytest
import torch

from hex_gym_env_tpu_torch.models.loading import agent_path
from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.scripts import match
from hex_gym_env_tpu_torch.utils import profiling

AGENT5 = f"params:{agent_path(5)}"
PLY_SPANS = ("ply.observe", "ply.forward", "ply.pick", "ply.step")


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts and ends with no records and zeroed counters, on one
    torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_spans()
    profiling.take_counters()
    yield
    profiling.take_spans()
    profiling.take_counters()
    torch.set_num_threads(n)


def _play(record=None, **kw):
    return match.run_match(5, 8, AGENT5, AGENT5, seed=3, mode="stochastic", device="cpu",
                           record=record, **kw)


def test_spans_nest_with_parents_units_and_order():
    with profiling.tracing(True):
        with profiling.span("root", unit=7) as root:
            with profiling.span("a"):
                with profiling.span("a.x"):
                    pass
            with profiling.span("b"):
                pass
        with profiling.span("loose"):
            pass
    recs = profiling.take_spans()
    assert [r.name for r in recs] == ["root", "a", "a.x", "b", "loose"]
    assert [r.parent for r in recs] == [None, 0, 1, 0, None]
    assert [r.unit for r in recs] == [7, 7, 7, 7, None]
    assert recs[0] is root
    for r in recs:
        assert r.end_ns >= r.start_ns > 0
    for r in recs[1:4]:
        parent = recs[r.parent]
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    assert recs[1].end_ns <= recs[3].start_ns


def test_self_time_is_duration_less_the_children():
    def rec(name, start, end, parent):
        r = profiling.Span(name, parent, 0)
        r.start_ns, r.end_ns = start, end
        return r

    recs = [rec("root", 0, 10_000_000, None), rec("a", 1_000_000, 4_000_000, 0),
            rec("a.x", 2_000_000, 2_500_000, 1), rec("b", 5_000_000, 9_000_000, 0)]
    assert profiling.self_ms(recs) == pytest.approx([3.0, 2.5, 0.5, 4.0])
    table = profiling.span_table(recs + [rec("b", 20_000_000, 21_000_000, None)])
    assert list(table) == ["root", "a", "a.x", "b"]
    assert table["b"] == {"calls": 2, "total_ms": pytest.approx(5.0),
                          "self_ms": pytest.approx(5.0)}
    assert table["root"]["self_ms"] == pytest.approx(3.0)


def test_off_returns_one_shared_no_op_and_keeps_nothing():
    first = profiling.span("x")
    assert profiling.span("y", unit=3) is first
    with first as got, profiling.span("z"):
        assert got is None
    assert profiling.take_spans() == []
    with profiling.tracing(True):
        assert profiling.span("x") is not first
        with profiling.tracing(False):
            assert profiling.span("x") is first
    assert profiling.span("x") is first


def test_take_spans_and_take_counters_clear_what_they_return():
    with profiling.tracing(True), profiling.span("s"):
        pass
    profiling.count("c")
    profiling.count("c", 4)
    assert [r.name for r in profiling.take_spans()] == ["s"]
    assert profiling.take_spans() == []
    assert profiling.take_counters() == {"c": 5}
    assert profiling.take_counters() == {} and profiling.counters == {}


def test_take_spans_refuses_an_open_span():
    with profiling.tracing(True), profiling.span("open"):
        with pytest.raises(RuntimeError, match="open"):
            profiling.take_spans()


def test_launches_read_through_the_registry():
    assert dict(cuda_lib.launches) == {k: 0 for k in cuda_lib.KERNELS}
    profiling.count("launch.k1_step", 3)
    profiling.count("launch.k2_agent")
    assert cuda_lib.launches["k1_step"] == 3 and cuda_lib.launches["k2_agent"] == 1
    assert dict(cuda_lib.launches)["k1_step"] == 3 and len(cuda_lib.launches) == len(
        cuda_lib.KERNELS)
    with pytest.raises(KeyError):
        cuda_lib.launches["no_such_kernel"]
    profiling.count("other")
    cuda_lib.reset_launches()
    assert dict(cuda_lib.launches) == {k: 0 for k in cuda_lib.KERNELS}
    assert profiling.counters == {"other": 1}


class _Fake:
    """A stand-in for a tensor on a CUDA device or the CPU, to count copies
    on a machine without a card."""

    def __init__(self, kind, numel=6, element_size=4):
        self.device = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
        self.is_cuda = kind == "cuda"
        self._n, self._e = numel, element_size
        self.calls = []

    def numel(self):
        return self._n

    def element_size(self):
        return self._e

    def to(self, **kw):
        self.calls.append(("to", kw))
        return self

    def cpu(self):
        self.calls.append(("cpu",))
        return self


def test_copies_count_bytes_and_syncs_only_across_the_bus():
    t = _Fake("cpu", numel=6, element_size=4)
    assert profiling.to_device(t, "cuda", torch.float32) is t
    assert t.calls == [("to", {"device": "cuda", "dtype": torch.float32})]
    profiling.to_device(_Fake("cpu", numel=10, element_size=1), torch.device("cuda"))
    profiling.to_device(_Fake("cuda"), "cuda")
    profiling.to_device(_Fake("cpu"), "cpu")
    g = _Fake("cuda")
    assert profiling.to_host(g) is g and g.calls == [("cpu",)]
    profiling.to_host(_Fake("cpu"))
    assert profiling.take_counters() == {"h2d_bytes": 34, "h2d_copies": 2, "host_syncs": 1}


def test_copy_helpers_give_the_same_tensors():
    x = torch.randn(5, 3, dtype=torch.float64)
    for dtype in (None, torch.float32):
        want = x.to(device="cpu", dtype=dtype)
        got = profiling.to_device(x, "cpu", dtype)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(profiling.to_host(x), x.cpu())
    assert profiling.take_counters() == {}


def test_spans_mark_the_trace_and_enclose_a_plys_ops(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        _play()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("hex."):
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert len(ranges["hex.match"]) == 1 and len(ranges["hex.match.load"]) == 2
    assert len(ranges["hex.match.ply"]) == 26 and len(ranges["hex.ply.forward"]) == 52
    plies = sorted(ranges["hex.match.ply"])
    forwards = sorted(ranges["hex.ply.forward"])
    ops = [(e["ts"], e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]

    def inside(rs, t):
        return any(a <= t <= b for a, b in rs)

    for a, b in plies:
        assert any(a <= t <= b for t, _ in ops)
    linear = [t for t, name in ops if name in ("aten::linear", "aten::addmm")]
    assert len(linear) >= 52 * 3
    assert all(inside(forwards, t) and inside(plies, t) for t in linear)
    # the records kept by the trace's switch match the ranges one for one
    recs = profiling.take_spans()
    assert sum(r.name == "match.ply" for r in recs) == 26


def test_spans_off_still_mark_a_running_profiler(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("region"):
            torch.ones(8).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    assert "hex.region" in path.read_text()
    assert profiling.take_spans() == []


def test_run_match_spans_and_counters_on_the_cpu():
    with profiling.tracing(True):
        _play()
    recs = profiling.take_spans()
    names = [r.name for r in recs]
    want = {"match": 1, "match.load": 2, "load.template": 2, "load.read": 2, "load.h2d": 2,
            "match.bind": 2, "match.ply": 26, "ply.observe": 26, "ply.forward": 52,
            "ply.pick": 52, "ply.step": 26, "match.result": 1}
    assert {k: names.count(k) for k in set(names)} == want
    root = names.index("match")
    assert recs[root].parent is None and recs[root].unit is not None
    assert all(r.unit == recs[root].unit for r in recs)
    parent_of = {"match.load": "match", "match.bind": "match", "match.ply": "match",
                 "match.result": "match",
                 "load.template": "match.load", "load.read": "match.load",
                 "load.h2d": "match.load", **{k: "match.ply" for k in PLY_SPANS}}
    for r in recs:
        if r.name != "match":
            assert recs[r.parent].name == parent_of[r.name], r.name
    ply = [i for i, r in enumerate(recs) if r.name == "match.ply"][0]
    assert [r.name for r in recs if r.parent == ply] == [
        "ply.observe", "ply.forward", "ply.pick", "ply.forward", "ply.pick", "ply.step"]
    counters = profiling.take_counters()
    # the CPU binds nothing: every forward is functional_call's, none the kernel's
    assert counters == {"matches": 1, "policy_loads": 2, "forwards": 52}
    assert not any(k.startswith("launch.") for k in counters)


def test_root_units_count_the_matches():
    with profiling.tracing(True):
        _play()
        _play()
    roots = [r for r in profiling.take_spans() if r.name == "match"]
    assert len(roots) == 2 and roots[1].unit == roots[0].unit + 1
    assert profiling.take_counters()["matches"] == 2


@pytest.mark.parametrize("mode", ["stochastic", "deterministic"])
def test_run_match_plays_the_same_with_tracing_on_and_off(mode):
    def play():
        rec = {}
        out = match.run_match(5, 8, AGENT5, "random", seed=11, mode=mode, device="cpu",
                              record=rec)
        return out, rec

    off, rec_off = play()
    with profiling.tracing(True):
        on, rec_on = play()
    assert off == on
    assert torch.equal(rec_off["winners"], rec_on["winners"])
    assert torch.equal(rec_off["actions"], rec_on["actions"])


def test_match_cli_profile_writes_the_trace_and_prints_totals(tmp_path, monkeypatch, capsys):
    out_dir = tmp_path / "prof"
    monkeypatch.setattr(sys, "argv", [
        "match", "--board-size", "3", "--games", "4", "--a", "random", "--b", "random",
        "--cpu", "--profile", str(out_dir)])
    match.main()
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1])["games"] == 4
    assert "hex.match.ply" in (out_dir / "trace.json").read_text()
    lines = captured.err.splitlines()
    assert any(line.startswith("span match.ply: 10 calls,") for line in lines)
    assert any(line.startswith("span ply.forward: 20 calls,") for line in lines)
    assert "counter policy_loads: 2" in lines and "counter matches: 1" in lines
    assert profiling.take_spans() == []
