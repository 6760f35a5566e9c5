"""The ``program_counter`` metrics, read from the program's own counters
after a match cell's run: nothing where the readings or the counters are
missing, the count per match where they are planted, and the counts that a
CPU run of the match cell leaves; neither appears in the ``--trace 0`` line,
and the device-trace and MFU readers read what they read without them.
The ``program_span`` metrics, read from the program's own spans over the
matches a traced run plays inside the program's tracing: read in a traced
CPU run, and leaving the counters' readings as they are."""

import time

import pytest
import torch

from benchmark import counters, harness
from hex_gym_env_tpu_torch.utils import profiling

NEW = ("host_syncs.match", "h2d_bytes.match")
COUNTED = NEW + ("forward_kernel_pct.match",)
SPANNED = ("ply_us.match", "forward_us.match", "load_ms.match")
CELL = "mlp7-match-det"
MLP7 = "7x7_MLP-default_lr-0.0003"


@pytest.fixture(autouse=True)
def _zeroed():
    profiling.take_counters()
    yield
    profiling.take_counters()


def reader(name):
    return harness.load_module(harness.metric_file(name), "count_" + name.replace(".", "_"))


def match_readings() -> harness.Readings:
    r = harness.Readings(kind="match")
    r.busy_s, r.traced_units, r.unit_s, r.unit_flops = 0.055, 10, 0.084, 3.3e9
    return r


@pytest.mark.parametrize("name", NEW)
def test_reads_nothing_where_readings_are_missing(name, monkeypatch):
    read = reader(name).read
    assert read(match_readings()) is None  # no matches counted
    profiling.count("matches", 3)
    profiling.count("host_syncs", 6)
    profiling.count("h2d_bytes", 300)
    assert read(harness.Readings(kind="train")) is None
    monkeypatch.delattr(profiling, "counters")
    assert read(match_readings()) is None  # a program without the registry


@pytest.mark.parametrize("name, planted, want", [
    ("host_syncs.match", {"matches": 4, "host_syncs": 9, "h2d_bytes": 400}, 2.25),
    ("h2d_bytes.match", {"matches": 4, "host_syncs": 9, "h2d_bytes": 400}, 100.0),
    ("h2d_bytes.match", {"matches": 2, "host_syncs": 4}, 0.0),
])
def test_reads_the_count_per_match(name, planted, want):
    for k, v in planted.items():
        profiling.count(k, v)
    assert reader(name).read(match_readings()) == want
    assert profiling.counters == planted  # reading takes nothing away


def cpu_match_run(tmp_path, trace: bool = False):
    conf = harness.load_json(harness.HERE / "configs" / f"{MLP7}.json")
    wl = {**harness.load_json(harness.workload_file(CELL)), "games": 16, "check_from": 1,
          "check_matches": 1}
    driver = harness.load_module(harness.driver_file(wl["driver"]), "count_driver_match")
    ctx = harness.Context(name=CELL, workload=wl, config=conf, seed=2 ** 31 + 29, seconds=0.5,
                          trace=trace, t0=time.perf_counter(), device=torch.device("cpu"),
                          run_dir=str(tmp_path))
    return driver.run(ctx)


def test_a_cpu_match_run_fills_the_counters(tmp_path):
    out = cpu_match_run(tmp_path)
    assert out.correct
    c = dict(profiling.counters)
    assert c["matches"] == out.attempted + 1  # and the warm-up match
    assert c["policy_loads"] == 2 * c["matches"]
    # CPU tensors: nothing crosses a bus, so both read zero a match
    assert counters.per_match(out.readings, "host_syncs") == 0.0
    assert reader("h2d_bytes.match").read(out.readings) == 0.0


def test_new_metrics_are_per_layer_only(root):
    man = harness.manifest(root)
    e2e = [m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")]
    per_layer = {m["name"]: m for m in harness.cell_metrics(man, CELL, "per_layer")}
    for name in NEW:
        assert name not in e2e
        assert per_layer[name]["source"] == "program_counter"
        assert per_layer[name]["moves"] == "games_per_s"


def test_trace_and_mfu_readers_ignore_the_counters():
    r = match_readings()
    idle, mfu = reader("device_idle_pct.match").read(r), reader("mfu_pct.match").read(r)
    assert idle == harness.idle(r, "match") and mfu == harness.mfu(r, "match")
    profiling.count("matches", 5)
    profiling.count("host_syncs", 10)
    assert reader("device_idle_pct.match").read(r) == idle
    assert reader("mfu_pct.match").read(r) == mfu


def test_a_traced_cpu_match_run_reads_the_spans(tmp_path):
    """A ``--trace 1`` run plays ``SPAN_MATCHES`` whole matches inside the
    program's tracing after the window: the three span metrics read a
    positive mean each, and every per-match and per-forward counter reads
    as it does in an untraced run."""
    plain = cpu_match_run(tmp_path)
    counted = {name: reader(name).read(plain.readings) for name in COUNTED}
    c = profiling.take_counters()
    per_match = {k: c[k] / c["matches"] for k in ("policy_loads", "forwards")}
    assert plain.readings.program_spans is None
    assert all(reader(name).read(plain.readings) is None for name in SPANNED)

    traced = cpu_match_run(tmp_path, trace=True)
    assert traced.correct
    table = traced.readings.program_spans
    assert table["match"]["calls"] == 10 and table["match.load"]["calls"] == 20
    assert table["match.ply"]["calls"] == 10 * 50 and table["ply.forward"]["calls"] == 10 * 100
    for name in SPANNED:
        assert reader(name).read(traced.readings) > 0, name
    assert reader("forward_us.match").read(traced.readings) == pytest.approx(
        1e3 * table["ply.forward"]["total_ms"] / table["ply.forward"]["calls"])
    assert {name: reader(name).read(traced.readings) for name in COUNTED} == counted
    matches = profiling.counters["matches"]
    assert {k: profiling.counters[k] / matches for k in per_match} == per_match
    assert matches == traced.attempted + 1 + 10  # the warm-up and the span part


def test_span_metrics_are_per_layer_only(root):
    man = harness.manifest(root)
    e2e = [m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")]
    per_layer = {m["name"]: m for m in harness.cell_metrics(man, CELL, "per_layer")}
    for name in SPANNED:
        assert name not in e2e
        assert per_layer[name]["source"] == "program_span"
        assert per_layer[name]["moves"] == "games_per_s"
        assert reader(name).read(harness.Readings(kind="train", program_spans={})) is None
