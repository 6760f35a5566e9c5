"""The ``program_counter`` metrics, read from the program's own counters
after a match cell's run: nothing where the readings or the counters are
missing, the count per match where they are planted, and the counts that a
CPU run of the match cell leaves; neither appears in the ``--trace 0`` line,
and the device-trace and MFU readers read what they read without them."""

import time

import pytest
import torch

from benchmark import counters, harness
from hex_gym_env_tpu_torch.utils import profiling

NEW = ("host_syncs.match", "h2d_bytes.match")
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


def test_a_cpu_match_run_fills_the_counters(tmp_path):
    conf = harness.load_json(harness.HERE / "configs" / f"{MLP7}.json")
    wl = {**harness.load_json(harness.workload_file(CELL)), "games": 16, "check_from": 1,
          "check_matches": 1}
    driver = harness.load_module(harness.driver_file(wl["driver"]), "count_driver_match")
    ctx = harness.Context(name=CELL, workload=wl, config=conf, seed=2 ** 31 + 29, seconds=0.5,
                          trace=False, t0=time.perf_counter(), device=torch.device("cpu"),
                          run_dir=str(tmp_path))
    out = driver.run(ctx)
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
