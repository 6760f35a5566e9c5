"""The 9x9 CNN rating match's benchmark cell, ``cnn9-match-det``, on the
CPU: the port's ``run_match`` between two CNN ``params:`` agents at 5x5
(seeded weights, BatchNorm drawn as the cell's driver draws it, both on
argmax) held against the benchmark's plain reference
(``benchmark/drivers/match.replay`` over ``benchmark/reference/models``),
sound and with a BatchNorm that ignores its running statistics; the three
readers of the forward's device time on made-up readings; and the cell's
entries in ``BENCHMARK.json``."""

import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, work
from hex_gym_env_tpu_torch.models import cnn
from hex_gym_env_tpu_torch.scripts import match

ROOT = Path(__file__).resolve().parents[1]
CELL = "cnn9-match-det"
BOARD, GAMES = 5, 64
# Both sides compute in float32 on the CPU with the same operations, up to
# the order of the sums in the convs and the dense layers, on logits of a
# few units: about 1e-6 is expected (0.7e-6 to 1.2e-6 read on four seeds);
# 1e-5 leaves eight times that for the order of the sums and stays ten
# times below the cell's limit.
LOGIT_TOL = 1e-5
READERS = ("forward_device_us.match", "norm_device_us.match", "forward_flop_pct.match")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def driver():
    return harness.load_module(harness.driver_file("match"), "cnn_match_driver")


def cell_context(tmp_path, seed: int) -> harness.Context:
    """The cell's workload and configuration at ``BOARD`` and ``GAMES``."""
    man = harness.manifest(ROOT)
    entry = harness.entry(man["workloads"], CELL, "workload")
    conf = harness.load_json(ROOT / harness.entry(man["configs"], entry["config"],
                                                  "configuration")["file"])
    conf["model"]["board_size"] = BOARD
    wl = {**harness.load_json(harness.workload_file(CELL)), "games": GAMES}
    return harness.Context(name=CELL, workload=wl, config=conf, seed=seed, seconds=0.0,
                           trace=False, t0=time.perf_counter(), device=torch.device("cpu"),
                           run_dir=str(tmp_path))


def play_and_judge(ctx, driver) -> dict:
    """One recorded match of the cell's agents through ``run_match``, and
    the reference's replay of its moves: the judged numbers, the winners
    both give, and the largest logit gap of each ply over both sides."""
    model = work.model_of(ctx.config)
    family, mode = ctx.config["model"]["name"], ctx.workload["mode"]
    (wa, spec_a), (wb, spec_b) = driver.make_agents(ctx, model)
    assert not torch.equal(wa["conv_in.bn.var"], torch.ones_like(wa["conv_in.bn.var"]))
    rec = {}
    with driver.logit_tap() as taps:
        match.run_match(model.board, GAMES, spec_a, spec_b, mode=mode, family_a=family,
                        family_b=family, device="cpu", record=rec)
    ref = driver.replay(wa, wb, model, mode, GAMES, None, rec["actions"], taps)
    per_ply = [max(float((taps[side][t].double() - ref["logits"][side][t].double())
                         .abs().max()) for side in (0, 1))
               for t in range(model.cells + 1)]
    judged = driver.judge(wa, wb, model, mode, GAMES, None, rec["actions"], rec["winners"],
                          taps)
    return {"judged": judged, "winners": (rec["winners"].long(), ref["winners"]),
            "per_ply": per_ply}


@pytest.mark.parametrize("seed", [2 ** 31 + 19, 7])
def test_cnn_match_agrees_with_the_reference(seed, driver, tmp_path):
    ctx = cell_context(tmp_path, seed)
    out = play_and_judge(ctx, driver)
    got, want = out["winners"]
    assert torch.equal(got, want)
    assert max(out["per_ply"]) < LOGIT_TOL, out["per_ply"]
    assert max(out["per_ply"]) == out["judged"]["logit_gap"]
    limits = ctx.workload["limits"]
    assert out["judged"]["winner_mismatch"] == 0
    assert all(harness.within(v, limits[k]) for k, v in out["judged"].items()), out["judged"]


def test_batch_norm_ignoring_its_statistics_fails_the_cell(driver, tmp_path, monkeypatch):
    """The port's BatchNorm at inference normalises with mean 0 and variance
    1 in place of its running statistics: the logits move on the first ply
    already and the cell's ``logit_gap`` fails."""
    inner = cnn.BatchNorm.forward

    def forward(self, x, train):
        if train:
            return inner(self, x, train)
        mul = torch.rsqrt(torch.ones_like(self.var) + cnn.BN_EPS) * self.scale
        return x * mul[:, None, None] + self.bias[:, None, None], None, None

    monkeypatch.setattr(cnn.BatchNorm, "forward", forward)
    ctx = cell_context(tmp_path, 2 ** 31 + 19)
    out = play_and_judge(ctx, driver)
    limit = ctx.workload["limits"]["logit_gap"]
    assert out["per_ply"][0] > limit
    assert not harness.within(out["judged"]["logit_gap"], limit), out["judged"]


def reader(name):
    return harness.load_module(harness.metric_file(name), "cnn9_" + name.replace(".", "_"))


def made_up(device: bool) -> harness.Readings:
    """A span table of 10 9x9 matches of 4,096 games: 82 plies a match, two
    forwards a ply, each 4.3 ms on the device of which 1.5 ms BatchNorm;
    without the device clock, the rows a program without it gives."""
    forwards = 10 * 82 * 2
    table = {
        "match": {"calls": 10, "total_ms": 9e3, "self_ms": 1.0},
        "match.ply": {"calls": 820, "total_ms": 8e3, "self_ms": 1.0},
        "ply.forward": {"calls": forwards, "total_ms": 5e3, "self_ms": 1.0},
        "forward.norm": {"calls": 5 * forwards, "total_ms": 100.0, "self_ms": 100.0},
    }
    if device:
        table["ply.forward"]["device_ms"] = 4.3 * forwards
        table["forward.norm"]["device_ms"] = 1.5 * forwards
        table["match"]["device_ms"] = table["match.ply"]["device_ms"] = None
    r = harness.Readings(kind="match", program_spans=table)
    r.unit_flops = 4096 * 81 * 25.4e6
    return r


@pytest.mark.parametrize("name, want", [
    ("forward_device_us.match", 4300.0),
    ("norm_device_us.match", 1500.0),
    ("forward_flop_pct.match", 100.0 * 4096 * 25.4e6 / 4.3e-3 / work.PEAK_FLOPS_FP32),
])
def test_readers_read_the_device_clock(name, want):
    assert reader(name).read(made_up(True)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_the_device_clock(name):
    read = reader(name).read
    assert read(made_up(False)) is None
    r = made_up(True)
    for row in r.program_spans.values():
        row["device_ms"] = None
    assert read(r) is None
    assert read(harness.Readings(kind="match")) is None
    assert read(harness.Readings(kind="train", program_spans=made_up(True).program_spans)) is None


def test_the_cell_finds_its_files_and_reports_its_metrics(monkeypatch):
    # importing the run sets these for its own process: keep them out of
    # the processes later tests start
    for key in ("USE_FLAX", "USE_JAX", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, "")  # recorded as it was, put back after
        monkeypatch.delenv(key)
    from benchmark import run

    man = harness.manifest(ROOT)
    cell = harness.entry(man["workloads"], CELL, "workload")
    conf_entry = harness.entry(man["configs"], cell["config"], "configuration")
    assert cell["chips"] == 1 and conf_entry["reduced"] == []
    conf = harness.load_json(ROOT / conf_entry["file"])
    assert conf["model"] == {"name": "CNN", "family": "CNN", "board_size": 9,
                             "hidden": [128, 128], "activation": "relu", "filters": 64,
                             "conv_layers": 5, "features": 128}
    wl = harness.load_json(harness.workload_file(CELL))
    assert (wl["driver"], wl["games"], wl["mode"], wl["check_from"]) == (
        "match", 4096, "deterministic", 32)
    assert wl["init"] == {"action_gain": 2.0, "bias_std": 0.1}
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", "games_per_s"}
    per_layer = {m["name"] for m in harness.cell_metrics(man, CELL, "per_layer")}
    assert per_layer == {"device_idle_pct.match", "mfu_pct.match", "host_syncs.match",
                         "h2d_bytes.match", "ply_us.match", "load_ms.match", *READERS,
                         "epilogue_kernel_pct.match"}
    for trace in ("0", "1"):
        args = run.parse(["--workload", CELL, "--seed", str(2 ** 31 + 1), "--seconds", "1",
                          "--trace", trace])
        _, _, got_wl, got_conf, got_driver, metrics, readers = run.prepare(args)
        assert got_wl == wl and got_conf == conf and hasattr(got_driver, "run")
        assert {m["name"] for m in metrics} == (per_layer if trace == "1" else e2e)
        assert all(hasattr(readers[m], "read") for m in readers)
