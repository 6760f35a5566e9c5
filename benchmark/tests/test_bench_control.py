"""On the card: each cell's control, the plain reference computed in TF32 and
put in the program's place, fails one of the cell's limits, while the
program passes them, at a size a test run holds.  The readings the limits
were set from come from ``benchmark/control.py`` at the cells' own sizes."""

import time

import pytest

from benchmark import harness

SMALL = {"n_envs": 64, "n_steps": 32, "minibatch_size": 512, "n_epochs": 2, "buffer_size": 5,
         "n_eval_episodes": 5, "eval_freq": 1, "checkpoint_every": 1_000_000}
CELLS = [c["name"] for c in harness.manifest(harness.HERE.parent)["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, cuda_device, tmp_path):
    man = harness.manifest(harness.HERE.parent)
    entry = harness.entry(man["workloads"], cell, "workload")
    conf_entry = harness.entry(man["configs"], entry["config"], "configuration")
    conf = harness.load_json(harness.HERE.parent / conf_entry["file"])
    wl = harness.load_json(harness.workload_file(cell))
    if wl["driver"] == "train":
        conf["overrides"] = dict(SMALL)
        conf["train"].update(SMALL)
    else:
        wl["games"] = 1024
    driver = harness.load_module(harness.driver_file(wl["driver"]), f"control_{wl['driver']}")
    for seed in (3, 4, 5):
        ctx = harness.Context(name=cell, workload=wl, config=conf, seed=seed, seconds=0.0,
                              trace=False, t0=time.perf_counter(), device=cuda_device,
                              run_dir=str(tmp_path))
        out = driver.control(ctx)
        limits = wl["limits"]
        assert all(harness.within(v, limits[k]) for k, v in out["program"].items()), out
        assert not all(harness.within(v, limits[k]) for k, v in out["control"].items()), out
