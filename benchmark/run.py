"""Run one cell of the benchmark of ``hex_gym_env_tpu_torch`` and print its
result line.

    python benchmark/run.py --workload mlp7-match-det --seed 7 --seconds 45 --trace 0

It reads ``BENCHMARK.json`` at the root of the checkout, the cell's
``benchmark/workloads/<cell>.json`` and its configuration's file, loads the
cell's driver (``benchmark/drivers/<driver>.py``), which sets up, warms up,
measures for ``--seconds`` and checks the program's outputs against the
plain reference in ``benchmark/reference/``, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``benchmark/metrics/<metric>.py``.

The run needs as many CUDA cards as the cell asks for, and it refuses to
give a result where JAX or the JAX package is loaded.  What the program
writes (logs, checkpoints, parameter files, traces) goes to a directory
under ``$TMPDIR`` that the run removes; the kernels' build stays in the
package's fixed build directory inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one host thread for the program's CPU work: with torch's default of one
# thread a core, the match read slower and spread wider between runs
# (PERF.md, section 2)
os.environ.setdefault("OMP_NUM_THREADS", "1")

from benchmark import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(args):
    """The cell's manifest entries and files; raises ``HarnessError`` where
    one is missing."""
    man = harness.manifest(ROOT)
    cell = harness.entry(man["workloads"], args.workload, "workload")
    conf_entry = harness.entry(man["configs"], cell["config"], "configuration")
    wl_path = harness.workload_file(args.workload)
    if not wl_path.is_file():
        raise harness.HarnessError(f"{wl_path} is missing")
    conf_path = ROOT / conf_entry["file"]
    if not conf_path.is_file():
        raise harness.HarnessError(f"{conf_path} is missing")
    workload = harness.load_json(wl_path)
    driver = harness.load_module(harness.driver_file(workload["driver"]),
                                 f"bench_driver_{workload['driver']}")
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = harness.cell_metrics(man, args.workload, kind)
    readers = {m["name"]: harness.load_module(harness.metric_file(m["name"]),
                                              f"bench_metric_{m['name']}")
               for m in metrics} if args.trace else {}
    return man, cell, workload, harness.load_json(conf_path), driver, metrics, readers


def main(argv=None) -> int:
    args = parse(argv)
    try:
        man, cell, workload, config, driver, metrics, readers = prepare(args)
        import torch

        torch.set_num_threads(1)
        chips = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise harness.HarnessError(
                f"the cell needs {chips} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    except harness.HarnessError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2

    run_dir = tempfile.mkdtemp(prefix=f"hexbench-{args.workload}-")
    try:
        ctx = harness.Context(name=args.workload, workload=workload, config=config,
                              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              t0=T0, device=torch.device("cuda"), run_dir=run_dir)
        outcome = driver.run(ctx)
        harness.check_imports()
    except harness.HarnessError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(outcome.readings) if args.trace else \
            outcome.end_to_end.get(m["name"])
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": values,
        "device": harness.device_block(outcome, bool(args.trace), chips),
    }
    if args.trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = harness.checks_block(outcome.checks)
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(f"correct: {outcome.correct}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
