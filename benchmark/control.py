"""The readings that a cell's limits are set from, on the card, at the
cell's own size, over several seeds in one process.

    python benchmark/control.py --workload mlp7-match-det --seeds 11,12,13 --out control.jsonl

For each seed the cell's driver (its ``control`` function) runs the program
as a run's set-up does and prints one JSON line: the numbers of the
program against the plain reference, of the control (the reference in the
next precision below the configuration's, TF32, put in the program's
place) and of the planted faults.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    cell = harness.entry(man["workloads"], args.workload, "workload")
    conf = harness.load_json(ROOT / harness.entry(man["configs"], cell["config"],
                                                  "configuration")["file"])
    workload = harness.load_json(harness.workload_file(args.workload))
    driver = harness.load_module(harness.driver_file(workload["driver"]), "bench_driver")
    for seed in (int(s) for s in args.seeds.split(",")):
        run_dir = tempfile.mkdtemp(prefix="hexbench-control-")
        t = time.perf_counter()
        try:
            ctx = harness.Context(name=args.workload, workload=workload, config=conf, seed=seed,
                                  seconds=0.0, trace=False, t0=t, device=torch.device("cuda"),
                                  run_dir=run_dir)
            line = {"workload": args.workload, "seed": seed, **driver.control(ctx),
                    "seconds": time.perf_counter() - t}
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
