"""Env-throughput benchmark: Hex env-steps/s on one card (7x7, batch 8192).

    python -m hex_gym_env_tpu_torch.bench [--repeats N]

The port of the JAX package's root ``bench.py``: lockstep rollouts over
8192 seven-by-seven games — uniform-random legal moves, a full win check
every move, auto-reset on termination; steps/s counts applied moves per
second.  Three routes to the same function are measured and the fastest
wins:

1. ``pallas``: the fused random-legal rollout K7
   (``ops/step_kernel.random_rollout``), all T steps in one launch;
2. ``api``: the composable env API with the kernel dispatch
   (``core.env.make_ops(impl="auto")``): one K1 launch per step, plain
   PyTorch legal mask, sampling and reset;
3. ``lax``: the same loop on the plain PyTorch step (``impl="lax"``).

On a CPU device (``device="cpu"``, for tests) the ``pallas`` and ``api``
routes take the kernels' twins.  No route's failure is caught: a kernel that
fails to build or launch fails the run.

Each route is timed as ``repeats`` samples of ``calls`` calls of
``steps`` steps, each sample ended by a device synchronise; the record
carries each route's median/min/max and the winner's median as ``value``.
Prints exactly one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.ops import masked, step_kernel
from hex_gym_env_tpu_torch.utils import roofline
from hex_gym_env_tpu_torch.utils.device import resolve_device

METRIC = "hex_env_steps_per_s_7x7_b8192"
BOARD = 7
BATCH = 8192
STEPS_PER_CALL = 512
CALLS_PER_SAMPLE = 5
DEFAULT_REPEATS = 5  # timed samples per route
TARGET = 10_000_000.0  # the JAX package's north-star target, env-steps/s


def drain(device: torch.device) -> None:
    """Wait until every queued launch on ``device`` has run."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample_rates(run_call, state, repeats: int, device, steps: int, batch: int, calls: int):
    """``repeats`` timed samples of ``calls`` calls and one drain; returns
    env-steps/s per sample."""
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            state = run_call(state)
        drain(device)
        rates.append(calls * steps * batch / (time.perf_counter() - t0))
    return rates


def bench_composable(topo, impl: str, repeats: int, device, batch: int, steps: int, calls: int):
    """The public composable path: ops resolved once through ``make_ops``."""
    ops = hex_env.make_ops(topo, impl=impl, device=device)
    fresh = ops.initial_state(batch)
    zeros = torch.zeros((batch, topo.num_cells), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def run(state):
        for _ in range(steps):
            legal = ops.legal_mask(state)
            action = masked.sample(masked.draw_bits(gen, legal.shape, device), zeros, legal)
            state, _ = ops.step(state, action)
            state = ops.reset_where(state, state.done, fresh)
        return state

    state = run(ops.initial_state(batch))  # warm
    drain(device)
    return _sample_rates(run, state, repeats, device, steps, batch, calls)


def bench_fused(topo, repeats: int, device, batch: int, steps: int, calls: int):
    """K7: every step of a call in one launch (its twin on a CPU device).

    The generator lies on the CPU: it only seeds each launch's Philox
    streams (``cuda_lib.philox_seed``), and a CUDA generator's seed would be
    read back with a synchronising ``.item()`` before every launch."""
    gen = torch.Generator().manual_seed(0)

    def run(state):
        return step_kernel.random_rollout(topo, state, steps, generator=gen)[0]

    state, games = step_kernel.random_rollout(
        topo, hex_env.initial_state(topo, batch, device), steps, generator=gen)  # warm
    drain(device)
    if int(games.sum()) <= 0:
        raise RuntimeError("the fused rollout finished no games")
    return _sample_rates(run, state, repeats, device, steps, batch, calls)


def _stats(rates: list) -> dict:
    return {
        "median": round(statistics.median(rates), 1),
        "min": round(min(rates), 1),
        "max": round(max(rates), 1),
        "samples": [round(r, 1) for r in rates],
    }


def main(
    repeats: int = DEFAULT_REPEATS,
    device=None,
    board: int = BOARD,
    batch: int = BATCH,
    steps: int = STEPS_PER_CALL,
    calls: int = CALLS_PER_SAMPLE,
) -> dict:
    """Run the three routes, print the JSON record and return it.
    ``device=None`` means ``cuda``; the shape knobs are for tests."""
    device = resolve_device(device)
    topo = get_topology(board)
    shape = (device, batch, steps, calls)
    routes = {
        "pallas": bench_fused(topo, repeats, *shape),
        "api": bench_composable(topo, "auto", repeats, *shape),
        "lax": bench_composable(topo, "lax", repeats, *shape),
    }
    med = {name: statistics.median(rates) for name, rates in routes.items()}
    winner = max(med, key=med.get)
    steps_per_s = med[winner]
    win_rates = routes[winner]
    record = {
        "metric": METRIC,
        "value": round(steps_per_s, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(steps_per_s / TARGET, 3),
        "winner": winner,
        "median": round(steps_per_s, 1),
        "spread": {
            "min": round(min(win_rates), 1),
            "max": round(max(win_rates), 1),
            "n_samples": len(win_rates),
        },
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "shape": {"board": board, "batch": batch, "steps_per_call": steps,
                  "calls_per_sample": calls},
    }
    for name, rates in routes.items():
        record[name] = _stats(rates)
        record[f"{name}_steps_per_s"] = round(med[name], 1)

    # Env stepping runs no products: its FLOPs are zero and device memory is
    # the roofline axis of the composable routes, which read and write the
    # whole state every step (plus the sampling intermediates); K7 keeps
    # each game in shared memory for all of a call's steps.
    state = hex_env.initial_state(topo, batch, device)
    state_bytes = sum(getattr(state, k).nbytes for k in state.__dataclass_fields__)
    bytes_per_env_step = (2 * state_bytes + 3 * batch * topo.num_cells * 4) / batch
    hbm_pct = {
        name: round(100.0 * bytes_per_env_step * med[name] / roofline.PEAK_HBM_BPS, 2)
        for name in ("api", "lax")
    }
    record["roofline"] = {
        "flops_per_s": 0.0,
        "note": "env stepping has no products; device memory is the roofline axis",
        "composable_bytes_per_env_step_model": round(bytes_per_env_step, 1),
        "api_pct_peak_hbm": hbm_pct["api"],
        "lax_pct_peak_hbm": hbm_pct["lax"],
        "pallas_kernel": "game state in shared memory across a call; bound by operations",
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=DEFAULT_REPEATS,
                    help="timed samples per route (median/min/max reported)")
    main(repeats=ap.parse_args().repeats)
