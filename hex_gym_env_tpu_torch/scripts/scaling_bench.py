"""Weak-scaling benchmark of the data-parallel selfplay-PPO iteration.

The counterpart of the JAX package's ``scripts/scaling_bench.py``.  Each
rank owns a fixed number of environments (``--envs-per-device``), so perfect
scaling multiplies transitions/s by the number of ranks D.  The only traffic
between ranks is one gradient ``all_reduce`` a grad step plus the metric
reductions (``parallel/distributed.py``).

    # one rank a card, over NCCL
    torchrun --nproc_per_node=N -m hex_gym_env_tpu_torch.scripts.scaling_bench
    # without torchrun: D = 1 in this process (an NCCL group of one), D > 1
    # as spawned ranks, one a card
    python -m hex_gym_env_tpu_torch.scripts.scaling_bench --devices 1 --predict
    # gloo ranks on the CPU (they timeshare its cores: counts, not speed)
    python -m hex_gym_env_tpu_torch.scripts.scaling_bench --devices 1,2 --cpu

Per D it prints one JSON row: transitions/s, ms an iteration, the sharded
and the replicated eval, the collectives one iteration and one eval issued
(counted at ``parallel/mesh.Mesh``), and a stage split: rollout + GAE, the
sweep with its all-reduces, and the same sweep with the all-reduce replaced
by the identity (their difference is ``collective_delta_ms``).  Efficiency
is taken within one platform only.  ``--predict`` adds an analytic 1, 2 and
4-host prediction for HGX H100 nodes from the smallest run.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO, bootstrap, make_mesh
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device
from hex_gym_env_tpu_torch.utils.profiling import time_fn

# HGX H100 interconnect, data-sheet figures (no rate here was measured)
CARDS_PER_HOST = 8  # an HGX H100 node
NVLINK_BW = 450e9  # bytes/s a card each way: NVLink 4 through NVSwitch, 900 GB/s both ways
IB_BW = 50e9  # bytes/s a card each way: one 400 Gb/s NDR InfiniBand link a card
HOP_US = 1.0  # latency of one ring step: an assumption, not a data-sheet figure


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board-size", type=int, default=11)
    ap.add_argument("--envs-per-device", type=int, default=256)
    ap.add_argument("--n-steps", type=int, default=64)
    ap.add_argument("--minibatch-size", type=int, default=2048)
    ap.add_argument("--n-epochs", type=int, default=10)
    ap.add_argument("--buffer-size", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--devices", default=None,
                    help="comma list of rank counts, e.g. 1,2,4,8 (default: 1 and every "
                         "card; under torchrun its world size)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--no-attribution", action="store_true",
                    help="skip the per-stage timing split (faster; counts only)")
    ap.add_argument("--predict", action="store_true",
                    help="print the analytic 1 -> 4-host efficiency prediction from the "
                         "smallest run and the iteration's gradient traffic")
    return ap.parse_args(argv)


def make_config(args, n_devices: int) -> TrainConfig:
    return TrainConfig(
        ppo=PPOConfig(n_steps=args.n_steps, minibatch_size=args.minibatch_size,
                      n_epochs=args.n_epochs),
        selfplay=SelfplayConfig(board_size=args.board_size,
                                n_envs=n_devices * args.envs_per_device,
                                buffer_size=args.buffer_size),
    )


def grad_allreduces_per_iter(args) -> int:
    """One gradient all-reduce a grad step of a rank's sweep."""
    return args.n_epochs * (args.n_steps * args.envs_per_device // args.minibatch_size)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, *fargs, repeats: int) -> float:
    return time_fn(fn, *fargs, repeats=repeats)["seconds_per_call"] * 1e3


def _ms_in_turns(fns, repeats: int, device) -> list:
    """The median ms of each of ``fns`` over ``repeats`` calls, taken in
    turns (a, b, b, a, ...) after a warm-up call of each, so that a drift of
    the host's speed falls on both alike."""
    times = [[] for _ in fns]
    for fn in fns:
        fn()
    for r in range(repeats):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            _sync(device)
            t0 = time.perf_counter()
            fns[i]()
            _sync(device)
            times[i].append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in times]


def _synthetic_batch(n: int, board: int, seed: int, device) -> ppo.PPOBatch:
    """A sweep batch of the training shapes: random boards with at least one
    empty cell, a uniform legal action each."""
    A = board * board
    g = torch.Generator().manual_seed(seed)
    boards = torch.randint(-1, 2, (n, A), generator=g, dtype=torch.int8)
    boards[torch.arange(n), torch.randint(0, A, (n,), generator=g)] = 0
    legal = boards == 0
    action = torch.where(legal, torch.rand((n, A), generator=g), -1.0).argmax(1)
    fields = dict(
        obs=boards.reshape(n, board, board), legal=legal, action=action.to(torch.int32),
        log_prob_old=torch.randn((n,), generator=g) * 0.3 - 2.5, value_old=torch.zeros(n),
        advantage=torch.randn((n,), generator=g), ret=torch.zeros(n),
    )
    return ppo.PPOBatch(**{k: v.to(device) for k, v in fields.items()})


def _stage_attribution(algo: DistributedSelfplayPPO, args) -> dict:
    """Rollout + GAE (local work, no collective), the sweep with its
    all-reduces, and the same sweep with the all-reduce replaced by the
    identity: their difference is the collectives' cost."""
    cfg, runner = algo.cfg, algo.local_runner
    state = algo.init_sharded_state(1)
    reps = max(2, args.iters // 2)
    g = torch.Generator().manual_seed(5)

    def rollout_gae():
        _, tr, last = runner.run(state.params, state.bank, state.carry, g, cfg.ppo.n_steps)
        return algo.gae_fn(tr.reward, tr.value, tr.done, last, cfg.ppo.gamma, cfg.ppo.gae_lambda)

    rollout_ms = _ms(rollout_gae, repeats=reps)
    n = cfg.ppo.n_steps * runner.cfg.n_envs
    batch = _synthetic_batch(n, cfg.selfplay.board_size, 9, algo.device)
    # the same reduce hook (flatten, divide by D, split) on a mesh without a
    # group, whose all_reduce is the identity
    local = copy.copy(algo)
    local.mesh = dataclasses.replace(algo.mesh, group=None)
    local_update = ppo.make_update_fn(algo.model, cfg.ppo, grad_reduce=local._grad_reduce)
    reduce_ms, local_ms = _ms_in_turns(
        [lambda: algo.dist_update_fn(state.params, state.opt_state, batch, g),
         lambda: local_update(state.params, state.opt_state, batch, g)], reps, algo.device)
    return {
        "rollout_gae_ms": rollout_ms,
        "update_allreduce_ms": reduce_ms,
        "update_local_ms": local_ms,
        "collective_delta_ms": reduce_ms - local_ms,
    }


def bench_devices(mesh, args) -> dict:
    """The row of one rank count, measured on every rank of ``mesh``."""
    D, dev = mesh.world_size, mesh.device
    cfg = make_config(args, D)
    algo = DistributedSelfplayPPO(cfg, mesh)
    state = algo.init_sharded_state(0)

    def issued(fn, *fargs):
        for k in mesh.issued:
            mesh.issued[k] = 0
        out = fn(*fargs)
        _sync(dev)
        return out, dict(mesh.issued)

    (state, _), train_counts = issued(algo.train_step, state)  # also the warm-up
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, _ = algo.train_step(state)
    _sync(dev)
    dt = time.perf_counter() - t0

    es = algo.init_sharded_state(2)
    _, eval_counts = issued(algo.eval_step, es)
    eval_sharded_ms = _ms(algo.eval_step, es, repeats=args.iters)
    # every rank plays all E episodes through the single-device evaluator
    eval_replicated_ms = _ms(lambda s: SelfplayPPO.eval_step(algo, s), es, repeats=args.iters)

    per_iter = cfg.ppo.n_steps * cfg.selfplay.n_envs
    report = {
        "devices": D,
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "board_size": args.board_size,
        "n_envs": cfg.selfplay.n_envs,
        "transitions_per_s": per_iter * args.iters / dt,
        "iter_ms": dt / args.iters * 1e3,
        "eval_sharded_ms": eval_sharded_ms,
        "eval_replicated_ms": eval_replicated_ms,
        # collectives issued by one train_step and one eval_step
        "collectives": {"train_step": train_counts, "eval_step": eval_counts},
        "grad_allreduces_per_iter": grad_allreduces_per_iter(args),
        "n_params": int(sum(v.numel() for v in state.params.values())),
        "host_cpu_count": os.cpu_count(),
    }
    if not args.no_attribution:
        report["stages"] = _stage_attribution(algo, args)
    return report


def predict_multihost(report: dict, args) -> dict:
    """Analytic 1 -> N-host efficiency prediction from measured parts.

    Inputs: the smallest run's iteration less its measured collectives (the
    compute a rank does at any D, weak scaling) and the iteration's gradient
    traffic: one all-reduce of the whole float32 parameter set a grad step.

    Comms model (HGX H100 nodes, weak scaling, data-sheet rates):
      - a host holds 8 cards joined by NVLink 4 through NVSwitch; each card
        has its own 400 Gb/s NDR InfiniBand link to the other hosts;
      - a hierarchical all-reduce: a reduce-scatter and an all-gather inside
        the host, 2 (g - 1) / g x bytes over NVLink, and a ring all-reduce
        of each card's 1/g shard across the h hosts, 2 (h - 1) / h x bytes
        / g over InfiniBand, all g shards at once;
      - 2 (g - 1) + 2 (h - 1) ring steps at ``HOP_US`` each;
      - collectives serialized with compute (no overlap credit).

    predicted_efficiency(h) = t_compute / (t_compute + t_comm(h))."""
    g = CARDS_PER_HOST
    grad_bytes = report["n_params"] * 4
    steps = grad_allreduces_per_iter(args)
    # a delta below zero is the host's noise, not a collective that saves time
    collective_ms = max(report.get("stages", {}).get("collective_delta_ms", 0.0), 0.0)
    t_compute = max(report["iter_ms"] - collective_ms, 0.0) / 1e3
    rows = []
    for hosts in (1, 2, 4):
        wire = (2 * (g - 1) / g * grad_bytes / NVLINK_BW
                + 2 * (hosts - 1) / hosts * grad_bytes / g / IB_BW)
        t_ar = wire + (2 * (g - 1) + 2 * (hosts - 1)) * HOP_US * 1e-6
        t_comm = steps * t_ar
        rows.append({
            "hosts": hosts,
            "chips": hosts * g,
            "allreduce_us_each": round(t_ar * 1e6, 2),
            "comm_ms_per_iter": round(t_comm * 1e3, 3),
            "predicted_efficiency": round(t_compute / (t_compute + t_comm), 4),
        })
    return {"predicted_scaling": {
        "model": {
            "basis_iter_ms": report["iter_ms"],
            "basis_collective_ms": collective_ms,
            "basis_platform": report["platform"],
            "grad_bytes_per_allreduce": grad_bytes,
            "grad_allreduces_per_iter": steps,
            "cards_per_host": g,
            "nvlink_bw_bytes_per_s": NVLINK_BW,
            "ib_bw_bytes_per_s": IB_BW,
            "hop_latency_us": HOP_US,
            "assumptions": "weak scaling, serial collectives (no overlap credit), "
                           "hierarchical all-reduce: NVLink 4 through NVSwitch inside an "
                           "8-card HGX H100 host (900 GB/s a card both ways, data sheet), "
                           "one 400 Gb/s NDR InfiniBand link a card across hosts (data sheet); "
                           "1 us a ring step (assumed); no rate here was measured",
        },
        "hosts": rows,
        "meets_80pct_at_4_hosts": rows[-1]["predicted_efficiency"] >= 0.8,
    }}


def _rank(rank: int, n: int, port: int, argv: list, out_path: str) -> None:
    """One spawned rank of a D = n run; rank 0 writes the row to ``out_path``."""
    args = parse_args(argv)
    if args.cpu:
        torch.set_num_threads(1)  # n ranks share the host's cores
    bootstrap.init_distributed(f"localhost:{port}", n, rank,
                               backend="gloo" if args.cpu else "nccl")
    try:
        report = bench_devices(make_mesh("cpu" if args.cpu else None), args)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run_size(n: int, args, argv: list) -> dict:
    """The row of D = n: in this process for n = 1 (a group of one), else
    ``n`` spawned ranks."""
    if not args.cpu and n > torch.cuda.device_count():
        raise SystemExit(f"--devices {n} needs {n} cards, this machine has "
                         f"{torch.cuda.device_count()}")
    backend = "gloo" if args.cpu else "nccl"
    if n == 1:
        bootstrap.init_distributed(f"localhost:{bootstrap.free_port()}", 1, 0, backend=backend)
        try:
            return bench_devices(make_mesh("cpu" if args.cpu else None), args)
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "row.json")
        bootstrap.spawn(_rank, n, (n, bootstrap.free_port(), list(argv), out_path), timeout=1800)
        with open(out_path) as f:
            return json.load(f)


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if not args.cpu:
        resolve_device(None)  # raises where no CUDA device exists
    torchrun = any(v in os.environ for v in bootstrap.TORCHRUN_VARS)
    if torchrun:
        bootstrap.init_distributed(backend="gloo" if args.cpu else "nccl")
        try:
            mesh = make_mesh("cpu" if args.cpu else None)
            if args.devices and [int(s) for s in args.devices.split(",")] != [mesh.world_size]:
                raise SystemExit(f"under torchrun the run has {mesh.world_size} ranks; "
                                 f"--devices {args.devices} asks for others")
            results = [bench_devices(mesh, args)]
        finally:
            dist.destroy_process_group()
        if mesh.rank != 0:
            return results
    else:
        if args.devices:
            sizes = [int(s) for s in args.devices.split(",")]
        else:
            sizes = [1] if args.cpu else sorted({1, torch.cuda.device_count()})
        results = [run_size(n, args, argv) for n in sizes]

    # efficiency only within one platform
    base_by_platform: dict = {}
    for r in results:
        base_by_platform.setdefault(r["platform"], r["transitions_per_s"] / r["devices"])
    for r in results:
        r["efficiency_vs_1dev"] = r["transitions_per_s"] / (
            r["devices"] * base_by_platform[r["platform"]])
        if r["devices"] == min(x["devices"] for x in results if x["platform"] == r["platform"]):
            r["efficiency_baseline"] = True
        print(json.dumps(r), flush=True)
    if args.predict:
        basis = min(results, key=lambda r: (r["platform"] == "cpu", r["devices"]))
        results.append(predict_multihost(basis, args))
        print(json.dumps(results[-1]), flush=True)
    if any(r.get("platform") == "cpu" for r in results):
        print(json.dumps({"note": "CPU ranks timeshare the host's cores: the efficiency is "
                                  "not a device number (it checks the data-parallel program "
                                  "and counts its collectives)"}), flush=True)
    return results


if __name__ == "__main__":
    main()
