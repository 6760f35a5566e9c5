"""The 5x5 learning probe: does training on the card learn?

The counterpart of the JAX package's ``scripts/verify_train_tpu.py``, the
repo's learning bar.  It trains a 5x5 agent for 128 PPO iterations
(2,097,152 transitions) through the whole-rollout kernel K4, GAE (K5) and
the sweep (K6, by default on the ``pallas-fast`` schedule), then plays it
against a fresh all-random pool: the mean eval reward must clear +0.5 (a
winrate of at least 75% against random) for the run to count as learning.

    python -m hex_gym_env_tpu_torch.scripts.verify_train [UPDATE_IMPL] [--cpu]

``UPDATE_IMPL`` is ``pallas-fast`` (the default), ``pallas``, ``auto`` or
``lax``.  It prints one JSON line and exits 1 unless the bar is cleared.
The run is on ``cuda`` unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device

CHUNKS, PER_CHUNK = 8, 16  # 128 iterations, as the JAX probe's 8 calls of train_steps(16)
THRESHOLD = 0.5  # mean eval reward against random


def probe_config(impl: str = "pallas-fast") -> TrainConfig:
    """The JAX probe's configuration, with ``update_impl=impl``."""
    return TrainConfig(
        ppo=PPOConfig(n_steps=64, minibatch_size=512, update_impl=impl),
        selfplay=SelfplayConfig(board_size=5, n_envs=256, buffer_size=20,
                                rollout_impl="auto", eval_freq=10**9),
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(cfg: TrainConfig, device, chunks: int = CHUNKS, per_chunk: int = PER_CHUNK) -> dict:
    """Train ``chunks * per_chunk`` iterations of ``cfg`` from seed 0, then
    evaluate against a fresh all-random pool; returns the JSON record."""
    algo = SelfplayPPO(cfg, device)
    state = algo.init_state(0)
    _sync(algo.device)
    t0 = time.perf_counter()
    for _ in range(chunks):
        state, _ = algo.train_steps(state, per_chunk)
    _sync(algo.device)
    dt = time.perf_counter() - t0

    # zero params play uniformly over the legal cells (BaseRandomPolicy)
    random_bank = init_bank(state.params, cfg.selfplay.buffer_size)
    rewards = algo.evaluator.play_vs_pool(
        state.params, random_bank, torch.Generator().manual_seed(123),
        fixed_seats=state.carry.agent_seat)
    mean_r = float(rewards.mean())
    transitions = algo.timesteps(state)
    return {
        "update_impl": cfg.ppo.update_impl,
        "transitions": transitions,
        "seconds": round(dt, 2),
        "transitions_per_s": round(transitions / dt),
        "eval_mean_reward_vs_random": round(mean_r, 4),
        "pass": mean_r > THRESHOLD,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("update_impl", nargs="?", default="pallas-fast",
                    help="the sweep: pallas-fast (default), pallas, auto or lax")
    ap.add_argument("--cpu", action="store_true", help="run the kernels' twins on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    out = probe(probe_config(args.update_impl), device)
    print(json.dumps(out), flush=True)
    if not out["pass"]:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
