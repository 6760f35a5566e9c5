"""Per-stage timing breakdown of one PPO training iteration.

The counterpart of the JAX package's ``scripts/breakdown_bench.py``.  It
times each stage of ``SelfplayPPO.train_step`` on its own (on ``cuda``
unless ``--cpu``), each call waited for (``utils/profiling.time_fn``):

  null_dispatch       one trivial CUDA op: the launch-and-wait constant
                      that every figure below includes
  rollout             ``SelfplayRunner.run`` (K4 on the fused path)
  gae                 the resolved GAE function (K5)
  update              the resolved epochs x minibatches sweep (K6 for an MLP)
  update_lax          the autograd sweep, ``train/ppo.make_update_fn``
  perm_gather         K6's host prologue: the epoch permutations, the
                      minibatch index rows and the obs/scalar streams the
                      kernel reads
  train_step          the whole iteration
  superstep_per_iter  ``train_steps(k)`` divided by k

It prints one JSON object per stage and a summary with the sustained
transitions/s.  On the card each stage also gets its roofline: the model's
operations (``stage_models``) against the float32 peak, and its bytes
where the port's kernels run.  The defaults are the JAX script's (6x6, 512
envs, n_steps 128, minibatch 1024, pool 64):

    python -m hex_gym_env_tpu_torch.scripts.breakdown_bench [--board-size 7 \\
        --n-envs 256 --n-steps 128 --minibatch-size 4096 --buffer-size 30] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from hex_gym_env_tpu_torch.ops import ppo_kernel
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils import roofline
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device
from hex_gym_env_tpu_torch.utils.profiling import time_fn

ROOFLINE_KEYS = ("achieved_tflops", "pct_peak_flops", "achieved_gbps", "pct_peak_hbm",
                 "hbm_model", "bound")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--board-size", type=int, default=6)
    p.add_argument("--n-envs", type=int, default=512)
    p.add_argument("--n-steps", type=int, default=128)
    p.add_argument("--minibatch-size", type=int, default=1024)
    p.add_argument("--buffer-size", type=int, default=64)
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--superstep", type=int, default=8)
    p.add_argument("--policy", default="MLP-default",
                   help="policy family (MLP-default/MLP-deep/MLP-wide-deep/CNN)")
    p.add_argument("--policy-impl", default="auto")
    p.add_argument("--update-impl", default="auto")
    p.add_argument("--rollout-impl", default="auto")
    p.add_argument("--cnn-bank-mode", default="auto", choices=["auto", "dense", "gathered"],
                   help="CNN opponent-bank strategy (gathered: only each env's assigned "
                        "member; dense: every member)")
    p.add_argument("--bank-bf16", action="store_true",
                   help="bf16 opponent-bank forwards (the rollout_bank_bf16 deviation)")
    p.add_argument("--cpu", action="store_true", help="run the kernels' twins on the CPU")
    return p.parse_args(argv)


def make_config(args) -> TrainConfig:
    return TrainConfig(
        ppo=PPOConfig(n_steps=args.n_steps, minibatch_size=args.minibatch_size,
                      n_epochs=args.n_epochs, update_impl=args.update_impl),
        selfplay=SelfplayConfig(
            board_size=args.board_size, n_envs=args.n_envs, buffer_size=args.buffer_size,
            policy=args.policy, policy_impl=args.policy_impl, rollout_impl=args.rollout_impl,
            rollout_bank_bf16=args.bank_bf16, cnn_bank_mode=args.cnn_bank_mode, eval_freq=10**9,
        ),
    )


def stage_models(args, algo: SelfplayPPO) -> dict:
    """Per-iteration ``(operations, bytes)`` of each stage, from
    ``utils/roofline.py``: the products the port runs (2 per multiply-add;
    the JAX script's composition, with the opponent's reply one member's
    tower where the port's bank passes serve each game its own member),
    and the device-memory bytes of the port's kernels, each input read and
    each output written once.  Bytes are None where the stage does not run
    a kernel of the port (the scan rollout, a plain sweep, any CPU run):
    a stream model of the kernel would undercount what the plain ops move."""
    N = args.board_size
    F = A = N * N
    P1 = args.buffer_size + 1
    per_iter = args.n_steps * args.n_envs
    E = args.n_epochs
    if args.policy == "CNN":
        fwd = roofline.cnn_forward_flops(F, n_actions=A)
        if args.cnn_bank_mode != "dense":
            # the gathered pass: one conv stack a game, every member's towers
            opp = roofline.cnn_gathered_bank_flops(F, args.buffer_size, n_actions=A)
        else:
            opp = P1 * fwd  # every member's whole forward
    else:
        H, NL = algo.model.pi_layers[0], len(algo.model.pi_layers)
        fwd = roofline.mlp_forward_flops(F, H, NL, A)
        # the bank passes (K4, K3 and their twins) run each game's own
        # member's tower; the plain path runs every member's and the best's
        # on every board, as the JAX package's dense bank does
        kernel_bank = algo.runner.fused_pol is not None or algo.runner.pol is not None
        opp = (1 if kernel_bank else P1) * roofline.policy_tower_flops(F, H, NL, A)
    on_card = algo.device.type == "cuda"
    fused_rollout = on_card and algo.runner.fused_pol is not None
    fused_update = (on_card and algo.cfg.ppo.update_impl in ("auto", "pallas", "pallas-fast")
                    and ppo_kernel.supported_policy(algo.model))
    # K4's record per transition: the int8 board, 8 int32 and 8 float32 lanes
    roll_bytes = per_iter * (F + 64) if fused_rollout else None
    # K6 per row visit: the int8 board, 4 float32 scalars and the int32 row index
    upd_bytes = per_iter * E * (F + 20) if fused_update else None
    models = {
        # the agent's forward and the opponent's reply a transition
        "rollout": (per_iter * (fwd + opp), roll_bytes),
        # forward and backward ~ 3x the forward's products a row visit
        "update": (per_iter * E * 3 * fwd, upd_bytes),
        # the plain sweep gathers float32 boards, the mask and the scalars
        "update_lax": (per_iter * E * 3 * fwd, per_iter * E * (F * 4 + A + 16 + 4 * 4) * 2),
        # K5: reward, value (float32) and done (bool) read, advantage and return written
        "gae": (per_iter * 5, per_iter * 17),
        # the index rows written, four scalars read and their packed rows written
        "perm_gather": (0.0, per_iter * (E * 4 + 32)),
        "train_step": (per_iter * (fwd + opp + E * 3 * fwd),
                       roll_bytes + upd_bytes if fused_rollout and fused_update else None),
    }
    models["superstep_per_iter"] = models["train_step"]
    return models


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def main(argv=None) -> list:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = make_config(args)
    algo = SelfplayPPO(cfg, device)
    state = algo.init_state(0)
    per_iter = args.n_steps * args.n_envs
    models = stage_models(args, algo)
    on_card = device.type == "cuda"
    report: dict[str, float] = {}
    rows, records = [], []

    def record(name: str, seconds: float) -> None:
        report[name] = seconds
        out = {"stage": name, "ms": round(seconds * 1e3, 3),
               "transitions_per_s": round(per_iter / seconds)}
        # a roofline share is a device metric: only from a run on the card
        if on_card and name in models:
            flops, n_bytes = models[name]
            row = roofline.stage(name, seconds, per_iter, flops, n_bytes)
            rows.append(row)
            out |= {k: row[k] for k in ROOFLINE_KEYS if k in row}
        records.append(out)
        print(json.dumps(out), flush=True)

    def timed(fn, *fargs, repeats=args.repeats) -> float:
        return time_fn(fn, *fargs, repeats=repeats)["seconds_per_call"]

    record("null_dispatch", timed(lambda t: t + 1.0, torch.zeros((8, 128), device=device)))

    g = torch.Generator().manual_seed(1)

    def rollout():
        return algo.runner.run(state.params, state.bank, state.carry, g, args.n_steps)

    record("rollout", timed(rollout))
    _, tr, last_values = rollout()

    def gae():
        return algo.gae_fn(tr.reward, tr.value, tr.done, last_values, cfg.ppo.gamma,
                           cfg.ppo.gae_lambda)

    record("gae", timed(gae))
    advantages, returns = gae()
    batch = ppo.PPOBatch(
        obs=_flat(tr.obs), legal=_flat(tr.legal), action=_flat(tr.action),
        log_prob_old=_flat(tr.log_prob), value_old=_flat(tr.value),
        advantage=_flat(advantages), ret=_flat(returns),
    )

    record("update", timed(lambda: algo.update_fn(state.params, state.opt_state, batch, g)))
    lax_update = ppo.make_update_fn(algo.model, cfg.ppo)
    record("update_lax", timed(lambda: lax_update(state.params, state.opt_state, batch, g)))

    n = per_iter

    def prologue():
        # what the exact-stream K6 entry does before its launch
        perms = ppo.epoch_permutations(g, n, cfg.ppo.n_epochs)
        idx = ppo.minibatch_indices(perms, n, cfg.ppo.minibatch_size)
        return idx.to(device, torch.int32).contiguous(), ppo_kernel.batch_streams(batch)

    record("perm_gather", timed(prologue))
    record("train_step", timed(algo.train_step, state))
    k = args.superstep
    record("superstep_per_iter",
           timed(lambda s: algo.train_steps(s, k), state, repeats=max(1, args.repeats // 2)) / k)

    train_flops = models["train_step"][0]
    summary = {"summary": {
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "shape": dataclasses.asdict(cfg.ppo) | {
            "n_envs": args.n_envs, "buffer_size": args.buffer_size,
            "board_size": args.board_size, "policy": args.policy},
        "per_iter_transitions": per_iter,
        "sustained_transitions_per_s": round(per_iter / report["superstep_per_iter"]),
        "model_flops_per_transition": round(train_flops / per_iter),
        # the port's products run in float32 (TF32 off, the kernels on the
        # CUDA cores), so the float32 rate is the peak; the JAX script's bf16
        # peak describes TPU matmuls that run as bf16 passes
        "peak": "fp32",
        "sustained_mfu_pct": (round(100.0 * train_flops / report["superstep_per_iter"]
                                    / roofline.PEAK_FLOPS_FP32, 3) if on_card else None),
        "roofline": rows,
    }}
    records.append(summary)
    print(json.dumps(summary), flush=True)
    return records


if __name__ == "__main__":
    main()
