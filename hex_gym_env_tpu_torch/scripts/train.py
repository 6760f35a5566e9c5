"""Training entry point.

The counterpart of the JAX package's ``scripts/train.py``: one CLI over the
preset registry (``experiments/``), with the same flags and overrides.

    python -m hex_gym_env_tpu_torch.scripts.train \\
        --experiment 7x7_MLP-default_lr-0.0003 --total-timesteps 2000000 \\
        [--n-envs 512] [--resume] [--cpu]

    torchrun --nproc_per_node=N -m hex_gym_env_tpu_torch.scripts.train \\
        --experiment 7x7_MLP-default_lr-0.0003 --multichip

The run is on ``cuda`` (and raises where there is none) unless ``--cpu``
asks for the CPU.  ``--multichip`` runs the data-parallel trainer
(``parallel.DistributedSelfplayPPO``) over torchrun's process group, or over
a group of this one process where torchrun did not start it: NCCL on the
card, gloo with ``--cpu``.  Metrics go to ``<log_dir>/<name>/metrics.jsonl``
and checkpoints to ``<model_dir>/<name>/``, relative to the working
directory.
"""

from __future__ import annotations

import argparse

FLAG_OVERRIDES = (  # (flag's attribute, config field) for the valued flags
    ("total_timesteps", "total_timesteps"), ("n_envs", "n_envs"), ("n_steps", "n_steps"),
    ("minibatch_size", "minibatch_size"), ("seed", "seed"),
    ("learning_rate", "learning_rate"), ("eval_freq", "eval_freq"),
    ("checkpoint_every", "checkpoint_every"), ("iters_per_dispatch", "iters_per_dispatch"),
    ("env_step_impl", "env_step_impl"), ("update_impl", "update_impl"),
    ("policy_impl", "policy_impl"), ("rollout_impl", "rollout_impl"),
    ("pool_score_decay", "pool_score_decay"), ("cnn_bank_mode", "cnn_bank_mode"),
    ("model_name", "model_name"),
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--experiment", default="7x7_MLP-default_lr-0.0003")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument("--total-timesteps", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=None)
    ap.add_argument("--n-steps", type=int, default=None)
    ap.add_argument("--minibatch-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--eval-freq", type=int, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--iters-per-dispatch", type=int, default=None,
                    help="iterations per call of train_and_eval_steps (the one fit "
                         "loop; any value gives the same run)")
    ap.add_argument("--env-step-impl", choices=["auto", "lax", "pallas"], default=None,
                    help="env step of the scan path: auto = the kernel on the card")
    ap.add_argument("--update-impl", choices=["auto", "lax", "pallas", "pallas-fast"],
                    default=None,
                    help="PPO sweep: auto = the fused sweep kernel on the card for MLP "
                         "policies, lax = autograd; pallas-fast adds the shuffle-once "
                         "schedule (a documented minibatch-stream deviation)")
    ap.add_argument("--rollout-impl", choices=["auto", "scan", "fused"], default=None,
                    help="rollout: fused = all T steps in one kernel launch")
    ap.add_argument("--symmetric-eval", action="store_true",
                    help="eval every pool member from both seats (2E episodes)")
    ap.add_argument("--cnn-bank-mode", choices=["auto", "dense", "gathered"], default=None)
    ap.add_argument("--pool-score-decay", type=float, default=None,
                    help="decay pool scores by this fraction per eval (0 = reference rule)")
    ap.add_argument("--bank-bf16", action="store_true",
                    help="bf16 opponent-bank products in the rollout (a documented "
                         "deviation of the opponents' logits)")
    ap.add_argument("--policy-impl", choices=["auto", "lax", "pallas"], default=None,
                    help="rollout policy passes: auto = the kernels with their Philox "
                         "streams on the card (same distribution as lax, another stream)")
    ap.add_argument("--model-name", default=None,
                    help="override the run/checkpoint directory name")
    ap.add_argument("--seed-pool", default=None,
                    help="comma list of policy specs (random|sb3:zip|orbax:dir|params:file) "
                         "planted into the opponent pool; the first becomes the best")
    ap.add_argument("--multichip", action="store_true",
                    help="data-parallel over torchrun's process group (or one process)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo for --multichip)")
    return ap


def config_from_args(args):
    from hex_gym_env_tpu_torch.experiments import get_config

    overrides = {field: getattr(args, flag) for flag, field in FLAG_OVERRIDES
                 if getattr(args, flag) is not None}
    if args.bank_bf16:
        overrides["rollout_bank_bf16"] = True
    if args.symmetric_eval:
        overrides["symmetric_eval"] = True
    return get_config(args.experiment, **overrides)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    from hex_gym_env_tpu_torch.experiments import list_experiments

    if args.list:
        print("\n".join(list_experiments()))
        return
    cfg = config_from_args(args)
    device = "cpu" if args.cpu else None

    from hex_gym_env_tpu_torch.train.trainer import Trainer
    from hex_gym_env_tpu_torch.utils.device import resolve_device

    resolve_device(device)  # no CUDA device and no --cpu: raise before any group forms

    if not args.multichip:
        run(Trainer(cfg, device=device), cfg, args, n_devices=1)
        return
    import torch.distributed as dist

    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO, bootstrap, make_mesh

    backend = "gloo" if args.cpu else "nccl"
    if not bootstrap.init_distributed(backend=backend):
        bootstrap.init_distributed(f"localhost:{bootstrap.free_port()}", 1, 0, backend=backend)
    try:
        mesh = make_mesh(device)
        trainer = Trainer(cfg, algo=DistributedSelfplayPPO(cfg, mesh))
        run(trainer, cfg, args, n_devices=mesh.world_size)
    finally:
        dist.destroy_process_group()


def run(trainer, cfg, args, n_devices: int):
    """Resume or start, plant the seed pool, print the run's line and fit."""
    from hex_gym_env_tpu_torch.parallel.bootstrap import is_main_process

    algo = trainer.algo
    state = trainer.resume() if args.resume else trainer.init_state()
    if args.seed_pool:
        from hex_gym_env_tpu_torch.models.loading import load_policy_params

        seeds = [load_policy_params(s, cfg.selfplay.board_size, algo.model,
                                    device=algo.device)[1]
                 for s in args.seed_pool.split(",")]
        state = algo.seed_bank(state, seeds)
    if is_main_process():
        if cfg.selfplay.policy_impl == "auto" and algo.device.type == "cuda":
            print("note: policy_impl=auto -> the rollout kernels' Philox sampling on the "
                  "card (distribution-identical to lax, another stream; pin --policy-impl "
                  "lax for the plain path's stream)")
        print(f"training {cfg.model_name}: {cfg.total_timesteps} transitions "
              f"on {n_devices} device(s)", flush=True)
    return trainer.fit(state)


if __name__ == "__main__":
    main()
