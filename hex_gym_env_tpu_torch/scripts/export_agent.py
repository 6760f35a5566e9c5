"""Extract the agent's parameters from a training checkpoint.

The counterpart of the JAX package's ``scripts/export_agent.py``.  A training
checkpoint (``<model_dir>/<run>/step_<N>.pt``) holds the whole resumable
``TrainState``; this tool writes the agent's policy parameters alone as a
``params:`` file (``utils/checkpoint.save_params``) that the match,
tournament, GUI and CLI scripts load:

    python -m hex_gym_env_tpu_torch.scripts.export_agent \\
        --experiment 7x7_MLP-default_lr-0.0003 [--model-name NAME] [--step N] \\
        [--n-envs 512 --n-steps 128 --minibatch-size 1024] \\
        [--out models/NAME/agent.pt] [--cpu]

The checkpoint carries its own shapes, so no training override is needed;
the JAX script's overrides are taken all the same, as overrides of the
preset.  ``--n-envs`` shapes the saved env carry and is checked against it;
``--n-steps`` and ``--minibatch-size`` shape nothing that is saved.  The
state is read onto ``cuda`` unless ``--cpu``; the file holds CPU tensors.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--experiment", required=True)
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--n-envs", type=int, default=None,
                    help="the run's n_envs: checked against the checkpoint's env carry")
    ap.add_argument("--n-steps", type=int, default=None,
                    help="the run's n_steps (accepted; a checkpoint holds nothing it shapes)")
    ap.add_argument("--minibatch-size", type=int, default=None,
                    help="the run's minibatch_size (accepted; a checkpoint holds nothing it "
                         "shapes)")
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    ap.add_argument("--out", default=None,
                    help="output file (default: <run dir>/agent_<step>.pt)")
    ap.add_argument("--cpu", action="store_true", help="read the checkpoint on the CPU")
    args = ap.parse_args(argv)

    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.utils.checkpoint import CheckpointManager, save_params
    from hex_gym_env_tpu_torch.utils.device import resolve_device

    overrides = {
        k: v
        for k, v in {
            "model_name": args.model_name,
            "n_envs": args.n_envs,
            "n_steps": args.n_steps,
            "minibatch_size": args.minibatch_size,
        }.items()
        if v is not None
    }
    cfg = get_config(args.experiment, **overrides)
    run_dir = os.path.join(cfg.model_dir, cfg.model_name)
    mgr = CheckpointManager(run_dir)
    step = mgr.latest_step() if args.step is None else args.step
    state = mgr.restore(step, map_location=resolve_device("cpu" if args.cpu else None))
    rows = state.carry.agent_seat.shape[0]
    if args.n_envs is not None and args.n_envs != rows:
        ap.error(f"--n-envs {args.n_envs} does not match the checkpoint at step {step}, "
                 f"whose env carry holds {rows} envs")
    out = args.out or os.path.join(run_dir, f"agent_{step}.pt")
    save_params(out, {k: v.cpu() for k, v in state.params.items()})
    print(f"exported agent params at step {step} -> {out}")
    return out


if __name__ == "__main__":
    main()
