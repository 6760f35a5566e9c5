"""Extract the agent's parameters from a training checkpoint.

The counterpart of the JAX package's ``scripts/export_agent.py``.  A training
checkpoint (``<model_dir>/<run>/step_<N>.pt``) holds the whole resumable
``TrainState``; this tool writes the agent's policy parameters alone as a
``params:`` file (``utils/checkpoint.save_params``) that the match,
tournament, GUI and CLI scripts load:

    python -m hex_gym_env_tpu_torch.scripts.export_agent \\
        --experiment 7x7_MLP-default_lr-0.0003 [--model-name NAME] [--step N] \\
        [--out models/NAME/agent.pt] [--cpu]

The checkpoint carries its own shapes, so no training override is needed.
The state is read onto ``cuda`` unless ``--cpu``; the file holds CPU tensors.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--experiment", required=True)
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    ap.add_argument("--out", default=None,
                    help="output file (default: <run dir>/agent_<step>.pt)")
    ap.add_argument("--cpu", action="store_true", help="read the checkpoint on the CPU")
    args = ap.parse_args(argv)

    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.utils.checkpoint import CheckpointManager, save_params
    from hex_gym_env_tpu_torch.utils.device import resolve_device

    overrides = {} if args.model_name is None else {"model_name": args.model_name}
    cfg = get_config(args.experiment, **overrides)
    run_dir = os.path.join(cfg.model_dir, cfg.model_name)
    mgr = CheckpointManager(run_dir)
    step = mgr.latest_step() if args.step is None else args.step
    state = mgr.restore(step, map_location=resolve_device("cpu" if args.cpu else None))
    out = args.out or os.path.join(run_dir, f"agent_{step}.pt")
    save_params(out, {k: v.cpu() for k, v in state.params.items()})
    print(f"exported agent params at step {step} -> {out}")
    return out


if __name__ == "__main__":
    main()
