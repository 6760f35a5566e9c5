"""The port's graft entry points (the JAX package's repo-root
``__graft_entry__.py``).

- ``entry(device=None)`` returns the actor step on the flagship model
  (MlpPolicy on 7x7, batch 1024) and its arguments: observe, policy forward,
  masked sample, the batched env step (K1 on the card) and a reset of the
  finished games.
- ``dryrun_multichip(n, device=None)`` starts ``n`` processes, each one rank
  of the data-parallel trainer (``parallel.DistributedSelfplayPPO``; gloo
  on the CPU, NCCL on the card with ``n`` at most the CUDA devices), and
  runs two ``train_step``s and one ``train_and_eval_steps(state, 2)`` at
  tiny shapes, asserting the transition counts.

    python -m hex_gym_env_tpu_torch.__graft_entry__ [--cpu] [N]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

BOARD, BATCH = 7, 1024


def entry(device=None):
    """``(actor_step, (params, state, generator))``: ``actor_step(params,
    state, generator, bits=None) -> (state', (action, rewards, value))``,
    where ``bits`` (B, A) int32 words replace the generator's draws."""
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import masked

    topo = get_topology(BOARD)
    ops = hex_env.make_ops(topo, "auto", device)
    model = make_policy("MLP-default", topo.num_cells, generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().to(ops.device) for k, v in model.state_dict().items()}
    state = ops.initial_state(BATCH)
    generator = torch.Generator(ops.device).manual_seed(1)

    @torch.no_grad()
    def actor_step(params, state, generator, bits=None):
        obs = ops.observe(state).to(torch.float32)
        legal = ops.legal_mask(state)
        logits, value = torch.func.functional_call(model, params, (obs,))
        if bits is None:
            bits = masked.draw_bits(generator, legal.shape, ops.device)
        action = masked.sample(bits, logits, legal)
        new_state, rewards = ops.step(state, action)
        new_state = ops.reset_where(new_state, new_state.done)
        return new_state, (action, rewards, value)

    return actor_step, (params, state, generator)


def _dryrun_rank(rank: int, n: int, port: int, device: Optional[str]) -> None:
    import torch.distributed as dist

    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO, bootstrap, make_mesh
    from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

    cpu = device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    bootstrap.init_distributed(f"localhost:{port}", n, rank, backend="gloo" if cpu else "nccl")
    try:
        mesh = make_mesh("cpu" if cpu else torch.device("cuda", rank))
        cfg = TrainConfig(
            ppo=PPOConfig(n_steps=4, minibatch_size=8, n_epochs=1),
            selfplay=SelfplayConfig(board_size=5, n_envs=2 * n, buffer_size=2),
        )
        algo = DistributedSelfplayPPO(cfg, mesh)
        state = algo.init_sharded_state(0)
        state, _ = algo.train_step(state)
        if algo.timesteps(state) != cfg.ppo.n_steps * cfg.selfplay.n_envs:
            raise AssertionError(f"rank {rank}: {algo.timesteps(state)} transitions after a step")
        state, _ = algo.train_step(state)
        state, _ = algo.train_and_eval_steps(state, 2)
        if algo.timesteps(state) != 4 * cfg.ppo.n_steps * cfg.selfplay.n_envs:
            raise AssertionError(f"rank {rank}: {algo.timesteps(state)} transitions after 4")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the data-parallel train step over ``n_devices`` processes; raises
    where a rank fails or the run outlasts ten minutes (a rank still running
    is then killed by its PID)."""
    from hex_gym_env_tpu_torch.parallel.bootstrap import free_port, spawn
    from hex_gym_env_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need as many CUDA devices, "
                         f"{torch.cuda.device_count()} are present")
    spawn(_dryrun_rank, n_devices, (n_devices, free_port(), dev.type))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks of the dry run (default: the CUDA devices, or 2 with --cpu)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    fn, fn_args = entry(device)
    fn(*fn_args)
    print("entry() ok")
    n = args.n or (2 if args.cpu else torch.cuda.device_count())
    dryrun_multichip(n, device)
    print("dryrun_multichip ok")


if __name__ == "__main__":
    main()
