"""Legacy outer-loop selfplay protocol (the reference's ``scripts/selfplay.py``).

The counterpart of the JAX package's ``scripts/train_legacy.py``.  The
reference's older pipeline trains in short bursts and then rebuilds the env
with an opponent sampled from a model-history list: 80% the latest model,
20% uniform from the history (``scripts/selfplay.py:59-92``).  That protocol
maps onto the opponent bank: "latest" is the bank's best snapshot
(``best_prob=0.8``) and "history" is the pool, into which each burst's
snapshot goes round-robin (slot ``(burst - 1) % history``, score ``burst``).
The bursts run on the device; only the burst/append cadence is the host's.

    python -m hex_gym_env_tpu_torch.scripts.train_legacy --board-size 5 \\
        --bursts 20 --history 10 [--cpu]

The final agent is saved as ``models/<name>/final``, a ``params:`` file.
"""

from __future__ import annotations

import argparse
import dataclasses


def append_to_history(bank, params, slot: int, burst: int):
    """The bank with ``params`` in pool slot ``slot`` at score ``burst``, and
    as the best ("latest") snapshot with ``best_score = burst``."""
    from hex_gym_env_tpu_torch.train.bank import OpponentBank

    stack = {k: v.clone() for k, v in bank.params.items()}
    for k in stack:
        stack[k][slot] = params[k]
    scores = bank.scores.clone()
    scores[slot] = float(burst)
    return OpponentBank(params=stack, scores=scores,
                        best_params={k: v.clone() for k, v in params.items()},
                        best_score=scores.new_tensor(float(burst)))


def legacy_config(board_size: int, bursts: int, burst_steps: int, history: int, n_envs: int):
    from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

    n_steps = max(1, burst_steps // n_envs)
    return TrainConfig(
        ppo=PPOConfig(n_steps=n_steps, minibatch_size=min(256, n_steps * n_envs)),
        selfplay=SelfplayConfig(
            board_size=board_size, n_envs=n_envs, buffer_size=history,
            best_prob=0.8,  # 80% latest / 20% history, selfplay.py:61-92
        ),
        total_timesteps=bursts * n_steps * n_envs,
        model_name=f"legacy_{board_size}x{board_size}",
    )


def run_bursts(cfg, bursts: int, device=None, on_burst=None):
    """``bursts`` PPO iterations, each followed by the history append;
    ``on_burst(burst, state, metrics)`` sees each.  Returns the algorithm
    and the final state."""
    from hex_gym_env_tpu_torch.train import SelfplayPPO

    algo = SelfplayPPO(cfg, device)
    state = algo.init_state(cfg.selfplay.seed)
    history = cfg.selfplay.buffer_size
    for burst in range(1, bursts + 1):
        state, metrics = algo.train_step(state)
        state = dataclasses.replace(state, bank=append_to_history(
            state.bank, state.params, (burst - 1) % history, burst))
        if on_burst is not None:
            on_burst(burst, state, metrics)
    return algo, state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board-size", type=int, default=5)
    ap.add_argument("--bursts", type=int, default=20,
                    help="outer-loop iterations (reference: 'generations')")
    ap.add_argument("--burst-steps", type=int, default=8192,
                    help="agent transitions per burst (reference: learn(100-500))")
    ap.add_argument("--history", type=int, default=10, help="model-history size")
    ap.add_argument("--n-envs", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from hex_gym_env_tpu_torch.utils.checkpoint import save_params

    cfg = legacy_config(args.board_size, args.bursts, args.burst_steps, args.history,
                        args.n_envs)

    def report(burst, state, metrics):
        steps = state.iteration * cfg.ppo.n_steps * cfg.selfplay.n_envs
        print(f"burst {burst}/{args.bursts}: steps={steps} "
              f"ep_rew={float(metrics.mean_episode_reward):+.3f} "
              f"episodes={int(metrics.episodes_finished)}", flush=True)

    _, state = run_bursts(cfg, args.bursts, "cpu" if args.cpu else None, report)
    out = f"models/{cfg.model_name}/final"
    save_params(out, {k: v.cpu() for k, v in state.params.items()})
    print(f"saved {out}")


if __name__ == "__main__":
    main()
