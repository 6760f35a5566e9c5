"""Human-vs-model GUI play.

The counterpart of the JAX package's ``scripts/play_gui.py``, over the
port's ``interactive/`` and the selfplay wrapper of ``compat/``:

    # a params: (or orbax:) spec
    python -m hex_gym_env_tpu_torch.scripts.play_gui --board-size 7 \\
        --checkpoint params:hex_gym_env_tpu_torch/models/agents/7x7_strict_sb3.pt

    # a reference SB3 zip
    python -m hex_gym_env_tpu_torch.scripts.play_gui --board-size 5 --sb3 PATH.zip

    # random agent (the reference's play_gui_random.py)
    python -m hex_gym_env_tpu_torch.scripts.play_gui --board-size 11 --random

The human plays through the pygame board (click to move; ``d`` dark mode,
``s`` probability overlay, ``r`` restart).  ``--agent-seat {0,1}`` picks the
model's seat like the reference's ``agent_player_num``.  The model plays its
argmax move.  The game runs on ``cuda`` unless ``--cpu``.
"""

from __future__ import annotations

import argparse

import torch

from hex_gym_env_tpu_torch.scripts.play_cli import policy_spec


def build(board_size: int, spec: str, agent_seat: int = 0, overlay: bool = False,
          device=None):
    """The GUI env (the selfplay wrapper with the human as its opponent) and
    the model's move function ``act(obs, legal) -> action``."""
    from hex_gym_env_tpu_torch.compat import HexEnv, selfplay_wrapper
    from hex_gym_env_tpu_torch.models.loading import load_policy_params
    from hex_gym_env_tpu_torch.ops import masked

    model, params = load_policy_params(spec, board_size, device=device)
    dev = next(iter(params.values())).device

    @torch.no_grad()
    def act(obs, legal) -> int:
        o = torch.as_tensor(obs, dtype=torch.float32, device=dev)[None]
        m = torch.as_tensor(legal, device=dev)[None]
        logits, _ = torch.func.functional_call(model, params, (o,))
        return int(masked.mode(logits, m)[0])

    env = selfplay_wrapper(HexEnv)(
        board_size=board_size, play_gui=True,
        prob_model=(model, params) if overlay else None,
        agent_player_num=agent_seat, device=dev,
    )
    return env, act


def play(env, act) -> int:
    """One game to its end; returns the winner's seat."""
    obs, _ = env.reset()
    terminated = False
    while not terminated:
        obs, _, terminated, _, _ = env.step(act(obs, env.legal_actions()))
    return env.winner


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board-size", type=int, default=5)
    ap.add_argument("--sb3", help="path to a reference SB3 zip checkpoint")
    ap.add_argument("--checkpoint", help="a params:/orbax: spec")
    ap.add_argument("--random", action="store_true", help="random agent")
    ap.add_argument("--agent-seat", type=int, default=0, choices=[0, 1])
    ap.add_argument("--overlay", action="store_true",
                    help="show the model's move probabilities on empty cells")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    spec = "random" if args.random else policy_spec(args.sb3, args.checkpoint)
    env, act = build(args.board_size, spec, args.agent_seat, args.overlay,
                     "cpu" if args.cpu else None)
    winner = play(env, act)
    print(f"game over — winner seat: {winner}")
    env.opponent_model.gui.show_winner(winner if winner in (0, 1) else -1)
    env.opponent_model.gui.get_move()  # wait for a last key/click


if __name__ == "__main__":
    main()
