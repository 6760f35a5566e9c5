"""Head-to-head strength match between two policies on the card.

The counterpart of the JAX package's ``scripts/match.py``.  Pits policy A
against policy B over many games in lockstep with alternating seats (half
the batch each way) and reports winrates.  Policies: ``--a/--b`` take
``random``, ``sb3:<zip>``, ``orbax:<dir>`` (needs ``tensorstore``) or
``params:<file>`` (``models/loading.py``).

    python -m hex_gym_env_tpu_torch.scripts.match --board-size 7 --games 4096 \\
        --a params:hex_gym_env_tpu_torch/models/agents/7x7_strict_sb3.pt --b random

Every ply steps all games through ``core.env.make_ops(topo, "auto", device)``:
the env-step kernel on the card (``num_cells + 1`` launches a match), the
plain step on the CPU (``--cpu``).  The policies' forwards are the modules'
own (cuBLAS/cuDNN on the card).  Samples are Gumbel-max draws over 32-bit
words (``ops/masked.sample``), drawn from a ``torch.Generator`` seeded by
``--seed`` or given as ``bits``; the JAX package draws from its own key, so
a stochastic match agrees with it in distribution, and with injected words
game for game.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models.loading import load_policy_params
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.utils.device import resolve_device

MODES = ("stochastic", "deterministic", "a-det", "b-det")


def bits_shape(board_size: int, games: int) -> tuple[int, int, int, int]:
    """The random words of one match: ``(plies, side, game, action)`` — for
    each of the ``num_cells + 1`` plies and each side, a row of words per
    game, one for each action's Gumbel noise."""
    cells = board_size * board_size
    return (cells + 1, 2, games, cells)


def _pick(model, params, obs, legal, bits, deterministic):
    logits, _ = torch.func.functional_call(model, params, (obs,))
    if deterministic:
        return masked.mode(logits, legal)
    return masked.sample(bits, logits, legal)


@torch.no_grad()
def run_match(board_size: int, games: int, spec_a: str, spec_b: str,
              seed: int = 0, stochastic: bool = True,
              mode: Optional[str] = None, family_a: str = "MLP-default",
              family_b: str = "MLP-default", device=None,
              bits: Optional[torch.Tensor] = None,
              record: Optional[dict] = None) -> dict:
    """``mode`` selects per-side play style:

    - "stochastic" (default) / "deterministic": both sides alike —
      note that both-deterministic collapses to 2 distinct games;
    - "a-det" / "b-det": one side argmax (ties to the lowest index), the
      other samples — the reference's own eval protocol (SB3
      ``evaluate_policy`` plays the agent deterministically against
      stochastic pool opponents).

    ``device=None`` means ``cuda``.  ``bits`` (``bits_shape``, int32 words)
    replaces the draws from the generator seeded by ``seed``.  ``record``,
    where given, receives the CPU tensors ``winners`` (games,) and
    ``actions`` (plies, games).
    """
    device = resolve_device(device)
    if mode is None:
        mode = "stochastic" if stochastic else "deterministic"
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    a_det = mode in ("deterministic", "a-det")
    b_det = mode in ("deterministic", "b-det")

    topo = get_topology(board_size)
    ops = hex_env.make_ops(topo, "auto", device)
    model_a, params_a = load_policy_params(spec_a, board_size, family=family_a, device=device)
    model_b, params_b = load_policy_params(spec_b, board_size, family=family_b, device=device)
    B = games
    shape = bits_shape(board_size, B)
    if bits is None:
        if not (a_det and b_det):
            bits = masked.draw_bits(torch.Generator(device).manual_seed(seed), shape, device)
    elif tuple(bits.shape) != shape or bits.dtype != torch.int32:
        raise ValueError(f"bits must be int32 of shape {shape}, got {tuple(bits.shape)} "
                         f"{bits.dtype}")
    else:
        bits = bits.to(device)

    # env i: policy A holds seat (i mod 2) — alternating-seat pairing
    seat_a = torch.arange(B, dtype=torch.int32, device=device) % 2
    state = ops.initial_state(B)
    actions = []
    # every ply evaluates both policies for every game; a finished game's
    # step is a frozen no-op, so the match never stops early
    for t in range(shape[0]):
        obs = ops.observe(state).to(torch.float32)
        legal = ops.legal_mask(state)
        a_act = _pick(model_a, params_a, obs, legal, None if a_det else bits[t, 0], a_det)
        b_act = _pick(model_b, params_b, obs, legal, None if b_det else bits[t, 1], b_det)
        action = torch.where(state.to_move == seat_a, a_act, b_act)
        state, _ = ops.step(state, action)
        actions.append(action)

    winners = state.winner.cpu().numpy()
    seat = seat_a.cpu().numpy()
    if record is not None:
        record["winners"] = torch.from_numpy(winners)
        record["actions"] = torch.stack(actions).cpu()
    a_wins = int((winners == seat).sum())
    b_wins = int((winners == 1 - seat).sum())
    return {
        "games": games,
        "mode": mode,
        "a": spec_a,
        "b": spec_b,
        "a_winrate": a_wins / games,
        "b_winrate": b_wins / games,
        "a_wins_as_seat0": int(((winners == 0) & (seat == 0)).sum()),
        "a_wins_as_seat1": int(((winners == 1) & (seat == 1)).sum()),
        "undecided": int((winners < 0).sum() + (winners == 2).sum() + (winners == 3).sum()),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board-size", type=int, default=5)
    ap.add_argument("--games", type=int, default=1024)
    ap.add_argument("--a", default="random")
    ap.add_argument("--b", default="random")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--mode", default=None, choices=list(MODES))
    ap.add_argument("--a-family", default="MLP-default",
                    help="architecture of --a (make_policy name, e.g. CNN)")
    ap.add_argument("--b-family", default="MLP-default")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain step)")
    args = ap.parse_args()
    out = run_match(
        args.board_size, args.games, args.a, args.b,
        seed=args.seed, stochastic=not args.deterministic,
        mode=args.mode, family_a=args.a_family, family_b=args.b_family,
        device="cpu" if args.cpu else None,
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
