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
plain step on the CPU (``--cpu``).  An MLP side on the card is bound once a
match (``ops/mlp_forward.bind``: its parameters assigned to the module,
their image built in one launch), and each of its forwards is the module's
call, one launch of the forward kernel; any other side (a CNN, or any side
on the CPU) runs ``functional_call`` of its module (cuDNN/cuBLAS on the
card).  Samples are Gumbel-max draws over 32-bit words
(``ops/masked.sample``), drawn from a ``torch.Generator`` seeded by
``--seed`` or given as ``bits``; the JAX package draws from its own key, so
a stochastic match agrees with it in distribution, and with injected words
game for game.

``run_match`` is instrumented with ``utils/profiling``'s spans: ``match``
(a root, its unit the match's number in the process), two ``match.load``
(``load.template``, ``load.read``, ``load.h2d`` inside), two
``match.bind``, a ``match.ply`` each ply (``ply.observe``, ``ply.forward``
and ``ply.pick`` for each side, ``ply.step``) and ``match.result``; and it
counts ``matches``, ``host_syncs``, the loads' ``h2d_bytes``, and
``forwards`` (one a side each ply, whichever path runs).  ``--profile DIR``
plays the match inside ``profiling.trace(DIR)``: it writes
``DIR/trace.json`` with the spans as ``hex.*`` ranges and prints, to
stderr, a line per span name (calls, total and self ms) and the counters.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Optional

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models.loading import load_policy_params
from hex_gym_env_tpu_torch.ops import masked, mlp_forward
from hex_gym_env_tpu_torch.utils import profiling
from hex_gym_env_tpu_torch.utils.device import resolve_device

MODES = ("stochastic", "deterministic", "a-det", "b-det")
_match_ids = itertools.count()


def bits_shape(board_size: int, games: int) -> tuple[int, int, int, int]:
    """The random words of one match: ``(plies, side, game, action)`` — for
    each of the ``num_cells + 1`` plies and each side, a row of words per
    game, one for each action's Gumbel noise."""
    cells = board_size * board_size
    return (cells + 1, 2, games, cells)


def _bind(model, params):
    """``None`` where ``model`` now holds ``params`` and forwards through
    the kernel (``mlp_forward.bind``: an MLP side on the card), else
    ``params``, which each forward passes through ``functional_call``."""
    with profiling.span("match.bind"):
        return None if mlp_forward.bind(model, params) else params


def _forward(model, params, obs):
    with profiling.span("ply.forward"):
        profiling.count("forwards")
        if params is None:
            logits, _ = model(obs)
        else:
            logits, _ = torch.func.functional_call(model, params, (obs,))
    return logits


def _pick(logits, legal, bits, deterministic):
    with profiling.span("ply.pick"):
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
    with profiling.span("match", unit=next(_match_ids)):
        profiling.count("matches")
        device = resolve_device(device)
        if mode is None:
            mode = "stochastic" if stochastic else "deterministic"
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        a_det = mode in ("deterministic", "a-det")
        b_det = mode in ("deterministic", "b-det")

        topo = get_topology(board_size)
        ops = hex_env.make_ops(topo, "auto", device)
        with profiling.span("match.load"):
            model_a, params_a = load_policy_params(spec_a, board_size,
                                                   family=family_a, device=device)
        with profiling.span("match.load"):
            model_b, params_b = load_policy_params(spec_b, board_size,
                                                   family=family_b, device=device)
        params_a = _bind(model_a, params_a)
        params_b = _bind(model_b, params_b)
        B = games
        shape = bits_shape(board_size, B)
        if bits is None:
            if not (a_det and b_det):
                bits = masked.draw_bits(torch.Generator(device).manual_seed(seed), shape, device)
        elif tuple(bits.shape) != shape or bits.dtype != torch.int32:
            raise ValueError(f"bits must be int32 of shape {shape}, got {tuple(bits.shape)} "
                             f"{bits.dtype}")
        else:
            bits = profiling.to_device(bits, device)

        # env i: policy A holds seat (i mod 2) — alternating-seat pairing
        seat_a = torch.arange(B, dtype=torch.int32, device=device) % 2
        state = ops.initial_state(B)
        actions = []
        # every ply evaluates both policies for every game; a finished game's
        # step is a frozen no-op, so the match never stops early
        for t in range(shape[0]):
            with profiling.span("match.ply"):
                with profiling.span("ply.observe"):
                    obs = ops.observe(state).to(torch.float32)
                    legal = ops.legal_mask(state)
                a_act = _pick(_forward(model_a, params_a, obs), legal,
                              None if a_det else bits[t, 0], a_det)
                b_act = _pick(_forward(model_b, params_b, obs), legal,
                              None if b_det else bits[t, 1], b_det)
                with profiling.span("ply.step"):
                    action = torch.where(state.to_move == seat_a, a_act, b_act)
                    state, _ = ops.step(state, action)
                actions.append(action)

        with profiling.span("match.result"):
            winners = profiling.to_host(state.winner).numpy()
            seat = profiling.to_host(seat_a).numpy()
            if record is not None:
                record["winners"] = torch.from_numpy(winners)
                record["actions"] = profiling.to_host(torch.stack(actions))
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
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="play inside profiling.trace(DIR): DIR/trace.json with the hex.* "
                         "spans, and the spans' and counters' totals on stderr")
    args = ap.parse_args()

    def play():
        return run_match(
            args.board_size, args.games, args.a, args.b,
            seed=args.seed, stochastic=not args.deterministic,
            mode=args.mode, family_a=args.a_family, family_b=args.b_family,
            device="cpu" if args.cpu else None,
        )

    if args.profile is None:
        print(json.dumps(play()))
        return
    profiling.take_spans()
    profiling.take_counters()
    with profiling.trace(args.profile):
        out = play()
    print(json.dumps(out))
    for name, row in profiling.span_table(profiling.take_spans()).items():
        print(f"span {name}: {row['calls']} calls, {row['total_ms']:.3f} ms total, "
              f"{row['self_ms']:.3f} ms self", file=sys.stderr)
    for name, value in sorted(profiling.take_counters().items()):
        print(f"counter {name}: {value}", file=sys.stderr)


if __name__ == "__main__":
    main()
