"""Round-robin strength tournament with Elo fitting.

The counterpart of the JAX package's ``scripts/tournament.py``.  Plays
every pair of policies head-to-head (alternating seats, stochastic play —
``scripts/match.run_match``, on the card unless ``--cpu``) and fits
Bradley-Terry ratings via the classic minorization-maximization updates,
reported on the Elo scale anchored at the first player = 0.

    python -m hex_gym_env_tpu_torch.scripts.tournament --board-size 7 --games 512 \\
        random params:hex_gym_env_tpu_torch/models/agents/7x7_strict_sb3.pt

The reference has no rating machinery (its ``config.ini`` ``[ELO]`` section
is vestigial upstream-HexHex content that nothing reads — SURVEY.md §2);
this tool supplies the capability natively.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
from typing import Sequence

from hex_gym_env_tpu_torch.scripts.match import run_match


def fit_elo(n_players: int, wins: dict, games: dict, iters: int = 200):
    """Bradley-Terry MM fit; returns Elo ratings anchored at player 0 = 0."""
    gamma = [1.0] * n_players
    for _ in range(iters):
        new = []
        for i in range(n_players):
            w_i = sum(wins.get((i, j), 0.0) for j in range(n_players) if j != i)
            denom = sum(
                games.get((min(i, j), max(i, j)), 0) / (gamma[i] + gamma[j])
                for j in range(n_players)
                if j != i and games.get((min(i, j), max(i, j)), 0)
            )
            new.append(w_i / denom if denom else gamma[i])
        scale = new[0] if new[0] > 0 else 1.0
        gamma = [g / scale for g in new]
    return [400.0 * math.log10(max(g, 1e-12)) for g in gamma]


def run_tournament(players: Sequence[str], board_size: int = 7, games: int = 512,
                   seed: int = 0, device=None):
    """Every pair's match result (in pair order) and each player's Elo (in
    player order)."""
    n = len(players)
    wins: dict = {}
    decided: dict = {}
    results = []
    for i, j in itertools.combinations(range(n), 2):
        r = run_match(board_size, games, players[i], players[j],
                      seed=seed + 1000 * i + j, device=device)
        decided[(i, j)] = r["games"] - r["undecided"]
        wins[(i, j)] = r["a_winrate"] * r["games"]
        wins[(j, i)] = r["b_winrate"] * r["games"]
        results.append(r)
    return results, fit_elo(n, wins, decided)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("players", nargs="+",
                    help="policy specs: random | sb3:<zip> | orbax:<dir> | params:<file>")
    ap.add_argument("--board-size", type=int, default=7)
    ap.add_argument("--games", type=int, default=512, help="games per pair")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain step)")
    args = ap.parse_args()

    results, elo = run_tournament(args.players, args.board_size, args.games, args.seed,
                                  device="cpu" if args.cpu else None)
    for r in results:
        print(json.dumps({"a": r["a"], "b": r["b"], "a_winrate": r["a_winrate"]}))
    table = sorted(zip(args.players, elo), key=lambda t: -t[1])
    print(json.dumps({
        "board_size": args.board_size,
        "games_per_pair": args.games,
        "elo": [{"player": p, "elo": round(e, 1)} for p, e in table],
    }))


if __name__ == "__main__":
    main()
