"""Text-protocol (GTP-style) Hex engine CLI.

The counterpart of the JAX package's ``scripts/play_cli.py``: a GTP-style
loop over ``compat.HexEnv``.  Commands (a subset of GTP adapted to Hex):

    name / version / protocol_version
    boardsize N            reset to an NxN board
    clear_board
    play <b|w> <move>      move like "b4" (letter column, number row)
    genmove <b|w>          engine answers with its move
    showboard
    final_score            "B+" / "W+" / "?" while undecided
    list_commands / quit

Engine policy: ``--checkpoint`` (a ``params:`` or ``orbax:`` spec),
``--sb3`` (a reference SB3 zip), else uniform random.  ``genmove`` samples
through the masked Gumbel-max sampler from a generator seeded with 0.  The
game runs on ``cuda`` (the env step's kernel) unless ``--cpu``.

    printf "boardsize 5\\nplay b a1\\ngenmove w\\nshowboard\\nquit\\n" | \\
        python -m hex_gym_env_tpu_torch.scripts.play_cli --cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

COMMANDS = [
    "name", "version", "protocol_version", "boardsize", "clear_board",
    "play", "genmove", "showboard", "final_score", "list_commands", "quit",
]


def policy_spec(sb3: Optional[str], checkpoint: Optional[str]) -> str:
    """The ``models/loading`` spec of the CLI's engine policy."""
    if sb3:
        return f"sb3:{sb3}"
    return checkpoint or "random"


class CliGame:
    def __init__(self, board_size: int = 5, sb3: Optional[str] = None,
                 checkpoint: Optional[str] = None, device=None):
        from hex_gym_env_tpu_torch.utils.device import resolve_device

        self._spec = policy_spec(sb3, checkpoint)
        self.device = resolve_device(device)
        self._generator = torch.Generator(self.device).manual_seed(0)
        self._build(board_size)

    def _build(self, n: int) -> None:
        from hex_gym_env_tpu_torch.compat import HexEnv
        from hex_gym_env_tpu_torch.models.loading import load_policy_params

        self.n = n
        self.env = HexEnv(board_size=n, device=self.device)
        self.env.reset()
        self.model, self.params = load_policy_params(self._spec, n, device=self.device)

    @torch.no_grad()
    def logits(self) -> torch.Tensor:
        """The engine policy's (1, N*N) logits on the current position."""
        obs = torch.as_tensor(self.env.observation, dtype=torch.float32,
                              device=self.device)[None]
        return torch.func.functional_call(self.model, self.params, (obs,))[0]

    def _act(self) -> int:
        from hex_gym_env_tpu_torch.ops import masked

        legal = torch.as_tensor(self.env.legal_actions(), device=self.device)[None]
        bits = masked.draw_bits(self._generator, legal.shape, self.device)
        return int(masked.sample(bits, self.logits(), legal)[0])

    # -- move encoding ------------------------------------------------------
    # The CLI speaks fixed WORLD coordinates ("b4" = column b, row 4; black
    # connects rows, white connects columns) while the env consumes
    # mover-frame actions (the board inverts every move) — seat 1's world
    # (y, x) is mover-frame (x, y).

    def _parse_move(self, text: str, seat: int) -> int:
        text = text.strip().lower()
        x = ord(text[0]) - ord("a")
        y = int(text[1:]) - 1
        if not (0 <= x < self.n and 0 <= y < self.n):
            raise ValueError(f"move off board: {text}")
        if seat == 1:
            y, x = x, y
        return y * self.n + x

    def _fmt_move(self, action: int, seat: int) -> str:
        y, x = divmod(action, self.n)
        if seat == 1:
            y, x = x, y
        return f"{chr(ord('a') + x)}{y + 1}"

    def _world_board_str(self) -> str:
        board = self.env.world_board()
        sym = {0: ".", -1: "B", 1: "W"}
        return "\n".join(
            " " * i + " ".join(sym[int(v)] for v in row) for i, row in enumerate(board)
        )

    def _to_move_error(self, color_arg: str) -> Optional[str]:
        color = {"b": 0, "w": 1}[color_arg[0].lower()]
        if self.env.current_player_num != color:
            return f"it is not {color_arg}'s turn"
        if self.env.done:
            return "game is over"
        return None

    def respond(self, line: str) -> tuple[bool, str]:
        parts = line.strip().split()
        if not parts:
            return True, ""
        cmd, *args = parts
        try:
            if cmd == "name":
                return True, "hex_gym_env_tpu_torch"
            if cmd == "version":
                import hex_gym_env_tpu_torch

                return True, hex_gym_env_tpu_torch.__version__
            if cmd == "protocol_version":
                return True, "2"
            if cmd == "list_commands":
                return True, "\n".join(COMMANDS)
            if cmd == "boardsize":
                self._build(int(args[0]))
                return True, ""
            if cmd == "clear_board":
                self.env.reset()
                return True, ""
            if cmd == "play":
                error = self._to_move_error(args[0])
                if error:
                    return False, error
                action = self._parse_move(args[1], self.env.current_player_num)
                if not self.env.legal_actions()[action]:
                    return False, "illegal move"
                self.env.step(action)
                return True, ""
            if cmd == "genmove":
                error = self._to_move_error(args[0])
                if error:
                    return False, error
                seat = self.env.current_player_num
                action = self._act()
                self.env.step(action)
                return True, self._fmt_move(action, seat)
            if cmd == "showboard":
                return True, "\n" + self._world_board_str()
            if cmd == "final_score":
                return True, {0: "B+", 1: "W+"}.get(self.env.winner, "?")
            if cmd == "quit":
                return True, ""
            return False, f"unknown command: {cmd}"
        except (ValueError, KeyError, IndexError) as e:
            return False, str(e)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board-size", type=int, default=5)
    ap.add_argument("--sb3", help="a reference SB3 zip checkpoint")
    ap.add_argument("--checkpoint", help="a params:/orbax: spec")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    game = CliGame(args.board_size, sb3=args.sb3, checkpoint=args.checkpoint,
                   device="cpu" if args.cpu else None)
    for line in sys.stdin:
        ok, payload = game.respond(line)
        prefix = "=" if ok else "?"
        print(f"{prefix} {payload}".rstrip(), flush=True)
        print(flush=True)
        if line.strip() == "quit":
            break


if __name__ == "__main__":
    main()
