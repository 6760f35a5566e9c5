"""Batched environment state: a dataclass of tensors.

The counterpart of the JAX package's ``core/state.py``.  Winner codes mirror
the reference's observable outcomes: the reference returns seat ids 0/1 for
a win (``HexSingleGame.py:111-115``), ``None`` on a full-board draw
(``:117-119``), and the sentinel ``3`` for an invalid move that terminates
the episode (``:95-96`` + env handling at ``:240-241``).  ``None``/ongoing
maps to -1 here and draw to 2.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Winner(enum.IntEnum):
    """Outcome codes stored in ``HexState.winner``."""

    ONGOING = -1
    SEAT_0 = 0  # "black": connects top row to bottom row in the world frame
    SEAT_1 = 1  # "white": connects left col to right col in the world frame
    DRAW = 2  # board full with no connection (reachable only via quirks)
    INVALID = 3  # episode terminated by an invalid move (reference sentinel 3)


@dataclasses.dataclass
class HexState:
    """State of a batch of Hex games; every tensor has a leading batch axis B.

    Attributes:
      stones: (B, 2, L) bool — stones[b, s, c]: seat ``s`` occupies world
        cell ``c`` (flat index, lane-padded to L).
      labels: (B, L) int32 — flat connectivity labels over cells + 4 virtual
        edge nodes (``ops/labels.py``); equal labels == same group.  Padding
        lanes hold their own index.
      to_move: (B,) int32 — seat to move (0 or 1).
      done: (B,) bool.
      winner: (B,) int32 — ``Winner`` codes.
      empty: (B,) int32 — number of empty cells.
      move_count: (B,) int32 — moves applied this episode.
    """

    stones: torch.Tensor
    labels: torch.Tensor
    to_move: torch.Tensor
    done: torch.Tensor
    winner: torch.Tensor
    empty: torch.Tensor
    move_count: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.stones.shape[0]

    @property
    def lanes(self) -> int:
        return self.stones.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.stones.device
