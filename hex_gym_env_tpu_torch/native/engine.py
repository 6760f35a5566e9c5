"""Python wrapper over the native scalar engine.

The counterpart of the JAX package's ``native/engine.py``.  It mirrors the
batched core's observable contract exactly (mover-frame
observations/actions, 2-vector rewards, ``Winner`` codes) for a single
game — the host-side path for interactive play, scalar tooling, and the
oracle that ``compat.HexEnv`` is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from hex_gym_env_tpu_torch.native import load


class NativeHexEnv:
    """Scalar variant-B env backed by the C engine."""

    def __init__(self, board_size: int = 5):
        self._lib = load()
        self.n = board_size
        self._g = self._lib.hex_new(board_size)
        if not self._g:
            raise ValueError(f"unsupported board size {board_size}")
        self._obs_buf = np.zeros(board_size * board_size, dtype=np.int8)
        self._legal_buf = np.zeros(board_size * board_size, dtype=np.uint8)
        self._reward_buf = (ctypes.c_float * 2)()
        self.reset()

    def __del__(self):
        g, self._g = getattr(self, "_g", None), None
        if g:
            self._lib.hex_free(g)

    # -- surface mirroring compat.HexEnv ----------------------------------

    def reset(self, board: Optional[np.ndarray] = None) -> np.ndarray:
        if board is None:
            self._lib.hex_reset(self._g)
        else:
            arr = np.ascontiguousarray(board, dtype=np.int8).reshape(-1)
            if arr.size != self.n * self.n:
                raise ValueError(f"board has {arr.size} cells, not {self.n * self.n}")
            self._lib.hex_set_board(
                self._g, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
            )
        return self.observation

    @property
    def observation(self) -> np.ndarray:
        self._lib.hex_observe(
            self._g, self._obs_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        )
        return self._obs_buf.reshape(self.n, self.n).copy()

    def legal_actions(self) -> np.ndarray:
        self._lib.hex_legal(
            self._g, self._legal_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        return self._legal_buf.astype(bool)

    def world_board(self) -> np.ndarray:
        buf = np.zeros(self.n * self.n, dtype=np.int8)
        self._lib.hex_world_board(
            self._g, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        )
        return buf.reshape(self.n, self.n)

    @property
    def current_player_num(self) -> int:
        return self._lib.hex_to_move(self._g)

    @property
    def done(self) -> bool:
        return bool(self._lib.hex_done(self._g))

    @property
    def winner(self) -> Optional[int]:
        """Seat 0/1, 3 after an invalid move; ``None`` while the game runs
        and on a draw, as the reference reports both."""
        w = self._lib.hex_winner(self._g)
        return None if w in (-1, 2) else w

    @property
    def winner_code(self) -> int:
        return self._lib.hex_winner(self._g)

    def step(self, action: int):
        self._lib.hex_step(self._g, int(action), self._reward_buf)
        reward = [float(self._reward_buf[0]), float(self._reward_buf[1])]
        return self.observation, reward, self.done, {}


def random_playout_throughput(board_size: int, games: int, seed: int = 1):
    """(winners ndarray, total_moves) for `games` random-legal playouts."""
    lib = load()
    winners = np.zeros(games, dtype=np.int32)
    moves = lib.hex_random_playouts(
        board_size, games, seed, winners.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    )
    return winners, int(moves)
