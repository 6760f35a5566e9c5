"""Human-in-the-loop opponent adapter, the counterpart of the JAX package's
``interactive/interactive.py`` (it reads this package's ``utils/settings``).

Duck-typed like any opponent policy (``choose_action(board, mask)``),
wrapping the pygame :class:`~hex_gym_env_tpu_torch.interactive.gui.Gui` — the
equivalent of the reference's ``InteractiveGame``
(``minihex/interactive/interactive.py:11-90``).  Where the reference's
meta-move handlers were dead code (``play_ai_move``/``undo_move`` reference
attributes that never existed, ``interactive.py:41-60``), the intended
behaviors are implemented natively through three optional hooks wired by
the owning environment:

- ``ai_policy(board, mask) -> action`` — the ``a`` key: a model plays the
  human's move;
- ``undo_hook() -> board`` — the ``z`` key: the env rewinds one full move
  and returns the board to redraw;
- ``edit_hook(board) -> None`` — editor mode (``e``): clicks cycle cells
  (empty -> seat0 -> seat1 -> empty) and commit the edited position to the
  env; the AI never replies while editing because no action is returned
  (the reference's gui.py:48 "AI will not move in editor mode").
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class InteractiveGame:
    """GUI-backed human "policy"."""

    def __init__(
        self,
        board: np.ndarray,
        radius: Optional[int] = None,
        dark_mode: Optional[bool] = None,
    ):
        from hex_gym_env_tpu_torch.interactive.gui import Gui
        from hex_gym_env_tpu_torch.utils.settings import gui_settings

        cfg = gui_settings()
        self.gui = Gui(
            np.asarray(board),
            radius=radius if radius is not None else cfg["radius"],
            dark_mode=dark_mode if dark_mode is not None else cfg["dark_mode"],
        )
        self.ai_policy: Optional[Callable] = None
        self.undo_hook: Optional[Callable] = None
        self.edit_hook: Optional[Callable] = None
        self.last_meta_move: Optional[str] = None

    def choose_action(self, board: np.ndarray, action_mask=None) -> int:
        """Block on the event loop until a move is decided: a click on a
        legal empty cell, an ``a``-key AI move, or ``r`` (returns -1 =
        restart request).  Other meta-moves act and keep waiting
        (``interactive.py:76-90``)."""
        board = np.array(board)
        self.gui.update_board(board)
        n = board.shape[0]
        while True:
            move = self.gui.get_move()
            if move == "redraw" or move == "editor":
                self.last_meta_move = move
                self.gui.update_board(board)
                continue
            if isinstance(move, tuple):
                y, x = move
                if self.gui.editor_mode:
                    # cycle the clicked cell; commit, never yield a move
                    board[y, x] = {0: -1, -1: 1, 1: 0}[int(board[y, x])]
                    if self.edit_hook is not None:
                        self.edit_hook(board)
                    self.gui.update_board(board)
                    continue
                if board[y, x] == 0:
                    return int(y * n + x)
                continue
            if move == "ai_move":
                self.last_meta_move = move
                if self.ai_policy is not None:
                    mask = board.reshape(-1) == 0
                    return int(self.ai_policy(board, mask))
                continue
            if move == "undo_move":
                self.last_meta_move = move
                if self.undo_hook is not None:
                    board = np.array(self.undo_hook())
                    self.gui.update_board(board)
                continue
            if move == "show_ratings":
                self.last_meta_move = move
                self.gui.show_field_text = not self.gui.show_field_text
                self.gui.update_board(board)
                continue
            if move == "restart":
                self.last_meta_move = move
                return -1

    def save_model(self, path: str) -> None:
        return None
