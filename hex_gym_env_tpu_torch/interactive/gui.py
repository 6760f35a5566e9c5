"""Pygame board GUI, a copy of the JAX package's ``interactive/gui.py`` (host
code: it draws numpy boards and touches no device).

Functional parity with the reference's ``minihex/interactive/gui.py``:
rhombic board of flat-top hexagons with the two players' edges painted on a
one-cell border, click-to-move (nearest hexagon center), dark-mode toggle,
per-cell float overlay text (policy probabilities), winner banner, restart
and editor keybindings.  Geometry follows the same center/vertex math
(``gui.py:78-89,116-119``): centers at ``(x*r/2 + y*r, sqrt(3)/2 * x*r)``
skewed axes, vertices at angles ``pi/6 + k*pi/3``.

Written fresh for this framework (world-frame int boards: -1 black / +1
white / 0 empty); pygame is an optional dependency — import errors surface
only when a GUI is actually requested.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

LIGHT = {
    "background": (245, 245, 245),
    "lines": (50, 50, 50),
    "black_stone": (30, 30, 30),
    "white_stone": (235, 235, 235),
    "empty": (200, 160, 110),
    "black_edge": (30, 30, 30),
    "white_edge": (235, 235, 235),
    "text": (10, 10, 10),
    "banner": (200, 40, 40),
}
DARK = {
    "background": (25, 25, 30),
    "lines": (180, 180, 180),
    "black_stone": (15, 15, 15),
    "white_stone": (225, 225, 225),
    "empty": (90, 70, 50),
    "black_edge": (15, 15, 15),
    "white_edge": (225, 225, 225),
    "text": (230, 230, 230),
    "banner": (240, 80, 80),
}

BLACK, WHITE, EMPTY = -1, 1, 0


class Gui:
    """Render a Hex board and collect human moves.

    ``get_move()`` runs the event loop until the human clicks a cell or hits
    a keybinding, returning either ``(y, x)`` board coordinates or one of
    the meta-moves {"show_ratings", "redraw", "ai_move", "undo_move",
    "restart", "editor"} — the same duck-type contract the reference's
    ``InteractiveGame`` consumes (``interactive.py:28-39``).
    """

    def __init__(self, board: np.ndarray, radius: int = 40, dark_mode: bool = False):
        import pygame

        self.pygame = pygame
        self.radius = radius
        self.dark_mode = dark_mode
        self.colors = DARK if dark_mode else LIGHT
        self.board = np.asarray(board)
        n = self.board.shape[0]
        self.size = n
        width = int((1.5 * (n + 2)) * radius + radius)
        height = int(math.sqrt(3) / 2 * (n + 2) * radius + 2 * radius)
        pygame.init()
        self.screen = pygame.display.set_mode((width, height))
        pygame.display.set_caption("hex_gym_env_tpu_torch")
        # The reference ships its own GUI font (``fonts/FallingSky-JKwK.otf``,
        # loaded at reference gui.py:65-67); we bundle the freely-licensed
        # DejaVu Sans instead (fonts/ + DEJAVU-LICENSE) so rendering is
        # identical across machines, falling back to the system default if
        # the asset is missing from a stripped install.
        font_path = os.path.join(os.path.dirname(__file__), "fonts", "DejaVuSans.ttf")
        size = max(14, radius // 2)
        try:
            self.font = pygame.font.Font(font_path, size)
        except (FileNotFoundError, OSError):
            self.font = pygame.font.SysFont(None, size)
        self.field_text: Optional[np.ndarray] = None
        # ratings-overlay visibility: off by default, toggled by the `s`
        # key (reference gui.py:50 defines it, :131 gates drawing on it,
        # interactive.py:31-32 flips it).  ``field_text`` persists across
        # redraws so toggling back on shows the last overlay.
        self.show_field_text = False
        self.editor_mode = False
        self.update_board(self.board)

    # -- geometry (reference gui.py:78-89) ---------------------------------

    def get_center(self, y: int, x: int):
        r = self.radius
        cx = (x * r / 2) + (y * r) + 1.5 * r
        cy = (math.sqrt(3) / 2 * x * r) + 1.5 * r
        return (cx, cy)

    def pixel_to_pos(self, px: float, py: float):
        best, best_d = None, 1e18
        for y in range(self.size):
            for x in range(self.size):
                cx, cy = self.get_center(y + 1, x + 1)
                d = (cx - px) ** 2 + (cy - py) ** 2
                if d < best_d:
                    best, best_d = (y, x), d
        if best is not None and best_d <= self.radius**2:
            return best
        return None

    def _hexagon(self, center):
        r = self.radius / math.sqrt(3) * 1.04
        return [
            (
                center[0] + r * math.cos(math.pi / 6 + k * math.pi / 3),
                center[1] + r * math.sin(math.pi / 6 + k * math.pi / 3),
            )
            for k in range(6)
        ]

    # -- drawing -----------------------------------------------------------

    def _cell_color(self, value: int):
        c = self.colors
        return {BLACK: c["black_stone"], WHITE: c["white_stone"], EMPTY: c["empty"]}[int(value)]

    def update_board(self, board: np.ndarray) -> None:
        """Redraw the padded board: border cells carry the edge colors
        (black owns top/bottom rows, white owns left/right columns)."""
        pygame = self.pygame
        self.board = np.asarray(board)
        n = self.size
        c = self.colors
        self.screen.fill(c["background"])
        padded = np.zeros((n + 2, n + 2), dtype=int)
        padded[1:-1, 1:-1] = self.board
        for y in range(n + 2):
            for x in range(n + 2):
                border_y = y in (0, n + 1)
                border_x = x in (0, n + 1)
                center = self.get_center(y, x)
                verts = self._hexagon(center)
                if border_y and border_x:
                    continue  # corners stay background
                if border_y:
                    color = c["black_edge"]
                elif border_x:
                    color = c["white_edge"]
                else:
                    color = self._cell_color(padded[y, x])
                pygame.draw.polygon(self.screen, color, verts)
                pygame.draw.polygon(self.screen, c["lines"], verts, 2)
        if self.show_field_text and self.field_text is not None:
            self._draw_field_text()
        pygame.display.flip()

    def update_field_text(self, values: np.ndarray, board: np.ndarray) -> None:
        """Overlay one float per cell (policy-probability display,
        reference gui.py:91-93,131-140)."""
        self.field_text = np.asarray(values).reshape(self.size, self.size)
        self.update_board(board)

    def _draw_field_text(self) -> None:
        for y in range(self.size):
            for x in range(self.size):
                if self.board[y, x] != EMPTY:
                    continue
                txt = self.font.render(
                    f"{self.field_text[y, x]:.1f}", True, self.colors["text"]
                )
                cx, cy = self.get_center(y + 1, x + 1)
                self.screen.blit(txt, (cx - txt.get_width() / 2, cy - txt.get_height() / 2))
        self.pygame.display.flip()

    def show_winner(self, winner: int) -> None:
        name = "BLACK" if winner == 0 else "WHITE"
        txt = self.font.render(f"{name} wins! (r to restart)", True, self.colors["banner"])
        self.screen.blit(txt, (10, 10))
        self.pygame.display.flip()

    # -- input loop (keybindings per reference gui.py:162-188) -------------

    def get_move(self):
        pygame = self.pygame
        while True:
            event = pygame.event.wait()
            if event.type == pygame.QUIT:
                raise SystemExit
            if event.type == pygame.MOUSEBUTTONDOWN and event.button == 1:
                pos = self.pixel_to_pos(*event.pos)
                if pos is not None:
                    return pos
            if event.type == pygame.KEYDOWN:
                if event.key == pygame.K_d:
                    self.dark_mode = not self.dark_mode
                    self.colors = DARK if self.dark_mode else LIGHT
                    return "redraw"
                if event.key == pygame.K_a:
                    return "ai_move"
                if event.key == pygame.K_z:
                    return "undo_move"
                if event.key == pygame.K_s:
                    return "show_ratings"
                if event.key == pygame.K_r:
                    return "restart"
                if event.key == pygame.K_e:
                    self.editor_mode = not self.editor_mode
                    return "editor"
