"""Headless pygame GUI tests of the port (SDL dummy video driver), the
counterparts of ``tests/test_gui.py``.

Pins the geometry and interaction contract of the port's
``interactive/gui.py``:
center math, click -> cell resolution, board rendering with stones and the
probability overlay, dark-mode palette swap, and the InteractiveGame
click-to-action loop (driven by synthetic pygame events).
"""

import math
import os

import numpy as np
import pytest

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

pygame = pytest.importorskip("pygame")

from hex_gym_env_tpu_torch.interactive.gui import Gui  # noqa: E402
from hex_gym_env_tpu_torch.interactive.interactive import InteractiveGame  # noqa: E402


@pytest.fixture()
def gui():
    g = Gui(np.zeros((5, 5), dtype=int), radius=30)
    yield g
    pygame.quit()


def test_center_geometry_matches_reference_formula(gui):
    r = gui.radius
    cx, cy = gui.get_center(2, 3)
    assert cx == pytest.approx(3 * r / 2 + 2 * r + 1.5 * r)
    assert cy == pytest.approx(math.sqrt(3) / 2 * 3 * r + 1.5 * r)


def test_pixel_to_pos_roundtrip_every_cell(gui):
    for y in range(5):
        for x in range(5):
            cx, cy = gui.get_center(y + 1, x + 1)
            assert gui.pixel_to_pos(cx + 2, cy - 3) == (y, x)


def test_pixel_far_outside_returns_none(gui):
    assert gui.pixel_to_pos(-500.0, -500.0) is None


def test_update_board_renders_stones_and_edges(gui):
    board = np.zeros((5, 5), dtype=int)
    board[0, 0] = -1  # black stone
    board[4, 4] = 1  # white stone
    gui.update_board(board)
    # stone pixels carry the stone colors at the cell centers
    c00 = gui.screen.get_at(tuple(int(v) for v in gui.get_center(1, 1)))[:3]
    c44 = gui.screen.get_at(tuple(int(v) for v in gui.get_center(5, 5)))[:3]
    assert c00 == gui.colors["black_stone"]
    assert c44 == gui.colors["white_stone"]
    # border cells: top row = black edge, left column = white edge
    top = gui.screen.get_at(tuple(int(v) for v in gui.get_center(0, 2)))[:3]
    left = gui.screen.get_at(tuple(int(v) for v in gui.get_center(2, 0)))[:3]
    assert top == gui.colors["black_edge"]
    assert left == gui.colors["white_edge"]


def test_probability_overlay_and_dark_mode(gui):
    board = np.zeros((5, 5), dtype=int)
    gui.update_field_text(np.linspace(0, 1, 25), board)
    assert gui.field_text.shape == (5, 5)
    # dark-mode palette swap via the 'd' keybinding
    pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_d))
    assert gui.get_move() == "redraw"
    assert gui.dark_mode and gui.colors["background"] == (25, 25, 30)


def test_keybindings_map_to_meta_moves(gui):
    for key, expected in [
        (pygame.K_a, "ai_move"),
        (pygame.K_z, "undo_move"),
        (pygame.K_s, "show_ratings"),
        (pygame.K_r, "restart"),
        (pygame.K_e, "editor"),
    ]:
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=key))
        assert gui.get_move() == expected


def test_interactive_game_click_to_action():
    board = np.zeros((4, 4), dtype=int)
    board[0, 0] = -1  # occupied: a click there must be ignored
    game = InteractiveGame(board, radius=30, dark_mode=False)
    try:
        occupied = game.gui.get_center(1, 1)
        target = game.gui.get_center(3, 2)  # cell (2, 1) -> action 9
        for pos in (occupied, target):
            pygame.event.post(
                pygame.event.Event(
                    pygame.MOUSEBUTTONDOWN, button=1,
                    pos=(int(pos[0]), int(pos[1])),
                )
            )
        assert game.choose_action(board) == 2 * 4 + 1
    finally:
        pygame.quit()


def _post_key(key):
    pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=key))


def _post_click(gui, y, x):
    pos = gui.get_center(y + 1, x + 1)
    pygame.event.post(
        pygame.event.Event(
            pygame.MOUSEBUTTONDOWN, button=1, pos=(int(pos[0]), int(pos[1]))
        )
    )


def test_interactive_ai_move_plays_policy_action():
    """The `a` key hands the human's move to the wired policy
    (the reference's intended play_ai_move, interactive.py:47-60)."""
    board = np.zeros((4, 4), dtype=int)
    game = InteractiveGame(board, radius=30, dark_mode=False)
    try:
        calls = []

        def policy(b, mask):
            calls.append(np.array(b))
            return int(np.flatnonzero(mask)[0])

        game.ai_policy = policy
        _post_key(pygame.K_a)
        assert game.choose_action(board) == 0
        assert len(calls) == 1
    finally:
        pygame.quit()


def test_interactive_undo_redraws_and_keeps_waiting():
    board = np.zeros((4, 4), dtype=int)
    board[1, 1] = -1
    game = InteractiveGame(board, radius=30, dark_mode=False)
    try:
        undone = np.zeros((4, 4), dtype=int)  # position after the undo
        game.undo_hook = lambda: undone
        _post_key(pygame.K_z)
        _post_click(game.gui, 1, 1)  # legal again after the undo
        assert game.choose_action(board) == 1 * 4 + 1
        assert game.last_meta_move == "undo_move"
    finally:
        pygame.quit()


def test_interactive_editor_mode_suppresses_moves_and_commits_edits():
    """Editor mode: clicks cycle cells and commit via edit_hook; no action
    is ever returned while editing (gui.py:48 'AI will not move')."""
    board = np.zeros((4, 4), dtype=int)
    game = InteractiveGame(board, radius=30, dark_mode=False)
    try:
        commits = []
        game.edit_hook = lambda b: commits.append(np.array(b))
        _post_key(pygame.K_e)  # editor on
        _post_click(game.gui, 0, 0)  # empty -> -1
        _post_click(game.gui, 0, 0)  # -1 -> +1
        _post_key(pygame.K_e)  # editor off
        _post_click(game.gui, 2, 2)  # now a real move
        assert game.choose_action(board) == 2 * 4 + 2
        assert len(commits) == 2
        assert commits[0][0, 0] == -1 and commits[1][0, 0] == 1
    finally:
        pygame.quit()


def test_interactive_restart_returns_sentinel():
    board = np.zeros((4, 4), dtype=int)
    game = InteractiveGame(board, radius=30, dark_mode=False)
    try:
        _post_key(pygame.K_r)
        assert game.choose_action(board) == -1
        assert game.last_meta_move == "restart"
    finally:
        pygame.quit()


def test_selfplay_wrapper_gui_restart_and_undo(monkeypatch):
    """End-to-end: human presses r mid-game -> step returns restart info;
    undo rewinds a full move pair through the env history."""
    from hex_gym_env_tpu_torch.compat import HexEnv, selfplay_wrapper

    env = selfplay_wrapper(HexEnv)(board_size=4, play_gui=True, agent_player_num=0,
                                   device="cpu")
    try:
        obs, _ = env.reset(seed=0)
        human = env.opponent_model
        # agent (seat 0) moves; human replies via a scripted click, then
        # a second agent move where the human presses r
        _post_click(human.gui, 0, 0)
        obs, r, done, _, info = env.step(5)
        assert not done and "restart" not in info

        # undo hook: rewinds the human's click + the agent move
        before = np.array(env.observation)
        after_undo = env._undo_for_human()
        assert (np.asarray(after_undo) != before).any()
        # events must be queued BEFORE the step that blocks on the human
        _post_click(human.gui, 0, 0)  # human's reply to the redone move
        env.step(5)
        _post_key(pygame.K_r)  # human requests a restart next turn
        obs, r, done, _, info = env.step(6)
        assert done and info.get("restart") is True
    finally:
        pygame.quit()


def _patch_has_text(gui, y, x) -> bool:
    """True when the text color appears near cell (y, x)'s center.

    Antialiased glyphs (the bundled DejaVu font) blend most pixels toward
    the background, so sample every pixel — but demand >=3 near-solid
    glyph-core pixels (Manhattan distance < 45 from the text color): one
    pixel within a looser distance could come from a black stone or a blend
    pixel.  45 excludes every color an EMPTY probed cell can show in either
    scheme (closest: light black_stone at 60; dark white_stone is nearer to
    dark text, so only probe empty cells) while glyph cores at >=90% text
    blend pass.
    """
    cx, cy = gui.get_center(y + 1, x + 1)
    text = gui.colors["text"]
    hits = 0
    for dy in range(-10, 11):
        for dx in range(-10, 11):
            px = gui.screen.get_at((int(cx) + dx, int(cy) + dy))[:3]
            if sum(abs(a - b) for a, b in zip(px, text)) < 45:
                hits += 1
                if hits >= 3:
                    return True
    return False


def test_ratings_toggle_through_choose_action():
    """Press `s` twice mid-game through InteractiveGame.choose_action (the
    path that used to crash): overlay appears, then disappears, no exception
    (reference gui.py:50,131-136 + interactive.py:31-32)."""
    board = np.zeros((4, 4), dtype=int)
    game = InteractiveGame(board, radius=30, dark_mode=False)
    try:
        gui = game.gui
        # overlay data present but hidden by default
        gui.update_field_text(np.linspace(0, 1, 16), board)
        assert gui.show_field_text is False
        assert not _patch_has_text(gui, 0, 0)
        # `s` toggles the overlay on; the click ends the wait loop
        _post_key(pygame.K_s)
        _post_click(gui, 2, 1)
        assert game.choose_action(board) == 2 * 4 + 1
        assert gui.show_field_text is True
        assert _patch_has_text(gui, 0, 0)
        # field_text persists across redraws; `s` again hides it
        _post_key(pygame.K_s)
        _post_click(gui, 2, 2)
        assert game.choose_action(board) == 2 * 4 + 2
        assert gui.show_field_text is False
        assert gui.field_text is not None
        assert not _patch_has_text(gui, 0, 0)
    finally:
        pygame.quit()


def test_hex_v0_interactive_restart_resets_episode():
    """The `r` key during the opponent's turn in `hex-v0` interactive mode
    must end the episode as a restart request, not feed the -1 sentinel to
    the core as an invalid move."""
    from hex_gym_env_tpu_torch.compat.gym_env import HexEnvV0

    env = HexEnvV0(board_size=4, opponent_policy="interactive", device="cpu")
    try:
        obs, _ = env.reset()
        # agent (black) moves; human opponent presses `r`
        _post_key(pygame.K_r)
        obs, reward, done, truncated, info = env.step(0)
        assert done and info.get("restart")
        assert reward == 0.0
        # a fresh reset plays normally afterwards
        _post_click(env._interactive.gui, 1, 1)
        obs, _ = env.reset()
        obs, reward, done, truncated, info = env.step(0)
        assert not info.get("restart")
    finally:
        pygame.quit()
