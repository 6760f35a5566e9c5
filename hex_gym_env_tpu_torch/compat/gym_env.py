"""Gymnasium-compatible scalar env adapters (host-side shells).

The counterpart of the JAX package's ``compat/gym_env.py``.  These
reproduce the reference's two environment surfaces for drop-in use — the
canonical single-agent env (``minihex/HexSingleGame.py:156-331``, variant
"B") and the legacy ``hex-v0`` fixed-opponent env
(``minihex/HexGame.py:145-371``, variant "A") — as thin wrappers around the
batched core with batch 1.  The step goes through ``core.env.make_ops(topo,
"auto", device)``: the env-step kernel on a CUDA device, the plain step on
the CPU.  Every ``observation`` and ``legal_actions`` is a copy to the host:
this is the scalar surface for API parity, interactive play and debugging;
training never touches it (the batched rollout replaces the whole Gym
loop).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

try:  # gymnasium only decides the base class; the envs run without it
    import gymnasium as gym
    from gymnasium import spaces

    _GYM_BASE = gym.Env
except ImportError:  # pragma: no cover
    gym = None
    spaces = None
    _GYM_BASE = object

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core import random_board
from hex_gym_env_tpu_torch.core.state import Winner
from hex_gym_env_tpu_torch.core.topology import get_topology

# the port's ids live in a gymnasium namespace of their own, beside the JAX
# package's un-namespaced ``hex-v0`` and ``hex-single-v0``
GYM_NAMESPACE = "hex_gym_env_tpu_torch"


def random_policy(board: np.ndarray, rng: Optional[np.random.Generator] = None) -> int:
    """Uniform-random move over empty cells in variant-A encoding.

    Free-function twin of ``minihex.random_policy``
    (``minihex/__init__.py:8-12``): empty cells are ``== 2``; the reference
    draws via unseeded ``random.random()``, here an optional ``rng`` makes
    the draw reproducible.
    """
    board = np.asarray(board)
    actions = np.arange(board.size)
    valid = actions[board.flatten() == 2]
    r = np.random.random() if rng is None else rng.random()
    return int(valid[int(r * len(valid))])


class HexEnv(_GYM_BASE):
    """Single-agent, alternate-and-invert Hex env (reference variant B).

    API mirrors ``HexSingleGame.HexEnv``: ``reset() -> (obs, info)``;
    ``step(action) -> (obs, reward_2vec, done, info)`` (the reference's
    old-Gym 4-tuple, ``HexSingleGame.py:262-263``); ``legal_actions()``
    boolean mask over the mover-frame grid.  The game lives on ``device``
    (``None`` means ``cuda``); ``sample_board`` starts draw from a
    ``torch.Generator`` on it, seeded by ``seed``.
    """

    metadata = {"render.modes": ["ansi"]}

    def __init__(
        self,
        board_size: int = 5,
        sample_board: bool = False,
        seed: int = 0,
        device=None,
    ):
        self.board_size = board_size
        self.topo = get_topology(board_size)
        self._ops = hex_env.make_ops(self.topo, "auto", device)
        self.device = self._ops.device
        self.sample_board = sample_board
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._state = None
        self._history = []  # step() before the first reset() must not hit AttributeError
        self.winner: Optional[int] = None
        if spaces is not None:
            self.observation_space = spaces.Box(
                low=-1, high=1, shape=(board_size, board_size), dtype=int
            )
            self.action_space = spaces.Discrete(board_size**2)

    # -- helpers -----------------------------------------------------------

    @property
    def observation(self) -> np.ndarray:
        return self._ops.observe(self._state)[0].cpu().numpy()

    def legal_actions(self) -> np.ndarray:
        return self._ops.legal_mask(self._state)[0].cpu().numpy()

    def world_board(self) -> np.ndarray:
        """The (N, N) int8 world-frame board: -1 seat 0, +1 seat 1."""
        return hex_env.world_boards(self.topo, self._state)[0].cpu().numpy()

    @property
    def current_player_num(self) -> int:
        return int(self._state.to_move[0])

    @property
    def done(self) -> bool:
        return bool(self._state.done[0])

    # -- gym surface -------------------------------------------------------

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        if self.sample_board:
            boards = random_board.sample_boards(self._generator, self.topo, 1)
            self._state = hex_env.state_from_boards(self.topo, boards)
        else:
            self._state = self._ops.initial_state(1)
        self.winner = None
        self._history = []
        obs = self.observation
        return obs, {"state": obs, "last_move_opponent": None, "last_move_player": None}

    def undo_move(self, steps: int = 1) -> np.ndarray:
        """Rewind ``steps`` half-moves (the GUI ``z`` key; the reference's
        ``undo_move`` path was dead code referencing a nonexistent
        ``board.undo_move_board`` — ``interactive.py:41-45``).  Returns the
        restored mover-frame observation.  The history holds whole states on
        the device."""
        for _ in range(min(steps, len(self._history))):
            self._state = self._history.pop()
        if self._state is None:  # undo before the first reset: nothing to show
            return None
        self.winner = None
        return self.observation

    def set_world_board(self, board: np.ndarray) -> None:
        """Replace the position (GUI editor mode), keeping the mover; the
        labels are rebuilt from the stones."""
        self._history.append(self._state)
        boards = torch.as_tensor(np.asarray(board, np.int8), device=self.device)[None]
        self._state = hex_env.state_from_boards(self.topo, boards, to_move=self._state.to_move)
        self.winner = None

    def step(self, action: int):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        self._history.append(self._state)
        actions = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        self._state, rewards = self._ops.step(self._state, actions)
        w = int(self._state.winner[0])
        if w == Winner.INVALID:
            self.winner = 3
        elif w in (0, 1):
            self.winner = w
        else:
            self.winner = None
        r = rewards[0].tolist()
        return self.observation, [float(r[0]), float(r[1])], self.done, {}

    def render(self, mode: str = "ansi", close: bool = False) -> str:
        """ASCII rhombus like the reference's render (``HexSingleGame.py:
        273-298``), returned as a string (also printed)."""
        board = self.observation
        sym = {0: ".", -1: "B", 1: "W"}
        lines = []
        for i, row in enumerate(board):
            lines.append(" " * i + " ".join(sym[int(v)] for v in row))
        out = "\n".join(lines)
        print(out)
        return out


class HexEnvV0(_GYM_BASE):
    """Legacy ``hex-v0`` surface (reference variant A): opponent inside step.

    Mirrors ``minihex/HexGame.py:145-371``: board encoding BLACK=0, WHITE=1,
    EMPTY=2; the opponent policy moves inside ``step`` after the agent;
    rewards +1 win / -1 loss / -100 invalid; board inversion so the opponent
    model always sees itself as black (``HexGame.py:297-303,332-349``);
    ``opponent_policy`` may be a callable ``f(board, mask) -> action``, the
    string ``"random"``, or ``"opponent_predict"`` with ``opponent_model``
    exposing SB3-style ``predict`` (+ epsilon-random mixing, ``:354-359``).
    The game lives on ``device`` (``None`` means ``cuda``).
    """

    metadata = {"render.modes": ["ansi"]}

    def __init__(
        self,
        board_size: int = 5,
        opponent_policy: Any = "random",
        opponent_model: Any = None,
        player_color: int = 0,
        eps: float = 0.0,
        seed: int = 0,
        show_board: bool = False,
        show_result: bool = False,
        device=None,
    ):
        self.board_size = board_size
        self.topo = get_topology(board_size)
        self.opponent_policy = opponent_policy
        self.opponent_model = opponent_model
        self.player_color = player_color  # seat the agent occupies (0=BLACK)
        self.eps = eps
        self.show_board = show_board
        self.show_result = show_result
        self._rng = np.random.default_rng(seed)
        self._inner = HexEnv(board_size=board_size, seed=seed, device=device)
        if spaces is not None:
            self.observation_space = spaces.Box(
                low=0, high=2, shape=(board_size, board_size), dtype=int
            )
            self.action_space = spaces.Discrete(board_size**2)

        # ``show_board=True`` opens the pygame window with the config.ini
        # geometry, like ``HexGame.py:194-197``; ``opponent_policy=
        # "interactive"`` makes the human the opponent (``HexGame.py:163-165``)
        self._interactive = None
        if show_board or opponent_policy == "interactive":
            from hex_gym_env_tpu_torch.interactive.interactive import InteractiveGame

            self._interactive = InteractiveGame(
                np.zeros((board_size, board_size), np.int8)
            )

    # -- GUI helpers ---------------------------------------------------------

    def _gui_sync(self) -> None:
        if self._interactive is not None:
            self._interactive.gui.update_board(self._inner.world_board())

    def _interactive_action(self) -> int:
        """Human plays the opponent seat: world-frame click -> mover-frame
        action (the inner canonical core transposes for the WHITE seat)."""
        n = self.board_size
        a_world = self._interactive.choose_action(self._inner.world_board())
        if a_world < 0:  # restart request
            return a_world
        y, x = divmod(a_world, n)
        if self._inner.current_player_num == 1:
            return x * n + y
        return a_world

    # encoding helpers: variant A uses {BLACK:0, WHITE:1, EMPTY:2}
    @staticmethod
    def _to_v0(board_b: np.ndarray) -> np.ndarray:
        out = np.full_like(board_b, 2)
        out[board_b == -1] = 0
        out[board_b == 1] = 1
        return out

    def _world_v0(self) -> np.ndarray:
        """Variant A returns the un-inverted world board every step
        (``HexGame.py:262``, the invert branches are commented out)."""
        return self._to_v0(self._inner.world_board())

    def _opponent_action(self) -> int:
        if self.opponent_policy == "interactive":
            return self._interactive_action()
        mask = self._inner.legal_actions()
        board = self._inner.observation  # opponent sees itself as black (-1)
        if callable(self.opponent_policy):
            return int(self.opponent_policy(self._to_v0(board), mask))
        if self.opponent_policy == "opponent_predict" and self.opponent_model is not None:
            if self._rng.random() < self.eps:
                return int(self._rng.choice(np.flatnonzero(mask)))
            action, _ = self.opponent_model.predict(
                board, deterministic=False, action_masks=mask
            )
            return int(action)
        return int(self._rng.choice(np.flatnonzero(mask)))

    def reset(self, seed=None, options=None):
        # loop: a GUI restart request (`r`, sentinel -1) during the
        # opponent's opening move re-resets instead of being fed to the
        # core as an invalid move (cf. compat/selfplay_wrapper.py restart
        # handling)
        while True:
            self._inner.reset(seed=seed)
            self._gui_sync()
            if self.player_color != 0:
                # opponent (black seat) opens, like HexGame.py:224-230
                a = self._opponent_action()
                if a < 0:
                    continue
                self._inner.step(a)
                self._gui_sync()
            return self._world_v0(), {}

    def legal_actions(self) -> np.ndarray:
        return self._inner.legal_actions()

    def get_action_mask(self) -> np.ndarray:
        return self.legal_actions()

    def step(self, action: int):
        agent_seat = self.player_color
        _, _, done, _ = self._inner.step(action)
        self._gui_sync()
        w = self._inner.winner
        if w == 3:
            return self._world_v0(), -100.0, True, False, {}
        if not done:
            opp_a = self._opponent_action()
            if opp_a < 0:
                # GUI restart request: end the episode so the caller resets
                # (same contract as the selfplay wrapper's restart path)
                return self._world_v0(), 0.0, True, False, {"restart": True}
            _, _, done, _ = self._inner.step(opp_a)
            self._gui_sync()
            w = self._inner.winner
            if w == 3:  # opponent invalid: episode over, no agent reward
                return self._world_v0(), 0.0, True, False, {}
        if done and self.show_result and self._interactive is not None and w in (0, 1):
            self._interactive.gui.show_winner(-1 if w == 0 else 1)
        if w == agent_seat:
            reward = 1.0
        elif w == (agent_seat + 1) % 2:
            reward = -1.0
        else:
            reward = 0.0
        return self._world_v0(), reward, done, False, {}

    def render(self, mode: str = "ansi", close: bool = False) -> str:
        """ASCII grid table like the reference's (``HexGame.py:305-330``):
        numbered rows/columns, O/B/W cells; printed and returned."""
        board = self._world_v0()
        n = board.shape[1]
        sym = {2: "  O  ", 0: "  B  ", 1: "  W  "}
        lines = []
        header = " " * 6 + "".join(f"  {j + 1}  |" for j in range(n))
        lines.append(header)
        lines.append(" " * 5 + "-" * (n * 6 - 1))
        for i in range(n):
            row = " " * (1 + i * 3) + f"{i + 1}  |"
            row += "".join(sym[int(board[i, j])] + "|" for j in range(n))
            lines.append(row)
            lines.append(" " * (i * 3 + 1) + "-" * (n * 7 - 1))
        out = "\n".join(lines)
        print(out)
        return out


def register_envs() -> None:
    """Register ``hex_gym_env_tpu_torch/hex-v0`` (variant A) and
    ``hex_gym_env_tpu_torch/hex-single-v0`` (variant B), the reference's
    ``minihex/__init__.py:15-18`` ids in this package's namespace, so they
    never displace the JAX package's ``hex-v0`` and ``hex-single-v0``."""
    if gym is None:  # pragma: no cover
        return
    from gymnasium.envs.registration import register, registry

    for name, cls in (("hex-v0", "HexEnvV0"), ("hex-single-v0", "HexEnv")):
        env_id = f"{GYM_NAMESPACE}/{name}"
        if env_id not in registry:
            register(id=env_id, entry_point=f"hex_gym_env_tpu_torch.compat.gym_env:{cls}")
