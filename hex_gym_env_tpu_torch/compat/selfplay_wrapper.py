"""Host-side SelfplayWrapper parity surface.

The counterpart of the JAX package's ``compat/selfplay_wrapper.py``: a
faithful re-statement of the reference's ``selfplay_wrapper(env)`` class
factory (``minihex/SelfplayWrapper.py:37-208``) around the compat ``HexEnv``:
opponent pool + scores, 80/20 best/pool per-episode opponent selection,
``continue_game`` playing the opponent through the same step path, eval mode
iterating the pool, pool mutation and best promotion.  This is the surface
GUI play scripts and API-parity tests use; training uses the batched bank
(``train/bank.py``) instead.  ``TorchOpponentPolicy`` plays one of this
package's policies (``models/loading.load_policy_params``) on its params'
device.

Known reference bugs deliberately NOT copied (SURVEY.md §7):
``append_opponent_model`` calling ``.append`` on a numpy array (would crash,
``SelfplayWrapper.py:106-112``) is implemented correctly here.
"""

from __future__ import annotations

import random as _random
from typing import Any, List, Optional

import numpy as np

import torch

from hex_gym_env_tpu_torch.compat.gym_env import HexEnv
from hex_gym_env_tpu_torch.ops import masked


class BaseRandomPolicy:
    """Uniform-random over empty cells (``SelfplayWrapper.py:16-24``)."""

    def choose_action(self, board: np.ndarray, action_mask=None) -> int:
        valid = np.flatnonzero(np.asarray(board).reshape(-1) == 0)
        return int(valid[int(_random.random() * len(valid))])

    def save_model(self, path: str) -> None:
        return None


class OpponentPolicy:
    """Wraps an SB3-style model with ``predict`` (``SelfplayWrapper.py:26-35``)."""

    def __init__(self, model: Any):
        self.opponent_model = model

    def choose_action(self, board: np.ndarray, action_mask=None) -> int:
        action, _ = self.opponent_model.predict(
            board, deterministic=False, action_masks=action_mask
        )
        return int(action)

    def save_model(self, path: str) -> None:
        self.opponent_model.save(path)


class TorchOpponentPolicy:
    """Opponent over this package's policies: stochastic masked sampling
    like ``OpponentPolicy``.  ``params`` is the model's state dict (as
    ``models/loading.load_policy_params`` gives it); the forward runs on
    its device, the draws come from a ``torch.Generator`` there, seeded by
    ``seed``."""

    def __init__(self, model, params, seed: int = 0):
        self._model = model
        self._params = params
        self.device = next(iter(params.values())).device
        self._generator = torch.Generator(self.device).manual_seed(seed)

    @torch.no_grad()
    def choose_action(self, board: np.ndarray, action_mask=None) -> int:
        if action_mask is None:
            action_mask = np.asarray(board).reshape(-1) == 0
        obs = torch.as_tensor(np.asarray(board), dtype=torch.float32, device=self.device)[None]
        legal = torch.as_tensor(np.asarray(action_mask, bool), device=self.device)[None]
        logits, _ = torch.func.functional_call(self._model, self._params, (obs,))
        bits = masked.draw_bits(self._generator, legal.shape, self.device)
        return int(masked.sample(bits, logits, legal)[0])

    def save_model(self, path: str) -> None:
        from hex_gym_env_tpu_torch.utils.checkpoint import save_params

        save_params(path, {k: v.cpu() for k, v in self._params.items()})


def selfplay_wrapper(env_cls=HexEnv):
    """Class factory mirroring ``selfplay_wrapper`` (``SelfplayWrapper.py:37``)."""

    class SelfPlayEnv(env_cls):
        def __init__(
            self,
            base_model: Any = None,
            scores: Optional[np.ndarray] = None,
            play_gui: bool = False,
            board_size: int = 5,
            buffer_size: int = 20,
            sample_board: bool = False,
            prob_model: Any = None,
            agent_player_num: Optional[int] = None,
            device=None,
        ):
            super().__init__(board_size=board_size, sample_board=sample_board, device=device)
            self.agent_player_num = agent_player_num
            self.play_gui = play_gui
            self.prob_model = prob_model
            self.calculate_probs = False
            self._restart_requested = False

            if play_gui:
                from hex_gym_env_tpu_torch.interactive.interactive import InteractiveGame

                human = InteractiveGame(np.zeros((board_size, board_size), dtype=int))
                # meta-move hooks: z = undo one full move, e-mode edits commit
                # to the env (interactive.py module docstring)
                human.undo_hook = self._undo_for_human
                human.edit_hook = self._commit_edited_board
                self.opponent_models: List[Any] = [human]
                self.opponent_model = human
                self.opponent_scores = np.asarray([1.0])
                self.best_model = human
                self.calculate_probs = prob_model is not None
            else:
                if base_model is None:
                    base_model = BaseRandomPolicy()
                if isinstance(base_model, BaseRandomPolicy):
                    self.opponent_models = [BaseRandomPolicy() for _ in range(buffer_size)]
                    self.opponent_scores = np.zeros(buffer_size)
                else:
                    wrap = (
                        base_model
                        if hasattr(base_model, "choose_action")
                        else OpponentPolicy(base_model)
                    )
                    self.opponent_models = [wrap for _ in range(buffer_size)]
                    self.opponent_scores = (
                        np.asarray(scores, dtype=float)
                        if scores is not None
                        else np.zeros(buffer_size)
                    )
                self.best_model = (
                    base_model
                    if hasattr(base_model, "choose_action")
                    else OpponentPolicy(base_model)
                )

            self.best_score = float(np.max(self.opponent_scores))
            self.best_mean_reward = -np.inf
            self.eval_state = False
            self.eval_episode = 0

        # -- reset / opponent selection -----------------------------------

        def reset(self, seed=None, options=None):
            self._restart_requested = False
            obs, info = super().reset(seed=seed, options=options)
            # Reference quirk reproduced: the seat is drawn only while the
            # attribute is None, i.e. once per object lifetime
            # (``SelfplayWrapper.py:72-73``).
            if self.agent_player_num is None:
                self.agent_player_num = _random.randint(0, 1)
            self.setup_opponents()
            if self.play_gui:
                self.best_model.gui.update_board(self._gui_board())

            if self.current_player_num != self.agent_player_num:
                self.continue_game()

            info = {
                "state": self.observation,
                "last_move_opponent": None,
                "last_move_player": None,
            }
            return self.observation, info

        def setup_opponents(self) -> None:
            if self.eval_state:
                if self.eval_episode <= len(self.opponent_models) - 1:
                    self.opponent_model = self.opponent_models[self.eval_episode]
                    self.eval_episode += 1
                return
            if _random.uniform(0, 1) < 0.8:
                self.opponent_model = self.best_model
            else:
                i = int(_random.random() * len(self.opponent_models))
                self.opponent_model = self.opponent_models[i]

        # -- pool management ------------------------------------------------

        def append_opponent_model(self, opponent_model, best_model=False, mean_reward=None):
            new = (
                opponent_model
                if hasattr(opponent_model, "choose_action")
                else OpponentPolicy(opponent_model)
            )
            if best_model:
                self.best_model = new
                self.best_mean_reward = mean_reward
            self.opponent_models.append(new)
            self.opponent_scores = np.append(self.opponent_scores, 0.0)

        def get_best_mean_reward(self):
            return self.best_mean_reward

        def set_eval(self, eval_state: bool) -> None:
            self.eval_episode = 0
            self.eval_state = eval_state
            assert len(self.opponent_models) == len(self.opponent_scores)

        def get_scores(self) -> np.ndarray:
            return self.opponent_scores

        def get_opponent_models(self):
            return self.opponent_models

        def set_opponent_model(self, index: int, model: Any, score: float) -> None:
            new = model if hasattr(model, "choose_action") else OpponentPolicy(model)
            self.opponent_models[index] = new
            self.opponent_scores[index] = score
            if score > self.best_score:
                self.best_model = new
                self.best_score = score

        def save_best_model(self) -> None:
            self.best_model.save_model(f"models/best_model_{self.best_score}")

        # -- stepping -------------------------------------------------------

        def _gui_board(self) -> np.ndarray:
            # the GUI always renders the world frame (seat0 = black)
            return self.world_board()

        def continue_game(self):
            if self.play_gui and self.calculate_probs:
                self.get_probs(self.prob_model)
            action = self.opponent_model.choose_action(
                self.observation, self.legal_actions()
            )
            if int(action) < 0:  # GUI restart request (the `r` key)
                self._restart_requested = True
                return None, None, True, None
            obs, reward, done, _ = super().step(int(action))
            return obs, reward, done, None

        def step(self, action: int):
            obs, reward, done, _ = super().step(int(action))
            if self.play_gui:
                self.opponent_model.gui.update_board(self._gui_board())
            if not done:
                package = self.continue_game()
                if self._restart_requested:
                    return self.observation, 0.0, True, False, {"restart": True}
                if package[0] is not None:
                    obs, reward, done, _ = package
            agent_reward = reward[self.agent_player_num]
            if self.play_gui and done:
                self.opponent_model.gui.update_board(self._gui_board())
            return obs, agent_reward, done, False, {}

        # -- GUI meta-move hooks ---------------------------------------------

        def _mover_to_world(self, board: np.ndarray) -> np.ndarray:
            """The human edits the mover-frame board; the env state rebuild
            wants the world frame (transpose + color swap for seat 1)."""
            board = np.asarray(board)
            if self.current_player_num == 1:
                b = board.T.copy()
                out = np.zeros_like(b)
                out[b == -1] = 1
                out[b == 1] = -1
                return out
            return board

        def _commit_edited_board(self, board_mover: np.ndarray) -> None:
            self.set_world_board(self._mover_to_world(board_mover))

        def _undo_for_human(self) -> np.ndarray:
            """Rewind one full move (the human's last + the reply)."""
            return self.undo_move(2)

        # -- GUI probability overlay ---------------------------------------

        def get_probs(self, model) -> None:
            """Policy-probability overlay (``SelfplayWrapper.py:201-206``)."""
            board = self.observation
            mask = self.legal_actions()
            probs = _policy_probs(model, board, mask)
            legal_probs = probs[np.asarray(board).reshape(-1) == 0]
            scaled = scale_value(probs, legal_probs.min(), legal_probs.max())
            self.opponent_model.gui.update_field_text(np.round(scaled, 1), board)

    return SelfPlayEnv


def _policy_probs(model, board: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Action probabilities from either an SB3-style model or (module,
    params) of this package."""
    if isinstance(model, tuple):  # (policy module, its state dict)
        module, params = model
        dev = next(iter(params.values())).device
        obs = torch.as_tensor(np.asarray(board), dtype=torch.float32, device=dev)[None]
        legal = torch.as_tensor(np.asarray(mask, bool), device=dev)[None]
        with torch.no_grad():
            logits, _ = torch.func.functional_call(module, params, (obs,))
        return masked.probs(logits, legal)[0].cpu().numpy()
    # SB3 path (torch)
    tensor = model.policy.obs_to_tensor(board)[0]
    probs = model.policy.get_distribution(tensor).distribution.probs
    return probs.detach().numpy()[0]


def scale_value(value, min_val, max_val):
    return 10 * (value - min_val) / (max_val - min_val)
