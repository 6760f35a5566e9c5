"""Evaluation vs the opponent pool + pool-update protocol.

The counterpart of the JAX package's ``train/evaluate.py``, mirroring the
reference's ``SelfPlayCallback`` + eval-mode wrapper:

- eval mode serves pool member ``i`` to episode ``i`` and keeps the LAST
  member past the end of the buffer (``SelfplayWrapper.py:92-96``; every
  experiment sets ``n_eval_episodes = buffer_size``);
- the agent acts deterministically (SB3 ``evaluate_policy`` default), the
  opponent stochastically;
- ``score = mean_reward * exp(mean(pool_scores) - 1)``
  (``EvaluationCallback.py:35``); when ``mean_reward > 0`` and the score
  beats the pool minimum, a random argmin-score member is replaced by the
  current parameters and the best snapshot is promoted on a strict
  improvement (``EvaluationCallback.py:36-48``, ``SelfplayWrapper.py:125-137``).

All E = ``n_eval_episodes`` episodes run as one batch.  A fixed number of
N^2 // 2 + 2 agent/opponent move pairs covers any game (finished games
freeze).  Where the whole-rollout kernel resolves (``rollout_kernel.resolve``)
the eval pass is the opening move through the env step (K1 on the card) and
then one K4 launch in ``eval_mode``; configs that pin the scan/lax paths,
a CNN, ``sample_board`` (episodes start from random mid-game boards) and
``symmetric_eval`` take the plain loop (the env step K1 on the card).

Seat protocol: under ``seat_mode="per_episode"`` each eval episode draws a
fresh agent seat.  Under ``seat_mode="fixed_random"`` eval episode ``i``
inherits the seat of rollout env ``i mod n_envs`` (the reference evaluates
through the env it trains in).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core import random_board
from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.models.cnn import CnnPolicy, bank_logits
from hex_gym_env_tpu_torch.models.mlp import ACTIVATIONS
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.ops import rollout_kernel
from hex_gym_env_tpu_torch.train.bank import OpponentBank, replace_member
from hex_gym_env_tpu_torch.utils.config import SelfplayConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device


class EvalResult(NamedTuple):
    rewards: torch.Tensor  # (E,) final agent reward per eval episode
    mean_reward: torch.Tensor  # ()
    score: torch.Tensor  # ()
    replaced: torch.Tensor  # () bool — pool member replaced this eval
    best_score: torch.Tensor  # () after potential promotion


def serve_indices(n_episodes: int, pool_size: int, device=None) -> torch.Tensor:
    """Pool slot served to each eval episode: ``pool[i]`` then repeat the
    last member past the buffer end (``SelfplayWrapper.py:92-96``)."""
    return torch.clamp(torch.arange(n_episodes, device=device), max=pool_size - 1)


def eval_seats(
    cfg: SelfplayConfig,
    generator: torch.Generator,
    n_episodes: int,
    fixed_seats: Optional[torch.Tensor],
    device=None,
) -> torch.Tensor:
    """Agent seat per eval episode, (E,) int32.

    ``fixed_random`` + carry seats: episode ``i`` inherits rollout env
    ``i mod n_envs``'s seat; otherwise a fresh draw from ``generator``."""
    if cfg.seat_mode == "fixed_random" and fixed_seats is not None:
        rows = torch.arange(n_episodes, device=fixed_seats.device) % fixed_seats.shape[0]
        return fixed_seats[rows].to(torch.int32)
    u = torch.rand((n_episodes,), generator=generator, device=generator.device)
    return (u < 0.5).to(torch.int32).to(device)


def paired_pi_logits(served, n_layers: int, activation: str, x: torch.Tensor) -> torch.Tensor:
    """Row ``i`` of ``x`` (E, F) through policy ``i`` of ``served`` (state
    dict with a leading E axis): the (E, A) action logits."""
    act = ACTIVATIONS[activation]
    h = x[:, None, :]
    for i in range(n_layers):
        W, b = served[f"pi.{i}.weight"], served[f"pi.{i}.bias"]
        h = act(torch.baddbmm(b[:, None, :], h, W.transpose(1, 2)))
    W, b = served["action_head.weight"], served["action_head.bias"]
    return torch.baddbmm(b[:, None, :], h, W.transpose(1, 2))[:, 0]


class Evaluator:
    """Eval passes for one config on one device (``device=None`` means
    ``cuda``, which must exist)."""

    def __init__(self, topo: HexTopology, model, cfg: SelfplayConfig, device=None):
        self.topo = topo
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = hex_env.resolve_step_impl(cfg.env_step_impl)
        # eval as one K4 launch (argmax agent, freeze-at-done) where the
        # whole-rollout pass resolves; configs pinning the scan/lax paths
        # keep the plain loop
        self.fused_pol = rollout_kernel.resolve(model, cfg)

    def _opponent_move(self, served, st, generator, active):
        """Served member i plays episode i: an MLP's towers as batched
        products, a CNN's as one grouped conv per layer with BatchNorm
        folded (``models/cnn.bank_logits(..., paired=True)``, float32)."""
        topo = self.topo
        obs_f = hex_env.observe(topo, st).reshape(st.batch_size, -1).to(torch.float32)
        if isinstance(self.model, CnnPolicy):
            logits = bank_logits(self.model, served, obs_f, paired=True)
        else:
            logits = paired_pi_logits(served, len(self.model.pi_layers), self.model.activation,
                                      obs_f)
        legal = hex_env.legal_mask(topo, st)
        a = masked.sample(masked.draw_bits(generator, legal.shape, self.device), logits, legal)
        return self.step(topo, st, a, active=active)

    def start_states(self, n_episodes: int, generator: torch.Generator):
        """The eval episodes' boards before the opening move: empty, or under
        ``sample_board`` random mid-game boards drawn from ``generator``."""
        if self.cfg.sample_board:
            boards = random_board.sample_boards(generator, self.topo, n_episodes)
            return hex_env.state_from_boards(self.topo, boards.to(self.device))
        return hex_env.initial_state(self.topo, n_episodes, self.device)

    @torch.no_grad()
    def play_vs_pool(
        self,
        params,
        bank: OpponentBank,
        generator: torch.Generator,
        fixed_seats: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``n_eval_episodes`` episodes against the served pool sequence;
        returns (E,) final agent rewards.  ``fixed_seats`` (the rollout
        carry's per-env seats) drives the seat assignment under
        ``seat_mode="fixed_random"``."""
        topo, cfg, dev = self.topo, self.cfg, self.device
        P, E = bank.size, cfg.eval_episodes
        sym = cfg.symmetric_eval
        if self.fused_pol is not None and not cfg.sample_board and not sym:
            return self._play_vs_pool_fused(params, bank, generator, fixed_seats)
        if sym:
            # every served member twice, once with the agent in each seat;
            # seat_mode/fixed_seats are intentionally overridden.  Row i and
            # row E+i serve the same member.
            n_ep = 2 * E
            serve = serve_indices(E, P, dev).repeat(2)
            seat = torch.cat([torch.zeros(E, dtype=torch.int32, device=dev),
                              torch.ones(E, dtype=torch.int32, device=dev)])
        else:
            n_ep = E
            serve = serve_indices(E, P, dev)
            seat = eval_seats(cfg, generator, E, fixed_seats, dev)
        served = {k: v[serve] for k, v in bank.params.items()}

        state = self.start_states(n_ep, generator)
        # the opponent opens where it holds seat 0
        state, _ = self._opponent_move(served, state, generator, active=seat == 1)
        total = torch.zeros((n_ep,), dtype=torch.float32, device=dev)
        seat_col = seat[:, None].long()
        for _ in range(topo.num_cells // 2 + 2):
            obs = hex_env.observe(topo, state).to(torch.float32)
            legal = hex_env.legal_mask(topo, state)
            logits, _ = torch.func.functional_call(self.model, params, (obs,))
            state, rew1 = self.step(topo, state, masked.mode(logits, legal))  # deterministic agent
            state, rew2 = self._opponent_move(served, state, generator, active=~state.done)
            total = total + (rew1.gather(1, seat_col)[:, 0] + rew2.gather(1, seat_col)[:, 0])
        if sym:
            return 0.5 * (total[:E] + total[E:])  # per-member two-seat mean
        return total

    @torch.no_grad()
    def _play_vs_pool_fused(
        self,
        params,
        bank: OpponentBank,
        generator: Optional[torch.Generator],
        fixed_seats: Optional[torch.Tensor],
        seats: Optional[torch.Tensor] = None,
        opening: Optional[torch.Tensor] = None,
        bits=None,
    ) -> torch.Tensor:
        """The eval pass as the opening move (env step, K1 on the card) and
        one K4 launch in ``eval_mode``: agent argmax, stochastic served
        opponents, freeze-at-done.  ``seats`` (E,), ``opening`` (E,) actions
        and the K4 ``bits`` replace the generator's draws."""
        topo, cfg, dev = self.topo, self.cfg, self.device
        pol = self.fused_pol
        E = cfg.eval_episodes
        serve = serve_indices(E, bank.size, dev)
        seat = eval_seats(cfg, generator, E, fixed_seats, dev) if seats is None else seats
        stacked = pol.stack_bank(bank)

        state = hex_env.initial_state(topo, E, dev)
        # the opponent opens where it holds seat 0: the served member's
        # empty-board logits, a masked draw over the empty board, then an
        # active-masked env step
        if opening is None:
            logits0 = rollout_kernel.first_move_table(stacked, pol.dims)[serve]
            opening = masked.sample_masked(
                logits0, masked.draw_bits(generator, logits0.shape, dev))
        state, _ = self.step(topo, state, opening, active=seat == 1)

        unused_table = torch.zeros((stacked.shape[0], topo.num_cells), device=dev)
        out = rollout_kernel.fused_rollout(
            topo, pol, pol.pack_agent(params), stacked, unused_table, state, seat,
            torch.zeros((E,), dtype=torch.bool, device=dev), serve.to(torch.int32),
            topo.num_cells // 2 + 2, cfg.best_prob, False,
            bits=bits, generator=generator, eval_mode=True, bank_bf16=cfg.rollout_bank_bf16,
        )
        return out.flts[..., rollout_kernel.F_REWARD].sum(dim=0)

    def apply_pool_update(
        self,
        params,
        bank: OpponentBank,
        rewards: torch.Tensor,
        generator: torch.Generator,
    ) -> tuple[OpponentBank, EvalResult]:
        """The pool-mutation tail of an eval pass (score, replace, promote of
        the agent's ``params``) given the (E,) episode rewards."""
        mean_reward = rewards.mean()
        # Opt-in pool-freeze mitigation (0.0 = reference-exact): decay the
        # recorded pool scores, never ``best_score`` (the promotion bar stays
        # monotone); the replacement bar is ``min(scores)``.
        decay = self.cfg.pool_score_decay
        if decay:
            bank = dataclasses.replace(bank, scores=bank.scores * (1.0 - decay))
        score = mean_reward * torch.exp(bank.scores.mean() - 1.0)
        do_replace = bool((mean_reward > 0) & (score > bank.scores.min()))
        bank = replace_member(bank, generator, params, score, do_replace)
        return bank, EvalResult(
            rewards=rewards,
            mean_reward=mean_reward,
            score=score,
            replaced=torch.tensor(do_replace),
            best_score=bank.best_score,
        )

    def eval_and_update(
        self,
        params,
        bank: OpponentBank,
        generator: torch.Generator,
        fixed_seats: Optional[torch.Tensor] = None,
    ) -> tuple[OpponentBank, EvalResult]:
        rewards = self.play_vs_pool(params, bank, generator, fixed_seats=fixed_seats)
        return self.apply_pool_update(params, bank, rewards, generator)
