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

The data-parallel trainer (``parallel/distributed.py``) evaluates a slice of
the episode grid per rank through ``play_vs_pool_sharded``: every draw there
is keyed by the global episode id (each episode's words from its own
generator, ``episode_words``), so the rewards do not depend on how many
ranks share the grid.

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


def fold_seed(seed: int, index: int) -> int:
    """The 63-bit seed of stream ``index`` under ``seed`` (a global eval
    episode, a rank): a fixed mix, splitmix64's finalizer, in place of JAX's
    ``fold_in``."""
    z = (seed + 0x9E3779B97F4A7C15 * (index + 1)) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def episode_words(eval_seed: int, episode_ids: torch.Tensor, n_actions: int,
                  n_plies: int) -> torch.Tensor:
    """(El, 1 + n_plies * A) int32 words on the CPU, row i drawn from
    episode ``episode_ids[i]``'s own generator: the seat word, then for each
    opponent ply (the opening, then one per move pair) a word per action for
    its Gumbel-max draw (``scripts/match.bits_shape``'s layout)."""
    out = torch.empty((episode_ids.numel(), 1 + n_plies * n_actions), dtype=torch.int32)
    for i, e in enumerate(episode_ids.tolist()):
        g = torch.Generator().manual_seed(fold_seed(eval_seed, e))
        out[i] = masked.draw_bits(g, out.shape[1:], "cpu")
    return out


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

    def _opponent_move(self, served, st, bits, active):
        """Served member i plays episode i, its Gumbel-max draw over the
        (B, A) words ``bits``: an MLP's towers as batched products, a CNN's
        as one grouped conv per layer with BatchNorm folded
        (``models/cnn.bank_logits(..., paired=True)``, float32).  Returns
        the env step's ``(state, rewards)`` and the actions."""
        topo = self.topo
        obs_f = hex_env.observe(topo, st).reshape(st.batch_size, -1).to(torch.float32)
        if isinstance(self.model, CnnPolicy):
            logits = bank_logits(self.model, served, obs_f, paired=True)
        else:
            logits = paired_pi_logits(served, len(self.model.pi_layers), self.model.activation,
                                      obs_f)
        a = masked.sample(bits, logits, hex_env.legal_mask(topo, st))
        return (*self.step(topo, st, a, active=active), a)

    def _agent_move(self, params, st):
        """The agent's deterministic move (SB3 ``evaluate_policy``'s
        default): the env step's ``(state, rewards)`` and the actions."""
        obs = hex_env.observe(self.topo, st).to(torch.float32)
        logits, _ = torch.func.functional_call(self.model, params, (obs,))
        a = masked.mode(logits, hex_env.legal_mask(self.topo, st))
        return (*self.step(self.topo, st, a), a)

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
        shape = (n_ep, topo.num_cells)
        # the opponent opens where it holds seat 0
        state, _, _ = self._opponent_move(served, state, masked.draw_bits(generator, shape, dev),
                                          active=seat == 1)
        total = torch.zeros((n_ep,), dtype=torch.float32, device=dev)
        seat_col = seat[:, None].long()
        for _ in range(topo.num_cells // 2 + 2):
            state, rew1, _ = self._agent_move(params, state)
            state, rew2, _ = self._opponent_move(
                served, state, masked.draw_bits(generator, shape, dev), active=~state.done)
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

    @torch.no_grad()
    def play_vs_pool_sharded(
        self,
        params,
        bank: OpponentBank,
        eval_seed: int,
        episode_ids: torch.Tensor,
        seats_all: Optional[torch.Tensor],
        words: Optional[torch.Tensor] = None,
        record: Optional[dict] = None,
    ) -> torch.Tensor:
        """Evaluate an explicit slice of the global episode grid (the
        sharded eval of ``parallel/distributed.py``); returns the (El,)
        final agent rewards of ``episode_ids``.

        Every draw is keyed by the GLOBAL episode id, so ranks that each
        evaluate a slice produce bitwise the per-episode rewards of one rank
        evaluating the whole grid.  Torch has no ``fold_in``: episode ``e``
        draws its words (``episode_words``) from its own CPU generator,
        seeded by ``fold_seed(eval_seed, e)``; ``words`` replaces them.
        The first word draws the seat under ``per_episode``; ``fixed_random``
        reads the whole rollout seat vector ``seats_all`` (gathered over the
        ranks) at ``e mod n_envs``.  Under ``symmetric_eval`` the grid has 2E
        rows: episode ``e`` plays member ``min(e mod E, P-1)`` with the agent
        in seat ``e // E``, and the caller averages the halves.  ``record``,
        where given, receives the CPU tensor ``actions`` (1 + 2 * pairs, El):
        the opening ply, then the agent's and the opponent's move of each
        pair.  ``sample_board`` runs take the replicated evaluator."""
        topo, cfg, dev = self.topo, self.cfg, self.device
        if cfg.sample_board:
            raise NotImplementedError(
                "sharded eval does not support sample_board; use the replicated evaluator"
            )
        P, E, A = bank.size, cfg.eval_episodes, topo.num_cells
        n_pairs = topo.num_cells // 2 + 2
        eids = episode_ids.to("cpu", torch.int64)
        n_ep = eids.numel()
        if n_ep == 0:  # a rank past the grid's end
            return torch.zeros((0,), dtype=torch.float32, device=dev)
        shape = (n_ep, 1 + (n_pairs + 1) * A)
        if words is None:
            words = episode_words(eval_seed, eids, A, n_pairs + 1)
        elif tuple(words.shape) != shape or words.dtype != torch.int32:
            raise ValueError(f"words must be int32 of shape {shape}, got {tuple(words.shape)} "
                             f"{words.dtype}")
        words = words.to(dev)
        if cfg.symmetric_eval:
            member = torch.clamp(eids % E, max=P - 1)
            seat = eids // E
        else:
            member = torch.clamp(eids, max=P - 1)
            if cfg.seat_mode == "fixed_random":
                seat = seats_all.cpu()[eids % seats_all.shape[0]]
            else:
                seat = masked.unit_uniform(words[:, 0]) < 0.5
        seat = seat.to(dev, torch.int32)
        served = {k: v[member.to(v.device)] for k, v in bank.params.items()}
        plies = words[:, 1:].reshape(n_ep, n_pairs + 1, A)

        state = hex_env.initial_state(topo, n_ep, dev)
        # the opponent opens where it holds seat 0
        state, _, a0 = self._opponent_move(served, state, plies[:, 0], active=seat == 1)
        actions = [a0]
        total = torch.zeros((n_ep,), dtype=torch.float32, device=dev)
        seat_col = seat[:, None].long()
        for s in range(n_pairs):
            state, rew1, a1 = self._agent_move(params, state)
            state, rew2, a2 = self._opponent_move(served, state, plies[:, s + 1],
                                                  active=~state.done)
            total = total + (rew1.gather(1, seat_col)[:, 0] + rew2.gather(1, seat_col)[:, 0])
            actions += [a1, a2]
        if record is not None:
            record["actions"] = torch.stack(actions).cpu()
        return total

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
