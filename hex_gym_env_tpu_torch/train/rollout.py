"""Selfplay rollout on the device.

The counterpart of the JAX package's ``train/rollout.py``.  It replaces the
reference's per-step Python round trip — SB3 ``collect_rollouts`` calling
``SelfPlayEnv.step``, which plays the agent's move and then the opponent's
reply (``minihex/SelfplayWrapper.py:146-199``) — with batched device work,
for every env in lockstep:

  1. agent forward (current params) -> masked sample -> env step;
  2. opponent reply where the game continues (``continue_game``);
  3. auto-reset of finished games: fresh board, per-episode seat draw,
     best/pool opponent draw (``setup_opponents``), and the opponent's first
     move when the agent sits second (``SelfplayWrapper.py:79-81``).

Two paths compute it.  ``run_fused`` runs all T steps in one pass of the
whole-rollout kernel K4 (``ops/rollout_kernel.py``; its PyTorch twin on a
CPU device).  The scan path loops over steps in Python, each step calling
the agent pass K2 and the bank pass K3 (``ops/policy_kernel.py``) and the
env step K1 (``ops/step_kernel.py``), or the plain model and env where the
``*_impl`` knobs pin "lax".  Both draw their randomness from a
``torch.Generator``; the kernels seed Philox streams from it.  Under
``sample_board`` fresh games start from random mid-game boards
(``core/random_board.py``); the whole-rollout kernel refuses that mode, so
it takes the scan path, where the opponent's opening move on a reset is a
full bank pass instead of the empty-board table.

Agent parameters are a state dict of the model, which is the skeleton the
plain path calls them through (``torch.func.functional_call``).  The kernel
passes K2-K4 take plain MLPs; a CNN takes the scan path with the env step
K1 and the model in PyTorch: the agent with its BatchNorm's running
statistics, the opponents with BatchNorm folded into their convs, each game
running only its own opponent's conv stack (``cnn_bank_mode`` "auto" or
"gathered", ``models/cnn.gathered_bank_logits``) or every member on every
board and then a selection ("dense", ``models/cnn.bank_logits``), both in
bf16 under ``rollout_bank_bf16``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core import random_board
from hex_gym_env_tpu_torch.core.state import HexState
from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.models import cnn
from hex_gym_env_tpu_torch.models.mlp import stacked_pi_logits
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.ops import policy_kernel, rollout_kernel
from hex_gym_env_tpu_torch.train.bank import OpponentBank, sample_opponents
from hex_gym_env_tpu_torch.utils.config import SelfplayConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device

# the one env-step dispatch rule, shared with core.env.make_ops
resolve_step_impl = hex_env.resolve_step_impl


class Transition(NamedTuple):
    """One agent transition per env, stacked to (T, ...)."""

    obs: torch.Tensor  # (B, N, N) int8 — mover-frame board the agent saw
    legal: torch.Tensor  # (B, A) bool
    action: torch.Tensor  # (B,) int32
    log_prob: torch.Tensor  # (B,) float32
    value: torch.Tensor  # (B,) float32
    reward: torch.Tensor  # (B,) float32 — reward[agent_seat] incl. opponent reply
    done: torch.Tensor  # (B,) bool — episode ended within this transition


@dataclasses.dataclass
class RolloutCarry:
    env: HexState
    agent_seat: torch.Tensor  # (B,) int32
    use_best: torch.Tensor  # (B,) bool — opponent is the designated best
    opp_idx: torch.Tensor  # (B,) int32 — pool slot otherwise


class SelfplayRunner:
    """Rollout collection for one config on one device.

    ``device=None`` means ``cuda`` and raises where there is none; pass
    ``device="cpu"`` to run the plain PyTorch twins."""

    def __init__(self, topo: HexTopology, model, cfg: SelfplayConfig, device=None):
        self.topo = topo
        self.model = model
        self.cfg = cfg
        if cfg.cnn_bank_mode not in ("auto", "dense", "gathered"):
            raise ValueError(
                f"cnn_bank_mode must be 'auto'/'dense'/'gathered', got {cfg.cnn_bank_mode!r}"
            )
        self.is_cnn = isinstance(model, cnn.CnnPolicy)
        self.device = resolve_device(device)
        self.step = resolve_step_impl(cfg.env_step_impl)
        # per-step kernel passes (None -> the plain model path)
        self.pol = policy_kernel.resolve_policy_ops(model, cfg)
        # whole-rollout pass (None -> the per-step scan)
        self.fused_pol = rollout_kernel.resolve(model, cfg)
        self.last_record = None

    # -- helpers -----------------------------------------------------------

    def fresh_envs(self, generator: Optional[torch.Generator] = None) -> HexState:
        """Fresh games: empty boards, or under ``sample_board`` random
        mid-game boards drawn from ``generator``."""
        if self.cfg.sample_board:
            boards = random_board.sample_boards(generator, self.topo, self.cfg.n_envs)
            return hex_env.state_from_boards(self.topo, boards.to(self.device))
        return hex_env.initial_state(self.topo, self.cfg.n_envs, self.device)

    def policy_logits_value(self, params, state: HexState):
        obs = hex_env.observe(self.topo, state)
        legal = hex_env.legal_mask(self.topo, state)
        logits, value = torch.func.functional_call(self.model, params, (obs.to(torch.float32),))
        return obs, legal, logits, value

    def bank_forward(self, stacked_params, obs_f: torch.Tensor) -> torch.Tensor:
        """All members' logits over a shared batch, (P, B, A): a CNN's as
        grouped convs with BatchNorm folded (bf16 under
        ``rollout_bank_bf16``)."""
        if self.is_cnn:
            return cnn.bank_logits(self.model, stacked_params, obs_f,
                                   bf16=self.cfg.rollout_bank_bf16)
        return stacked_pi_logits(
            stacked_params, len(self.model.pi_layers), self.model.activation, obs_f
        )

    def opponent_logits(self, bank: OpponentBank, use_best, opp_idx, state: HexState):
        obs_f = hex_env.observe(self.topo, state).reshape(state.batch_size, -1).to(torch.float32)
        legal = hex_env.legal_mask(self.topo, state)
        if self.is_cnn and self.cfg.cnn_bank_mode != "dense":
            # each game runs only its own opponent's conv stack (the best's
            # rides the same pass)
            logits = cnn.gathered_bank_logits(
                self.model, bank.params, bank.best_params, use_best, opp_idx, obs_f,
                bf16=self.cfg.rollout_bank_bf16)
            return logits, legal
        per_member = self.bank_forward(bank.params, obs_f)  # (P, B, A)
        chosen = per_member[opp_idx.long(), torch.arange(obs_f.shape[0], device=obs_f.device)]
        best = torch.func.functional_call(self.model, bank.best_params, (obs_f,))[0]
        return torch.where(use_best[:, None], best, chosen), legal

    def opponent_move(
        self, bank: OpponentBank, use_best, opp_idx, state: HexState,
        generator: torch.Generator, active: torch.Tensor, bank_op=None,
    ):
        """The opponent acts stochastically with the action mask, like
        ``OpponentPolicy.choose_action`` (``SelfplayWrapper.py:30-32``).
        ``bank_op`` is the bank pass's operand (``PolicyOps.bank_operand``),
        built once per rollout."""
        if self.pol is not None and bank_op is not None:
            obs = hex_env.observe(self.topo, state)
            legal = hex_env.legal_mask(self.topo, state)
            action, _ = self.pol.bank_act(bank_op, use_best, opp_idx, obs, legal, generator)
        else:
            logits, legal = self.opponent_logits(bank, use_best, opp_idx, state)
            bits = masked.draw_bits(generator, legal.shape, self.device)
            action = masked.sample(bits, logits, legal)
        return self.step(self.topo, state, action, active=active)

    def first_move_logits(self, bank: OpponentBank):
        """Every pool member's logits on the empty board, (P, A), and the
        best's, (A,): with empty resets the opening-move logits are a
        constant of the bank, computed once per rollout."""
        empty = torch.zeros((1, self.topo.num_cells), dtype=torch.float32, device=self.device)
        members = self.bank_forward(bank.params, empty)[:, 0]
        best = torch.func.functional_call(self.model, bank.best_params, (empty,))[0][0]
        return members, best

    def reset_finished(
        self, carry: RolloutCarry, bank: OpponentBank, generator: torch.Generator,
        first_logits=None, bank_op=None,
    ) -> RolloutCarry:
        """Auto-reset done games + seat/opponent redraw + opponent first move.

        ``first_logits`` (the empty-board table of ``first_move_logits``)
        serves the opening move on empty resets; under ``sample_board`` it is
        None and the opponent's full bank pass plays it."""
        cfg = self.cfg
        m = carry.env.done
        st = hex_env.reset_where(self.topo, carry.env, m, self.fresh_envs(generator))

        seat = carry.agent_seat
        if cfg.seat_mode == "per_episode":
            redraw = torch.rand((cfg.n_envs,), generator=generator, device=generator.device) < 0.5
            seat = torch.where(m, redraw.to(self.device).to(torch.int32), seat)
        # "fixed_random": the reference's first-reset-only seat draw
        # (SelfplayWrapper.py:72-73); assigned once in init_carry.

        nb, ni = sample_opponents(generator, bank.size, cfg.n_envs, cfg.best_prob, self.device)
        use_best = torch.where(m, nb, carry.use_best)
        opp_idx = torch.where(m, ni, carry.opp_idx)

        # Where the opponent holds seat 0 it opens the fresh game
        # (SelfplayWrapper.py:79-81); inactive rows' samples are discarded
        # by the step's mask.
        active = m & (seat == 1)
        if first_logits is None:
            st, _ = self.opponent_move(
                bank, use_best, opp_idx, st, generator, active=active, bank_op=bank_op)
            return RolloutCarry(env=st, agent_seat=seat, use_best=use_best, opp_idx=opp_idx)
        # every cell of the empty board is legal
        members, best_l = first_logits
        logits = torch.where(use_best[:, None], best_l[None, :], members[opp_idx.long()])
        bits = masked.draw_bits(generator, logits.shape, self.device)
        action = masked.sample_masked(logits, bits)
        st, _ = self.step(self.topo, st, action, active=active)
        return RolloutCarry(env=st, agent_seat=seat, use_best=use_best, opp_idx=opp_idx)

    # -- entry points ------------------------------------------------------

    def init_carry(self, bank: OpponentBank, generator: torch.Generator) -> RolloutCarry:
        cfg = self.cfg
        st = self.fresh_envs(generator)
        seat = torch.rand((cfg.n_envs,), generator=generator, device=generator.device) < 0.5
        seat = seat.to(self.device).to(torch.int32)
        use_best, opp_idx = sample_opponents(
            generator, bank.size, cfg.n_envs, cfg.best_prob, self.device
        )
        bank_op = self.pol.bank_operand(bank) if self.pol is not None else None
        st, _ = self.opponent_move(
            bank, use_best, opp_idx, st, generator, active=seat == 1, bank_op=bank_op
        )
        return RolloutCarry(env=st, agent_seat=seat, use_best=use_best, opp_idx=opp_idx)

    @torch.no_grad()
    def run_fused(
        self, params, bank: OpponentBank, carry: RolloutCarry,
        generator: torch.Generator, n_steps: int, bits=None,
    ):
        """All ``n_steps`` transitions in one pass of K4.  ``bits`` (the four
        planes of ``ops/rollout_kernel``) replaces the generator's draws.

        Returns ``(carry', transitions (T, ...), last_values (B,))``."""
        pol = self.fused_pol
        stacked = pol.stack_bank(bank)
        out = rollout_kernel.fused_rollout(
            self.topo, pol, pol.pack_agent(params), stacked,
            rollout_kernel.first_move_table(stacked, pol.dims), carry.env,
            carry.agent_seat, carry.use_best, carry.opp_idx, n_steps,
            self.cfg.best_prob, self.cfg.seat_mode == "per_episode",
            bits=bits, generator=generator, bank_bf16=self.cfg.rollout_bank_bf16,
        )
        n = self.topo.n
        ints, flts = out.ints, out.flts
        tr = Transition(
            obs=out.obs.reshape(n_steps, -1, n, n),
            legal=out.obs == 0,
            action=ints[..., rollout_kernel.I_ACTION],
            log_prob=flts[..., rollout_kernel.F_LOGP],
            value=flts[..., rollout_kernel.F_VALUE],
            reward=flts[..., rollout_kernel.F_REWARD],
            done=ints[..., rollout_kernel.I_DONE] != 0,
        )
        carry2 = RolloutCarry(
            env=out.state, agent_seat=out.agent_seat, use_best=out.use_best, opp_idx=out.opp_idx
        )
        # the kernel's full record (every draw it made), for
        # rollout_kernel.verify_rollout_trajectory
        self.last_record = out
        last_values = self.policy_logits_value(params, out.state)[3]
        return carry2, tr, last_values

    def run(
        self, params, bank: OpponentBank, carry: RolloutCarry,
        generator: torch.Generator, n_steps: int,
    ):
        """Collect ``n_steps`` agent transitions per env.

        Returns ``(carry', transitions (T, ...), last_values (B,))``."""
        if self.fused_pol is not None:
            return self.run_fused(params, bank, carry, generator, n_steps)
        return self._run_scan(params, bank, carry, generator, n_steps)

    @torch.no_grad()
    def _run_scan(self, params, bank, carry, generator, n_steps):
        # a sampled board is not empty: no opening-move table
        first_logits = None if self.cfg.sample_board else self.first_move_logits(bank)
        pol = self.pol
        agent_op = pol.agent_operand(params) if pol is not None else None
        bank_op = pol.bank_operand(bank) if pol is not None else None

        c = carry
        steps = []
        for _ in range(n_steps):
            if pol is not None:
                obs = hex_env.observe(self.topo, c.env)
                legal = hex_env.legal_mask(self.topo, c.env)
                res = pol.agent_act(agent_op, obs, legal, generator)
                action, log_prob, value = res.action, res.log_prob, res.value
            else:
                obs, legal, logits, value = self.policy_logits_value(params, c.env)
                bits = masked.draw_bits(generator, legal.shape, self.device)
                action, log_prob = masked.sample_with_info(bits, logits, legal)
            st1, rew1 = self.step(self.topo, c.env, action)
            seat_col = c.agent_seat[:, None].long()
            r_agent = rew1.gather(1, seat_col)[:, 0]

            st2, rew2 = self.opponent_move(
                bank, c.use_best, c.opp_idx, st1, generator, active=~st1.done,
                bank_op=bank_op,
            )
            r_agent = r_agent + rew2.gather(1, seat_col)[:, 0]
            done = st2.done

            c = self.reset_finished(
                RolloutCarry(st2, c.agent_seat, c.use_best, c.opp_idx), bank,
                generator, first_logits, bank_op=bank_op,
            )
            steps.append(Transition(obs, legal, action, log_prob, value, r_agent, done))

        transitions = Transition(*(torch.stack(field) for field in zip(*steps)))
        last_values = self.policy_logits_value(params, c.env)[3]
        return c, transitions, last_values
