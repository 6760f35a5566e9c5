"""Selfplay PPO training state and the PPO iteration.

The counterpart of the JAX package's ``train/selfplay.py``.  One
``train_step`` = one SB3 ``collect_rollouts`` + ``train`` cycle
(``MaskablePPO.learn`` internals, driven by ``scripts/selfplay_new.py:56-62``
in the reference): the rollout (K4), GAE (K5) and the epochs x minibatches
PPO sweep (K6), each one launch on the card.  ``eval_step`` is the eval
pass and pool update (K1 opening move + K4 ``eval_mode``).

Randomness comes from one ``torch.Generator`` carried in the state (on the
CPU; the kernels seed their Philox streams from it), so a run is a function
of its seed and a checkpoint that stores the generator's state resumes the
exact trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from hex_gym_env_tpu_torch.core.topology import HexTopology, get_topology
from hex_gym_env_tpu_torch.models import CnnPolicy, MlpPolicy, family_class, make_policy
from hex_gym_env_tpu_torch.ops import gae_kernel, ppo_kernel
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank
from hex_gym_env_tpu_torch.train.evaluate import EvalResult, Evaluator
from hex_gym_env_tpu_torch.train.rollout import RolloutCarry, SelfplayRunner
from hex_gym_env_tpu_torch.utils.config import TrainConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    params: ppo.Params  # the policy's state dict on the device (a CNN's BatchNorm stats too)
    opt_state: ppo.AdamState
    bank: OpponentBank
    carry: RolloutCarry
    generator: torch.Generator
    # completed PPO iterations; transitions are iteration * n_steps * n_envs
    # (an unbounded host int)
    iteration: int = 0
    # agent transitions since the last eval; gates ``eval_freq``
    eval_accum: int = 0


class TrainMetrics(NamedTuple):
    mean_episode_reward: torch.Tensor  # mean agent reward over finished episodes
    episodes_finished: torch.Tensor
    ppo: ppo.PPOStats


class SelfplayPPO:
    """Builder wiring topology, model, runner, learner and evaluator on one
    device (``device=None`` means ``cuda``, which must exist).  The policy
    family must have an opponent-bank path: an MLP's or a CNN's
    (``train/rollout.py``); any other raises a ``ValueError``."""

    def __init__(self, cfg: TrainConfig, device=None):
        cfg.ppo.validate(cfg.selfplay.n_envs)
        family = cfg.selfplay.policy
        if not issubclass(family_class(family), (MlpPolicy, CnnPolicy)):
            raise ValueError(f"policy family {family!r} has no opponent-bank path in the trainer "
                             "(an MLP's or a CNN's); it plays only in matches")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.topo: HexTopology = get_topology(cfg.selfplay.board_size)
        self.model = make_policy(cfg.selfplay.policy, self.topo.num_cells)
        self.runner = SelfplayRunner(self.topo, self.model, cfg.selfplay, self.device)
        self.update_fn = self._resolve_update_fn()
        self.evaluator = Evaluator(self.topo, self.model, cfg.selfplay, self.device)
        self.gae_fn = self._resolve_gae_fn()

    def _resolve_gae_fn(self):
        """``cfg.ppo.gae_impl``: "lax" the plain loop; "pallas" K5 (raising
        on a CPU tensor); "auto" K5 on the card, the twin on the CPU."""
        return gae_kernel.resolve(self.cfg.ppo.gae_impl)

    def _resolve_update_fn(self):
        """The epoch-sweep backend (``PPOConfig.update_impl``, see
        ``ops/ppo_kernel.resolve``)."""
        return ppo_kernel.resolve(self.model, self.cfg.ppo)

    @property
    def per_iter(self) -> int:
        """Agent transitions per PPO iteration."""
        return self.cfg.ppo.n_steps * self.cfg.selfplay.n_envs

    def timesteps(self, state: TrainState) -> int:
        """Exact agent-transition count (unbounded host int)."""
        return int(state.iteration) * self.per_iter

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int) -> TrainState:
        g = torch.Generator().manual_seed(seed)
        model = make_policy(self.cfg.selfplay.policy, self.topo.num_cells, generator=g)
        params = {k: v.detach().to(self.device) for k, v in model.state_dict().items()}
        bank = init_bank(params, self.cfg.selfplay.buffer_size)
        carry = self.runner.init_carry(bank, g)
        trained = {k: params[k] for k in ppo.trainable_keys(model)}
        return TrainState(
            params=params, opt_state=ppo.init_adam(trained), bank=bank, carry=carry, generator=g,
        )

    # -- placement: the identity on one device (see parallel/distributed.py) --

    def shard_state(self, state: TrainState) -> TrainState:
        """``state`` laid out for this process (the identity here)."""
        return state

    def gather_state(self, state: TrainState) -> TrainState:
        """The whole ``state``, as a checkpoint holds it (the identity here)."""
        return state

    def barrier(self) -> None:
        """Wait for every process of the run (none here)."""

    def seed_bank(
        self,
        state: TrainState,
        seeds: list,
        score: float = 0.5,
        as_best: bool = True,
        pin_best: bool = True,
    ) -> TrainState:
        """Plant parameter snapshots (state dicts) into the opponent pool
        before training; seeded slots get ``score`` (high scores make them
        sticky, since replacement targets argmin-score slots).  ``as_best``
        installs ``seeds[0]`` as the designated best opponent; ``pin_best``
        sets ``best_score = score`` so promotion requires out-scoring it.

        ``score`` must stay below 1.0 when ``pin_best`` is set: eval scores
        are ``mean_reward * exp(mean(pool_scores) - 1) < 1`` whenever any
        pool slot scores < 1 (``EvaluationCallback.py:35``), so a pinned best
        at 1.0 could never be out-promoted."""
        bank = state.bank
        if len(seeds) > bank.size:
            raise ValueError(
                f"{len(seeds)} seed snapshots exceed the opponent pool size {bank.size}"
            )
        if pin_best and score >= 1.0:
            raise ValueError(
                f"pin_best with score={score} >= 1.0 makes best-promotion "
                "unreachable (eval score < 1 whenever any pool slot scores "
                "< 1); use score < 1.0 or pin_best=False"
            )
        stack = {k: v.clone() for k, v in bank.params.items()}
        scores = bank.scores.clone()
        for i, sd in enumerate(seeds):
            for k in stack:
                stack[k][i] = sd[k].to(stack[k].device)
            scores[i] = score
        best = {k: v.to(self.device) for k, v in seeds[0].items()} if as_best else bank.best_params
        best_score = (torch.tensor(score, dtype=torch.float32, device=scores.device)
                      if as_best and pin_best else bank.best_score)
        return dataclasses.replace(
            state, bank=OpponentBank(params=stack, scores=scores, best_params=best,
                                     best_score=best_score))

    # -- one PPO iteration ---------------------------------------------------

    def train_step(self, state: TrainState) -> tuple[TrainState, TrainMetrics]:
        cfg = self.cfg
        g = state.generator
        carry, tr, last_values = self.runner.run(
            state.params, state.bank, state.carry, g, cfg.ppo.n_steps
        )
        advantages, returns = self.gae_fn(
            tr.reward, tr.value, tr.done, last_values, cfg.ppo.gamma, cfg.ppo.gae_lambda,
        )

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        batch = ppo.PPOBatch(
            obs=flat(tr.obs),
            legal=flat(tr.legal),
            action=flat(tr.action),
            log_prob_old=flat(tr.log_prob),
            value_old=flat(tr.value),
            advantage=flat(advantages),
            ret=flat(returns),
        )
        params, opt_state, stats = self.update_fn(state.params, state.opt_state, batch, g)

        finished = tr.done.sum()
        # episode reward == the terminal transition's reward (0 elsewhere)
        ep_sum = torch.where(tr.done, tr.reward, torch.zeros_like(tr.reward)).sum()
        mean_ep_reward = torch.where(
            finished > 0, ep_sum / finished.clamp(min=1).to(torch.float32), torch.zeros_like(ep_sum)
        )
        new_state = dataclasses.replace(
            state, params=params, opt_state=opt_state, carry=carry,
            iteration=state.iteration + 1, eval_accum=state.eval_accum + self.per_iter,
        )
        return new_state, TrainMetrics(mean_ep_reward, finished, stats)

    def train_steps(self, state: TrainState, k: int):
        """``k`` PPO iterations; per-iteration metrics stacked on a leading
        (k,) axis."""
        metrics = []
        for _ in range(k):
            state, m = self.train_step(state)
            metrics.append(m)
        return state, _stack(metrics)

    def train_and_eval_steps(self, state: TrainState, k: int):
        """``k`` iterations of (PPO update + cadenced eval/pool-update).

        Eval fires when the transitions accumulated since the last eval reach
        ``eval_freq`` (``EvaluationCallback.py:30``'s ``n_calls % eval_freq``
        in its iteration-quantized form) — the gate ``Trainer.fit`` uses, so
        ``fit`` and ``fit_fused`` give the same pool curriculum and random
        stream.  Returns the final state plus per-iteration ``(TrainMetrics,
        EvalResult, did_eval)`` stacked on a leading (k,) axis; ``EvalResult``
        rows where ``did_eval`` is False are zeros."""
        eval_freq = self.cfg.selfplay.eval_freq
        E = self.cfg.selfplay.eval_episodes
        metrics, results, did = [], [], []
        for _ in range(k):
            state, m = self.train_step(state)
            do_eval = state.eval_accum >= eval_freq
            if do_eval:
                state, r = self.eval_step(state)
            else:
                zero = torch.zeros((), dtype=torch.float32, device=self.device)
                r = EvalResult(
                    rewards=torch.zeros((E,), dtype=torch.float32, device=self.device),
                    mean_reward=zero, score=zero, replaced=torch.tensor(False),
                    best_score=state.bank.best_score,
                )
            metrics.append(m)
            results.append(r)
            did.append(do_eval)
        return state, (_stack(metrics), _stack(results), torch.tensor(did))

    # -- eval + pool update ------------------------------------------------

    def eval_step(self, state: TrainState):
        bank, result = self.evaluator.eval_and_update(
            state.params, state.bank, state.generator, fixed_seats=state.carry.agent_seat,
        )
        return dataclasses.replace(state, bank=bank, eval_accum=0), result


def _stack(items):
    """A list of (nested) NamedTuples of tensors -> one with stacked fields."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([x.to(first.device) for x in items])
    return type(first)(*(_stack([getattr(x, f) for x in items]) for f in first._fields))
