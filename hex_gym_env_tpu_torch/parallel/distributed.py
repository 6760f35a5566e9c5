"""Data-parallel selfplay PPO over a process group (one process per device).

The counterpart of the JAX package's ``parallel/distributed.py``.  Each rank
owns ``n_envs / D`` environments: the rollout, GAE and the minibatch sweeps
run on its own data; the only traffic between ranks is one ``all_reduce`` of
the gradients per minibatch plus scalar metric reductions.  Parameters,
Adam state and the opponent bank stay bitwise replicated: every rank applies
the identical averaged update, so no parameter broadcast is ever needed.

- The rollout is the local runner's (``train/rollout.SelfplayRunner`` at
  ``n_envs / D``), chosen as the single-device runner is: the whole-rollout
  kernel K4 on the card.
- GAE goes through ``self.gae_fn``: K5 on the card.  The JAX package calls
  the plain ``gae.compute_gae`` here; K5 equals that recurrence bit for bit,
  so the numbers are the JAX package's.
- The sweep is ``train/ppo.make_update_fn``'s autograd loop with the
  ``grad_reduce`` hook, as in the JAX package (never the fused sweep K6):
  the gradient dict is flattened into one buffer, all-reduced once per
  minibatch and divided by D, and every rank then applies the same clip and
  Adam step.

Deviations from a single stream, documented as the JAX package documents
its own: minibatch shuffling is per rank, not global; and torch has no
``fold_in``, so each iteration draws a rollout seed and an update seed from
the replicated generator, and rank r seeds its own generators from (seed,
r).  The replicated generator advances identically on every rank, so a
checkpoint holds one generator state.  A CNN's BatchNorm running statistics
are not reduced across ranks (nor in the JAX package, whose out-spec for
params is replicated): each rank keeps its own minibatches' statistics.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from hex_gym_env_tpu_torch.ops.cuda_lib import philox_seed as draw_seed
from hex_gym_env_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, gather_batch_tree, replicate_tree, shard_batch_tree)
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.evaluate import fold_seed
from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO, TrainMetrics, TrainState
from hex_gym_env_tpu_torch.utils.config import TrainConfig


class DistributedSelfplayPPO(SelfplayPPO):
    """``SelfplayPPO`` whose ``train_step`` and ``eval_step`` run one rank's
    share of the data-parallel program over ``mesh``."""

    def __init__(self, cfg: TrainConfig, mesh: Mesh):
        n_data = mesh.world_size
        if cfg.selfplay.n_envs % n_data:
            raise ValueError(
                f"n_envs {cfg.selfplay.n_envs} must divide over {DATA_AXIS} axis {n_data}"
            )
        local_envs = cfg.selfplay.n_envs // n_data
        if (cfg.ppo.n_steps * local_envs) % cfg.ppo.minibatch_size:
            raise ValueError(
                "per-device rollout size (n_steps x local_envs = "
                f"{cfg.ppo.n_steps} x {local_envs}) must be divisible by "
                f"minibatch_size {cfg.ppo.minibatch_size}"
            )
        super().__init__(cfg, mesh.device)
        self.mesh = mesh
        self.n_data = n_data
        self.local_runner = SelfplayRunner(
            self.topo, self.model, dataclasses.replace(cfg.selfplay, n_envs=local_envs),
            self.device)
        self.grad_reduces = 0  # all-reduces made by the sweep's hook
        self.dist_update_fn = ppo.make_update_fn(self.model, cfg.ppo,
                                                 grad_reduce=self._grad_reduce)

    def _grad_reduce(self, grads: dict) -> dict:
        """The mean of ``grads`` over the ranks: one all-reduce of the
        flattened gradients, divided by D."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        self.mesh.all_reduce(flat)
        self.grad_reduces += 1
        flat = flat / self.n_data
        out, i = {}, 0
        for k, g in grads.items():
            out[k] = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        return out

    # -- state placement ---------------------------------------------------

    def shard_state(self, state: TrainState) -> TrainState:
        """This rank's rows of the carry (kept where it already holds only
        them), everything else broadcast from rank 0."""
        n = state.carry.agent_seat.shape[0]
        if n == self.cfg.selfplay.n_envs:
            carry = shard_batch_tree(state.carry, self.mesh)
        elif n * self.n_data == self.cfg.selfplay.n_envs:
            carry = state.carry
        else:
            raise ValueError(f"a carry of {n} envs is neither the whole batch nor a shard")
        return dataclasses.replace(
            state,
            params=replicate_tree(state.params, self.mesh),
            opt_state=replicate_tree(state.opt_state, self.mesh),
            bank=replicate_tree(state.bank, self.mesh),
            carry=carry,
        )

    def init_sharded_state(self, seed: int) -> TrainState:
        return self.shard_state(self.init_state(seed))

    def barrier(self) -> None:
        self.mesh.barrier()

    def gather_state(self, state: TrainState) -> TrainState:
        """The whole state on every rank (for a checkpoint): every rank's
        carry rows by zero-padded all-reduces; the rest is replicated."""
        return dataclasses.replace(state, carry=gather_batch_tree(state.carry, self.mesh))

    # -- one data-parallel iteration ----------------------------------------

    def _rank_generator(self, seed: int) -> torch.Generator:
        return torch.Generator().manual_seed(fold_seed(seed, self.mesh.rank))

    def train_step(self, state: TrainState):
        cfg = self.cfg
        g_roll = self._rank_generator(draw_seed(state.generator))
        g_update = self._rank_generator(draw_seed(state.generator))
        carry, tr, last_values = self.local_runner.run(
            state.params, state.bank, state.carry, g_roll, cfg.ppo.n_steps)
        advantages, returns = self.gae_fn(
            tr.reward, tr.value, tr.done, last_values, cfg.ppo.gamma, cfg.ppo.gae_lambda)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        batch = ppo.PPOBatch(
            obs=flat(tr.obs), legal=flat(tr.legal), action=flat(tr.action),
            log_prob_old=flat(tr.log_prob), value_old=flat(tr.value),
            advantage=flat(advantages), ret=flat(returns),
        )
        params, opt_state, stats = self.dist_update_fn(
            state.params, state.opt_state, batch, g_update)

        finished = self.mesh.all_reduce(tr.done.sum())
        # [episode reward sum, the five PPO stats]: sums, then the stats' mean
        sums = self.mesh.all_reduce(torch.stack(
            [torch.where(tr.done, tr.reward, torch.zeros_like(tr.reward)).sum(), *stats]))
        reward_sum = sums[0]
        stats = ppo.PPOStats(*(sums[1:] / self.n_data))
        mean_ep_reward = torch.where(
            finished > 0, reward_sum / finished.clamp(min=1).to(torch.float32),
            torch.zeros_like(reward_sum))
        new_state = dataclasses.replace(
            state, params=params, opt_state=opt_state, carry=carry,
            iteration=state.iteration + 1, eval_accum=state.eval_accum + self.per_iter,
        )
        return new_state, TrainMetrics(mean_ep_reward, finished, stats)

    # -- sharded eval + replicated pool update --------------------------------

    def eval_step(self, state: TrainState):
        """Each rank evaluates ``ceil(G / D)`` episodes of the global grid
        (G = E, or 2E under ``symmetric_eval``), keyed per global episode id,
        so the rewards are bitwise the same at every D; a zero-padded
        all-reduce gathers the (G,) rewards and the replicated pool update
        follows, identical on every rank.  ``sample_board`` configs run the
        inherited replicated evaluator (its episodes have no per-episode
        generators) on the gathered rollout seats."""
        cfg, mesh = self.cfg.selfplay, self.mesh
        seats = None
        if cfg.sample_board or cfg.seat_mode == "fixed_random":
            seats = gather_batch_tree(state.carry.agent_seat, mesh)
        if cfg.sample_board:
            bank, result = self.evaluator.eval_and_update(
                state.params, state.bank, state.generator, fixed_seats=seats)
            return dataclasses.replace(state, bank=bank, eval_accum=0), result
        E = cfg.eval_episodes
        G = 2 * E if cfg.symmetric_eval else E
        per = math.ceil(G / self.n_data)
        eids = torch.arange(mesh.rank * per, min((mesh.rank + 1) * per, G))
        rewards = self.evaluator.play_vs_pool_sharded(
            state.params, state.bank, draw_seed(state.generator), eids, seats)
        rewards = mesh.gather_rows(rewards, eids, G)
        if cfg.symmetric_eval:
            rewards = 0.5 * (rewards[:E] + rewards[E:])
        bank, result = self.evaluator.apply_pool_update(
            state.params, state.bank, rewards, state.generator)
        return dataclasses.replace(state, bank=bank, eval_accum=0), result
