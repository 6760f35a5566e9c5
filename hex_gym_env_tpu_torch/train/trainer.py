"""Host-side training orchestration.

The counterpart of the JAX package's ``train/trainer.py``: the loop that
alternates ``train_step`` / ``eval_step`` calls, fetches a handful of scalars
per iteration for logging, and writes checkpoints — the role of
``model.learn(..., callback=[SelfPlayCallback(...)])`` in the reference
(``scripts/selfplay_new.py:58-62``), with the eval cadence measured in agent
transitions like the callback's ``n_calls % eval_freq``.

One training loop serves ``fit`` and ``fit_fused`` (the same method): it runs
``iters_per_dispatch`` iterations per call of
``SelfplayPPO.train_and_eval_steps``, whose eval gate — eval fires when the
transitions accumulated since the last eval reach ``eval_freq`` — does not
depend on that count, so any ``iters_per_dispatch`` gives the identical pool
curriculum and random stream for the same config.  Metric scalars are
fetched one call late, so the host waits on call k only after it has queued
call k+1's work.

Multi-process runs (``parallel/distributed.py``) write metrics, checkpoints
and the ``best_*`` dumps from rank 0 only (``bootstrap.is_main_process``); a
checkpoint is collective: every rank gathers the whole state
(``algo.gather_state``), rank 0 writes it, and the others wait for it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from hex_gym_env_tpu_torch.parallel.bootstrap import is_main_process
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO, TrainState
from hex_gym_env_tpu_torch.utils import checkpoint as ckpt_lib
from hex_gym_env_tpu_torch.utils.config import TrainConfig
from hex_gym_env_tpu_torch.utils.metrics import MetricsLogger


def _train_scalars(m, i: int) -> dict:
    def get(x):
        return float(x[i])

    return {
        "rollout/ep_rew_mean": get(m.mean_episode_reward),
        "rollout/episodes": get(m.episodes_finished),
        "train/policy_loss": get(m.ppo.policy_loss),
        "train/value_loss": get(m.ppo.value_loss),
        "train/entropy": get(m.ppo.entropy),
        "train/approx_kl": get(m.ppo.approx_kl),
        "train/clip_frac": get(m.ppo.clip_frac),
    }


def _eval_scalars(r, i: int) -> dict:
    def get(x):
        return float(x[i])

    return {
        "eval/mean_reward": get(r.mean_reward),
        "eval/score": get(r.score),
        "eval/replaced": get(r.replaced),
        "eval/best_score": get(r.best_score),
    }


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        logger: Optional[MetricsLogger] = None,
        algo: Optional[SelfplayPPO] = None,
        device=None,
    ):
        """``algo`` swaps in a different training program; ``device=None``
        means ``cuda``, which must exist."""
        self.cfg = cfg
        self.algo = SelfplayPPO(cfg, device) if algo is None else algo
        if logger is not None:
            self.logger = logger
        elif is_main_process():
            self.logger = MetricsLogger(cfg.log_dir, cfg.model_name)
        else:
            self.logger = _NullLogger()
        self._ckpt: Optional[ckpt_lib.CheckpointManager] = None

    def _ckpt_mgr(self) -> ckpt_lib.CheckpointManager:
        if self._ckpt is None:
            self._ckpt = ckpt_lib.CheckpointManager(
                os.path.join(self.cfg.model_dir, self.cfg.model_name)
            )
        return self._ckpt

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh state, laid out for this process (``algo.shard_state``)."""
        seed = self.cfg.selfplay.seed if seed is None else seed
        return self.algo.shard_state(self.algo.init_state(seed))

    def resume(self) -> TrainState:
        """The latest checkpoint, laid out for this process."""
        state = self._ckpt_mgr().restore(map_location=self.algo.device)
        return self.algo.shard_state(state)

    def _save_checkpoint(self, steps: int, state: TrainState, best0: float) -> None:
        """Checkpoint + best-snapshot save, collective in a multi-process
        run: every rank gathers, rank 0 writes, every rank waits.  The
        ``best_*`` param dump is skipped while ``best_score`` has not moved
        since fit started: before the first promotion the "best" is the
        zero-params random policy or a seeded opponent, neither of which is
        this run's agent."""
        whole = self.algo.gather_state(state)
        if is_main_process():
            self._ckpt_mgr().save(steps, whole)
            best_score = float(whole.bank.best_score)
            if best_score > best0:
                ckpt_lib.save_params(
                    os.path.join(self.cfg.model_dir, self.cfg.model_name,
                                 f"best_{best_score:.4f}"),
                    whole.bank.best_params,
                )
        self.algo.barrier()

    def fit(self, state: Optional[TrainState] = None) -> TrainState:
        """Training loop: ``iters_per_dispatch`` (train + cadenced eval)
        iterations per call of ``SelfplayPPO.train_and_eval_steps``.  Every
        iteration's train metrics are written as their own record, and eval
        scalars for exactly the iterations where the ``eval_freq`` gate
        fired.  Checkpoints land between calls."""
        cfg = self.cfg
        state = self.init_state() if state is None else state
        per_iter = self.algo.per_iter
        k = cfg.iters_per_dispatch
        t_start = time.perf_counter()
        steps_start = self.algo.timesteps(state)
        best0 = float(state.bank.best_score)

        steps = steps_start
        next_ckpt = cfg.checkpoint_every
        pending = None  # (first_step, metrics(k,...), results(k,...), did_eval(k,))
        t_prev = time.perf_counter()

        def flush_pending(pending, t_prev):
            first_step, m, r, did = pending
            records = [_train_scalars(m, i) for i in range(k)]  # waits for that call only
            now = time.perf_counter()
            dt_iter = max(now - t_prev, 1e-9) / k
            for i, scalars in enumerate(records):
                scalars["perf/steps_per_s"] = per_iter / dt_iter
                if bool(did[i]):
                    scalars.update(_eval_scalars(r, i))
                self.logger.log(first_step + i * per_iter, scalars)
            return now

        while steps < cfg.total_timesteps:
            state, (metrics, results, did_eval) = self.algo.train_and_eval_steps(state, k)
            steps += k * per_iter

            if pending is not None:
                t_prev = flush_pending(pending, t_prev)
            pending = (steps - (k - 1) * per_iter, metrics, results, did_eval)

            if steps >= next_ckpt:
                self._save_checkpoint(steps, state, best0)
                next_ckpt = steps + cfg.checkpoint_every

        if pending is not None:
            flush_pending(pending, t_prev)
        wall = time.perf_counter() - t_start
        total = self.algo.timesteps(state) - steps_start
        self.logger.log(
            self.algo.timesteps(state), {"perf/total_steps_per_s": total / max(wall, 1e-9)}
        )
        return state

    fit_fused = fit  # the JAX package's superstep name; the one loop above serves both


class _NullLogger:
    """Metrics sink for non-main processes in multi-process runs."""

    def log(self, step: int, scalars: dict) -> None:
        pass

    def close(self) -> None:
        pass
