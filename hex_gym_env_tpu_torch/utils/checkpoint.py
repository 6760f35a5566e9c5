"""Checkpoint/resume on ``torch.save``/``torch.load``.

The counterpart of the JAX package's ``utils/checkpoint.py``.  A checkpoint
captures the whole ``TrainState``: params (a CNN's BatchNorm running
statistics with them), the Adam count and moments, the full opponent bank
(snapshots + scores + best), the live env rollout carry, the generator's
state, the iteration counter and the eval accumulator — so a resumed run
continues the exact trajectory (the reference's SB3 zip saves lose the
opponent pool on restart).

Cadence mirrors the reference: a numbered save every ``checkpoint_every``
agent transitions plus a "best" save (``EvaluationCallback.py:53-55``,
``SelfplayWrapper.py:142-144``).  Files hold only tensors, ints and dicts, so
they load with ``weights_only=True``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from hex_gym_env_tpu_torch.core.state import HexState
from hex_gym_env_tpu_torch.train.bank import OpponentBank
from hex_gym_env_tpu_torch.train.ppo import AdamState
from hex_gym_env_tpu_torch.train.rollout import RolloutCarry

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _state_payload(state) -> dict:
    carry = state.carry
    return {
        "params": state.params,
        "adam": {"count": state.opt_state.count, "mu": state.opt_state.mu,
                 "nu": state.opt_state.nu},
        "bank": {f.name: getattr(state.bank, f.name) for f in dataclasses.fields(OpponentBank)},
        "carry": {
            "env": {f.name: getattr(carry.env, f.name) for f in dataclasses.fields(HexState)},
            "agent_seat": carry.agent_seat,
            "use_best": carry.use_best,
            "opp_idx": carry.opp_idx,
        },
        "generator": state.generator.get_state(),
        "iteration": int(state.iteration),
        "eval_accum": int(state.eval_accum),
    }


def _state_from_payload(d: dict):
    from hex_gym_env_tpu_torch.train.selfplay import TrainState

    c = d["carry"]
    generator = torch.Generator()
    generator.set_state(d["generator"].cpu())
    adam = d["adam"]
    return TrainState(
        params=d["params"],
        opt_state=AdamState(count=int(adam["count"]), mu=adam["mu"], nu=adam["nu"]),
        bank=OpponentBank(**d["bank"]),
        carry=RolloutCarry(env=HexState(**c["env"]), agent_seat=c["agent_seat"],
                           use_best=c["use_best"], opp_idx=c["opp_idx"]),
        generator=generator,
        iteration=int(d["iteration"]),
        eval_accum=int(d["eval_accum"]),
    )


class CheckpointManager:
    """Numbered ``TrainState`` saves in one directory, the newest ``keep``
    kept."""

    def __init__(self, directory: str, keep: int = 20):
        self._dir = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self._dir)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def save(self, step: int, state) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(_state_payload(state), tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[: -self._keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, map_location=None):
        """The ``TrainState`` saved at ``step`` (default: the latest), its
        tensors on ``map_location`` (the generator stays on the CPU)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self._dir}")
        d = torch.load(self._path(step), map_location=map_location, weights_only=True)
        return _state_from_payload(d)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None


def save_params(path: str, params) -> None:
    """One-shot parameter snapshot (the ``save_best_model`` analog)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(dict(params), os.path.abspath(path))


def load_params(path: str, map_location=None) -> dict:
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
