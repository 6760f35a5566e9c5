"""The work each layer needs at a cell's shapes: operations (2 per
multiply-add) and bytes, and the least time the card could take for them.

Counts are of what the algorithm needs, never of what an implementation
runs, so a later change that computes less cannot read above 100% and a
change of kernel moves the time, not the count:

- a transition: one agent forward, both towers and both heads;
- an opponent reply: one pool member's policy forward (the pi tower and
  the action head; for the CNN its conv stack, the features layer, the pi
  tower and the action head), one per transition;
- a sweep row visit: three times the agent forward (forward and backward);
- an evaluation or match ply: one policy forward of the side to move; a
  game is counted at its longest, a full board of plies;
- bytes: each input read once and each output written once for the
  layer's record and batch.

The peaks are one NVIDIA H100 SXM's data-sheet figures at 700 W, as
``hex_gym_env_tpu_torch/utils/roofline.py`` has them: 67 TFLOP/s in float32
outside the tensor cores (the configurations compute in float32 with TF32
off) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

PEAK_FLOPS_FP32 = 67e12
PEAK_HBM_BPS = 3.35e12
F32 = 4


@dataclasses.dataclass(frozen=True)
class Model:
    """The shape of a policy: ``family`` "MLP" or "CNN"."""

    family: str
    board: int
    hidden: Sequence[int]
    activation: str = "tanh"
    filters: int = 0
    conv_layers: int = 0
    features: int = 0

    @property
    def cells(self) -> int:
        return self.board * self.board


def model_of(config: dict) -> Model:
    """The ``model`` block of a configuration file."""
    m = config["model"]
    return Model(family=m["family"], board=m["board_size"], hidden=tuple(m["hidden"]),
                 activation=m["activation"],
                 filters=m.get("filters", 0), conv_layers=m.get("conv_layers", 0),
                 features=m.get("features", 0))


def _tower(n_in: int, hidden: Sequence[int]) -> float:
    fl, prev = 0.0, n_in
    for h in hidden:
        fl += 2.0 * prev * h
        prev = h
    return fl


def _trunk(m: Model) -> tuple[float, int]:
    """Operations of the shared trunk (the CNN's convs and features) and
    the width it hands to the towers."""
    if m.family == "MLP":
        return 0.0, m.cells
    convs = 2.0 * 9 * 1 * m.filters * m.cells
    convs += (m.conv_layers - 1) * 2.0 * 9 * m.filters * m.filters * m.cells
    return convs + 2.0 * m.cells * m.filters * m.features, m.features


def policy_flops(m: Model) -> float:
    """One row through the policy: trunk, pi tower, action head."""
    trunk, width = _trunk(m)
    return trunk + _tower(width, m.hidden) + 2.0 * m.hidden[-1] * m.cells


def agent_flops(m: Model) -> float:
    """One row through the whole agent: trunk, both towers, both heads."""
    trunk, width = _trunk(m)
    return (trunk + 2 * _tower(width, m.hidden) + 2.0 * m.hidden[-1] * m.cells
            + 2.0 * m.hidden[-1])


def param_count(m: Model) -> int:
    """Parameters of one agent (the CNN's BatchNorm statistics included)."""
    trunk_p, width = 0, m.cells
    if m.family == "CNN":
        cin = 1
        for _ in range(m.conv_layers):
            trunk_p += cin * m.filters * 9 + m.filters + 4 * m.filters
            cin = m.filters
        trunk_p += m.cells * m.filters * m.features + m.features
        width = m.features
    tower, prev = 0, width
    for h in m.hidden:
        tower += prev * h + h
        prev = h
    return trunk_p + 2 * tower + (prev * m.cells + m.cells) + (prev + 1)


def rollout(m: Model, n_envs: int, n_steps: int, pool: int) -> tuple[float, float]:
    """(operations, bytes) of one rollout of ``n_steps`` x ``n_envs``
    transitions: reads the agent and the pool + best, writes the record
    (board int8, action, log-probability, value, reward, done)."""
    t = n_envs * n_steps
    flops = t * (agent_flops(m) + policy_flops(m))
    record = t * (m.cells + 4 * F32 + 1)
    return flops, (pool + 2) * param_count(m) * F32 + record


def sweep(m: Model, rows: int, n_epochs: int, minibatch: int) -> tuple[float, float]:
    """(operations, bytes) of one epochs x minibatches sweep over ``rows``:
    reads the batch (board int8; action, old log-probability, advantage,
    return) and the parameters and both moments, writes the three back."""
    visits = n_epochs * (rows // minibatch) * minibatch
    flops = 3.0 * agent_flops(m) * visits
    return flops, rows * (m.cells + 4 * F32) + 6 * param_count(m) * F32


def evaluation(m: Model, episodes: int) -> float:
    """Operations of one evaluation pass: ``episodes`` games of at most a
    full board of plies."""
    return episodes * m.cells * policy_flops(m)


def iteration(m: Model, n_envs: int, n_steps: int, n_epochs: int, minibatch: int,
              eval_episodes: int) -> float:
    """Operations of one training iteration with its evaluation."""
    return (rollout(m, n_envs, n_steps, 0)[0]
            + sweep(m, n_envs * n_steps, n_epochs, minibatch)[0]
            + evaluation(m, eval_episodes))


def match(m: Model, games: int) -> float:
    """Operations of one match of ``games`` games."""
    return games * m.cells * policy_flops(m)


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the operations over the float32 peak and the bytes over
    the HBM peak."""
    return max(flops / PEAK_FLOPS_FP32, nbytes / PEAK_HBM_BPS)
