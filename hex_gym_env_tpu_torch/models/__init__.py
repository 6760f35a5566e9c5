"""Policy model zoo mirroring the reference experiment grid.

Families (``scripts/experiments/*.py`` of the reference):

- ``MLP-default``: pi/vf [64, 64], Tanh
- ``MLP-deep``: pi/vf [64]*4, ReLU
- ``MLP-wide-deep``: pi/vf [128]*4, ReLU
- ``CNN``: conv 1->64 + four 64->64 convs with BatchNorm, features 128,
  pi/vf [128, 128], ReLU (``models/cnn.py``)
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.models.cnn import CnnPolicy
from hex_gym_env_tpu_torch.models.mlp import MlpPolicy


def make_policy(
    family: str, n_actions: int, generator: torch.Generator | None = None
) -> MlpPolicy | CnnPolicy:
    """Build a policy module (on the CPU) for one of the reference's families."""
    if family == "MLP-default":
        return MlpPolicy(n_actions, generator=generator)
    if family == "MLP-deep":
        return MlpPolicy(n_actions, (64,) * 4, (64,) * 4, "relu", generator)
    if family == "MLP-wide-deep":
        return MlpPolicy(n_actions, (128,) * 4, (128,) * 4, "relu", generator)
    if family == "CNN":
        return CnnPolicy(n_actions, generator=generator)
    raise ValueError(f"unknown policy family: {family!r}")


__all__ = ["CnnPolicy", "MlpPolicy", "make_policy"]
