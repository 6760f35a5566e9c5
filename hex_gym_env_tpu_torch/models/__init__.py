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


# each family's module class and the widths it is built with
_FAMILIES = {
    "MLP-default": (MlpPolicy, {}),
    "MLP-deep": (MlpPolicy, {"pi_layers": (64,) * 4, "vf_layers": (64,) * 4,
                             "activation": "relu"}),
    "MLP-wide-deep": (MlpPolicy, {"pi_layers": (128,) * 4, "vf_layers": (128,) * 4,
                                  "activation": "relu"}),
    "CNN": (CnnPolicy, {}),
}


def _family(family: str):
    if family not in _FAMILIES:
        raise ValueError(f"unknown policy family: {family!r}")
    return _FAMILIES[family]


def make_policy(
    family: str, n_actions: int, generator: torch.Generator | None = None
) -> MlpPolicy | CnnPolicy:
    """Build a policy module (on the CPU) for one of the reference's
    families, initialised from ``generator`` (the orthogonal weights) and
    torch's default generator (``nn.Linear``'s and ``nn.Conv2d``'s own
    draws, which the orthogonal init overwrites)."""
    cls, widths = _family(family)
    return cls(n_actions, generator=generator, **widths)


def policy_template(family: str, n_actions: int) -> MlpPolicy | CnnPolicy:
    """A fresh module (on the CPU) of ``family`` with no initialisation:
    every conv and dense weight and bias zero, BatchNorm at its ones and
    zeros, no generator read.  ``models/loading`` reads its names, shapes
    and dtypes, and whoever plays it replaces every tensor (``bind``,
    ``functional_call``); unbound it plays as the ``random`` spec."""
    cls, widths = _family(family)
    return cls(n_actions, init=False, **widths)


__all__ = ["CnnPolicy", "MlpPolicy", "make_policy", "policy_template"]
