"""Policy model zoo mirroring the reference experiment grid.

Families (``scripts/experiments/*.py`` of the reference):

- ``MLP-default``: pi/vf [64, 64], Tanh
- ``MLP-deep``: pi/vf [64]*4, ReLU
- ``MLP-wide-deep``: pi/vf [128]*4, ReLU
- ``CNN``: conv 1->64 + four 64->64 convs with BatchNorm, features 128,
  pi/vf [128, 128], ReLU (``models/cnn.py``)

and two beyond the reference's grid, which the rating match plays and the
trainer has no opponent-bank path for:

- ``AZ-ResNet``: the AlphaZero residual tower, a 3x3 conv block and 19
  residual blocks of 256 filters, its policy and value heads
  (``models/resnet.py``)
- ``KataGo-NBT``: KataGo's b18c384nbt, 18 pre-activation nested
  bottleneck blocks (384 -> 192, two inner residual blocks of 3x3 convs,
  192 -> 384) with global pooling in every third, its pooled policy and
  value heads (``models/nbt.py``)
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.models.cnn import CnnPolicy
from hex_gym_env_tpu_torch.models.mlp import MlpPolicy
from hex_gym_env_tpu_torch.models.nbt import NbtPolicy
from hex_gym_env_tpu_torch.models.resnet import ResNetPolicy


# each family's module class and the widths it is built with
_FAMILIES = {
    "MLP-default": (MlpPolicy, {}),
    "MLP-deep": (MlpPolicy, {"pi_layers": (64,) * 4, "vf_layers": (64,) * 4,
                             "activation": "relu"}),
    "MLP-wide-deep": (MlpPolicy, {"pi_layers": (128,) * 4, "vf_layers": (128,) * 4,
                                  "activation": "relu"}),
    "CNN": (CnnPolicy, {}),
    "AZ-ResNet": (ResNetPolicy, {"filters": 256, "blocks": 19, "value_hidden": 256}),
    "KataGo-NBT": (NbtPolicy, {"trunk": 384, "mid": 192, "gpool": 64, "blocks": 18,
                               "gpool_every": 3, "p1": 48, "g1": 48, "v1": 96, "v2": 128}),
}


def _family(family: str):
    if family not in _FAMILIES:
        raise ValueError(f"unknown policy family: {family!r}")
    return _FAMILIES[family]


Policy = MlpPolicy | CnnPolicy | ResNetPolicy | NbtPolicy


def family_class(family: str) -> type:
    """The module class of ``family``."""
    return _family(family)[0]


def make_policy(family: str, n_actions: int, generator: torch.Generator | None = None) -> Policy:
    """Build a policy module (on the CPU) for one of the reference's
    families, initialised from ``generator`` (the orthogonal weights) and
    torch's default generator (``nn.Linear``'s and ``nn.Conv2d``'s own
    draws, which the orthogonal init overwrites)."""
    cls, widths = _family(family)
    return cls(n_actions, generator=generator, **widths)


def policy_template(family: str, n_actions: int) -> Policy:
    """A fresh module (on the CPU) of ``family`` with no initialisation:
    every conv and dense weight and bias zero, BatchNorm at its ones and
    zeros, no generator read.  ``models/loading`` reads its names, shapes
    and dtypes, and whoever plays it replaces every tensor (``bind``,
    ``functional_call``); unbound it plays as the ``random`` spec."""
    cls, widths = _family(family)
    return cls(n_actions, init=False, **widths)


__all__ = ["CnnPolicy", "MlpPolicy", "NbtPolicy", "ResNetPolicy", "family_class", "make_policy",
           "policy_template"]
