"""Import SB3 MaskablePPO checkpoint weights as a flax-layout MLP tree.

The counterpart of the JAX package's ``models/sb3_import.py``, copied: it
reads ``policy.pth`` straight out of an SB3 zip with ``torch.load`` (no
stable-baselines3 dependency needed) and transposes torch's (out, in) Linear
weights into flax's (in, out) layout, so the tree is the one the JAX package
builds; ``models/convert.flax_state_dict`` turns it into an ``MlpPolicy``
state dict (``models/loading.py`` does both for a ``sb3:<zip>`` spec).

SB3 MlpPolicy state-dict layout (the reference's checkpoints, e.g.
``models/6x6_buffer_64_10.zip``)::

    mlp_extractor.policy_net.{0,2,...}.{weight,bias}   pi tower
    mlp_extractor.value_net.{0,2,...}.{weight,bias}    vf tower
    action_net.{weight,bias}                           logits head
    value_net.{weight,bias}                            value head
"""

from __future__ import annotations

import io
import zipfile
from typing import Any, Dict

import numpy as np
import torch


def load_sb3_policy_state(path: str) -> Dict[str, np.ndarray]:
    """Return the raw torch state dict (as numpy) from an SB3 zip."""
    with zipfile.ZipFile(path) as z:
        with z.open("policy.pth") as f:
            sd = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in sd.items()}


def sb3_to_mlp_params(path: str) -> Dict[str, Any]:
    """Convert an SB3 MlpPolicy checkpoint into a flax ``MlpPolicy`` tree
    (numpy leaves, Dense kernels (in, out))."""
    sd = load_sb3_policy_state(path)

    def linear(prefix: str) -> Dict[str, np.ndarray]:
        return {
            "kernel": sd[f"{prefix}.weight"].T.copy(),
            "bias": sd[f"{prefix}.bias"].copy(),
        }

    params: Dict[str, Any] = {}
    i = 0
    while f"mlp_extractor.policy_net.{2 * i}.weight" in sd:
        params[f"pi_{i}"] = linear(f"mlp_extractor.policy_net.{2 * i}")
        params[f"vf_{i}"] = linear(f"mlp_extractor.value_net.{2 * i}")
        i += 1
    params["action_head"] = linear("action_net")
    params["value_head"] = linear("value_net")
    return {"params": params}


def sb3_num_hidden_layers(path: str) -> int:
    sd = load_sb3_policy_state(path)
    i = 0
    while f"mlp_extractor.policy_net.{2 * i}.weight" in sd:
        i += 1
    return i
