"""Carry weights, optimizer and env state across from the JAX package.

The JAX package keeps MLP parameters as flax trees,
``{"params": {"pi_0": {"kernel", "bias"}, ..., "action_head": ...,
"value_head": ...}}``, with Dense kernels laid out (in, out).  ``nn.Linear``
weights are (out, in).  A CNN's tree adds ``params/<layer>/Conv_0/{kernel,
bias}`` (kernels (3, 3, Cin, Cout); ``nn.Conv2d``'s are (Cout, Cin, 3, 3)),
``params/<layer>/BatchNorm_0/{scale, bias}``, ``params/features`` and a
``batch_stats/<layer>/BatchNorm_0/{mean, var}`` collection.  These helpers
take such trees (and states) as numpy arrays — the caller converts with
``np.asarray`` — so this package never imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from hex_gym_env_tpu_torch.core.state import HexState
from hex_gym_env_tpu_torch.models.cnn import CONV_LAYERS, CnnPolicy
from hex_gym_env_tpu_torch.models.mlp import MlpPolicy

_FLAX_HEADS = (("action_head", "action_head"), ("value_head", "value_head"))


def _inner(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _n_layers(tree: Mapping, tower: str) -> int:
    return sum(1 for k in tree if k.startswith(f"{tower}_"))


def _flax_entries(tree: Mapping):
    """(state-dict key, flax leaf path) pairs of the Dense layers of a
    tree (a CNN's ``features`` first)."""
    out = [("features", "features")] if "features" in tree else []
    for tower in ("pi", "vf"):
        for i in range(_n_layers(tree, tower)):
            out.append((f"{tower}.{i}", f"{tower}_{i}"))
    out += list(_FLAX_HEADS)
    return out


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, np.float32)))


def flax_state_dict(params_np: Mapping) -> dict[str, torch.Tensor]:
    """A flax MLP or CNN tree (numpy leaves) as an ``MlpPolicy`` or
    ``CnnPolicy`` state dict.  A CNN (a tree with ``conv_in``) given as its
    whole variables also carries ``batch_stats`` across; given its
    ``params`` alone (as optax's moments are), the result holds only the
    trained parameters.

    Leading axes are kept, so this is also the stacked variant: a bank whose
    leaves have a leading P axis gives the stacked tensors of
    ``OpponentBank.params``."""
    tree = _inner(params_np)
    sd = {}
    if "conv_in" in tree:
        stats = params_np.get("batch_stats") if "params" in params_np else None
        for name in CONV_LAYERS:
            conv, bn = tree[name]["Conv_0"], tree[name]["BatchNorm_0"]
            # (..., 3, 3, Cin, Cout) -> (..., Cout, Cin, 3, 3)
            kernel = np.asarray(conv["kernel"], np.float32)
            nd = kernel.ndim
            axes = tuple(range(nd - 4)) + (nd - 1, nd - 2, nd - 4, nd - 3)
            sd[f"{name}.conv.weight"] = _tensor(np.transpose(kernel, axes))
            sd[f"{name}.conv.bias"] = _tensor(conv["bias"])
            sd[f"{name}.bn.scale"] = _tensor(bn["scale"])
            sd[f"{name}.bn.bias"] = _tensor(bn["bias"])
            if stats is not None:
                sd[f"{name}.bn.mean"] = _tensor(stats[name]["BatchNorm_0"]["mean"])
                sd[f"{name}.bn.var"] = _tensor(stats[name]["BatchNorm_0"]["var"])
    for key, name in _flax_entries(tree):
        kernel = np.asarray(tree[name]["kernel"], np.float32)
        sd[f"{key}.weight"] = _tensor(np.swapaxes(kernel, -1, -2))
        sd[f"{key}.bias"] = _tensor(tree[name]["bias"])
    return sd


def flax_to_torch(params_np: Mapping, activation: str = "tanh") -> MlpPolicy | CnnPolicy:
    """The port's ``MlpPolicy`` or ``CnnPolicy`` (on the CPU) holding a flax
    model's weights (a CNN's given as its whole variables, ``batch_stats``
    included).

    Layer widths are read off the kernels; an MLP's activation cannot be,
    so it is given ("tanh" for MLP-default, "relu" for the deep families;
    the CNN's is ReLU)."""
    tree = _inner(params_np)
    pi = [np.shape(tree[f"pi_{i}"]["kernel"])[1] for i in range(_n_layers(tree, "pi"))]
    vf = [np.shape(tree[f"vf_{i}"]["kernel"])[1] for i in range(_n_layers(tree, "vf"))]
    n_actions = np.shape(tree["action_head"]["kernel"])[1]
    if "conv_in" in tree:
        filters = np.shape(tree["conv_in"]["Conv_0"]["kernel"])[-1]
        features_dim = np.shape(tree["features"]["kernel"])[1]
        model = CnnPolicy(n_actions, filters, features_dim, pi, vf)
    else:
        model = MlpPolicy(n_actions, pi, vf, activation)
    model.load_state_dict(flax_state_dict(params_np))
    return model


def optax_adam_to_torch(opt_state_np):
    """The JAX package's optimizer state ``(clip_state, (ScaleByAdamState,
    lr_state))`` (``optax.chain(clip_by_global_norm, adam)``), with numpy
    leaves, as the port's ``train/ppo.AdamState``: the step count and the
    two moments as state dicts of the trained parameters (a CNN's moments
    cover its ``params``, not its ``batch_stats``), so both packages can
    start a sweep from the same moments and count."""
    from hex_gym_env_tpu_torch.train.ppo import AdamState

    adam = opt_state_np[1][0]
    return AdamState(
        count=int(np.asarray(adam.count)),
        mu=flax_state_dict(adam.mu),
        nu=flax_state_dict(adam.nu),
    )


_STATE_DTYPES = {
    "stones": torch.bool,
    "labels": torch.int32,
    "to_move": torch.int32,
    "done": torch.bool,
    "winner": torch.int32,
    "empty": torch.int32,
    "move_count": torch.int32,
}


def state_from_numpy(obj: Any, device=None):
    """A ``HexState`` or ``RolloutCarry`` of the JAX package, given with
    array leaves (numpy or anything ``np.asarray`` takes), as the port's
    tensors on ``device`` (default: the CPU)."""

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(dtype=dtype, device=device)

    if hasattr(obj, "env"):
        from hex_gym_env_tpu_torch.train.rollout import RolloutCarry

        return RolloutCarry(
            env=state_from_numpy(obj.env, device),
            agent_seat=t(obj.agent_seat, torch.int32),
            use_best=t(obj.use_best, torch.bool),
            opp_idx=t(obj.opp_idx, torch.int32),
        )
    return HexState(**{k: t(getattr(obj, k), d) for k, d in _STATE_DTYPES.items()})
