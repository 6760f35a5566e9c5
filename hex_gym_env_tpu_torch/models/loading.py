"""Policy-parameter loading by spec string.

The counterpart of the JAX package's ``models/loading.py``, shared by the
match and tournament scripts and the selfplay wrapper's opponents:

- ``random``          — zero parameters (uniform over legal moves, i.e. the
                        reference's ``BaseRandomPolicy``);
- ``sb3:<zip>``       — a reference SB3 checkpoint (``models/sb3_import``);
- ``orbax:<dir>``     — a params snapshot of the JAX package (its
                        ``utils/checkpoint.save_params``), read without JAX
                        through ``tensorstore``;
- ``params:<file>``   — a snapshot of this package's
                        ``utils/checkpoint.save_params``.

``spec_from_path`` turns the bare paths the CLI scripts take into specs.

The repo's trained agents are also kept as ``params:`` files beside this
module (``models/agents/{5x5,6x6,7x7}_strict_sb3.pt``), so a machine without
``tensorstore`` can play them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.convert import flax_state_dict
from hex_gym_env_tpu_torch.utils import profiling
from hex_gym_env_tpu_torch.utils.device import resolve_device

AGENTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "agents")


def agent_path(board_size: int) -> str:
    """The ``params:`` copy of the repo's trained ``NxN_strict_sb3`` agent."""
    return os.path.join(AGENTS_DIR, f"{board_size}x{board_size}_strict_sb3.pt")


def spec_from_path(path: str) -> str:
    """The spec of a ``--checkpoint`` argument: an existing directory is an
    orbax snapshot (``orbax:<dir>``, what the JAX scripts take), an existing
    file a ``params:`` file; anything else (a prefixed spec, ``random``) is
    returned as it is."""
    if os.path.isdir(path):
        return f"orbax:{path}"
    if os.path.isfile(path):
        return f"params:{path}"
    return path


def read_orbax_tree(path: str) -> dict:
    """The arrays of a JAX orbax params snapshot as a nested dict of numpy
    arrays (the flax tree), read through ``tensorstore``.

    The leaves' key paths come from ``<dir>/_METADATA``'s ``tree_metadata``;
    each leaf is a zarr array in the snapshot's OCDBT store."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "an 'orbax:' spec is read through the 'tensorstore' package, which "
            "is not installed; load the port's copy of the weights instead, "
            "e.g. 'params:hex_gym_env_tpu_torch/models/agents/7x7_strict_sb3.pt' "
            "(utils/checkpoint.save_params output)"
        ) from e
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)["tree_metadata"]
    tree: dict = {}
    for leaf in meta.values():
        keys = [k["key"] for k in leaf["key_metadata"]]
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{path}", "path": ".".join(keys)}}
        arr = ts.open(spec).result().read().result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr)
    return tree


def load_policy_params(spec: str, board_size: int, model=None, family: str = "MLP-default",
                       device=None):
    """Returns ``(model, params)`` for ``spec`` at ``board_size``: ``model``
    the policy module (on the CPU), ``params`` its state dict on ``device``
    (``None`` means ``cuda``), the form the runner, the evaluator and
    ``torch.func.functional_call`` take.

    ``family`` picks the architecture (``models.make_policy`` names) when no
    ``model`` is given — needed for non-MLP snapshots (e.g. CNN)."""
    device = resolve_device(device)
    profiling.count("policy_loads")
    n = board_size
    with profiling.span("load.template"):
        if model is None:
            model = make_policy(family, n * n)
        template = model.state_dict()
    if spec == "random":
        with profiling.span("load.h2d"):
            return model, {k: torch.zeros_like(v, device=device) for k, v in template.items()}
    kind, _, path = spec.partition(":")
    with profiling.span("load.read"):
        if kind == "sb3":
            from hex_gym_env_tpu_torch.models.sb3_import import sb3_to_mlp_params

            sd = flax_state_dict(sb3_to_mlp_params(path))
        elif kind == "orbax":
            sd = flax_state_dict(read_orbax_tree(path))
        elif kind == "params":
            from hex_gym_env_tpu_torch.utils.checkpoint import load_params

            sd = load_params(path, map_location="cpu")
        else:
            raise ValueError(f"unknown policy spec: {spec}")
    want = {k: tuple(v.shape) for k, v in template.items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if got != want:
        raise ValueError(f"{spec} does not fit a {family} policy at {n}x{n}: {got} vs {want}")
    with profiling.span("load.h2d"):
        return model, {k: profiling.to_device(v, device, template[k].dtype)
                       for k, v in sd.items()}
