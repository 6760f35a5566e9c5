"""Actor-critic MLP policy matching SB3's ``MlpPolicy`` family.

The counterpart of the JAX package's ``models/mlp.py``:

- flatten the (N, N) board to N^2 float32 features;
- two separate towers ``pi`` and ``vf``, default [64, 64] with Tanh
  (``MLP-default``); the deep/wide variants use ReLU;
- linear action head (N^2 logits) and linear value head (scalar);
- orthogonal init with SB3's gains: sqrt(2) for hidden layers, 0.01 for the
  action head, 1.0 for the value head; zero biases.  ``init=False`` builds
  the module with no initialisation (``BareLinear`` layers, weights and
  biases zero), the loader's template (``models.policy_template``), whose
  tensors are all replaced; a module whose initialisation ran counts
  ``policy_inits`` (``utils/profiling``).

Parameters follow ``nn.Linear``'s (out, in) layout; ``models/convert.py``
carries the JAX package's (in, out) flax kernels across.

``assign`` takes a state dict into a policy module with no copy; each
policy's ``bind`` calls it (the rating match binds each side once a match).
A bound ``MlpPolicy`` that the forward kernel takes (``ops/mlp_forward``)
forwards through it while its parameters stay as they were bound.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from hex_gym_env_tpu_torch.utils import profiling

ORTHO_HIDDEN_GAIN = 2.0**0.5
ORTHO_ACTION_GAIN = 0.01
ORTHO_VALUE_GAIN = 1.0

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def assign(module: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``module.load_state_dict(state, assign=True)`` for a state dict that
    names every parameter and buffer of ``module`` and nothing else (as
    ``load_policy_params`` gives it), without the loader's checks and hooks,
    which cost ~0.2 ms a call: each parameter becomes an ``nn.Parameter`` on
    ``state``'s tensor, keeping its ``requires_grad``, and each buffer is
    ``state``'s tensor; nothing is copied."""
    params = dict(module.named_parameters())
    own = params.keys() | dict(module.named_buffers()).keys()
    if state.keys() != own:
        raise ValueError(f"params name {sorted(state)}, the module {sorted(own)}")
    for name, t in state.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        if name in params:
            mod._parameters[leaf] = nn.Parameter(t, requires_grad=params[name].requires_grad)
        else:
            mod._buffers[leaf] = t


class Bare:
    """A layer whose constructor fills its weight and bias (where it has
    one) with zeros in place of ``reset_parameters``' draws: no generator is
    read, and one pass writes each tensor."""

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()


class BareLinear(Bare, nn.Linear):
    """``nn.Linear`` built with zero weight and bias (``Bare``)."""


def _dense(n_in: int, n_out: int, gain: float, generator, init: bool = True) -> nn.Linear:
    """A linear layer with orthogonal weights of ``gain`` and zero bias;
    with ``init`` off, a ``BareLinear``."""
    if not init:
        return BareLinear(n_in, n_out)
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        layer.bias.zero_()
    return layer


class MlpPolicy(nn.Module):
    """Separate pi/vf towers + action/value heads.

    Call with observations of shape (B, N, N) or (B, N*N), any dtype;
    returns ``(logits (B, N*N) float32, value (B,) float32)``.  With
    ``init`` off the layers are built bare (zero, no draw).  Where
    ``bind`` built an image of the parameters, a float32 call with grad
    disabled on the image's device runs as one launch of the forward kernel
    while the parameters stay as they were bound.
    """

    def __init__(
        self,
        n_actions: int,
        pi_layers: Sequence[int] = (64, 64),
        vf_layers: Sequence[int] = (64, 64),
        activation: str = "tanh",
        generator: torch.Generator | None = None,
        init: bool = True,
    ):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be 'tanh' or 'relu', got {activation!r}")
        self.n_actions = n_actions
        self.pi_layers = tuple(pi_layers)
        self.vf_layers = tuple(vf_layers)
        self.activation = activation

        def tower(widths):
            dims = (n_actions,) + tuple(widths)
            return nn.ModuleList(
                _dense(a, b, ORTHO_HIDDEN_GAIN, generator, init)
                for a, b in zip(dims[:-1], dims[1:])
            )

        self.pi = tower(self.pi_layers)
        self.vf = tower(self.vf_layers)
        self.action_head = _dense(self.pi_layers[-1], n_actions, ORTHO_ACTION_GAIN, generator,
                                  init)
        self.value_head = _dense(self.vf_layers[-1], 1, ORTHO_VALUE_GAIN, generator, init)
        if init:
            profiling.count("policy_inits")
        # the forward kernel on an image of the parameters, where bind
        # built one: taken while its rule holds
        self.bound_forward = None

    def bind(self, params: Mapping[str, torch.Tensor]) -> None:
        """Take ``params`` (a state dict) as the module's own with no copy
        (``assign``), and where the forward kernel takes the module
        (``ops/mlp_forward.kernel_forward``: equal towers of one width,
        float32 on a CUDA device), build their image in one launch and
        forward through it; elsewhere the module forwards on its plain
        path."""
        # a function-level import: ops/policy_kernel imports this module
        from hex_gym_env_tpu_torch.ops import mlp_forward

        assign(self, params)
        self.bound_forward = mlp_forward.kernel_forward(self)

    def forward(self, obs: torch.Tensor):
        bound = self.bound_forward
        if bound is not None and bound.takes(obs):
            return bound(obs)
        act = ACTIVATIONS[self.activation]
        x = obs.reshape(obs.shape[0], -1).to(torch.float32)
        pi = x
        for layer in self.pi:
            pi = act(layer(pi))
        vf = x
        for layer in self.vf:
            vf = act(layer(vf))
        return self.action_head(pi), self.value_head(vf)[..., 0]


def stacked_pi_logits(
    params: Mapping[str, torch.Tensor], n_layers: int, activation: str, x: torch.Tensor
) -> torch.Tensor:
    """Action logits of P stacked policies over one batch, (P, B, A).

    ``params`` holds ``MlpPolicy`` state-dict entries with a leading P axis
    (``pi.{i}.weight`` (P, out, in), ``pi.{i}.bias`` (P, out),
    ``action_head.*``); ``x`` is (B, F) float32.
    """
    act = ACTIVATIONS[activation]
    h = x[None]
    for i in range(n_layers):
        h = act(
            torch.matmul(h, params[f"pi.{i}.weight"].transpose(1, 2))
            + params[f"pi.{i}.bias"][:, None, :]
        )
    return (
        torch.matmul(h, params["action_head.weight"].transpose(1, 2))
        + params["action_head.bias"][:, None, :]
    )
