"""Actor-critic MLP policy matching SB3's ``MlpPolicy`` family.

The counterpart of the JAX package's ``models/mlp.py``:

- flatten the (N, N) board to N^2 float32 features;
- two separate towers ``pi`` and ``vf``, default [64, 64] with Tanh
  (``MLP-default``); the deep/wide variants use ReLU;
- linear action head (N^2 logits) and linear value head (scalar);
- orthogonal init with SB3's gains: sqrt(2) for hidden layers, 0.01 for the
  action head, 1.0 for the value head; zero biases.

Parameters follow ``nn.Linear``'s (out, in) layout; ``models/convert.py``
carries the JAX package's (in, out) flax kernels across.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

ORTHO_HIDDEN_GAIN = 2.0**0.5
ORTHO_ACTION_GAIN = 0.01
ORTHO_VALUE_GAIN = 1.0

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def _dense(n_in: int, n_out: int, gain: float, generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        layer.bias.zero_()
    return layer


class MlpPolicy(nn.Module):
    """Separate pi/vf towers + action/value heads.

    Call with observations of shape (B, N, N) or (B, N*N), any dtype;
    returns ``(logits (B, N*N) float32, value (B,) float32)``.  Where
    ``ops/mlp_forward.bind`` has bound the parameters and built their image,
    a float32 call with grad disabled on the image's device runs as one
    kernel launch while the parameters stay as they were bound.
    """

    def __init__(
        self,
        n_actions: int,
        pi_layers: Sequence[int] = (64, 64),
        vf_layers: Sequence[int] = (64, 64),
        activation: str = "tanh",
        generator: torch.Generator | None = None,
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
                _dense(a, b, ORTHO_HIDDEN_GAIN, generator) for a, b in zip(dims[:-1], dims[1:])
            )

        self.pi = tower(self.pi_layers)
        self.vf = tower(self.vf_layers)
        self.action_head = _dense(self.pi_layers[-1], n_actions, ORTHO_ACTION_GAIN, generator)
        self.value_head = _dense(self.vf_layers[-1], 1, ORTHO_VALUE_GAIN, generator)
        # the forward kernel on an image of the parameters, where
        # ops/mlp_forward.bind built one: taken while its rule holds
        self.bound_forward = None

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
