"""The two policy families of the benchmark's configurations, in float32.

Parameters are a dict of tensors under the names the harness gives them
(``pi.{i}.weight`` (out, in), ``pi.{i}.bias``, ``vf.{i}.*``,
``action_head.*``, ``value_head.*``; the CNN adds ``features.*`` and, for
each conv layer, ``<layer>.conv.weight`` (out, in, 3, 3), ``.conv.bias``,
``.bn.scale``, ``.bn.bias`` and the running ``.bn.mean`` and ``.bn.var``).

- MLP: the flattened board through two towers, each a stack of dense
  layers with one activation (tanh for MLP-default), then a linear action
  head (one logit per cell) and a linear value head.
- CNN: a 3x3 SAME conv 1 -> 64 and four 64 -> 64, each with BatchNorm and
  ReLU; the (H, W, C)-ordered flatten through a dense 128 with ReLU; ReLU
  towers [128, 128]; the two heads.  BatchNorm in training normalises with
  the batch's biased statistics over (N, H, W), the variance taken as
  ``max(0, E[x^2] - E[x]^2)``, and moves the running statistics to
  ``0.9 * old + 0.1 * batch``; outside training it uses the running ones.
  Epsilon 1e-5.

Every product runs in full float32: ``full_float32`` turns TF32 off for
cuBLAS and cuDNN, and ``tf32`` turns it on for the control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MASKED = float(np.finfo(np.float32).min)
U_MAX = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
CONV_LAYERS = ("conv_in", "block1_a", "block1_b", "block2_a", "block2_b")
ACT = {"tanh": torch.tanh, "relu": torch.relu}


@contextlib.contextmanager
def precision(allow_tf32: bool):
    """cuBLAS and cuDNN float32 products in TF32 or in full float32 for the
    calls inside; the flags are put back on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def full_float32():
    return precision(False)


def tf32():
    return precision(True)


def _tower(params, prefix: str, n_layers: int, act, x):
    for i in range(n_layers):
        x = act(x @ params[f"{prefix}.{i}.weight"].T + params[f"{prefix}.{i}.bias"])
    return x


def _heads(params, pi, vf):
    logits = pi @ params["action_head.weight"].T + params["action_head.bias"]
    value = (vf @ params["value_head.weight"].T + params["value_head.bias"])[:, 0]
    return logits, value


def mlp_forward(params, obs: torch.Tensor, n_layers: int, activation: str):
    """``(logits (B, A), value (B,))`` of boards ``obs`` (B, n, n) or (B, A)."""
    x = obs.reshape(obs.shape[0], -1).to(torch.float32)
    act = ACT[activation]
    return _heads(params, _tower(params, "pi", n_layers, act, x),
                  _tower(params, "vf", n_layers, act, x))


def mlp_policy_logits(params, obs: torch.Tensor, n_layers: int, activation: str):
    """The action logits alone (the pi tower and the action head)."""
    x = obs.reshape(obs.shape[0], -1).to(torch.float32)
    pi = _tower(params, "pi", n_layers, ACT[activation], x)
    return pi @ params["action_head.weight"].T + params["action_head.bias"]


def _batch_norm(params, name: str, x, train: bool, new_stats: dict):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        new_stats[f"{name}.bn.mean"] = (
            BN_MOMENTUM * params[f"{name}.bn.mean"] + (1 - BN_MOMENTUM) * mean).detach()
        new_stats[f"{name}.bn.var"] = (
            BN_MOMENTUM * params[f"{name}.bn.var"] + (1 - BN_MOMENTUM) * var).detach()
    else:
        mean, var = params[f"{name}.bn.mean"], params[f"{name}.bn.var"]
    mul = torch.rsqrt(var + BN_EPS) * params[f"{name}.bn.scale"]
    return (x - mean[:, None, None]) * mul[:, None, None] + params[f"{name}.bn.bias"][:, None, None]


def _cnn_features(params, obs: torch.Tensor, train: bool, new_stats: dict):
    """The conv stack, the (H, W, C) flatten and the features layer."""
    B = obs.shape[0]
    n = int(round((obs[0].numel()) ** 0.5))
    x = obs.reshape(B, 1, n, n).to(torch.float32)
    for name in CONV_LAYERS:
        x = F.conv2d(x, params[f"{name}.conv.weight"], params[f"{name}.conv.bias"], padding=1)
        x = torch.relu(_batch_norm(params, name, x, train, new_stats))
    x = x.permute(0, 2, 3, 1).reshape(B, -1)
    return torch.relu(x @ params["features.weight"].T + params["features.bias"])


def cnn_forward(params, obs: torch.Tensor, n_layers: int = 2, train: bool = False):
    """``(logits, value)``, and with ``train`` also the new running
    statistics by name."""
    new_stats: dict = {}
    feats = _cnn_features(params, obs, train, new_stats)
    logits, value = _heads(params, _tower(params, "pi", n_layers, torch.relu, feats),
                           _tower(params, "vf", n_layers, torch.relu, feats))
    if train:
        return logits, value, new_stats
    return logits, value


def policy_logits(model, params, obs: torch.Tensor):
    """The action logits of ``model`` (a ``work.Model``) on boards ``obs``:
    for the MLP ``mlp_policy_logits``; for the CNN the conv stack with
    BatchNorm on its running statistics, the (H, W, C) flatten, the
    features layer, the pi tower and the action head."""
    if model.family == "MLP":
        return mlp_policy_logits(params, obs, len(model.hidden), model.activation)
    pi = _tower(params, "pi", len(model.hidden), torch.relu, _cnn_features(params, obs, False, {}))
    return pi @ params["action_head.weight"].T + params["action_head.bias"]


def masked_log_softmax(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of the categorical over the legal actions; illegal
    entries hold the masked logit's log-probability (about -3.4e38)."""
    return torch.log_softmax(torch.where(legal, logits, torch.full_like(logits, MASKED)), dim=-1)


def gumbel(words: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from 32-bit words (int32 bit patterns): the top
    24 bits ``k`` as ``u = k * 2**-24 + 2**-25``, a point of (0, 1), then
    ``-log(-log u)``.  In float32 the top word's ``u`` (1 - 2**-25) rounds
    to 1.0, whose noise is infinite and would let a masked cell win the
    draw; ``u`` is held at the largest float32 below 1 (``U_MAX``), so the
    noise is finite for every word and a masked cell never wins."""
    u = ((words >> 8) & 0xFFFFFF).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25
    return -torch.log(-torch.log(torch.clamp(u, max=U_MAX)))
