"""The AlphaZero residual tower, in plain float32 PyTorch: the reference that
judges the program's ``AZ-ResNet`` family.

The network of AlphaGo Zero (Silver et al. 2017, Nature 550:354, Methods,
"Neural network architecture"), kept by AlphaZero (Silver et al. 2018,
Science 362:1140, supplement, "Architecture"):

- a 3x3 conv of F filters (stride 1), BatchNorm, ReLU;
- ``blocks`` residual blocks: 3x3 conv, BatchNorm, ReLU, 3x3 conv,
  BatchNorm, the block's input added, ReLU;
- the policy head: a 1x1 conv of 2 filters, BatchNorm, ReLU, a dense layer
  to the logits;
- the value head: a 1x1 conv of 1 filter, BatchNorm, ReLU, a dense layer to
  a hidden width, ReLU, a dense layer to one value, tanh.

Departures from the paper, each forced by the game or by the system it
judges:

- the input is one plane, the board in the mover's frame (the mover's
  stones -1, the opponent's 1, transposed for the second seat so that the
  mover always joins the same two sides; ``env.mover_frame``), not the
  paper's 17 planes of history and colour: the program's policies see one
  plane;
- Hex has no pass, so the policy head gives one logit per cell, N*N, not
  N*N + 1;
- the heads' conv outputs are flattened in (C, H, W) order, the paper
  giving none;
- the convs carry no bias: the paper lists none, and each BatchNorm's shift
  stands in its place;
- BatchNorm follows flax's rule (as ``models.py``): at inference the running
  statistics, eps 1e-5; in training the batch's biased statistics over (N,
  H, W), the running ones moved to ``0.9 * old + 0.1 * batch``.

Parameters are a dict of tensors under the program's state-dict names:
``conv_in.conv.weight`` (F, 1, 3, 3), ``blocks.{i}.a.conv.weight`` and
``blocks.{i}.b.conv.weight`` (F, F, 3, 3), ``policy.conv.weight`` (2, F, 1,
1), ``value.conv.weight`` (1, F, 1, 1), each with ``.bn.scale``,
``.bn.bias``, ``.bn.mean`` and ``.bn.var`` beside it under the layer's
name; ``action_head.*`` (N*N, 2 N*N), ``value_fc.*`` (hidden, N*N) and
``value_head.*`` (1, hidden), each ``weight`` and ``bias``.

Nothing here sets the precision: the caller does (``models.precision``),
full float32 for the judge and TF32 for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import _batch_norm


def _conv_bn(params, name: str, x, train: bool, new_stats: dict):
    """A conv without a bias (SAME padding) and its BatchNorm."""
    w = params[f"{name}.conv.weight"]
    y = F.conv2d(x, w, None, padding=w.shape[-1] // 2)
    return _batch_norm(params, name, y, train, new_stats)


def _tower(params, obs: torch.Tensor, blocks: int, train: bool, new_stats: dict):
    """The input block and the residual blocks: (B, F, N, N)."""
    B = obs.shape[0]
    n = int(round(obs[0].numel() ** 0.5))
    x = torch.relu(_conv_bn(params, "conv_in", obs.reshape(B, 1, n, n).to(torch.float32),
                            train, new_stats))
    for i in range(blocks):
        h = torch.relu(_conv_bn(params, f"blocks.{i}.a", x, train, new_stats))
        x = torch.relu(_conv_bn(params, f"blocks.{i}.b", h, train, new_stats) + x)
    return x


def _head(params, name: str, x, train: bool, new_stats: dict):
    y = torch.relu(_conv_bn(params, name, x, train, new_stats))
    return y.reshape(y.shape[0], -1)  # (C, H, W) order


def _logits(params, x, train: bool, new_stats: dict):
    p = _head(params, "policy", x, train, new_stats)
    return p @ params["action_head.weight"].T + params["action_head.bias"]


def forward(params, obs: torch.Tensor, blocks: int, train: bool = False):
    """``(logits (B, N*N), value (B,))`` of boards ``obs`` (B, N, N) or (B,
    N*N), and with ``train`` also the new running statistics by name."""
    new_stats: dict = {}
    x = _tower(params, obs, blocks, train, new_stats)
    logits = _logits(params, x, train, new_stats)
    v = _head(params, "value", x, train, new_stats)
    v = torch.relu(v @ params["value_fc.weight"].T + params["value_fc.bias"])
    value = torch.tanh(v @ params["value_head.weight"].T + params["value_head.bias"])[:, 0]
    if train:
        return logits, value, new_stats
    return logits, value


def policy_logits(params, obs: torch.Tensor, blocks: int):
    """The action logits alone: the tower and the policy head, BatchNorm on
    its running statistics."""
    return _logits(params, _tower(params, obs, blocks, False, {}), False, {})
