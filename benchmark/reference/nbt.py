"""KataGo's nested-bottleneck tower with global pooling, in plain float32
PyTorch: the reference that judges the program's ``KataGo-NBT`` family.

The network KataGo names ``b18c384nbt`` (lightvector/KataGo,
``python/katago/train/modelconfigs.py``, config ``b18c384nbt``: 18 blocks,
a trunk of 384 channels, 192 inside the bottleneck, 64 pooled;
``python/katago/train/model_pytorch.py``: ``NestedBottleneckResBlock``,
``ResBlock``, ``ConvAndGPool``, ``KataGPool``, ``KataValueHeadGPool``,
``PolicyHead``, ``ValueHead``; global pooling after Wu 2019, arXiv:
1902.10565).  With A = N^2 cells and BNR(z) = relu(BatchNorm(z)), every
conv without a bias:

    x = conv3x3[1 -> 384](obs)
    each block i:
        h = conv1x1[384 -> 192](BNR(x))
        each inner block j of 2:
            pooled (every third block, j = 1):
                [r | g] = conv3x3[192 -> 128 | 64](BNR(h))
                f = [mean BNR(g), mean BNR(g) (sqrt(A) - 14) / 10, max BNR(g)]
                h = h + conv3x3[128 -> 192](BNR(r + W_g f))
            else:
                h = h + conv3x3[192 -> 192](BNR(conv3x3[192 -> 192](BNR(h))))
        x = x + conv1x1[192 -> 384](BNR(h))
    z = BNR(x)
    policy: p = conv1x1[384 -> p1](z); q = BNR(conv1x1[384 -> g1](z))
            logits = conv1x1[p1 -> 1](BNR(p + W_pg [mean q, mean q (sqrt(A) - 14) / 10, max q]))
    value:  v = BNR(conv1x1[384 -> v1](z))
            f = [mean v, mean v (sqrt(A) - 14) / 10, mean v ((sqrt(A) - 14)^2 / 100 - 0.1)]
            value = tanh(W2 relu(W1 f + b1) + b2)

Departures from KataGo, each forced by the game or by the system it judges:

- the input is one plane, the board in the mover's frame (the mover's
  stones -1, the opponent's 1, transposed for the second seat;
  ``env.mover_frame``), and its conv is 3x3 (KataGo: 22 spatial planes and
  19 global features, a 5x5 input conv in its larger nets): the program's
  policies see one plane;
- Hex has no pass and no score: the policy head gives one logit a cell (no
  pass logit, no auxiliary policy channels), the value head one tanh value
  (KataGo: win/loss/draw, score, ownership and more);
- every normalization is BatchNorm on running statistics with flax's rule
  (as ``models.py``, eps 1e-5; in training the batch's biased statistics,
  the running ones moved to ``0.9 * old + 0.1 * batch``), where KataGo's
  newer nets use fixed-scale or bias-only norms; the heads' ``bias``
  layers are BatchNorm too;
- the activation is ReLU (KataGo's default; its mish variant not taken);
- the boards carry no mask: every cell is on the board, so the pooled
  means are over all A cells and sqrt(A) is the board's side;
- the pooled positions are every third block, as the source's
  ``block_kind`` for b18c384nbt is recalled;
- the head widths p1 = g1 = 48, v1 = 96, v2 = 128 are set here.

Parameters are a dict of tensors under the program's state-dict names: a
conv's ``<layer>.conv.weight`` with the BatchNorm of its input
``<layer>.bn.{scale,bias,mean,var}`` beside it, for ``blocks.{i}.pre``,
``blocks.{i}.inner.{j}.a``, ``blocks.{i}.inner.{j}.b``, ``blocks.{i}.post``
and ``policy_out``; ``conv_in.weight``, ``policy_p.weight``,
``policy_g.weight`` and ``value_conv.weight`` without one; a pooling's
``<name>.bn.*`` and ``<name>.fc.weight`` (no bias) for
``blocks.{i}.inner.0.g`` and ``policy_pool``; ``final.bn.*`` and
``value_norm.bn.*``; ``value_fc.*`` and ``value_head.*``, each ``weight``
and ``bias``.  The structure (blocks, pooled blocks, widths) is read from
the names and shapes.

Nothing here sets the precision: the caller does (``models.precision``),
full float32 for the judge and TF32 for the control.  ``norm``, where
given, replaces BNR: the driver's draw calibrates BatchNorm through it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.models import _batch_norm


def _bnr(params, name: str, x, train: bool, new_stats: dict):
    return torch.relu(_batch_norm(params, name, x, train, new_stats))


def _conv(params, key: str, x):
    w = params[key]
    return F.conv2d(x, w, None, padding=w.shape[-1] // 2)


def pool(a: torch.Tensor, third: str = "max") -> torch.Tensor:
    """(B, 3 C): the mean of each channel over the board, the mean x
    (sqrt(A) - 14) / 10, and the max (``third`` "max") or the mean x
    ((sqrt(A) - 14)^2 / 100 - 0.1) (``third`` "moment")."""
    off = math.sqrt(a.shape[2] * a.shape[3]) - 14.0
    mean = a.mean(dim=(2, 3))
    last = a.amax(dim=(2, 3)) if third == "max" else mean * (off * off / 100.0 - 0.1)
    return torch.cat((mean, mean * (off / 10.0), last), dim=1)


def blocks_of(params) -> int:
    """The number of nested bottleneck blocks in ``params``."""
    i = 0
    while f"blocks.{i}.pre.conv.weight" in params:
        i += 1
    return i


def trunk(params, obs: torch.Tensor, train: bool = False, new_stats: dict | None = None,
          norm=None):
    """z (B, trunk, N, N), the trunk's output after its final BNR."""
    new_stats = {} if new_stats is None else new_stats
    bnr = norm or (lambda name, x: _bnr(params, name, x, train, new_stats))
    B = obs.shape[0]
    n = int(round(obs[0].numel() ** 0.5))
    x = _conv(params, "conv_in.weight", obs.reshape(B, 1, n, n).to(torch.float32))
    for i in range(blocks_of(params)):
        b = f"blocks.{i}"
        h = _conv(params, f"{b}.pre.conv.weight", bnr(f"{b}.pre", x))
        for j in range(2):
            inner = f"{b}.inner.{j}"
            y = _conv(params, f"{inner}.a.conv.weight", bnr(f"{inner}.a", h))
            if f"{inner}.g.fc.weight" in params:
                pooled = params[f"{inner}.g.bn.mean"].shape[0]
                r, g = y[:, :-pooled], y[:, -pooled:]
                f = pool(bnr(f"{inner}.g", g))
                y = r + (f @ params[f"{inner}.g.fc.weight"].T)[:, :, None, None]
            h = h + _conv(params, f"{inner}.b.conv.weight", bnr(f"{inner}.b", y))
        x = x + _conv(params, f"{b}.post.conv.weight", bnr(f"{b}.post", h))
    return bnr("final", x)


def _logits(params, z, train: bool, new_stats: dict, norm=None):
    bnr = norm or (lambda name, x: _bnr(params, name, x, train, new_stats))
    p = _conv(params, "policy_p.weight", z)
    q = bnr("policy_pool", _conv(params, "policy_g.weight", z))
    p = p + (pool(q) @ params["policy_pool.fc.weight"].T)[:, :, None, None]
    out = _conv(params, "policy_out.conv.weight", bnr("policy_out", p))
    return out.reshape(z.shape[0], -1)


def _value(params, z, train: bool, new_stats: dict, norm=None):
    bnr = norm or (lambda name, x: _bnr(params, name, x, train, new_stats))
    v = bnr("value_norm", _conv(params, "value_conv.weight", z))
    v = torch.relu(pool(v, "moment") @ params["value_fc.weight"].T + params["value_fc.bias"])
    return torch.tanh(v @ params["value_head.weight"].T + params["value_head.bias"])[:, 0]


def forward(params, obs: torch.Tensor, train: bool = False, norm=None):
    """``(logits (B, N*N), value (B,))`` of boards ``obs`` (B, N, N) or (B,
    N*N), and with ``train`` also the new running statistics by name."""
    new_stats: dict = {}
    z = trunk(params, obs, train, new_stats, norm)
    logits = _logits(params, z, train, new_stats, norm)
    value = _value(params, z, train, new_stats, norm)
    if train:
        return logits, value, new_stats
    return logits, value


def policy_logits(params, obs: torch.Tensor):
    """The action logits alone: the trunk and the policy head, BatchNorm on
    its running statistics."""
    return _logits(params, trunk(params, obs), False, {})
