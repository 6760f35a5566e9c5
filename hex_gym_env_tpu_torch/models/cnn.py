"""CNN feature-extractor policy, the counterpart of the JAX package's
``models/cnn.py`` (the reference's ``minihex/CustomNetwork.py:9-60`` with the
CNN experiments' policy kwargs):

- a 3x3 SAME conv (1 -> 64), then BatchNorm and ReLU;
- two "residual" blocks that are plain double Conv + BN + ReLU stacks: the
  reference's ``residual()`` has no skip connection despite its name, and
  neither has this port;
- flatten in (H, W, C) order -> ``features`` (Dense 128, ReLU);
- pi/vf towers [128, 128] with ReLU and the usual heads.

BatchNorm follows flax's rule, written out by hand rather than with
``nn.BatchNorm2d`` (which updates its running variance with the unbiased
batch variance): ``train=True`` normalises with the batch's biased
statistics over (N, H, W), ``max(0, E[x^2] - E[x]^2)`` as flax's
``use_fast_variance``, and returns the new running statistics
``0.9 * old + 0.1 * batch`` (flax ``momentum=0.9``) beside the outputs;
``train=False`` uses the running statistics.  The statistics are buffers
(``<layer>.bn.mean``, ``<layer>.bn.var``), so they ride in the state dict with
the parameters; ``models/convert.py`` carries flax variables across.

Convolutions and products run in full float32 and deterministically
(``full_float32``, scoped to the CNN's calls): cuDNN would otherwise take
TF32 for a float32 conv and may pick weight-gradient algorithms that sum
with atomics, and neither the tolerances against the JAX package nor the
bitwise resume would hold.

The opponent bank runs with BatchNorm folded into the convs (``fold_bn``):
``bank_logits`` runs every member as one grouped conv per layer (``groups``
= members), ``gathered_bank_logits`` only each game's own member (its
folded filters gathered, ``groups`` = games).  Under ``rollout_bank_bf16``
both round the conv weights and activations to bf16 as the JAX package
does (``bf16=True``); the dense tower after the convs stays float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hex_gym_env_tpu_torch.models.mlp import (
    ORTHO_ACTION_GAIN,
    ORTHO_HIDDEN_GAIN,
    ORTHO_VALUE_GAIN,
    _dense,
)

# One constant for the live BatchNorm layers and for ``fold_bn``: torch's
# BatchNorm2d default, which the reference's extractor uses.
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: new = momentum * old + (1 - momentum) * batch
CONV_LAYERS = ("conv_in", "block1_a", "block1_b", "block2_a", "block2_b")


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions in full float32 (no TF32), deterministic and
    without autotuning, and float32 matmuls in full float32, for the calls
    inside; the flags are put back on exit.  The learner holds it around the
    forward and the backward of a CNN's grad step."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False
        ):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor: learned
    ``scale`` and ``bias``, running ``mean`` and ``var`` as buffers."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool):
        """Returns ``(y, new_mean, new_var)``; the new running statistics
        (detached) only with ``train``, else None."""
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            new_mean = (BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean).detach()
            new_var = (BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var).detach()
        else:
            mean, var, new_mean, new_var = self.mean, self.var, None, None
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y, new_mean, new_var


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        with torch.no_grad():
            nn.init.orthogonal_(self.conv.weight, gain=ORTHO_HIDDEN_GAIN, generator=generator)
            self.conv.bias.zero_()
        self.bn = BatchNorm(cout)


class CnnPolicy(nn.Module):
    """Conv extractor + ReLU towers + action/value heads.

    Call with observations of shape (B, N, N) or (B, N*N) (row-major), any
    dtype: ``forward(obs)`` returns ``(logits (B, N*N), value (B,))``;
    ``forward(obs, train=True)`` normalises with the batch's statistics and
    returns ``(logits, value, new_stats)``, ``new_stats`` the updated
    running statistics by state-dict key (the counterpart of flax's
    ``mutable=["batch_stats"]``).  ``train`` is an argument, not
    ``module.training``, because ``torch.func.functional_call`` shares one
    module between the rollout and the learner."""

    def __init__(
        self,
        n_actions: int,
        filters: int = 64,
        features_dim: int = 128,
        pi_layers: Sequence[int] = (128, 128),
        vf_layers: Sequence[int] = (128, 128),
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.n_actions = n_actions
        self.board = math.isqrt(n_actions)
        if self.board * self.board != n_actions:
            raise ValueError(f"n_actions {n_actions} is not the cell count of a square board")
        self.filters = filters
        self.features_dim = features_dim
        self.pi_layers = tuple(pi_layers)
        self.vf_layers = tuple(vf_layers)
        cin = 1
        for name in CONV_LAYERS:
            self.add_module(name, ConvBnRelu(cin, filters, generator))
            cin = filters
        self.features = _dense(n_actions * filters, features_dim, ORTHO_HIDDEN_GAIN, generator)

        def tower(widths):
            dims = (features_dim,) + tuple(widths)
            return nn.ModuleList(
                _dense(a, b, ORTHO_HIDDEN_GAIN, generator) for a, b in zip(dims[:-1], dims[1:])
            )

        self.pi = tower(self.pi_layers)
        self.vf = tower(self.vf_layers)
        self.action_head = _dense(self.pi_layers[-1], n_actions, ORTHO_ACTION_GAIN, generator)
        self.value_head = _dense(self.vf_layers[-1], 1, ORTHO_VALUE_GAIN, generator)

    def forward(self, obs: torch.Tensor, train: bool = False):
        n = self.board
        # float32 weights take float32 boards (float64 ones, a reference, float64)
        x = obs.reshape(obs.shape[0], 1, n, n).to(self.features.weight.dtype)
        new_stats = {}
        with full_float32():
            for name in CONV_LAYERS:
                layer = getattr(self, name)
                x, mean, var = layer.bn(layer.conv(x), train)
                x = torch.relu(x)
                if train:
                    new_stats[f"{name}.bn.mean"] = mean
                    new_stats[f"{name}.bn.var"] = var
            # flatten in flax's (H, W, C) order
            feats = torch.relu(self.features(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))
            pi = feats
            for layer in self.pi:
                pi = torch.relu(layer(pi))
            vf = feats
            for layer in self.vf:
                vf = torch.relu(layer(vf))
            logits, value = self.action_head(pi), self.value_head(vf)[..., 0]
        if train:
            return logits, value, new_stats
        return logits, value


# ---------------------------------------------------------------------------
# the opponent bank: BatchNorm folded, grouped convs
# ---------------------------------------------------------------------------


def fold_bn(params: Mapping[str, torch.Tensor]) -> dict:
    """Inference-mode BatchNorm folded into the conv weights and biases.

    ``params`` is a ``CnnPolicy`` state dict, or one with a leading P axis
    on every tensor (folding is elementwise over members).  Returns
    ``{layer: (weight (..., Cout, Cin, 3, 3), bias (..., Cout))}``: with
    ``inv = scale / sqrt(var + eps)``, ``weight * inv`` and
    ``(bias - mean) * inv + bn_bias``.  A zero member (``scale`` and ``var``
    0) folds to zero weights and biases."""
    out = {}
    for name in CONV_LAYERS:
        inv = params[f"{name}.bn.scale"] / torch.sqrt(params[f"{name}.bn.var"] + BN_EPS)
        weight = params[f"{name}.conv.weight"] * inv[..., None, None, None]
        bias = (params[f"{name}.conv.bias"] - params[f"{name}.bn.mean"]) * inv
        out[name] = (weight, bias + params[f"{name}.bn.bias"])
    return out


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def conv_relu(x, weight, bias, groups: int, bf16: bool = False):
    """One folded 3x3 SAME conv layer of the bank, then bias and ReLU:
    ``x`` (Bp, G*Cin, N, N), ``weight`` (G*Cout, Cin, 3, 3), ``bias``
    (G*Cout,), ``groups`` G.

    ``bf16`` follows the JAX package's bank: the weights (and the input,
    already bf16 values: the board's {-1, 0, 1} or the layer before's
    rounded output) are bf16, the products of two bf16 values are exact in
    float32 and are summed in float32, the bias is added in float32 after
    the sum, and the output is rounded to bf16 after the ReLU.  (A bf16
    ``conv2d`` would round its sum before the bias.)"""
    if bf16:
        weight = _round_bf16(weight)
    y = torch.relu(F.conv2d(x, weight, padding=1, groups=groups) + bias[:, None, None])
    return _round_bf16(y) if bf16 else y


def _boards(model: CnnPolicy, obs: torch.Tensor) -> torch.Tensor:
    n = model.board
    return obs.reshape(obs.shape[0], n, n).to(torch.float32)


def _flatten_groups(x: torch.Tensor, groups: int, n: int) -> torch.Tensor:
    """A grouped conv's output (Bp, G*C, n, n) as (G, Bp, n*n*C), each row
    flattened in the (H, W, C) order of ``features``."""
    Bp = x.shape[0]
    return x.reshape(Bp, groups, -1, n, n).permute(1, 0, 3, 4, 2).reshape(groups, Bp, -1)


def _stacked_dense(params, name: str, h: torch.Tensor) -> torch.Tensor:
    """(P, Bp, K) through each member's ``name`` layer: (P, Bp, M)."""
    return torch.baddbmm(params[f"{name}.bias"][:, None, :], h,
                         params[f"{name}.weight"].transpose(1, 2))


def bank_logits(model: CnnPolicy, stacked, obs: torch.Tensor, paired: bool = False,
                bf16: bool = False) -> torch.Tensor:
    """All bank members' action logits in one grouped-conv forward.

    - ``paired=False``: ``obs`` (B, N, N) or (B, N*N) is shared by every
      member -> (P, B, A), the rollout's dense bank pass;
    - ``paired=True``: ``obs`` holds P boards, member i sees board i ->
      (P, A), the evaluator's pass.

    ``stacked`` is a state dict with a leading P axis on every tensor.  Each
    conv layer runs for all members as one conv with ``groups=P`` (channels
    laid out (P, C)); the dense tower runs as P-batched products.  ``bf16``
    rounds the conv stack as ``conv_relu`` says."""
    folded = fold_bn(stacked)
    P = folded[CONV_LAYERS[0]][0].shape[0]
    n = model.board
    boards = _boards(model, obs)
    x = boards.reshape(1, P, n, n) if paired else boards[:, None].expand(-1, P, n, n)
    with full_float32():
        for name in CONV_LAYERS:
            w, b = folded[name]  # (P, Cout, Cin, 3, 3), (P, Cout)
            x = conv_relu(x, w.reshape((-1,) + w.shape[2:]), b.reshape(-1), P, bf16)
        h = torch.relu(_stacked_dense(stacked, "features", _flatten_groups(x, P, n)))
        for i in range(len(model.pi_layers)):
            h = torch.relu(_stacked_dense(stacked, f"pi.{i}", h))
        logits = _stacked_dense(stacked, "action_head", h)  # (P, Bp, A)
    return logits[:, 0] if paired else logits


def gathered_filters(folded, folded_best, use_best, opp_idx) -> list:
    """Each game's own member's folded conv stack, the best's where
    ``use_best``: per layer ``(weight (B*Cout, Cin, 3, 3), bias (B*Cout,))``,
    game b's filters contiguous, as ``conv_relu`` with ``groups=B`` takes
    them.  ``folded`` and ``folded_best`` are ``fold_bn``'s of the stacked
    members and of the best."""
    idx = opp_idx.long()
    out = []
    for name in CONV_LAYERS:
        w_st, b_st = folded[name]
        w_bb, b_bb = folded_best[name]
        w = torch.where(use_best[:, None, None, None, None], w_bb[None], w_st[idx])
        b = torch.where(use_best[:, None], b_bb[None], b_st[idx])
        out.append((w.reshape((-1,) + w.shape[2:]), b.reshape(-1)))
    return out


def gathered_conv_stack(model: CnnPolicy, filters, obs, bf16: bool = False) -> torch.Tensor:
    """Each game's ``gathered_filters`` on its board: the features' input,
    (B, N*N*C) in (H, W, C) order.  Each layer is one conv with
    ``groups=B``, every game a group with its own filters."""
    n = model.board
    B = obs.shape[0]
    x = _boards(model, obs).reshape(1, B, n, n)
    with full_float32():
        for w, b in filters:
            x = conv_relu(x, w, b, B, bf16)
    return _flatten_groups(x, B, n)[:, 0]


def gathered_bank_logits(model: CnnPolicy, stacked, best, use_best, opp_idx, obs,
                         bf16: bool = False) -> torch.Tensor:
    """Each game's assigned opponent's logits, (B, A), computing only that
    opponent's conv stack.

    1. BatchNorm is folded and each game's member's conv stack gathered (the
       best's where ``use_best``): ``gathered_filters``, run by
       ``gathered_conv_stack``;
    2. the dense tower stays weight-dense: every member's tower runs on
       every game's features as P-batched products, then each game takes its
       member's row; ``use_best`` rows take the best's tower.  The tower is
       ~5% of the conv stack's operations, and gathering its (N*N*C, 128)
       weights per game would move more bytes than it saves.

    The selected rows equal ``bank_logits``' selection up to float32 sums in
    another order."""
    filters = gathered_filters(fold_bn(stacked), fold_bn(best), use_best, opp_idx)
    feats = gathered_conv_stack(model, filters, obs, bf16)
    B = feats.shape[0]
    with full_float32():
        h = torch.relu(torch.matmul(feats, stacked["features.weight"].transpose(1, 2))
                       + stacked["features.bias"][:, None, :])  # (P, B, M)
        for i in range(len(model.pi_layers)):
            h = torch.relu(_stacked_dense(stacked, f"pi.{i}", h))
        logits_all = _stacked_dense(stacked, "action_head", h)  # (P, B, A)
        sel = logits_all[opp_idx.long(), torch.arange(B, device=feats.device)]
        hb = torch.relu(F.linear(feats, best["features.weight"], best["features.bias"]))
        for i in range(len(model.pi_layers)):
            hb = torch.relu(F.linear(hb, best[f"pi.{i}.weight"], best[f"pi.{i}.bias"]))
        best_logits = F.linear(hb, best["action_head.weight"], best["action_head.bias"])
    return torch.where(use_best[:, None], best_logits, sel)
