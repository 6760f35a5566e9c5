"""The AlphaZero residual tower as a Hex policy (family ``AZ-ResNet``).

The network of AlphaGo Zero (Silver et al. 2017, Nature 550:354, Methods,
"Neural network architecture"), which AlphaZero kept (Silver et al. 2018,
Science 362:1140, supplement), with Hex's planes:

- an input block: a 3x3 conv of ``filters`` (256), BatchNorm, ReLU;
- ``blocks`` (19) residual blocks: 3x3 conv, BatchNorm, ReLU, 3x3 conv,
  BatchNorm, the block's input added, ReLU;
- a policy head: a 1x1 conv of 2 filters, BatchNorm, ReLU, a dense layer to
  one logit per cell (Hex has no pass);
- a value head: a 1x1 conv of 1 filter, BatchNorm, ReLU, a dense layer of
  ``value_hidden`` (256), ReLU, a dense layer to one value, tanh.

The input is the port's one mover-frame plane (the CNN's), not the paper's
stack of history and colour planes.  The convs have no bias, as published
(BatchNorm follows each); the heads' convs are flattened in (C, H, W)
order.  BatchNorm is ``models/cnn.BatchNorm`` (flax's rule, eps 1e-5):
``forward(obs, train=True)`` normalises with the batch's statistics and
returns the new running statistics by state-dict key, as ``CnnPolicy``
does.  Weights are orthogonal with SB3's gains (sqrt(2) for the convs and
the value head's hidden layer, 0.01 for the action head, 1 for the value
head), biases zero; with ``init`` off the module is built bare (zero, no
draw), the loader's template.

Convolutions run in full float32 (``cnn.full_float32``).  ``bind`` takes
the state dict as the module's own (``models/mlp.assign``), then, for each
3x3 conv that ``ops/winograd.takes`` (C_in and C_out multiples of 64, the
weight float32 on a CUDA device: the tower's convs, not the input conv),
builds its filter image once (``winograd.FilterImage``: the Winograd
F(4x4, 3x3) transform of the bound weight, in float64, rounded once), kept
on the layer as ``image``.  At inference on the card (float32 on a CUDA
device, grad off; ``CnnPolicy``'s rule) each 3x3 conv with a current image
is ``winograd.conv`` (hand-written float32 FFMA kernels, counted as
``launch.winograd_conv``), another (the input conv) cuDNN's conv; then one
launch of ``ops/cnn_epilogue``'s kernel
for BatchNorm and the ReLU, in place; a block's second layer launches with
the block's input as the skip operand (``cnn_epilogue.residual``, counted
as ``launch.cnn_epilogue_residual``), bit for bit ``BatchNorm.forward``,
``+ x`` and ``torch.relu``.  The heads stay on the eager chain by rule: their
convs give 2 and 1 channels, boards of C H W floats that the kernel does not
take at odd board sizes, and at 400 11x11 boards a head's activation is
under 0.4 MB, against 49.6 MB for a tower layer's.  With grad on, in
training, on the CPU and in float64 every layer runs the eager chain, each
conv ``F.conv2d``.

Spans (``utils/profiling``, each with the device clock): ``forward.conv``
around each 3x3 conv (39 a forward at 19 blocks), ``forward.norm`` around
each 3x3 layer's BatchNorm, skip and ReLU (39), ``forward.heads`` around
both heads (1).  Counter ``residual_blocks``: one a block a forward,
whichever path runs.  The trainer has no opponent-bank path for this
family (``train/selfplay.py`` refuses it).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from hex_gym_env_tpu_torch.models.cnn import BareConv2d, BatchNorm, CnnPolicy, full_float32
from hex_gym_env_tpu_torch.models.mlp import (
    ORTHO_ACTION_GAIN,
    ORTHO_HIDDEN_GAIN,
    ORTHO_VALUE_GAIN,
    _dense,
    assign,
)
from hex_gym_env_tpu_torch.ops import cnn_epilogue, winograd
from hex_gym_env_tpu_torch.utils import profiling


class ConvBn(nn.Module):
    """A square conv without a bias, orthogonal with gain sqrt(2) (with
    ``init`` off a ``BareConv2d``), SAME padding, and its ``BatchNorm``;
    ``image``, the conv's Winograd filter image where ``bind`` built one."""

    def __init__(self, cin: int, cout: int, kernel: int, generator, init: bool = True):
        super().__init__()
        conv = nn.Conv2d if init else BareConv2d
        self.conv = conv(cin, cout, kernel, padding=kernel // 2, bias=False)
        if init:
            with torch.no_grad():
                nn.init.orthogonal_(self.conv.weight, gain=ORTHO_HIDDEN_GAIN, generator=generator)
        self.bn = BatchNorm(cout)
        self.image: winograd.FilterImage | None = None


class ResidualBlock(nn.Module):
    """Two 3x3 ``ConvBn`` layers, ``a`` and ``b``; the block's input is added
    after ``b``'s BatchNorm."""

    def __init__(self, filters: int, generator, init: bool = True):
        super().__init__()
        self.a = ConvBn(filters, filters, 3, generator, init)
        self.b = ConvBn(filters, filters, 3, generator, init)


class ResNetPolicy(nn.Module):
    """The residual tower and its two heads.

    Call with observations of shape (B, N, N) or (B, N*N) (row-major), any
    dtype: ``forward(obs)`` returns ``(logits (B, N*N), value (B,))``;
    ``forward(obs, train=True)`` returns ``(logits, value, new_stats)``, the
    running statistics of every BatchNorm by state-dict key."""

    def __init__(
        self,
        n_actions: int,
        filters: int = 256,
        blocks: int = 19,
        value_hidden: int = 256,
        generator: torch.Generator | None = None,
        init: bool = True,
    ):
        super().__init__()
        self.n_actions = n_actions
        self.board = math.isqrt(n_actions)
        if self.board * self.board != n_actions:
            raise ValueError(f"n_actions {n_actions} is not the cell count of a square board")
        self.filters = filters
        self.value_hidden = value_hidden
        self.conv_in = ConvBn(1, filters, 3, generator, init)
        self.blocks = nn.ModuleList(ResidualBlock(filters, generator, init) for _ in range(blocks))
        self.policy = ConvBn(filters, 2, 1, generator, init)
        self.action_head = _dense(2 * n_actions, n_actions, ORTHO_ACTION_GAIN, generator, init)
        self.value = ConvBn(filters, 1, 1, generator, init)
        self.value_fc = _dense(n_actions, value_hidden, ORTHO_HIDDEN_GAIN, generator, init)
        self.value_head = _dense(value_hidden, 1, ORTHO_VALUE_GAIN, generator, init)
        if init:
            profiling.count("policy_inits")

    # the epilogue kernel's rule, the CNN's: inference, float32 on the card, grad off
    _fuses = CnnPolicy._fuses

    def forward(self, obs: torch.Tensor, train: bool = False):
        n = self.board
        # float32 weights take float32 boards (float64 ones, a reference, float64)
        x = obs.reshape(obs.shape[0], 1, n, n).to(self.action_head.weight.dtype)
        fused = self._fuses(x, train)
        new_stats = {}
        with full_float32():
            x = self._layer("conv_in", self.conv_in, x, fused, train, new_stats)
            for i, block in enumerate(self.blocks):
                profiling.count("residual_blocks")
                h = self._layer(f"blocks.{i}.a", block.a, x, fused, train, new_stats)
                x = self._layer(f"blocks.{i}.b", block.b, h, fused, train, new_stats, skip=x)
            with profiling.span("forward.heads", device=x.device):
                p = self._head("policy", self.policy, x, train, new_stats)
                logits = self.action_head(p)
                v = self._head("value", self.value, x, train, new_stats)
                value = torch.tanh(self.value_head(torch.relu(self.value_fc(v))))[..., 0]
        if train:
            return logits, value, new_stats
        return logits, value

    @staticmethod
    def _layer(name: str, layer: ConvBn, x, fused: bool, train: bool, new_stats: dict,
               skip=None):
        """A 3x3 layer: the conv (the Winograd kernels where ``fused`` and the
        layer holds a current image, else ``F.conv2d``), then BatchNorm, the
        ``skip`` where given, and the ReLU: one epilogue launch where
        ``fused``, else the eager chain (which records the new statistics
        under ``train``)."""
        device = x.device
        with profiling.span("forward.conv", device=device):
            image = layer.image if fused else None
            if image is not None and image.current(layer.conv.weight):
                y = winograd.conv(x, image.u)
            else:
                y = F.conv2d(x, layer.conv.weight, None, padding=1)
        with profiling.span("forward.norm", device=device):
            bn = layer.bn
            if fused:
                if skip is None:
                    return cnn_epilogue.epilogue(y, None, bn.mean, bn.mul(bn.var), bn.bias)
                return cnn_epilogue.residual(y, bn.mean, bn.mul(bn.var), bn.bias, skip)
            y, mean, var = bn(y, train)
            if skip is not None:
                y = y + skip
            if train:
                new_stats[f"{name}.bn.mean"] = mean
                new_stats[f"{name}.bn.var"] = var
            return torch.relu(y)

    @staticmethod
    def _head(name: str, layer: ConvBn, x, train: bool, new_stats: dict) -> torch.Tensor:
        """A head's 1x1 conv, BatchNorm and ReLU on the eager chain, flattened
        in (C, H, W) order."""
        y, mean, var = layer.bn(layer.conv(x), train)
        if train:
            new_stats[f"{name}.bn.mean"] = mean
            new_stats[f"{name}.bn.var"] = var
        return torch.relu(y).reshape(y.shape[0], -1)

    def convs3x3(self) -> list:
        """Every 3x3 ``ConvBn``, the input conv's and the blocks', in the
        forward's order."""
        return [self.conv_in] + [h for block in self.blocks for h in (block.a, block.b)]

    def bind(self, params: Mapping[str, torch.Tensor]) -> None:
        """Take ``params`` (a state dict, BatchNorm's statistics included)
        as the module's own with no copy (``models/mlp.assign``), then give
        each 3x3 conv that ``winograd.takes`` its filter image, and every
        other none."""
        assign(self, params)
        for layer in self.convs3x3():
            weight = layer.conv.weight
            layer.image = (winograd.FilterImage.of(weight) if winograd.takes(weight, self.board)
                           else None)
