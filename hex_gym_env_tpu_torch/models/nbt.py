"""KataGo's nested-bottleneck residual tower with global pooling as a Hex
policy (family ``KataGo-NBT``).

The network KataGo names ``b18c384nbt`` (lightvector/KataGo,
``python/katago/train/modelconfigs.py``; ``model_pytorch.py``:
``NestedBottleneckResBlock``, ``ResBlock``, ``ConvAndGPool``, ``KataGPool``,
``PolicyHead``, ``ValueHead``; global pooling after Wu 2019, "Accelerating
Self-Play Learning in Go", arXiv:1902.10565), with Hex's planes.  With
A = N^2 cells and BNR(z) = relu(BatchNorm(z)):

- pre-activation throughout: the residual stream is never normalized, and
  every conv is BNR, then the conv (no bias);
- an input conv, 3x3, 1 -> ``trunk`` (384);
- ``blocks`` (18) nested bottleneck blocks: a 1x1 conv ``trunk`` -> ``mid``
  (192), two inner residual blocks of two 3x3 ``mid`` -> ``mid`` convs each
  (the inner skip), a 1x1 conv ``mid`` -> ``trunk``, then the block's input
  added (the outer skip);
- in every ``gpool_every``-th block (3rd, 6th, ...) the first inner block's
  first conv gives ``mid - gpool`` channels r and ``gpool`` (64) channels g
  (one conv, ``mid`` outputs); g is pooled over the board, BNR then the
  mean, the mean x (sqrt(A) - 14) / 10 and the max of each channel, and a
  dense layer (no bias) maps those 3 ``gpool`` features to a bias of each
  board and r channel, added to r before the second conv's BNR; that conv
  takes ``mid - gpool`` channels;
- the trunk's final BNR, then the policy head: a 1x1 conv to ``p1`` (48)
  channels p, a 1x1 conv to ``g1`` (48) channels q, BNR, pooled as above,
  a dense layer (no bias) to a bias of each board and p channel, then BNR
  and a 1x1 conv to one logit a cell (Hex has no pass); and the value head:
  a 1x1 conv to ``v1`` (96), BNR, the mean, the mean x (sqrt(A) - 14) / 10
  and the mean x ((sqrt(A) - 14)^2 / 100 - 0.1) of each channel, a dense
  layer to ``v2`` (128), ReLU, a dense layer to one value, tanh.

The input is the port's one mover-frame plane (the CNN's and AZ-ResNet's);
the policy and value heads give one logit a cell and one tanh value, in
place of KataGo's pass, auxiliary and score outputs.  BatchNorm is
``models/cnn.BatchNorm`` (flax's rule, eps 1e-5): ``forward(obs,
train=True)`` normalises with the batch's statistics and returns the new
running statistics by state-dict key, as ``ResNetPolicy`` does.  Weights
are orthogonal (SB3's gains: sqrt(2) for the convs, the pooled blocks'
dense layers and the value head's hidden layer, 0.01 for the policy's last
conv, 1 for the value's last layer), biases zero; with ``init`` off the
module is built bare (zero, no draw), the loader's template.

Convolutions run in full float32 (``cnn.full_float32``).  ``bind`` takes
the state dict as the module's own (``models/mlp.assign``, no copy), then,
for each 3x3 conv that ``ops/winograd.takes`` (C_in and C_out multiples of
64, the weight float32 on a CUDA device: every conv of the blocks, the
pooled one as one ``mid`` -> ``mid`` image, not the input conv), builds
its filter image once (``winograd.FilterImage``), and for each 1x1 conv of
the blocks that ``ops/pointwise.takes`` (the same widths rule: the 36 of
384 -> 192 and 192 -> 384) its transpose (``pointwise.image_of``), kept on
the layer as ``image``; and it keeps each BatchNorm's factor rsqrt(var +
eps) x scale once (``Factor``, in ``factors``), which the forward would
otherwise compute again on every call, three small launches a BatchNorm.
At inference on the card (float32 on a CUDA device, grad off;
``CnnPolicy._fuses``) each 3x3 conv with a current image is
``winograd.conv``, each 1x1 conv with one ``pointwise.conv``, and the input
conv cuDNN's ``F.conv2d``; the heads' 1x1 convs (48, 96 and 1 outputs)
stay on the eager chain, as the heads do.  Each BNR is one launch of
``ops/cnn_epilogue.preact`` (on the kept factor where it is current),
which also adds the skip where one closes (writing the stream ``s = y +
skip`` over the conv's output and the next conv's input ``a =
relu(bn(s))`` into a new buffer) and the pooled bias where one is added,
bit for bit the eager chain.  So the BatchNorm applied
after a conv is the next conv's: the epilogue after the 1x1 conv that
closes block i is block i + 1's first BNR (the trunk's final one after
the last block).  The pooling itself (three reductions over the board and
a dense layer) and the heads stay on eager torch ops.  With grad on, in
training, on the CPU and in float64 every layer runs the eager chain, each
conv ``F.conv2d``.

Spans (``utils/profiling``, each with the device clock): ``forward.conv``
around each conv of the trunk (1 + 6 x blocks: 109 a forward at 18
blocks), ``forward.norm`` around each BNR of the trunk (1 + 6 a block,
7 a pooled block: 115), ``forward.gpool`` around each pooling of the
trunk and its dense layer (blocks / gpool_every: 6), ``forward.heads``
around both heads (1).  Counters: ``nbt_blocks`` (one a block a forward)
and ``gpool_layers`` (one a pooling of the trunk a forward), whichever path
runs; not ``residual_blocks``, which stays AZ-ResNet's.  The trainer has no
opponent-bank path for this family (``train/selfplay.py`` refuses it).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from hex_gym_env_tpu_torch.models.cnn import BareConv2d, BatchNorm, CnnPolicy, full_float32
from hex_gym_env_tpu_torch.models.mlp import (
    ORTHO_ACTION_GAIN,
    ORTHO_HIDDEN_GAIN,
    ORTHO_VALUE_GAIN,
    BareLinear,
    assign,
)
from hex_gym_env_tpu_torch.ops import cnn_epilogue, pointwise, winograd
from hex_gym_env_tpu_torch.utils import profiling


def _linear(n_in: int, n_out: int, gain: float, generator, init: bool, bias: bool) -> nn.Linear:
    """A linear layer, orthogonal with ``gain`` and a zero bias where it has
    one; with ``init`` off a ``BareLinear``."""
    if not init:
        return BareLinear(n_in, n_out, bias=bias)
    layer = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


def _conv(cin: int, cout: int, kernel: int, gain: float, generator, init: bool) -> nn.Conv2d:
    """A square conv without a bias, SAME padding, orthogonal with ``gain``;
    with ``init`` off a ``BareConv2d``."""
    conv = (nn.Conv2d if init else BareConv2d)(cin, cout, kernel, padding=kernel // 2, bias=False)
    if init:
        with torch.no_grad():
            nn.init.orthogonal_(conv.weight, gain=gain, generator=generator)
    return conv


class Factor(NamedTuple):
    """A BatchNorm's factor ``mul`` (``BatchNorm.mul``) and the scale and
    variance, each at its version, that it was computed from."""

    scale: torch.Tensor
    scale_version: int
    var: torch.Tensor
    var_version: int
    mul: torch.Tensor

    @classmethod
    def of(cls, bn: BatchNorm) -> "Factor":
        with torch.no_grad():
            return cls(bn.scale, bn.scale._version, bn.var, bn.var._version, bn.mul(bn.var))

    def current(self, bn: BatchNorm) -> bool:
        """``bn``'s scale and variance are still the tensors, at the
        versions, the factor was computed from (``winograd.FilterImage``'s
        rule)."""
        return (bn.scale is self.scale and bn.scale._version == self.scale_version
                and bn.var is self.var and bn.var._version == self.var_version)


class PreConv(nn.Module):
    """``bn`` over the input's channels (its ReLU after), then ``conv``;
    ``image``, the conv's Winograd filter image (3x3) or transpose (1x1)
    where ``bind`` built one."""

    def __init__(self, cin: int, cout: int, kernel: int, generator, init: bool = True,
                 gain: float = ORTHO_HIDDEN_GAIN):
        super().__init__()
        self.bn = BatchNorm(cin)
        self.conv = _conv(cin, cout, kernel, gain, generator, init)
        self.image: winograd.FilterImage | None = None


class GPool(nn.Module):
    """A global pooling: ``bn`` of the pooled channels (its ReLU after), the
    three features of each over the board, and ``fc`` (no bias) from them to
    ``out`` values a board."""

    def __init__(self, channels: int, out: int, generator, init: bool = True):
        super().__init__()
        self.bn = BatchNorm(channels)
        self.fc = _linear(3 * channels, out, ORTHO_HIDDEN_GAIN, generator, init, bias=False)


def pool_features(a: torch.Tensor, third: str = "max") -> torch.Tensor:
    """(B, 3 C) of activations ``a`` (B, C, N, N): the mean of each channel
    over the board, the mean x (sqrt(A) - 14) / 10, and the max (``third``
    "max", the trunk's and the policy's) or the mean x ((sqrt(A) - 14)^2 /
    100 - 0.1) (``third`` "moment", the value head's)."""
    off = math.sqrt(a.shape[2] * a.shape[3]) - 14.0
    mean = a.mean(dim=(2, 3))
    last = a.amax(dim=(2, 3)) if third == "max" else mean * (off * off / 100.0 - 0.1)
    return torch.cat((mean, mean * (off / 10.0), last), dim=1)


class InnerBlock(nn.Module):
    """Two 3x3 ``PreConv`` layers, ``a`` and ``b``, and the skip around them;
    with ``gpool`` channels, ``a`` gives ``mid`` channels, the last
    ``gpool`` of them pooled by ``g`` into a bias of each board and channel
    of the others, which ``b`` takes."""

    def __init__(self, mid: int, gpool: int, generator, init: bool = True):
        super().__init__()
        self.a = PreConv(mid, mid, 3, generator, init)
        self.b = PreConv(mid - gpool, mid, 3, generator, init)
        self.g = GPool(gpool, mid - gpool, generator, init) if gpool else None


class NbtBlock(nn.Module):
    """A nested bottleneck block: ``pre`` (1x1, trunk -> mid), two
    ``InnerBlock``\\ s, ``post`` (1x1, mid -> trunk), and the outer skip."""

    def __init__(self, trunk: int, mid: int, gpool: int, generator, init: bool = True):
        super().__init__()
        self.pre = PreConv(trunk, mid, 1, generator, init)
        self.inner = nn.ModuleList([InnerBlock(mid, gpool, generator, init),
                                    InnerBlock(mid, 0, generator, init)])
        self.post = PreConv(mid, trunk, 1, generator, init)


class Norm(nn.Module):
    """A ``bn`` alone: the trunk's final BatchNorm, the value head's."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm(channels)


class NbtPolicy(nn.Module):
    """The nested-bottleneck tower and its two heads.

    Call with observations of shape (B, N, N) or (B, N*N) (row-major), any
    dtype: ``forward(obs)`` returns ``(logits (B, N*N), value (B,))``;
    ``forward(obs, train=True)`` returns ``(logits, value, new_stats)``, the
    running statistics of every BatchNorm by state-dict key."""

    def __init__(
        self,
        n_actions: int,
        trunk: int = 384,
        mid: int = 192,
        gpool: int = 64,
        blocks: int = 18,
        gpool_every: int = 3,
        p1: int = 48,
        g1: int = 48,
        v1: int = 96,
        v2: int = 128,
        generator: torch.Generator | None = None,
        init: bool = True,
    ):
        super().__init__()
        self.n_actions = n_actions
        self.board = math.isqrt(n_actions)
        if self.board * self.board != n_actions:
            raise ValueError(f"n_actions {n_actions} is not the cell count of a square board")
        if not 0 < gpool < mid:
            raise ValueError(f"gpool {gpool} must lie between 0 and mid {mid}")
        self.trunk, self.mid, self.gpool, self.gpool_every = trunk, mid, gpool, gpool_every
        self.conv_in = _conv(1, trunk, 3, ORTHO_HIDDEN_GAIN, generator, init)
        self.blocks = nn.ModuleList(
            NbtBlock(trunk, mid, gpool if self.pooled(i) else 0, generator, init)
            for i in range(blocks))
        self.final = Norm(trunk)
        self.policy_p = _conv(trunk, p1, 1, ORTHO_HIDDEN_GAIN, generator, init)
        self.policy_g = _conv(trunk, g1, 1, ORTHO_HIDDEN_GAIN, generator, init)
        self.policy_pool = GPool(g1, p1, generator, init)
        self.policy_out = PreConv(p1, 1, 1, generator, init, gain=ORTHO_ACTION_GAIN)
        self.value_conv = _conv(trunk, v1, 1, ORTHO_HIDDEN_GAIN, generator, init)
        self.value_norm = Norm(v1)
        self.value_fc = _linear(3 * v1, v2, ORTHO_HIDDEN_GAIN, generator, init, bias=True)
        self.value_head = _linear(v2, 1, ORTHO_VALUE_GAIN, generator, init, bias=True)
        self.factors: dict[str, Factor] = {}  # by BatchNorm, kept by ``bind``
        if init:
            profiling.count("policy_inits")

    def pooled(self, i: int) -> bool:
        """Whether block ``i`` (from 0) pools: every ``gpool_every``-th."""
        return (i + 1) % self.gpool_every == 0

    # the epilogue kernel's rule, the CNN's: inference, float32 on the card, grad off
    _fuses = CnnPolicy._fuses

    def forward(self, obs: torch.Tensor, train: bool = False):
        n = self.board
        # float32 weights take float32 boards (float64 ones, a reference, float64)
        x = obs.reshape(obs.shape[0], 1, n, n).to(self.value_head.weight.dtype)
        fused = self._fuses(x, train)
        new_stats: dict = {}

        def conv(a, weight, image=None):
            with profiling.span("forward.conv", device=a.device):
                if fused and image is not None and image.current(weight):
                    return (winograd if weight.shape[-1] == 3 else pointwise).conv(a, image.u)
                return F.conv2d(a, weight, None, padding=weight.shape[-1] // 2)

        def norm(name, layer, y, skip=None, board_bias=None):
            return self._norm(name, layer.bn, y, skip, board_bias, fused, train, new_stats)

        def pre(layer: PreConv, a):
            return conv(a, layer.conv.weight, layer.image)

        r = self.mid - self.gpool
        with full_float32():
            x, a = norm("blocks.0.pre", self.blocks[0].pre, conv(x, self.conv_in.weight))
            for i, block in enumerate(self.blocks):
                profiling.count("nbt_blocks")
                name = f"blocks.{i}"
                # the layer whose BatchNorm follows each conv that closes an inner skip
                after = [(f"{name}.inner.1.a", block.inner[1].a), (f"{name}.post", block.post)]
                h, a = norm(f"{name}.inner.0.a", block.inner[0].a, pre(block.pre, a))
                for j, inner in enumerate(block.inner):
                    y = pre(inner.a, a)
                    if inner.g is None:
                        _, a = norm(f"{name}.inner.{j}.b", inner.b, y)
                    else:
                        _, ag = norm(f"{name}.inner.{j}.g", inner.g, y[:, r:])
                        profiling.count("gpool_layers")
                        with profiling.span("forward.gpool", device=y.device):
                            bias = inner.g.fc(pool_features(ag))
                        _, a = norm(f"{name}.inner.{j}.b", inner.b, y[:, :r], board_bias=bias)
                    h, a = norm(*after[j], pre(inner.b, a), skip=h)
                nxt = (("final", self.final) if i + 1 == len(self.blocks)
                       else (f"blocks.{i + 1}.pre", self.blocks[i + 1].pre))
                x, a = norm(*nxt, pre(block.post, a), skip=x)
            with profiling.span("forward.heads", device=a.device):
                logits = self._policy(a, train, new_stats)
                value = self._value(a, train, new_stats)
        if train:
            return logits, value, new_stats
        return logits, value

    def _norm(self, name: str, bn: BatchNorm, y, skip, board_bias, fused: bool, train: bool,
              new_stats: dict):
        """``(s, a)``: the stream ``s = y + skip`` (``y`` without a skip) and
        ``a``, BNR of ``s`` plus the board bias by ``bn``, its statistics
        recorded under ``name`` in training; one epilogue launch where
        ``fused`` (on the factor ``bind`` kept, where it is current), else
        the eager chain."""
        with profiling.span("forward.norm", device=y.device):
            if fused:
                kept = self.factors.get(name)
                mul = kept.mul if kept is not None and kept.current(bn) else bn.mul(bn.var)
                return cnn_epilogue.preact(y, skip, bn.mean, mul, bn.bias, board_bias)
            s = y if skip is None else y + skip
            t = s if board_bias is None else s + board_bias[:, :, None, None]
            return s, self._bnr(name, bn, t, train, new_stats)

    @staticmethod
    def _bnr(name: str, bn: BatchNorm, t, train: bool, new_stats: dict) -> torch.Tensor:
        """BNR on the eager chain, recording the new statistics under
        ``train``."""
        out, mean, var = bn(t, train)
        if train:
            new_stats[f"{name}.bn.mean"] = mean
            new_stats[f"{name}.bn.var"] = var
        return torch.relu(out)

    def _policy(self, z, train: bool, new_stats: dict) -> torch.Tensor:
        """The policy head on the trunk's output ``z``, eager: (B, N*N)."""
        p = F.conv2d(z, self.policy_p.weight)
        q = self._bnr("policy_pool", self.policy_pool.bn, F.conv2d(z, self.policy_g.weight),
                      train, new_stats)
        p = p + self.policy_pool.fc(pool_features(q))[:, :, None, None]
        p = self._bnr("policy_out", self.policy_out.bn, p, train, new_stats)
        return F.conv2d(p, self.policy_out.conv.weight).reshape(z.shape[0], -1)

    def _value(self, z, train: bool, new_stats: dict) -> torch.Tensor:
        """The value head on the trunk's output ``z``, eager: (B,)."""
        v = self._bnr("value_norm", self.value_norm.bn, F.conv2d(z, self.value_conv.weight),
                      train, new_stats)
        v = torch.relu(self.value_fc(pool_features(v, "moment")))
        return torch.tanh(self.value_head(v))[..., 0]

    def convs3x3(self) -> list:
        """Every 3x3 ``PreConv`` of the blocks, in the forward's order."""
        return [layer for block in self.blocks for inner in block.inner
                for layer in (inner.a, inner.b)]

    def convs1x1(self) -> list:
        """Every 1x1 ``PreConv`` of the blocks, in the forward's order."""
        return [layer for block in self.blocks for layer in (block.pre, block.post)]

    def bind(self, params: Mapping[str, torch.Tensor]) -> None:
        """Take ``params`` (a state dict, BatchNorm's statistics included)
        as the module's own with no copy (``models/mlp.assign``), then give
        each 3x3 conv that ``winograd.takes`` its filter image and each 1x1
        conv of the blocks that ``pointwise.takes`` its transpose, and every
        other none, and keep each BatchNorm's factor in ``factors``, by the
        name of the layer that holds it."""
        assign(self, params)
        self.factors = {name.removesuffix(".bn"): Factor.of(mod)
                        for name, mod in self.named_modules() if isinstance(mod, BatchNorm)}
        for layer in self.convs3x3():
            weight = layer.conv.weight
            layer.image = (winograd.FilterImage.of(weight) if winograd.takes(weight, self.board)
                           else None)
        for layer in self.convs1x1():
            weight = layer.conv.weight
            layer.image = pointwise.image_of(weight) if pointwise.takes(weight) else None
