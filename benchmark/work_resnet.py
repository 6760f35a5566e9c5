"""The work of the residual tower (the program's ``AZ-ResNet`` family) at a
cell's shapes, counted as ``work.py`` counts the other families: what the
algorithm needs, 2 operations a multiply-add, each input read once and
each output written once.

- ``policy_flops``: one board through the policy path, the input block, the
  residual blocks, the policy head's 1x1 conv and its dense layer;
  BatchNorm, the skips and the ReLUs are elementwise and not counted (as
  the CNN's are not).  At 11x11, 19 blocks of 256 filters: 5.4248 GFLOP.
- ``param_count``: one agent's parameters, BatchNorm's statistics
  included.
- ``residual_bytes``: the least bytes of one residual epilogue launch,
  the conv's output and the skip read and the output written, with
  BatchNorm's three vectors: ``(3 B C H W + 3 C) * 4``, 148.7 MB at 400
  11x11 boards of 256 channels (44.4 us at 3.35 TB/s).

``model_of`` and ``match`` take any configuration: the tower's here, the
others' by ``work.py``.
"""

from __future__ import annotations

import dataclasses

from benchmark import work

FAMILY = "ResNet"


@dataclasses.dataclass(frozen=True)
class ResNet:
    """The shape of a residual tower: ``filters`` wide, ``blocks`` residual
    blocks, the value head's hidden layer ``value_hidden`` wide."""

    family: str
    board: int
    filters: int
    blocks: int
    value_hidden: int

    @property
    def cells(self) -> int:
        return self.board * self.board


def model_of(config: dict):
    """The ``model`` block of a configuration file: a ``ResNet`` for the
    tower's family, else ``work.model_of``'s."""
    m = config["model"]
    if m["family"] != FAMILY:
        return work.model_of(config)
    return ResNet(family=FAMILY, board=m["board_size"], filters=m["filters"],
                  blocks=m["blocks"], value_hidden=m["value_hidden"])


def policy_flops(m: ResNet) -> float:
    """One board through the policy path."""
    A, F = m.cells, m.filters
    tower = 2.0 * 9 * 1 * F * A + m.blocks * 2 * (2.0 * 9 * F * F * A)
    return tower + 2.0 * F * 2 * A + 2.0 * (2 * A) * A


def param_count(m: ResNet) -> int:
    """Parameters of one agent: the convs (no bias), four BatchNorm vectors
    a conv, the dense layers with their biases."""
    A, F = m.cells, m.filters
    convs = [(1, F, 9)] + [(F, F, 9)] * (2 * m.blocks) + [(F, 2, 1), (F, 1, 1)]
    conv_p = sum(cin * cout * k + 4 * cout for cin, cout, k in convs)
    dense = [(2 * A, A), (A, m.value_hidden), (m.value_hidden, 1)]
    return conv_p + sum(n_in * n_out + n_out for n_in, n_out in dense)


def residual_bytes(B: int, C: int, H: int, W: int) -> int:
    """The least bytes of one residual epilogue launch over (B, C, H, W)."""
    return (3 * B * C * H * W + 3 * C) * work.F32


def match(m, games: int) -> float:
    """Operations of one match of ``games`` games: games x cells forwards
    of the side to move."""
    if m.family != FAMILY:
        return work.match(m, games)
    return games * m.cells * policy_flops(m)
