"""The work of KataGo's nested-bottleneck tower (the program's ``KataGo-NBT``
family) at a cell's shapes, counted as ``work.py`` counts the other
families: what the algorithm needs, 2 operations a multiply-add, each input
read once and each output written once.

- ``policy_flops``: one board through the policy path, the direct convs
  (the input conv, the blocks' 1x1 and 3x3 convs, the policy head's three
  1x1 convs) and the pooled blocks' and the policy head's dense layers;
  BatchNorm, the skips, the ReLUs and the pooling's reductions are
  elementwise or smaller and not counted (as the CNN's are not).  At 11x11,
  18 blocks, 384 / 192 / 64: 6.2727 GFLOP.
- ``param_count``: one agent's parameters, BatchNorm's statistics
  included.
- ``conv_least_s``: the least time of one call of the program's Winograd
  conv, averaged over the 3x3 convs of a forward (per block four, a pooled
  block's second ``mid - gpool`` -> ``mid``): the Winograd products the
  conv needs, 36 x the tiles x C_in x C_out x 2 (ceil(n / 4)^2 tiles a
  board; the rows by which the kernel pads their count to its 128-row
  product tile are part of the measured time, not of the bound), over 67
  TFLOP/s, or its bytes, x read, y written and the filter image read once,
  over 3.35 TB/s, whichever is larger.  Counting the Winograd products,
  not the direct conv's, keeps the share a share of the card's peak.
- ``preact_least_s``: the least time of one pre-activation epilogue launch,
  averaged over the launches of a forward: its bytes (``preact_bytes``)
  over 3.35 TB/s.

``model_of`` takes the tower's configurations alone.
"""

from __future__ import annotations

import dataclasses

from benchmark import work

FAMILY = "NBT"
POINTS = 36  # F(4x4, 3x3): 6 x 6 transformed points a tile


@dataclasses.dataclass(frozen=True)
class Nbt:
    """The shape of a nested-bottleneck tower: ``trunk`` wide, ``mid``
    inside the bottleneck, ``gpool`` channels pooled in every
    ``gpool_every``-th of ``blocks`` blocks; the heads ``p1``, ``g1``,
    ``v1`` and ``v2`` wide."""

    family: str
    board: int
    trunk: int
    mid: int
    gpool: int
    blocks: int
    gpool_every: int
    p1: int
    g1: int
    v1: int
    v2: int

    @property
    def cells(self) -> int:
        return self.board * self.board

    @property
    def pooled(self) -> int:
        """The blocks that pool."""
        return self.blocks // self.gpool_every


def model_of(config: dict):
    """The ``model`` block of a configuration file of the tower's family as
    an ``Nbt``; raises ``ValueError`` for another family's."""
    m = config["model"]
    if m["family"] != FAMILY:
        raise ValueError(f"family {m['family']!r} is not the nested-bottleneck tower's")
    return Nbt(family=FAMILY, board=m["board_size"], trunk=m["trunk"], mid=m["mid"],
               gpool=m["gpool"], blocks=m["blocks"], gpool_every=m["gpool_every"],
               p1=m["p1"], g1=m["g1"], v1=m["v1"], v2=m["v2"])


def convs3x3(m: Nbt) -> list:
    """``(C_in, C_out)`` of the 3x3 convs of one forward's blocks."""
    full, r = (m.mid, m.mid), m.mid - m.gpool
    return ([full] * 4 * (m.blocks - m.pooled)
            + [full, (r, m.mid), full, full] * m.pooled)


def policy_flops(m: Nbt) -> float:
    """One board through the policy path."""
    A, T, M, G = m.cells, m.trunk, m.mid, m.gpool
    convs = 2.0 * 9 * T * A + m.blocks * 2 * (2.0 * T * M * A)
    convs += sum(2.0 * 9 * cin * cout * A for cin, cout in convs3x3(m))
    dense = m.pooled * 2.0 * 3 * G * (M - G)
    head = 2.0 * T * (m.p1 + m.g1) * A + 2.0 * 3 * m.g1 * m.p1 + 2.0 * m.p1 * A
    return convs + dense + head


def param_count(m: Nbt) -> int:
    """Parameters of one agent: the convs (no bias), four BatchNorm vectors
    a BatchNorm, the dense layers (the pooled ones without a bias)."""
    T, M, G = m.trunk, m.mid, m.gpool
    convs = 9 * T + m.blocks * 2 * T * M + sum(9 * cin * cout for cin, cout in convs3x3(m))
    convs += T * (m.p1 + m.g1) + m.p1 + T * m.v1
    # a block's pre, inner and post BatchNorms (a pooled block's second
    # takes G fewer channels, its pooling's G more); the final; the heads'
    norms = m.blocks * (T + 5 * M) + T + m.g1 + m.p1 + m.v1
    dense = m.pooled * 3 * G * (M - G) + 3 * m.g1 * m.p1
    dense += 3 * m.v1 * m.v2 + m.v2 + m.v2 + 1
    return convs + 4 * norms + dense


def tiles(B: int, n: int) -> int:
    """The Winograd tiles of B boards: ceil(n / 4)^2 a board."""
    return B * ((n + 3) // 4) ** 2


def conv_least_s(m: Nbt, B: int) -> float:
    """The mean least time of one Winograd conv call over a forward's 3x3
    convs at B boards."""
    n, rows = m.board, tiles(B, m.board)
    times = [work.least_seconds(2.0 * POINTS * rows * cin * cout,
                                work.F32 * (B * (cin + cout) * n * n + POINTS * cin * cout))
             for cin, cout in convs3x3(m)]
    return sum(times) / len(times)


def preact_bytes(B: int, C: int, H: int, W: int, skip: bool = False,
                 board: bool = False) -> int:
    """The least bytes of one pre-activation epilogue launch over (B, C, H,
    W): y read and a written, with a skip the skip read and s written, with
    a board bias its (B, C) read, and BatchNorm's three vectors."""
    act = B * C * H * W
    return (act * (4 if skip else 2) + (B * C if board else 0) + 3 * C) * work.F32


def preacts(m: Nbt) -> list:
    """``(C, skip, board)`` of the pre-activation launches of one forward."""
    T, M, G = m.trunk, m.mid, m.gpool
    out = [(T, False, False)]
    for i in range(m.blocks):
        out.append((M, False, False))
        if (i + 1) % m.gpool_every == 0:
            out += [(G, False, False), (M - G, False, True)]
        else:
            out.append((M, False, False))
        out += [(M, True, False), (M, False, False), (M, True, False), (T, True, False)]
    return out


def preact_least_s(m: Nbt, B: int) -> float:
    """The mean least time of one pre-activation launch over a forward's at
    B boards."""
    n = m.board
    times = [work.least_seconds(0.0, preact_bytes(B, C, n, n, skip, board))
             for C, skip, board in preacts(m)]
    return sum(times) / len(times)


def match(m: Nbt, games: int) -> float:
    """Operations of one match of ``games`` games: games x cells forwards
    of the side to move."""
    return games * m.cells * policy_flops(m)
