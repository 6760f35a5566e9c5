"""Hex on plain boards.

A board is an (..., n, n) tensor: 0 empty, -1 and +1 the two sides.  In the
mover's frame the mover is -1 and connects the top row to the bottom row;
the other side is +1 and connects the left column to the right column.
In the world frame seat 0 is -1 (rows) and seat 1 is +1 (columns); seat 1's
frame is the world board transposed with the colours swapped.  The six hex
neighbours of (y, x) are (y-1, x), (y-1, x+1), (y, x-1), (y, x+1),
(y+1, x-1) and (y+1, x): a set that transposing leaves as it is, so both
frames share one adjacency.
"""

from __future__ import annotations

import torch

OFFSETS = ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0))


def dilate(x: torch.Tensor) -> torch.Tensor:
    """Cells of (..., n, n) bool ``x`` or next to one of them."""
    n = x.shape[-1]
    p = torch.nn.functional.pad(x.to(torch.uint8), (1, 1, 1, 1)).bool()
    out = x.clone()
    for dy, dx in OFFSETS:
        out |= p[..., 1 + dy:1 + dy + n, 1 + dx:1 + dx + n]
    return out


def flood(stones: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The cells of ``stones`` connected to ``seed & stones`` (both (..., n, n)
    bool)."""
    reach = stones & seed
    while True:
        grown = stones & dilate(reach)
        if torch.equal(grown, reach):
            return reach
        reach = grown


def edge(n: int, axis: int, last: bool, device=None) -> torch.Tensor:
    """(n, n) bool: the first or last row (``axis`` 0) or column (1)."""
    e = torch.zeros((n, n), dtype=torch.bool, device=device)
    i = n - 1 if last else 0
    if axis == 0:
        e[i, :] = True
    else:
        e[:, i] = True
    return e


def connects(stones: torch.Tensor, axis: int) -> torch.Tensor:
    """(...,) bool: ``stones`` join the two edges across ``axis`` (0: the
    top and bottom rows, 1: the left and right columns)."""
    n = stones.shape[-1]
    reach = flood(stones, edge(n, axis, False, stones.device))
    return (reach & edge(n, axis, True, stones.device)).flatten(-2).any(-1)


def winning_cells(board: torch.Tensor, side: int) -> torch.Tensor:
    """(..., n, n) bool: the empty cells where a stone of ``side`` (-1 joins
    rows, +1 joins columns, in the frame of ``board``) completes its
    connection."""
    n = board.shape[-1]
    axis = 0 if side == -1 else 1
    own = board == side
    dev = board.device
    near_first = dilate(flood(own, edge(n, axis, False, dev))) | edge(n, axis, False, dev)
    near_last = dilate(flood(own, edge(n, axis, True, dev))) | edge(n, axis, True, dev)
    return (board == 0) & near_first & near_last


def mover_frame(world: torch.Tensor, seat: torch.Tensor) -> torch.Tensor:
    """World boards (B, n, n) seen by the side to move (``seat`` (B,))."""
    inverted = -world.transpose(-1, -2)
    return torch.where((seat == 0)[:, None, None], world, inverted)


def world_cell(action: torch.Tensor, seat: torch.Tensor, n: int) -> torch.Tensor:
    """The world-frame flat cell of mover-frame flat ``action`` (B,)."""
    y, x = action // n, action % n
    return torch.where(seat == 0, y * n + x, x * n + y)
