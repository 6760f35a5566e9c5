"""Batched random mid-game start positions (the reference's ``sample_board``).

The counterpart of the JAX package's ``core/random_board.py``, with its
distribution, that of ``HexEnv.random_board`` (``minihex/HexSingleGame.py:
300-331``): a random m x l submatrix (m, l ~ U{n//4, ..., n-2}) at a
uniform offset, filled with an even number of stones, between ~50% and 100%
of the submatrix rounded down to even, half -1 and half +1 in uniformly
shuffled cells; the rest stays empty.  An even stone count keeps seat 0
("black") to move.

Stream deviation: the draws come from a ``torch.Generator``, which cannot
reproduce JAX's threefry keys, so the boards are the JAX sampler's
distribution and not its samples — as the JAX module's are the reference's
distribution and not its (never seeded) numpy samples.
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.core.topology import HexTopology


def sample_boards(generator: torch.Generator, topo: HexTopology, batch: int) -> torch.Tensor:
    """(B, N, N) int8 world-frame boards, seat 0 to move, drawn from
    ``generator`` on its device."""
    n = topo.n
    dev = generator.device
    lo = n // 4
    hi = max(n - 1, lo + 1)  # numpy randint(lo, n-1): upper-exclusive
    m = torch.randint(lo, hi, (batch,), generator=generator, device=dev)
    l = torch.randint(lo, hi, (batch,), generator=generator, device=dev)  # noqa: E741
    u_r, u_c = torch.rand((2, batch), generator=generator, device=dev, dtype=torch.float64)
    sr = torch.minimum((u_r * (n - m + 1)).long(), n - m)  # U{0, ..., n-m}
    sc = torch.minimum((u_c * (n - l + 1)).long(), n - l)

    ys = torch.arange(n, device=dev).repeat_interleave(n)  # (n*n,) row of each cell
    xs = torch.arange(n, device=dev).repeat(n)
    member = (
        (ys[None] >= sr[:, None]) & (ys[None] < (sr + m)[:, None])
        & (xs[None] >= sc[:, None]) & (xs[None] < (sc + l)[:, None])
    )

    u = torch.rand((batch,), generator=generator, device=dev)
    total = (m * l).to(torch.float32)
    nonzero = (torch.floor(total * (0.5 + 0.5 * u) / 2.0) * 2.0).to(torch.int64)
    n_black = nonzero // 2  # == nonzero - n_black: equal halves

    # uniform ranks 0..(m*l-1) over the submatrix: rank < n_black is -1,
    # rank < nonzero is +1, the rest empty — a uniform shuffle of the
    # reference's value multiset
    scores = torch.rand((batch, n * n), generator=generator, device=dev)
    scores = torch.where(member, scores, torch.full_like(scores, float("inf")))
    order = torch.argsort(scores, dim=1)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(n * n, device=dev).expand(batch, n * n).contiguous())
    one = torch.ones((), dtype=torch.int8, device=dev)
    vals = torch.where(
        member & (ranks < n_black[:, None]), -one,
        torch.where(member & (ranks < nonzero[:, None]), one, torch.zeros_like(one)),
    )
    return vals.reshape(batch, n, n)
