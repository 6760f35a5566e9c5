"""Hex connectivity as reach sets: neighbour dilation and propagation.

The counterpart of the JAX package's ``ops/connectivity.py``.  For each seat
and each of its two edges, the reach set is the set of that seat's stones
whose group touches the edge, grown to the fixpoint of

    reach = reach | (dilate(reach) & stones)

where ``dilate`` is six lane shifts gated by the topology's neighbour masks.
The env tracks connectivity with flat labels (``ops/labels.py``) instead;
this module computes the same partition independently, and the tests hold
``labels.labels_from_stones`` against it.
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.core.topology import HexTopology


def dilate(reach: torch.Tensor, topo: HexTopology) -> torch.Tensor:
    """Hex neighbour-OR: ``out[..., c] = any(reach[..., c + d])`` over the
    valid offsets ``d``; ``reach`` is (..., L) bool in the flat lane layout.
    Each offset's mask keeps wrapped lanes from leaking across rows and
    edges."""
    out = torch.zeros_like(reach)
    for d, mask in zip(topo.neighbor_shifts, topo.neighbor_masks):
        shifted = torch.roll(reach, -d, dims=-1)
        out = out | (shifted & torch.as_tensor(mask, device=reach.device))
    return out


def propagate(reach: torch.Tensor, stones: torch.Tensor, topo: HexTopology) -> torch.Tensor:
    """The smallest fixpoint of ``r | (dilate(r) & stones)`` containing
    ``reach``: every stone connected to the seed set through the hex
    adjacency restricted to ``stones`` (broadcastable against ``reach``)."""
    while True:
        grown = reach | (dilate(reach, topo) & stones)
        if torch.equal(grown, reach):
            return grown
        reach = grown


def propagate_fixed(
    reach: torch.Tensor, stones: torch.Tensor, topo: HexTopology, iters: int
) -> torch.Tensor:
    """:func:`propagate` for a fixed number of iterations (no convergence
    test); ``iters`` must bound the propagation depth."""
    for _ in range(iters):
        reach = reach | (dilate(reach, topo) & stones)
    return reach


def full_reach(stones: torch.Tensor, topo: HexTopology) -> torch.Tensor:
    """Both seats' reach planes from scratch: (B, 2, L) bool occupancy ->
    (B, 2, 2, L) bool (seat, edge)."""
    edges = torch.as_tensor(topo.edge_masks, device=stones.device)  # (2, 2, L)
    seeds = edges[None] & stones[:, :, None, :]
    return propagate(seeds, stones[:, :, None, :], topo)


def wins(reach_seat: torch.Tensor) -> torch.Tensor:
    """One seat's win from its (..., 2, L) reach planes: some stone reaches
    both of its edges."""
    return (reach_seat[..., 0, :] & reach_seat[..., 1, :]).any(dim=-1)
