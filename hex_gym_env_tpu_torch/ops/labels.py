"""Flat-label connectivity: the win-detection primitive.

The counterpart of the JAX package's ``ops/labels.py``: the reference's own
merge — ``regions[regions == label] = new_label``
(``minihex/HexSingleGame.py:150-153``) — over a batch.  Each game keeps one
(L,) int32 ``labels`` table over the lane-padded cell ids plus 4 virtual
edge nodes; cells of one connected group carry the same label.  Stones
touching a player's edge merge through that edge's virtual node.

Placing a stone at cell ``c``: compute the 8 merge slots (6 hex neighbours +
the mover's two edge virtuals), read each slot's pre-move label and
occupancy (a gather here; the TPU's one-hot reads are not needed), relabel
every node carrying an eligible slot label to ``c``, and read the win off
the slot labels.

Label invariants: empty cell c has label c; virtual node v starts with label
v; a group's label is the id of its most recently placed stone; two nodes
are connected iff their labels are equal.
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.core.topology import HexTopology

_IS_VIRTUAL = (False,) * 6 + (True,) * 2


def initial_labels(topo: HexTopology, batch: int, device=None) -> torch.Tensor:
    """(B, L) identity labels: every node its own singleton."""
    lane = torch.arange(topo.lanes, dtype=torch.int32, device=device)
    return lane.expand(batch, topo.lanes).contiguous()


def _slot_ids_valid(topo: HexTopology, seat: torch.Tensor, c: torch.Tensor):
    """Slot ids (B, 8) int64 and validity (B, 8) bool, computed arithmetically.

    Slots 0-5: hex neighbours {-n, -n+1, -1, +1, n-1, n} with the row/col
    constraints of the adjacency; slots 6-7: the mover's edge virtuals,
    valid only on the matching edge.  Neighbour ids are clamped to
    [0, L-1], so an invalid slot never reads out of bounds.
    """
    n = topo.n
    c = c.long()
    y, x = c // n, c % n
    offs = torch.tensor([-n, -n + 1, -1, 1, n - 1, n], device=c.device)
    ids6 = (c[:, None] + offs[None, :]).clamp(0, topo.lanes - 1)
    top, bot = y > 0, y < n - 1
    lft, rgt = x > 0, x < n - 1
    valid6 = torch.stack([top, top & rgt, lft, rgt, bot & lft, bot], dim=1)

    e0 = topo.num_cells + 2 * seat.long()
    ids_v = torch.stack([e0, e0 + 1], dim=1)
    is0 = seat == 0
    valid_v = torch.stack(
        [torch.where(is0, y == 0, x == 0), torch.where(is0, y == n - 1, x == n - 1)],
        dim=1,
    )
    return torch.cat([ids6, ids_v], dim=1), torch.cat([valid6, valid_v], dim=1)


def place_stone(
    topo: HexTopology,
    labels: torch.Tensor,  # (B, L) int32 — pre-move tables
    stones_mover: torch.Tensor,  # (B, L) bool — mover's stones INCLUDING the new one
    seat: torch.Tensor,  # (B,) int32
    c: torch.Tensor,  # (B,) int32 world cell of the new stone
    act: torch.Tensor,  # (B,) bool — games where the move actually applies
    pre_connected: bool = True,
):
    """Merge the new stone's group; returns ``(labels', win (B,) bool)``.

    ``win`` is true when the mover's two edges share a group after the move,
    including, with ``pre_connected``, the case where they were already
    connected before it.  The random-legal rollout (K7) counts only a join
    made by the new stone's group: ``pre_connected=False``.
    """
    ids, valid = _slot_ids_valid(topo, seat, c)
    slot_labels = labels.gather(1, ids)  # (B, 8)
    occ = stones_mover.gather(1, ids)  # (B, 8)
    is_virtual = torch.tensor(_IS_VIRTUAL, device=labels.device)
    eligible = valid & (occ | is_virtual[None, :]) & act[:, None]

    match = (
        (labels[:, None, :] == slot_labels[:, :, None]) & eligible[:, :, None]
    ).any(dim=1)
    new_labels = torch.where(match, c.to(labels.dtype)[:, None], labels)

    # slots 6/7 always address e0/e1: their pre-move labels are the edge groups
    label_e0 = slot_labels[:, 6:7]
    label_e1 = slot_labels[:, 7:8]
    joined_e0 = (eligible & (slot_labels == label_e0)).any(dim=1)
    joined_e1 = (eligible & (slot_labels == label_e1)).any(dim=1)
    win = joined_e0 & joined_e1
    if pre_connected:
        win = win | (label_e0[:, 0] == label_e1[:, 0])
    return new_labels, act & win


def labels_from_stones(topo: HexTopology, stones: torch.Tensor) -> torch.Tensor:
    """Rebuild label tables from (B, 2, L) bool occupancy (sampled boards).

    A replay over the cells in row-major order through ``place_stone`` — the
    batched form of the reference's construction loop
    (``HexSingleGame.py:57-65``).  Each cell's merge sees its seat's whole
    final occupancy, as in the JAX package, so the labels (not only the
    partition) are the JAX package's.
    """
    batch = stones.shape[0]
    labels = initial_labels(topo, batch, stones.device)
    for c in range(topo.num_cells):
        has0, has1 = stones[:, 0, c], stones[:, 1, c]
        seat = has1.to(torch.int32)  # 0 for a seat-0 stone or none
        cc = torch.full((batch,), c, dtype=torch.int32, device=stones.device)
        mover = torch.where(has1[:, None], stones[:, 1], stones[:, 0])
        labels, _ = place_stone(topo, labels, mover, seat, cc, has0 | has1)
    return labels


def connected_to_edge(
    topo: HexTopology, labels: torch.Tensor, seat: int, end: int
) -> torch.Tensor:
    """(B, L) bool — nodes grouped with seat's edge ``end`` virtual."""
    v = int(topo.virtual_ids[seat, end])
    return labels == labels[:, v : v + 1]


def seat_wins(topo: HexTopology, labels: torch.Tensor, seat: int) -> torch.Tensor:
    """(B,) bool — seat's two edge virtuals share a group."""
    v0 = int(topo.virtual_ids[seat, 0])
    v1 = int(topo.virtual_ids[seat, 1])
    return labels[:, v0] == labels[:, v1]
