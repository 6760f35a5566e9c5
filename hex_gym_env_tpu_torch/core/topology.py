"""Static board topology: cell layout, hex adjacency, edge membership.

The reference encodes adjacency implicitly via a 3x3 Moore neighborhood with
the (-1,-1) and (+1,+1) corners masked out (``minihex/HexSingleGame.py:135-140``),
i.e. the six hex neighbor offsets {(-1,0),(-1,+1),(0,-1),(0,+1),(+1,-1),(+1,0)}.

Here the board is stored flat and lane-packed: cell ``(y, x)`` lives at flat
index ``c = y*N + x`` inside a vector padded to a multiple of 128 lanes, so a
batch of boards is a ``(B, L)`` boolean array whose trailing axis maps onto
TPU vector lanes with zero waste (for N<=11, L=128).  Neighbor dilation then
becomes six lane-rotates (``jnp.roll``) gated by precomputed pair-validity
masks, instead of the reference's per-move O(N^2) label rescan
(``minihex/HexSingleGame.py:150-153``).

Frames and seats (world frame == the reference's "black"/reset frame):

- seat 0 ("black", board encoding -1) connects row 0 <-> row N-1;
- seat 1 ("white", board encoding +1) connects col 0 <-> col N-1
  (the reference pre-labels those padded edges at
  ``minihex/HexSingleGame.py:46-49``).
"""

from __future__ import annotations

import functools

import numpy as np

# (dy, dx) hex neighbor offsets; see module docstring for the reference cite.
NEIGHBOR_OFFSETS: tuple[tuple[int, int], ...] = (
    (-1, 0),
    (-1, 1),
    (0, -1),
    (0, 1),
    (1, -1),
    (1, 0),
)

LANE = 128


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


class HexTopology:
    """Precomputed constants for an N x N Hex board.

    All masks are host numpy arrays; they become XLA constants when closed
    over inside jitted functions.  Instances are cached per board size.

    Attributes:
      n: board side length.
      num_cells: N*N.
      lanes: padded flat length L (multiple of 128).
      cell_mask: (L,) bool — True for real cells, False for lane padding.
      neighbor_shifts: tuple of 6 flat offsets d such that cell c's neighbor
        is c + d.
      neighbor_masks: (6, L) bool — neighbor_masks[k, c] is True iff cell c
        has a valid neighbor at offset neighbor_shifts[k] (stays on board and
        respects the hex row/col constraints).
      edge_masks: (2, 2, L) bool — edge_masks[seat, end] marks the cells on
        the seat's own edge `end` (seat 0: rows 0 / N-1; seat 1: cols 0 / N-1).
    """

    def __init__(self, n: int):
        if n < 2:
            raise ValueError(f"board size must be >= 2, got {n}")
        self.n = n
        self.num_cells = n * n
        # lane-padded flat length; the last 4 slots double as the per-seat
        # edge "virtual nodes" of the flat-label connectivity structure
        self.lanes = _round_up(self.num_cells + 4, LANE)

        idx = np.arange(self.lanes)
        ys = idx // n
        xs = idx % n
        real = idx < self.num_cells

        self.cell_mask = real

        shifts = []
        masks = []
        for dy, dx in NEIGHBOR_OFFSETS:
            d = dy * n + dx
            ny = ys + dy
            nx = xs + dx
            ok = real & (ny >= 0) & (ny < n) & (nx >= 0) & (nx < n)
            # flat index of the neighbor must also be a real cell (implied by
            # the coordinate checks, but keep it explicit for safety).
            ok &= (idx + d >= 0) & (idx + d < self.num_cells)
            shifts.append(d)
            masks.append(ok)
        self.neighbor_shifts = tuple(shifts)
        self.neighbor_masks = np.stack(masks, axis=0)

        edge = np.zeros((2, 2, self.lanes), dtype=bool)
        edge[0, 0] = real & (ys == 0)
        edge[0, 1] = real & (ys == n - 1)
        edge[1, 0] = real & (xs == 0)
        edge[1, 1] = real & (xs == n - 1)
        self.edge_masks = edge

        # --- flat-label union tables -------------------------------------
        # Virtual edge nodes: ids N^2 + (2*seat + end).  A stone placed at
        # cell c can merge with up to 8 "slots": the 6 hex neighbors plus the
        # mover's two edge virtuals (valid only on the matching edge row/col).
        self.virtual_ids = np.array(
            [[self.num_cells + 0, self.num_cells + 1],
             [self.num_cells + 2, self.num_cells + 3]],
            dtype=np.int32,
        )
        nbr_ids = np.zeros((2, 8, self.lanes), dtype=np.int32)
        nbr_valid = np.zeros((2, 8, self.lanes), dtype=bool)
        for seat in range(2):
            for k, (d, mask) in enumerate(zip(self.neighbor_shifts, self.neighbor_masks)):
                nbr_ids[seat, k] = np.clip(idx + d, 0, self.lanes - 1)
                nbr_valid[seat, k] = mask
            for end in range(2):
                nbr_ids[seat, 6 + end] = self.virtual_ids[seat, end]
                nbr_valid[seat, 6 + end] = edge[seat, end]
        self.uf_nbr_ids = nbr_ids
        self.uf_nbr_valid = nbr_valid
        # slots 6,7 target virtual nodes (always "occupied")
        self.uf_slot_is_virtual = np.array([False] * 6 + [True] * 2)

    def __repr__(self) -> str:  # pragma: no cover
        return f"HexTopology(n={self.n}, lanes={self.lanes})"

    # Topologies are value-objects keyed by board size, so they can be used
    # as static arguments to jitted functions.
    def __eq__(self, other) -> bool:
        return isinstance(other, HexTopology) and other.n == self.n

    def __hash__(self) -> int:
        return hash(("HexTopology", self.n))


@functools.lru_cache(maxsize=None)
def get_topology(n: int) -> HexTopology:
    """Cached topology for board size ``n``."""
    return HexTopology(n)
