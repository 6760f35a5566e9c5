"""Batched Hex environment on tensors.

The counterpart of the JAX package's ``core/env.py``, with the same
semantics (``minihex/HexSingleGame.py`` variant "B") in a fixed world frame:

- the world frame is seat 0's frame; seat 1's moves land at transposed
  coordinates and its stones are +1 in the world board.  The mover-frame
  transform is applied only at the observation/action boundary;
- rewards are the reference's 2-vector: mover +1 / opponent -1 on a win,
  else zeros — including the quirk that an invalid move ends the episode
  with reward [0, 0];
- the win test fires only for the mover (``HexSingleGame.py:109-116``).

Functions here are the plain PyTorch path.  ``step`` is also the twin of
the env-step kernel (``ops/step_kernel.py``); ``make_ops`` binds the backend
choice once.
"""

from __future__ import annotations

from typing import Optional

import torch

from hex_gym_env_tpu_torch.core.state import HexState, Winner
from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.ops import labels as labels_ops
from hex_gym_env_tpu_torch.utils.device import resolve_device


def initial_state(topo: HexTopology, batch: int, device=None) -> HexState:
    """Fresh empty-board games, seat 0 to move (``HexSingleGame.py:208-231``).

    ``device=None`` means ``cuda`` and raises where there is none."""
    device = resolve_device(device)
    L = topo.lanes
    return HexState(
        stones=torch.zeros((batch, 2, L), dtype=torch.bool, device=device),
        labels=labels_ops.initial_labels(topo, batch, device),
        to_move=torch.zeros((batch,), dtype=torch.int32, device=device),
        done=torch.zeros((batch,), dtype=torch.bool, device=device),
        winner=torch.full((batch,), int(Winner.ONGOING), dtype=torch.int32, device=device),
        empty=torch.full((batch,), topo.num_cells, dtype=torch.int32, device=device),
        move_count=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def world_boards(topo: HexTopology, state: HexState) -> torch.Tensor:
    """(B, N, N) int8 world-frame boards: -1 seat0, +1 seat1, 0 empty."""
    vals = state.stones[:, 1].to(torch.int8) - state.stones[:, 0].to(torch.int8)
    return vals[:, : topo.num_cells].reshape(-1, topo.n, topo.n)


def observe(topo: HexTopology, state: HexState) -> torch.Tensor:
    """(B, N, N) int8 mover-frame observations.

    The mover always sees itself as -1 connecting top to bottom: for seat 1
    the world board is transposed and colour-swapped
    (``HexSingleGame.py:265-271``)."""
    grid = world_boards(topo, state)
    inverted = -grid.transpose(-1, -2)
    return torch.where((state.to_move == 0)[:, None, None], grid, inverted)


def legal_mask(topo: HexTopology, state: HexState) -> torch.Tensor:
    """(B, N*N) bool mover-frame legal-action masks (empty cells)."""
    empty = ~(state.stones[:, 0] | state.stones[:, 1])
    grid = empty[:, : topo.num_cells].reshape(-1, topo.n, topo.n)
    flipped = grid.transpose(-1, -2)
    out = torch.where((state.to_move == 0)[:, None, None], grid, flipped)
    return out.reshape(-1, topo.num_cells)


def step(
    topo: HexTopology,
    state: HexState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """Apply one mover-frame action per game.

    Args:
      topo: board topology.
      state: batched state.
      actions: (B,) integer flat actions in the mover frame.
      active: optional (B,) bool — games where the step applies; inactive
        games are untouched with zero reward.

    Returns ``(new_state, rewards (B, 2) float32)`` indexed by seat.  An
    already-done game is a frozen no-op with zero reward.
    """
    n, L = topo.n, topo.lanes
    s = state.to_move
    mover_is_0 = s == 0
    if active is None:
        active = torch.ones_like(state.done)

    actions = actions.to(torch.int32)
    ym = torch.div(actions, n, rounding_mode="floor")
    xm = actions - ym * n
    yw = torch.where(mover_is_0, ym, xm)
    xw = torch.where(mover_is_0, xm, ym)
    c = yw * n + xw  # world-frame flat cell

    lane = torch.arange(L, device=state.device)
    onehot = lane[None, :] == c[:, None]
    occupied = state.stones[:, 0] | state.stones[:, 1]
    valid = (onehot & ~occupied).any(dim=-1)
    invalid_now = ~valid & ~state.done & active
    act = valid & ~state.done & active  # games where a stone is placed

    seat_oh = torch.arange(2, device=state.device)[None, :] == s[:, None]  # (B, 2)
    add = onehot[:, None, :] & seat_oh[:, :, None] & act[:, None, None]
    stones = state.stones | add
    stones_s = torch.where(mover_is_0[:, None], stones[:, 0], stones[:, 1])

    # an off-board action is never valid, so clamp it before it indexes
    c_safe = torch.where(act, c, torch.zeros_like(c))
    new_labels, win = labels_ops.place_stone(topo, state.labels, stones_s, s, c_safe, act)

    empty = state.empty - act.to(torch.int32)
    draw = act & ~win & (empty <= 0)
    done = state.done | win | draw | invalid_now
    winner = torch.where(
        win,
        s,
        torch.where(
            draw,
            torch.full_like(s, int(Winner.DRAW)),
            torch.where(invalid_now, torch.full_like(s, int(Winner.INVALID)), state.winner),
        ),
    )

    r_scalar = win.to(torch.float32)
    rewards = torch.where(seat_oh, r_scalar[:, None], -r_scalar[:, None])

    # the reference flips the mover even on the terminating step
    # (``HexSingleGame.py:259-260``); games already done or inactive stay
    to_move = torch.where(state.done | ~active, s, 1 - s)

    new_state = HexState(
        stones=stones,
        labels=new_labels,
        to_move=to_move,
        done=done,
        winner=winner,
        empty=empty,
        move_count=state.move_count + act.to(torch.int32),
    )
    return new_state, rewards


class EnvOps:
    """The public env primitives with ``topo``, device and step backend bound."""

    def __init__(self, topo: HexTopology, step_fn, device: torch.device):
        self.topo = topo
        self.device = device
        self._step = step_fn

    def initial_state(self, batch: int) -> HexState:
        return initial_state(self.topo, batch, self.device)

    def observe(self, state: HexState) -> torch.Tensor:
        return observe(self.topo, state)

    def legal_mask(self, state: HexState) -> torch.Tensor:
        return legal_mask(self.topo, state)

    def step(self, state: HexState, actions, active=None):
        return self._step(self.topo, state, actions, active=active)

    def reset_where(self, state, mask, fresh=None) -> HexState:
        return reset_where(self.topo, state, mask, fresh)


def make_ops(topo: HexTopology, impl: str = "auto", device=None) -> EnvOps:
    """Composable env API with the step backend chosen once.

    ``impl``: "lax" the plain ``step`` above; "pallas" the CUDA env-step
    kernel (raises on a CPU tensor); "auto" the kernel on a CUDA tensor and
    the plain step on a CPU tensor.  ``device=None`` means ``cuda``."""
    return EnvOps(topo, resolve_step_impl(impl), resolve_device(device))


def resolve_step_impl(impl: str):
    """The one env-step dispatch rule, shared with the training rollout."""
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(
            f"env_step_impl must be one of 'auto'/'lax'/'pallas', got {impl!r}"
        )
    if impl == "lax":
        return step
    from hex_gym_env_tpu_torch.ops import step_kernel

    return step_kernel.step if impl == "auto" else step_kernel.step_cuda


def reset_where(
    topo: HexTopology,
    state: HexState,
    mask: torch.Tensor,
    fresh: Optional[HexState] = None,
) -> HexState:
    """Replace the games selected by ``mask`` with ``fresh`` ones (empty boards
    by default)."""
    if fresh is None:
        fresh = initial_state(topo, state.batch_size, state.device)
    fields = {}
    for name in HexState.__dataclass_fields__:
        a, b = getattr(state, name), getattr(fresh, name)
        m = mask.reshape((mask.shape[0],) + (1,) * (a.dim() - 1))
        fields[name] = torch.where(m, b, a)
    return HexState(**fields)
