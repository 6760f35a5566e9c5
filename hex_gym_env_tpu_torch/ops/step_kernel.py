"""K1, the env step, and K7, the random-legal rollout, as CUDA kernels.

K1 is the counterpart of the JAX package's ``ops/pallas_step.step``: move
decoding, legality, stone placement, the flat-label union, win/draw/invalid
resolution, the ``to_move`` flip and the 2-seat reward in one launch
(``csrc/hex_kernels.cu`` ``step_kernel``; its note gives the bound).  Its
plain PyTorch twin is ``core.env.step``, which computes the same function.
``step`` dispatches on the tensor's device: the kernel for a CUDA tensor,
the twin for a CPU tensor.  ``step_cuda`` is the kernel alone and raises on
a CPU tensor.

K7 is the counterpart of ``ops/pallas_step.random_rollout``: T uniform-random
legal moves per game with auto-reset in one launch, for the env-throughput
benchmark (``hex_gym_env_tpu_torch.bench``).  ``random_rollout`` dispatches
on ``impl``; ``random_rollout_twin`` is its plain PyTorch twin.
"""

from __future__ import annotations

from typing import Optional

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.state import HexState, Winner
from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.ops import cuda_lib, labels as labels_ops, masked


def step_cuda(
    topo: HexTopology,
    state: HexState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """``core.env.step`` on the CUDA kernel; returns ``(new_state, rewards)``."""
    B, L = state.batch_size, topo.lanes
    if state.lanes != L:
        raise ValueError(f"state has {state.lanes} lanes, topology {L}")
    chk = cuda_lib.check_cuda
    stones = chk("stones", state.stones, torch.bool, (B, 2, L))
    labels = chk("labels", state.labels, torch.int32, (B, L))
    to_move = chk("to_move", state.to_move, torch.int32, (B,))
    done = chk("done", state.done, torch.bool, (B,))
    winner = chk("winner", state.winner, torch.int32, (B,))
    empty = chk("empty", state.empty, torch.int32, (B,))
    moves = chk("move_count", state.move_count, torch.int32, (B,))
    actions = chk("actions", actions.to(torch.int32), torch.int32, (B,))
    if active is not None:
        active = chk("active", active.to(torch.bool), torch.bool, (B,))

    out = _empty_state_like(state)
    rewards = torch.empty((B, 2), dtype=torch.float32, device=stones.device)
    if B == 0:
        return out, rewards
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k1_step", "hex_step",
        p(stones), p(labels), p(to_move), p(done), p(winner), p(empty), p(moves),
        p(actions), p(active),
        p(out.stones), p(out.labels), p(out.to_move), p(out.done), p(out.winner),
        p(out.empty), p(out.move_count), p(rewards),
        B, topo.n, L,
    )
    return out, rewards


def step(
    topo: HexTopology,
    state: HexState,
    actions: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """The kernel on a CUDA state, the twin ``core.env.step`` on a CPU state."""
    if state.stones.is_cuda:
        return step_cuda(topo, state, actions, active)
    return hex_env.step(topo, state, actions, active)


def _empty_state_like(state: HexState) -> HexState:
    """Contiguous uninitialised tensors of the state's shapes, for outputs."""
    fields = {}
    for name in HexState.__dataclass_fields__:
        t = getattr(state, name)
        fields[name] = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return HexState(**fields)


# ---------------------------------------------------------------------------
# K7: the random-legal rollout
# ---------------------------------------------------------------------------


def random_rollout_cuda(
    topo: HexTopology,
    state: HexState,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
):
    """``random_rollout`` on the CUDA kernel; returns ``(state', games (B,))``.

    ``bits`` (T, B, L) int32 (uint32 patterns, the JAX interpret-mode layout)
    replaces the kernel's Philox streams, which are otherwise keyed by a seed
    drawn from ``generator``."""
    B, L = state.batch_size, topo.lanes
    if state.lanes != L:
        raise ValueError(f"state has {state.lanes} lanes, topology {L}")
    chk = cuda_lib.check_cuda
    stones = chk("stones", state.stones, torch.bool, (B, 2, L))
    labels = chk("labels", state.labels, torch.int32, (B, L))
    to_move = chk("to_move", state.to_move, torch.int32, (B,))
    empty = chk("empty", state.empty, torch.int32, (B,))
    if bits is not None:
        bits = chk("bits", bits, torch.int32, (n_steps, B, L))
        seed = 0
    else:
        seed = cuda_lib.philox_seed(generator)

    out = _empty_state_like(state)
    games = torch.empty((B,), dtype=torch.int32, device=stones.device)
    if B == 0:
        return out, games
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k7_random_rollout", "hex_random_rollout",
        p(stones), p(labels), p(to_move), p(empty), p(bits), seed,
        p(out.stones), p(out.labels), p(out.to_move), p(out.done), p(out.winner),
        p(out.empty), p(out.move_count), p(games),
        B, topo.n, L, n_steps,
    )
    return out, games


def random_rollout_twin(
    topo: HexTopology,
    state: HexState,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
):
    """K7's plain PyTorch twin (``ops/pallas_step.py:247-333`` of the JAX
    package), one step at a time.

    Each step's move is the argmax over lanes of ``(bits >> 8) + 1`` on empty
    real cells and 0 elsewhere (lowest lane on ties; lane 0 when no cell is
    empty), the union counts only a join made by the new stone's group, and
    a game that is won or full resets at once.  ``bits`` (T, B, L) int32, or
    a (B, L) draw from ``generator`` per step."""
    n_cells, L, B = topo.num_cells, topo.lanes, state.batch_size
    dev = state.device
    lane = torch.arange(L, device=dev)
    real = lane < n_cells
    identity = lane.to(torch.int32).expand(B, L)
    s0, s1 = state.stones[:, 0], state.stones[:, 1]
    labels, s, empty = state.labels, state.to_move, state.empty
    games = torch.zeros((B,), dtype=torch.int32, device=dev)
    for t in range(n_steps):
        w = bits[t] if bits is not None else masked.draw_bits(generator, (B, L), dev)
        free = ~(s0 | s1) & real
        score = torch.where(free, ((w >> 8) & 0xFFFFFF) + 1, torch.zeros_like(w))
        c = torch.argmax(score, dim=1)  # the first maximum

        onehot = lane[None, :] == c[:, None]
        mover0 = (s == 0)[:, None]
        s0 = s0 | (onehot & mover0)
        s1 = s1 | (onehot & ~mover0)
        stones_s = torch.where(mover0, s0, s1)
        labels, joined = labels_ops.place_stone(
            topo, labels, stones_s, s, c, torch.ones_like(state.done), pre_connected=False)

        empty = empty - 1
        done = joined | (empty <= 0)
        keep = ~done[:, None]
        s0, s1 = s0 & keep, s1 & keep
        labels = torch.where(keep, labels, identity)
        s = torch.where(done, torch.zeros_like(s), 1 - s)
        empty = torch.where(done, torch.full_like(empty, n_cells), empty)
        games = games + done.to(torch.int32)

    zeros = torch.zeros_like(s)
    return HexState(
        stones=torch.stack([s0, s1], dim=1),
        labels=labels.contiguous(),
        to_move=s,
        done=torch.zeros_like(state.done),
        winner=torch.full_like(s, int(Winner.ONGOING)),
        empty=empty,
        move_count=zeros,
    ), games


def random_rollout(
    topo: HexTopology,
    state: HexState,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    impl: str = "auto",
):
    """``n_steps`` uniform-random legal moves per game with auto-reset;
    returns ``(state', games (B,) int32)``, ``games`` counting each game's
    finished episodes.  For throughput benchmarking and soak testing.

    ``impl``: "pallas" the kernel (raises on a CPU state), "lax" the twin,
    "auto" the kernel on a CUDA state and the twin on a CPU state.  The
    randomness is ``bits`` (T, B, L) int32 where given, else drawn from
    ``generator``: the kernel's Philox streams, keyed per launch, are its
    stream deviation from the twin's per-step draws (and from the TPU's
    hardware PRNG)."""
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(f"impl must be one of 'auto'/'lax'/'pallas', got {impl!r}")
    if bits is None and generator is None:
        raise ValueError("random_rollout needs a torch.Generator or injected bits")
    if impl == "pallas" or (impl == "auto" and state.stones.is_cuda):
        return random_rollout_cuda(topo, state, n_steps, generator, bits)
    return random_rollout_twin(topo, state, n_steps, generator, bits)
