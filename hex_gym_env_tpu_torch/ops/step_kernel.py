"""K1, the env step, and K7, the random-legal rollout, as CUDA kernels.

K1 is the counterpart of the JAX package's ``ops/pallas_step.step``: move
decoding, legality, stone placement, the flat-label union, win/draw/invalid
resolution, the ``to_move`` flip and the 2-seat reward in one launch
(``csrc/hex_kernels.cu`` ``step_kernel``; its note gives the bound).  Its
plain PyTorch twin is ``core.env.step``, which computes the same function.
``step`` dispatches on the tensor's device: the kernel for a CUDA tensor,
the twin for a CPU tensor.  ``step_cuda`` is the kernel alone and raises on
a CPU tensor.  Both kernels run a warp per game for any number of lanes
and write into two buffers whose views ``carve_outputs`` hands back.

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
    """``core.env.step`` on the CUDA kernel; returns ``(new_state, rewards)``.

    The outputs are views of two buffers (``carve_outputs``); an input that
    already has the kernel's dtype and layout is passed as it is."""
    B, L = state.batch_size, topo.lanes
    if state.lanes != L:
        raise ValueError(f"state has {state.lanes} lanes, topology {L}")
    chk = cuda_lib.check_cuda
    stones = _aligned(chk("stones", state.stones, torch.bool, (B, 2, L)))
    labels = _aligned(chk("labels", state.labels, torch.int32, (B, L)))
    to_move = chk("to_move", state.to_move, torch.int32, (B,))
    done = chk("done", state.done, torch.bool, (B,))
    winner = chk("winner", state.winner, torch.int32, (B,))
    empty = chk("empty", state.empty, torch.int32, (B,))
    moves = chk("move_count", state.move_count, torch.int32, (B,))
    if actions.dtype != torch.int32:
        actions = actions.to(torch.int32)
    actions = chk("actions", actions, torch.int32, (B,))
    if active is not None:
        if active.dtype != torch.bool:
            active = active.to(torch.bool)
        active = chk("active", active, torch.bool, (B,))

    out, rewards, ints, bytes_ = carve_outputs(B, L, stones.device, 2 * B)
    rewards = rewards.view(torch.float32).view(B, 2)
    if B == 0:
        return out, rewards
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k1_step", "hex_step",
        p(stones), p(labels), p(to_move), p(done), p(winner), p(empty), p(moves),
        p(actions), p(active), p(ints), p(bytes_),
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it starts on a 16-byte boundary (any fresh tensor
    and any batch slice of one), else a copy: K1 and K7 move a game's
    labels and stones in 16- and 4-byte words."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def carve_outputs(B: int, L: int, device, n_extra: int):
    """K1's and K7's outputs as views of one int32 and one bool buffer, in
    the kernels' layout (``csrc/hex_kernels.cu``, the launch shape of K1 and
    K7): ints = labels (B, L), to_move, winner, empty, move_count (B each),
    then ``n_extra`` ints (K1's rewards, K7's games); bytes = stones
    (B, 2, L), done (B).  Returns ``(state, extra, ints, bytes)``: two
    allocations per call where the fields would take eight."""
    ints = torch.empty((B * (L + 4) + n_extra,), dtype=torch.int32, device=device)
    bytes_ = torch.empty((B * (2 * L + 1),), dtype=torch.bool, device=device)
    labels, to_move, winner, empty, moves, extra = ints.split((B * L, B, B, B, B, n_extra))
    stones, done = bytes_.split((2 * B * L, B))
    state = HexState(stones=stones.view(B, 2, L), labels=labels.view(B, L), to_move=to_move,
                     done=done, winner=winner, empty=empty, move_count=moves)
    return state, extra, ints, bytes_


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
    stones = _aligned(chk("stones", state.stones, torch.bool, (B, 2, L)))
    labels = _aligned(chk("labels", state.labels, torch.int32, (B, L)))
    to_move = chk("to_move", state.to_move, torch.int32, (B,))
    empty = chk("empty", state.empty, torch.int32, (B,))
    if bits is not None:
        bits = chk("bits", bits, torch.int32, (n_steps, B, L))
        seed = 0
    else:
        seed = cuda_lib.philox_seed(generator)

    out, games, ints, bytes_ = carve_outputs(B, L, stones.device, B)
    if B == 0:
        return out, games
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k7_random_rollout", "hex_random_rollout",
        p(stones), p(labels), p(to_move), p(empty), p(bits), seed, p(ints), p(bytes_),
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
