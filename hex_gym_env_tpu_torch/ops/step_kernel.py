"""K1: the env step as one CUDA kernel.

The counterpart of the JAX package's ``ops/pallas_step.step``: move
decoding, legality, stone placement, the flat-label union, win/draw/invalid
resolution, the ``to_move`` flip and the 2-seat reward in one launch
(``csrc/hex_kernels.cu`` ``step_kernel``; its note gives the bound).  The
plain PyTorch twin is ``core.env.step``, which computes the same function.

``step`` dispatches on the tensor's device: the kernel for a CUDA tensor,
the twin for a CPU tensor.  ``step_cuda`` is the kernel alone and raises on
a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.state import HexState
from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.ops import cuda_lib


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

    out = HexState(
        stones=torch.empty_like(stones),
        labels=torch.empty_like(labels),
        to_move=torch.empty_like(to_move),
        done=torch.empty_like(done),
        winner=torch.empty_like(winner),
        empty=torch.empty_like(empty),
        move_count=torch.empty_like(moves),
    )
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
