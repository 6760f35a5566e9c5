"""K5: GAE as one CUDA kernel.

The counterpart of the JAX package's ``ops/pallas_gae.py``: the reverse GAE
recurrence over ``(T, B)`` in SB3's operation order, in one launch
(``csrc/learner_kernels.cu`` ``gae_kernel``; its note gives the bound and
the design).  A CTA owns 32 columns and takes the steps in chunks from
t = T-1 down: all its threads load a chunk and compute each step's parts
that need no carry, then one warp walks the carry through it, so there is
no unroll cap.  Each operation is one float32 rounding (no FMA
contraction), in the twin's order, so the kernel equals the twin exactly.

The twin is ``train/gae.compute_gae``.  ``compute_gae`` here dispatches by
``impl`` ("auto": the kernel on a CUDA tensor, the twin on a CPU tensor;
"pallas": the kernel, raising on a CPU tensor; "lax": the twin).
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.ops.policy_kernel import use_kernel
from hex_gym_env_tpu_torch.train import gae

compute_gae_twin = gae.compute_gae


def compute_gae_cuda(rewards, values, dones, last_values, gamma: float, gae_lambda: float):
    """``train/gae.compute_gae`` on the CUDA kernel: ``(advantages,
    returns)``, views of one (2, T, B) buffer.  The inputs are read in place,
    any strides (the rollout record's lanes are strided views)."""
    T, B = rewards.shape

    def chk(name, t, dtype, shape):
        return cuda_lib.check_cuda(name, t, dtype, shape, strided=True)

    rewards = chk("rewards", rewards, torch.float32, (T, B))
    values = chk("values", values, torch.float32, (T, B))
    dones = chk("dones", dones.to(torch.bool), torch.bool, (T, B))
    last_values = chk("last_values", last_values, torch.float32, (B,))
    out = torch.empty((2, T, B), dtype=torch.float32, device=rewards.device)
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k5_gae", "hex_gae",
        p(rewards), *rewards.stride(), p(values), *values.stride(), p(dones), *dones.stride(),
        p(last_values), last_values.stride(0), p(out),
        T, B, float(gamma), float(gamma * gae_lambda),
    )
    return out[0], out[1]


def compute_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_values: torch.Tensor,
    gamma: float,
    gae_lambda: float,
    impl: str = "auto",
):
    """``(advantages, returns)``, both (T, B) float32, by ``impl``."""
    if use_kernel(rewards, impl):
        return compute_gae_cuda(rewards, values, dones, last_values, gamma, gae_lambda)
    return compute_gae_twin(rewards, values, dones, last_values, gamma, gae_lambda)


def resolve(impl: str):
    """``PPOConfig.gae_impl`` -> a ``compute_gae`` function of the six
    arguments of ``train/gae.compute_gae``."""
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(f"gae_impl must be one of 'auto'/'lax'/'pallas', got {impl!r}")
    if impl == "lax":
        return compute_gae_twin

    def gae_fn(rewards, values, dones, last_values, gamma, gae_lambda):
        return compute_gae(rewards, values, dones, last_values, gamma, gae_lambda, impl)

    return gae_fn
