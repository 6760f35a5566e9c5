"""K5: GAE as one CUDA kernel.

The counterpart of the JAX package's ``ops/pallas_gae.py``: the reverse GAE
recurrence over ``(T, B)`` in SB3's operation order, in one launch
(``csrc/learner_kernels.cu`` ``gae_kernel``; its note gives the bound).  One
thread per env column walks t from T-1 down to 0, so there is no unroll
cap.  Each operation is one float32 rounding (no FMA contraction), in the
twin's order, so the kernel equals the twin exactly.

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
    """``train/gae.compute_gae`` on the CUDA kernel."""
    T, B = rewards.shape
    chk = cuda_lib.check_cuda
    rewards = chk("rewards", rewards, torch.float32, (T, B))
    values = chk("values", values, torch.float32, (T, B))
    dones = chk("dones", dones.to(torch.bool), torch.bool, (T, B))
    last_values = chk("last_values", last_values, torch.float32, (B,))
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k5_gae", "hex_gae",
        p(rewards), p(values), p(dones), p(last_values), p(adv), p(ret),
        T, B, float(gamma), float(gamma * gae_lambda),
    )
    return adv, ret


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
