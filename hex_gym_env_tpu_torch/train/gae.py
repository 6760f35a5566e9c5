"""Generalized Advantage Estimation, matching SB3's recurrence.

The counterpart of the JAX package's ``train/gae.py``.  SB3's
``RolloutBuffer.compute_returns_and_advantage`` walks time backwards with
``next_non_terminal = 1 - episode_start[t+1]`` and bootstraps the final step
from the value of the post-rollout observation.  Here ``dones[t]`` marks a
transition that *ended* an episode (so ``episode_start[t+1] == dones[t]``
under in-rollout auto-reset), which gives the identical recurrence over
``(T, B)`` tensors.

This plain loop is also the twin of the GAE kernel K5
(``ops/gae_kernel.py``): every operation is one float32 rounding, in the
order the JAX scan takes them, so the kernel reproduces it exactly.
"""

from __future__ import annotations

import torch


def compute_gae(
    rewards: torch.Tensor,  # (T, B) float32
    values: torch.Tensor,  # (T, B) float32 — V(obs_t)
    dones: torch.Tensor,  # (T, B) bool — transition t ended its episode
    last_values: torch.Tensor,  # (B,) float32 — V(obs_T) after auto-reset
    gamma: float,
    gae_lambda: float,
):
    """Returns ``(advantages, returns)``, both (T, B) float32.

    ``returns = advantages + values`` (SB3's TD(lambda) target).  Per step:
    ``delta = r + gamma*next_v*nt - v`` and ``adv = delta + gl*nt*adv`` with
    ``gl = gamma*gae_lambda`` multiplied as Python floats first."""
    g = torch.tensor(gamma, dtype=torch.float32)
    gl = torch.tensor(gamma * gae_lambda, dtype=torch.float32)
    nonterminal = 1.0 - dones.to(torch.float32)
    adv = torch.zeros_like(last_values)
    next_v = last_values
    out = torch.empty_like(rewards)
    for t in reversed(range(rewards.shape[0])):
        v, nt = values[t], nonterminal[t]
        delta = rewards[t] + g * next_v * nt - v
        adv = delta + gl * nt * adv
        out[t] = adv
        next_v = v
    return out, out + values
