"""Masked categorical distribution over actions.

The counterpart of the JAX package's ``ops/masked.py``, with sb3_contrib's
``MaskableCategorical`` semantics: illegal logits are replaced by the most
negative finite float32, probabilities and log-probs come from a softmax
over the masked logits, and masked entropy terms are exactly zero.

Sampling is a function of random bits, with the kernels' map
(``ops/pallas_policy.py:96-114`` in the JAX package): a uint32 word ``b``
becomes ``u = (b >> 8) * 2**-24 + 2**-25`` in (0, 1), Gumbel noise
``g = -log(-log u)``, and the action is the argmax of ``masked + g`` (ties
to the lowest index).  Bits are carried as int32 tensors holding the uint32
bit pattern (torch has no general uint32 arithmetic); ``draw_bits`` draws
them from a ``torch.Generator``.  With the same bits the plain versions here
and the CUDA kernels draw the same action.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASKED_LOGIT = float(np.finfo(np.float32).min)


def draw_bits(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit words from ``gen`` as an int32 tensor on ``device``."""
    words = torch.randint(
        -(2**31), 2**31, tuple(shape), dtype=torch.int32, generator=gen, device=gen.device
    )
    return words.to(device)


def bits_from_numpy(bits: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy bits (e.g. ``jax.random.bits``) as the int32 bit pattern."""
    return torch.from_numpy(np.array(bits, np.uint32).view(np.int32)).to(device)


def unit_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The top 24 bits as a float32 in [0, 1): ``(b >> 8) * 2**-24``."""
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * (2.0**-24)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """Bits -> standard Gumbel noise, exactly as the kernels compute it."""
    u = unit_uniform(bits) + 2.0**-25
    return -torch.log(-torch.log(u))


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Row argmax as int32, ties to the lowest index."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def sample_masked(masked_logits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw over already-masked logits ((..., A) -> (...,) int32)."""
    return argmax_first(masked_logits + gumbel(bits))


def mask_logits(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Replace illegal entries with the float32 minimum."""
    return torch.where(legal, logits, torch.full_like(logits, MASKED_LOGIT))


def sample(bits: torch.Tensor, logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Stochastic draw over legal actions ((B,) int32)."""
    return sample_masked(mask_logits(logits, legal), bits)


def mode(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Deterministic (argmax) action, as SB3's ``predict(deterministic=True)``."""
    return argmax_first(mask_logits(logits, legal))


def log_prob(logits: torch.Tensor, legal: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a | s) under the masked distribution ((B,) float32)."""
    logp = torch.log_softmax(mask_logits(logits, legal), dim=-1)
    return logp.gather(-1, actions.long()[..., None])[..., 0]


def entropy(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Entropy with masked terms contributing exactly zero ((B,) float32)."""
    logp = torch.log_softmax(mask_logits(logits, legal), dim=-1)
    p_log_p = torch.where(legal, logp.exp() * logp, torch.zeros_like(logp))
    return -p_log_p.sum(dim=-1)


def probs(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Action probabilities."""
    return torch.softmax(mask_logits(logits, legal), dim=-1)


class DistInfo(NamedTuple):
    """Bundle returned by :func:`sample_with_info` for rollout buffers."""

    action: torch.Tensor
    log_prob: torch.Tensor


def sample_with_info(bits: torch.Tensor, logits: torch.Tensor, legal: torch.Tensor) -> DistInfo:
    masked = mask_logits(logits, legal)
    action = sample_masked(masked, bits)
    logp = torch.log_softmax(masked, dim=-1)
    return DistInfo(action=action, log_prob=logp.gather(-1, action.long()[..., None])[..., 0])
