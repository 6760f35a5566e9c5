"""Opponent snapshot bank on the device.

The counterpart of the JAX package's ``train/bank.py``.  The reference keeps
a Python list of SB3 models plus scores (``minihex/SelfplayWrapper.py:39-67``)
and mutates it from the eval callback (``set_opponent_model``, ``:125-137``).
Here the bank is a dict of *stacked* parameter snapshots (the policy's
state-dict names, leading axis = pool slot; a CNN's BatchNorm statistics
ride with its weights), a scores vector and the designated best snapshot.

A zero parameter snapshot plays exactly the reference's ``BaseRandomPolicy``
(``SelfplayWrapper.py:16-24``): zero weights give constant logits, and the
masked categorical over constant logits is uniform over legal moves.  So a
fresh bank of zeros is the reference's initial pool of random policies.  A
zero CNN snapshot has BatchNorm scale 0 and running variance 0, which folds
to zero filters (``0 / sqrt(0 + eps)``), not NaN, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class OpponentBank:
    """Pool of ``size`` opponent snapshots + scores + best snapshot.

    Attributes:
      params: state dict with a leading axis P on every tensor.
      scores: (P,) float32 — the pool scores (``opponent_scores``).
      best_params: state dict — the designated best snapshot (``best_model``).
      best_score: () float32 (``best_score``).
    """

    params: Params
    scores: torch.Tensor
    best_params: Params
    best_score: torch.Tensor

    @property
    def size(self) -> int:
        return self.scores.shape[0]


def init_bank(template_params: Params, size: int) -> OpponentBank:
    """Fresh bank of ``size`` random policies (zero params), zero scores, on
    the template's device."""
    zeros = {k: torch.zeros_like(v) for k, v in template_params.items()}
    device = next(iter(zeros.values())).device
    return OpponentBank(
        params={k: z[None].repeat((size,) + (1,) * z.dim()) for k, z in zeros.items()},
        scores=torch.zeros((size,), dtype=torch.float32, device=device),
        best_params=zeros,
        best_score=torch.zeros((), dtype=torch.float32, device=device),
    )


def sample_opponents(
    generator: torch.Generator, bank_size: int, batch: int, best_prob: float, device
):
    """Per-episode opponent draw: P(best) = best_prob, else a uniform pool
    slot (``setup_opponents``, ``SelfplayWrapper.py:97-104``).

    Returns ``(use_best (B,) bool, idx (B,) int32)`` on ``device``."""
    gdev = generator.device
    u = torch.rand((batch,), generator=generator, device=gdev)
    idx = torch.randint(0, bank_size, (batch,), generator=generator, device=gdev)
    return (u < best_prob).to(device), idx.to(torch.int32).to(device)


def replace_member(
    bank: OpponentBank,
    generator: torch.Generator,
    new_params: Params,
    score: torch.Tensor,
    do_replace: bool,
) -> OpponentBank:
    """Conditionally replace a random minimum-score member with ``new_params``.

    Mirrors the eval callback + ``set_opponent_model``
    (``EvaluationCallback.py:36-48``, ``SelfplayWrapper.py:125-137``): pick
    uniformly among the argmin-score slots, overwrite params and score, and
    promote to best when the score strictly beats ``best_score``.  Returns a
    new bank; the given one is not modified.
    """
    if not do_replace:
        return bank
    scores = bank.scores
    score = torch.as_tensor(score, dtype=torch.float32, device=scores.device)
    mins = torch.nonzero(scores == scores.min()).flatten()
    pick = torch.randint(0, mins.numel(), (1,), generator=generator, device=generator.device)
    slot = mins[pick.to(mins.device)][0]

    params = {}
    for k, stacked in bank.params.items():
        updated = stacked.clone()
        updated[slot] = new_params[k]
        params[k] = updated
    new_scores = scores.clone()
    new_scores[slot] = score

    promote = bool(score > bank.best_score)
    return OpponentBank(
        params=params,
        scores=new_scores,
        best_params={k: v.clone() for k, v in new_params.items()} if promote else bank.best_params,
        best_score=score.clone() if promote else bank.best_score,
    )
