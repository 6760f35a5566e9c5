"""The opponent pool's update after an evaluation (the reference's eval
callback): with ``mean_reward`` the mean of the episode rewards and
``score = mean_reward * exp(mean(scores) - 1)``, the pool replaces one of
its lowest-scoring members with the agent when ``mean_reward > 0`` and
``score > min(scores)``, and the agent becomes the best opponent when
``score > best_score``.
"""

from __future__ import annotations

import torch


def faults(rewards, scores, best_score, new_scores, new_best_score, replaced_slot,
           member_is_agent: bool, best_is_agent: bool, others_unchanged: bool) -> int:
    """How many parts of one pool update break the rule.

    ``rewards`` (E,), ``scores`` (P,) and ``best_score`` are the inputs;
    ``new_scores``, ``new_best_score``, ``replaced_slot`` (None where no slot
    changed), ``member_is_agent`` (the changed slot holds the agent's
    parameters), ``best_is_agent`` and ``others_unchanged`` describe what
    the program left.  Every reward of a finished Hex game is +1 or -1."""
    rewards = rewards.double().cpu()
    scores = scores.double().cpu()
    new_scores = new_scores.double().cpu()
    best_score = float(best_score)
    new_best = float(new_best_score)
    n = int((rewards.abs() != 1.0).sum())
    mean_reward = float(rewards.mean())
    score = mean_reward * float(torch.exp(scores.mean() - 1.0))
    tol = 1e-6 * max(1.0, abs(score))
    replace = mean_reward > 0 and score > float(scores.min()) + tol
    keep = mean_reward <= 0 or score < float(scores.min()) - tol
    if replace or keep:  # away from the threshold the decision is sharp
        n += int((replaced_slot is not None) != replace)
    if replaced_slot is not None:
        n += int(float(scores[replaced_slot]) != float(scores.min()))
        n += int(abs(float(new_scores[replaced_slot]) - score) > tol)
        n += int(not member_is_agent)
        promote = score > best_score
        n += int(best_is_agent != promote)
        n += int(abs(new_best - (score if promote else best_score)) > tol)
    else:
        n += int(new_best != best_score) + int(best_is_agent)
    n += int(not others_unchanged)
    return n
