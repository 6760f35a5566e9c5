"""GAE, the maskable-PPO loss and the sweep of clipped Adam steps.

SB3's PPO as the reference trains it: per-minibatch advantage
normalisation with Bessel's correction (eps 1e-8), the clipped surrogate,
the unclipped value MSE, the entropy term (coefficient 0 in these
presets), and optax's ``chain(clip_by_global_norm(max_norm), adam(lr,
b1=0.9, b2=0.999, eps))``: the gradients scaled by ``max_norm / gnorm``
where their global norm reaches ``max_norm``, then ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g^2`` and ``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 -
b2^t)) + eps)``.  A sweep takes ``n_epochs`` permutations of the rows and
visits each in minibatches of ``minibatch_size`` rows, dropping a tail.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from benchmark.reference.models import masked_log_softmax

B1, B2, ADV_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class Hyper:
    learning_rate: float
    n_epochs: int
    minibatch_size: int
    gamma: float
    gae_lambda: float
    clip_range: float
    ent_coef: float
    vf_coef: float
    max_grad_norm: float
    adam_eps: float


@dataclasses.dataclass
class Adam:
    count: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def zero_adam(params: Dict[str, torch.Tensor]) -> Adam:
    return Adam(0, {k: torch.zeros_like(p) for k, p in params.items()},
                {k: torch.zeros_like(p) for k, p in params.items()})


def gae(rewards, values, dones, last_values, gamma: float, lam: float):
    """(T, B) advantages and returns; ``dones[t]`` ends the episode of step
    t, and the step after the last bootstraps from ``last_values``."""
    T = rewards.shape[0]
    adv = torch.zeros_like(rewards)
    running = torch.zeros_like(last_values)
    next_v = last_values
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t].to(torch.float32)
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        running = delta + gamma * lam * nonterminal * running
        adv[t] = running
        next_v = values[t]
    return adv, adv + values


def loss(forward: Callable, params, mb: dict, h: Hyper):
    """``(loss, [policy_loss, value_loss, entropy], new_stats)`` of one
    minibatch; ``forward(params, obs)`` returns logits, values and the
    model's new running statistics."""
    logits, values, new_stats = forward(params, mb["obs"])
    logp_all = masked_log_softmax(logits, mb["legal"])
    logp = logp_all.gather(1, mb["action"].long()[:, None])[:, 0]
    probs = logp_all.exp()
    entropy = -torch.where(mb["legal"], probs * logp_all, torch.zeros_like(logp_all)).sum(-1)
    adv = mb["advantage"]
    adv = (adv - adv.mean()) / (adv.std() + ADV_EPS)
    ratio = torch.exp(logp - mb["log_prob_old"])
    clipped = torch.clamp(ratio, 1.0 - h.clip_range, 1.0 + h.clip_range)
    policy_loss = -torch.minimum(adv * ratio, adv * clipped).mean()
    value_loss = ((mb["ret"] - values) ** 2).mean()
    total = policy_loss - h.ent_coef * entropy.mean() + h.vf_coef * value_loss
    return total, torch.stack([policy_loss, value_loss, entropy.mean()]).detach(), new_stats


def sweep(forward: Callable, params: Dict[str, torch.Tensor], trained: tuple, opt: Adam,
          batch: dict, perms: torch.Tensor, h: Hyper):
    """The epochs x minibatches sweep.  ``batch`` holds (n, ...) rows
    (``obs``, ``legal``, ``action``, ``log_prob_old``, ``advantage``,
    ``ret``); ``perms`` (n_epochs, n) the row order.  Only the ``trained``
    names are stepped; the rest take the forward's new running statistics.

    Returns ``(params', opt', stats (G, 3) [policy, value, entropy],
    first_grad {name: gradient of the first step, before the clip})``."""
    n = batch["action"].shape[0]
    n_mb = n // h.minibatch_size
    rows = perms[:, : n_mb * h.minibatch_size].reshape(-1, h.minibatch_size).to(
        batch["action"].device).long()
    p = {k: t.detach().clone() for k, t in params.items()}
    m, v = dict(opt.m), dict(opt.v)
    stats, first_grad = [], None
    for step, r in enumerate(rows):
        mb = {k: x[r] for k, x in batch.items()}
        leaves = [p[k].requires_grad_() for k in trained]
        total, st, new_stats = loss(forward, p, mb, h)
        grads = torch.autograd.grad(total, leaves)
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(trained, grads)}
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(gnorm < h.max_grad_norm, torch.ones_like(gnorm),
                            h.max_grad_norm / gnorm)
        t = opt.count + step + 1
        bc1, bc2 = 1.0 - math.pow(B1, t), 1.0 - math.pow(B2, t)
        for k, g in zip(trained, grads):
            g = g * scale
            m[k] = B1 * m[k] + (1.0 - B1) * g
            v[k] = B2 * v[k] + (1.0 - B2) * g * g
            p[k] = (p[k].detach()
                    - h.learning_rate * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + h.adam_eps))
        p.update(new_stats)
        stats.append(st)
    return p, Adam(opt.count + rows.shape[0], m, v), torch.stack(stats), first_grad


def epoch_permutations(generator: torch.Generator, n: int, n_epochs: int) -> torch.Tensor:
    """``n_epochs`` uniform permutations of ``range(n)``, drawn one after the
    other with ``torch.randperm`` from ``generator``."""
    return torch.stack([torch.randperm(n, generator=generator) for _ in range(n_epochs)])
