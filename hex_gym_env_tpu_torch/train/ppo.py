"""Maskable PPO learner.

The counterpart of the JAX package's ``train/ppo.py``, with SB3 PPO
semantics (the reference trains with stock ``MaskablePPO``): clipped
surrogate objective over the masked categorical, per-minibatch advantage
normalization with the unbiased std, unclipped value MSE, entropy bonus
(coefficient 0 by default), and optax's ``chain(clip_by_global_norm,
adam(eps=1e-5))`` written out here:

- ``clip_scale``: 1 if ``gnorm < max_norm``, else ``max_norm / gnorm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``gnorm + 1e-6`` instead);
- ``adam_update``: ``scale_by_adam(b1=0.9, b2=0.999, eps)`` with a carried
  ``count`` and the update ``-lr * m_hat / (sqrt(v_hat) + eps)``.

The optimizer state is an ``AdamState`` over the state-dict names of the
model's trained parameters (``trainable_keys``): a CNN's BatchNorm running
statistics are buffers, carried but not trained.  ``make_update_fn`` is the
plain path: autograd through ``torch.func.functional_call``, one minibatch
at a time; a model with buffers runs with ``train=True`` there, and its new
running statistics carry from minibatch to minibatch and out of the sweep,
as the JAX package's ``batch_stats`` do.  The fused sweep kernel K6 and its
twin live in ``ops/ppo_kernel.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from hex_gym_env_tpu_torch.models.cnn import CnnPolicy, full_float32
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.utils.config import PPOConfig

Params = Dict[str, torch.Tensor]

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADV_EPS = 1e-8


class PPOBatch(NamedTuple):
    """Flattened rollout data, leading axis = T*B.

    Invariant: ``legal == (obs.reshape(n, A) == 0)`` — in Hex every empty
    mover-frame cell is a legal move and vice versa.  The rollout producer
    guarantees this, and the sweep kernel K6 RELIES on it: it re-derives the
    mask in-kernel as ``obs == 0`` and never reads ``legal``
    (``ops/ppo_kernel.py``).  A producer whose ``legal`` deviated from
    ``obs == 0`` would diverge from the plain path.
    """

    obs: torch.Tensor  # (n, N, N) int8
    legal: torch.Tensor  # (n, A) bool — MUST equal (obs == 0) flattened
    action: torch.Tensor  # (n,) int32
    log_prob_old: torch.Tensor  # (n,)
    value_old: torch.Tensor  # (n,)
    advantage: torch.Tensor  # (n,)
    ret: torch.Tensor  # (n,)


class PPOStats(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    clip_frac: torch.Tensor


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: steps taken and the two moments."""

    count: int
    mu: Params
    nu: Params


def init_adam(params: Params) -> AdamState:
    """Zero moments over ``params`` (the trained ones: ``trainable_keys``)."""
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(count=0, mu=zeros, nu={k: v.clone() for k, v in zeros.items()})


def trainable_keys(model) -> tuple:
    """The state-dict names of ``model``'s trained parameters; the rest of
    its state dict (a CNN's BatchNorm statistics) are buffers."""
    return tuple(name for name, _ in model.named_parameters())


def bias_corrections(count0: int, n_steps: int, device=None) -> torch.Tensor:
    """(n_steps, 2) float32 ``[1 - b1**t, 1 - b2**t]`` for ``t = count0 + 1 ...``:
    the Adam bias corrections of each step, computed in float64 and rounded
    once, so the plain path, the twin and the kernel divide by the same
    numbers."""
    rows = [
        (1.0 - math.pow(ADAM_B1, t), 1.0 - math.pow(ADAM_B2, t))
        for t in range(count0 + 1, count0 + n_steps + 1)
    ]
    return torch.tensor(rows, dtype=torch.float32, device=device).reshape(n_steps, 2)


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``'s factor: 1 below ``max_norm``, else
    ``max_norm / gnorm``."""
    return torch.where(gnorm < max_norm, torch.ones_like(gnorm), max_norm / gnorm)


def adam_update(p, g, m, v, bc1, bc2, cfg: PPOConfig):
    """One Adam step on one tensor (``g`` already clipped); returns
    ``(p', m', v')``."""
    m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
    v = ADAM_B2 * v + (1.0 - ADAM_B2) * (g * g)
    return p - cfg.learning_rate * (m / bc1) / (torch.sqrt(v / bc2) + cfg.adam_eps), m, v


def make_loss_fn(model, cfg: PPOConfig):
    """The PPO minibatch loss ``loss_fn(params, mb) -> (loss, PPOStats)``."""
    train_loss = make_train_loss_fn(model, cfg)

    def loss_fn(params: Params, mb: PPOBatch):
        return train_loss(params, mb)[:2]

    return loss_fn


def make_train_loss_fn(model, cfg: PPOConfig):
    """The PPO minibatch loss with the model's new buffers:
    ``loss_fn(params, mb) -> (loss, PPOStats, new_buffers)``.  A model with
    buffers (a CNN's BatchNorm) runs with ``train=True``, normalising with
    the minibatch's statistics; ``new_buffers`` are its updated running
    statistics ({} for an MLP)."""
    has_buffers = any(True for _ in model.named_buffers())

    def loss_fn(params: Params, mb: PPOBatch):
        obs = mb.obs.to(torch.float32)
        if has_buffers:
            logits, values, new_buffers = torch.func.functional_call(
                model, params, (obs,), {"train": True})
        else:
            (logits, values), new_buffers = torch.func.functional_call(model, params, (obs,)), {}
        log_prob = masked.log_prob(logits, mb.legal, mb.action)
        entropy = masked.entropy(logits, mb.legal)

        # SB3 normalizes per minibatch with torch.Tensor.std(): Bessel's
        # correction (ddof=1)
        adv = mb.advantage
        adv = (adv - adv.mean()) / (adv.std() + ADV_EPS)

        ratio = torch.exp(log_prob - mb.log_prob_old)
        unclipped = adv * ratio
        clipped = adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
        policy_loss = -torch.mean(torch.minimum(unclipped, clipped))

        value_loss = torch.mean((mb.ret - values) ** 2)
        entropy_loss = -torch.mean(entropy)

        loss = policy_loss + cfg.ent_coef * entropy_loss + cfg.vf_coef * value_loss

        log_ratio = log_prob - mb.log_prob_old
        approx_kl = torch.mean(torch.exp(log_ratio) - 1.0 - log_ratio)
        clip_frac = torch.mean((torch.abs(ratio - 1.0) > cfg.clip_range).to(torch.float32))
        stats = PPOStats(policy_loss, value_loss, -entropy_loss, approx_kl, clip_frac)
        return loss, PPOStats(*(s.detach() for s in stats)), new_buffers

    return loss_fn


def epoch_permutations(generator: torch.Generator, n: int, n_epochs: int) -> torch.Tensor:
    """``(n_epochs, n)`` int32 — one uniform permutation of ``range(n)`` per
    epoch, drawn on the generator's device.  The stream every sweep backend
    reads its minibatch indices from; SB3's contract is a fresh uniform full
    reshuffle per epoch."""
    return torch.stack(
        [torch.randperm(n, generator=generator, device=generator.device) for _ in range(n_epochs)]
    ).to(torch.int32)


def minibatch_indices(perms: torch.Tensor, n: int, mbs: int) -> torch.Tensor:
    """(G, mbs) row indices of the sweep's grad steps in visit order; the
    tail rows past ``n // mbs`` minibatches are dropped."""
    n_mb = n // mbs
    return perms[:, : n_mb * mbs].reshape(-1, mbs)


def mean_stats(stats: torch.Tensor) -> PPOStats:
    """(G, >=5) per-step stats -> their means as ``PPOStats``."""
    mean = stats.mean(dim=0)
    return PPOStats(*(mean[i] for i in range(len(PPOStats._fields))))


def make_update_fn(model, cfg: PPOConfig, grad_reduce: Optional[Callable] = None):
    """Build ``update(params, opt_state, batch, generator, perms=None) ->
    (params', opt_state', stats)`` running ``n_epochs`` shuffled sweeps of
    minibatch SGD.

    ``perms`` (n_epochs, n) replaces the generator's permutations.
    ``grad_reduce`` (optional) is applied to the gradient dict before the
    clip — the data-parallel hook (an all-reduce mean across replicas keeps
    their parameters bitwise replicated).

    Only ``trainable_keys(model)`` are differentiated and stepped; the other
    entries of ``params`` (a CNN's BatchNorm statistics) are replaced by the
    loss's new buffers after each minibatch.  A CNN's steps run inside
    ``full_float32``, forward and backward."""
    loss_fn = make_train_loss_fn(model, cfg)
    keys = trainable_keys(model)
    scope = full_float32 if isinstance(model, CnnPolicy) else contextlib.nullcontext

    def update(params: Params, opt_state: AdamState, batch: PPOBatch,
               generator: Optional[torch.Generator] = None, perms=None):
        n = batch.action.shape[0]
        if perms is None:
            perms = epoch_permutations(generator, n, cfg.n_epochs)
        idx = minibatch_indices(perms.to(batch.action.device).long(), n, cfg.minibatch_size)
        bc = bias_corrections(opt_state.count, idx.shape[0]).tolist()
        p = {k: v.detach() for k, v in params.items()}
        mu, nu = dict(opt_state.mu), dict(opt_state.nu)
        stats = []
        with scope():
            for step, rows in enumerate(idx):
                mb = PPOBatch(*(x[rows] for x in batch))
                leaves = {k: p[k].requires_grad_() for k in keys}
                loss, st, new_buffers = loss_fn(p, mb)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                if grad_reduce is not None:
                    grads = grad_reduce(grads)
                gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                scale = clip_scale(gnorm, cfg.max_grad_norm)
                bc1, bc2 = bc[step]
                for k in keys:
                    p[k], mu[k], nu[k] = adam_update(
                        p[k].detach(), grads[k] * scale, mu[k], nu[k], bc1, bc2, cfg)
                p.update(new_buffers)
                stats.append(torch.stack(list(st)))
        new_state = AdamState(count=opt_state.count + idx.shape[0], mu=mu, nu=nu)
        return p, new_state, mean_stats(torch.stack(stats))

    return update
