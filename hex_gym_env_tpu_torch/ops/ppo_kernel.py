"""K6: the whole epochs x minibatches PPO sweep as one CUDA kernel.

The counterpart of the JAX package's ``ops/pallas_ppo.py``.  One
cooperative launch runs every grad step of a sweep (``csrc/learner_kernels.cu``
``ppo_kernel``; its note gives the design and the bound): per step the
forward of both towers, the masked-PPO loss with the minibatch's ddof=1
advantage normalisation, the hand-derived backward, optax's global-norm
clip and Adam, and 8 stats ``[policy_loss, value_loss, entropy, approx_kl,
clip_frac, 0, 0, 0]``.

It works on the port's own packing (``policy_kernel.PolicyOps.pack_agent``:
separate pi and vf towers, kernels (in, out)), with the Adam moments packed
the same way, and reads minibatch rows through an index array from the
ungathered ``obs`` (n, F) int8 and ``flt`` (n, 4) ``[action, logp_old, adv,
ret]``; the legal mask is ``obs == 0`` (the ``PPOBatch`` invariant), so
``batch.legal`` is never read.

``sweep_twin`` is the kernel's math in plain PyTorch — forward, the hand
backward, clip and Adam on the flat packed vectors, rows gathered by index —
so the hand backward is checked on the CPU against autograd and JAX.
Two entries, as in the JAX package:

- ``make_kernel_update_fn``: the exact stream, ``n_epochs`` permutations of
  ``train/ppo.epoch_permutations`` cut into (G, mb) index rows;
- ``make_kernel_fast_update_fn``: the same kernel fed ``fast_schedule``, one
  row shuffle per sweep and a fresh block visit order per epoch.

Both take the kernel for a CUDA batch and the twin for a CPU batch under
``impl="auto"``; ``"pallas"`` pins the kernel (raises on a CPU tensor).
"""

from __future__ import annotations

from typing import Optional

import torch

from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.ops import masked as masked_ops
from hex_gym_env_tpu_torch.ops import policy_kernel as pk
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.utils.config import PPOConfig

N_STATS = 8  # [policy_loss, value_loss, entropy, approx_kl, clip_frac, 0, 0, 0]
# the kernel's phase clock: a start stamp and one stamp per phase of a grad step
PPO_PHASES = ("prologue", "forward", "loss", "backward", "sync 1", "reduce", "sync 2", "adam",
              "sync 3")
PPO_MARKS = len(PPO_PHASES) + 1


def supported_policy(model) -> bool:
    """True for a plain equal-tower MLP of one hidden width (tanh or relu)."""
    return pk.supported(model)


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------


def _act_grad(d: pk.MlpDims):
    if d.relu:
        return lambda h: (h > 0.0).to(torch.float32)
    return lambda h: 1.0 - h * h


def _tower_forward(views, x, d: pk.MlpDims):
    act = pk._act(d)
    hs = [x]
    for W, b in views[:-1]:
        hs.append(act(hs[-1] @ W + b))
    W, b = views[-1]
    return hs, hs[-1] @ W + b


def _tower_backward(views, hs, dout, d: pk.MlpDims) -> torch.Tensor:
    """The tower's gradient as one flat run in its packed layout."""
    act_grad = _act_grad(d)
    W, _ = views[-1]
    grads = [hs[-1].T @ dout, dout.sum(0)]
    dh = dout @ W.T
    for l in reversed(range(d.n_layers)):
        dz = dh * act_grad(hs[l + 1])
        grads = [hs[l].T @ dz, dz.sum(0)] + grads
        if l > 0:
            dh = dz @ views[l][0].T
    return torch.cat([g.reshape(-1) for g in grads])


def grad_step_twin(p, d: pk.MlpDims, cfg: PPOConfig, obs, flt):
    """Loss stats and flat gradient of one minibatch, by hand: the
    ``(grad (S,), stats (N_STATS,))`` of the kernel's phases 1-2."""
    mb, A = obs.shape[0], d.A
    split = pk.tower_size(d, A)
    pi = pk.tower_views(p[:split], d, A)
    vf = pk.tower_views(p[split:], d, 1)
    x = obs.to(torch.float32)
    legal = x == 0.0
    a = flt[:, 0].long()
    lp_old, adv_raw, ret = flt[:, 1], flt[:, 2], flt[:, 3]

    hs_pi, logits = _tower_forward(pi, x, d)
    hs_vf, value = _tower_forward(vf, x, d)
    value = value[:, 0]

    masked = masked_ops.mask_logits(logits, legal)
    z = masked - masked.max(dim=-1, keepdim=True).values
    ez = torch.exp(z)
    sum_ez = ez.sum(dim=-1, keepdim=True)
    lse = torch.log(sum_ez)
    logp = z - lse
    prob = ez / sum_ez
    lp_a = logp.gather(1, a[:, None])[:, 0]

    mean = adv_raw.sum() / mb
    var = ((adv_raw - mean) ** 2).sum() / (mb - 1)
    adv = (adv_raw - mean) / (torch.sqrt(var) + ppo.ADV_EPS)

    clip = cfg.clip_range
    log_ratio = lp_a - lp_old
    ratio = torch.exp(log_ratio)
    unclipped = adv * ratio
    clipped = adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    policy_loss = -torch.minimum(unclipped, clipped).sum() / mb
    err = value - ret
    value_loss = (err * err).sum() / mb
    ent_terms = torch.where(legal, prob * logp, torch.zeros_like(logp))
    ent = -ent_terms.sum(dim=-1)
    entropy = ent.sum() / mb
    approx_kl = (ratio - 1.0 - log_ratio).sum() / mb
    clip_frac = (torch.abs(ratio - 1.0) > clip).to(torch.float32).sum() / mb

    # d(policy_loss)/d(lp_a) flows through min's active branch; the clipped
    # branch has zero slope outside the clip interval
    in_bounds = (ratio > 1.0 - clip) & (ratio < 1.0 + clip)
    active = (unclipped <= clipped) | in_bounds
    dlp_a = -torch.where(active, adv * ratio, torch.zeros_like(ratio)) / mb
    onehot = torch.nn.functional.one_hot(a, A).to(torch.float32)
    dmasked = dlp_a[:, None] * (onehot - prob)
    if cfg.ent_coef != 0.0:
        dmasked = dmasked + (cfg.ent_coef / mb) * prob * (logp + ent[:, None])
    dlogits = torch.where(legal, dmasked, torch.zeros_like(dmasked))
    dvalue = (cfg.vf_coef * 2.0 / mb) * err

    grad = torch.cat([
        _tower_backward(pi, hs_pi, dlogits, d),
        _tower_backward(vf, hs_vf, dvalue[:, None], d),
    ])
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    stats = torch.stack([policy_loss, value_loss, entropy, approx_kl, clip_frac, zero, zero, zero])
    return grad, stats


def sweep_twin(p, m, v, d: pk.MlpDims, cfg: PPOConfig, obs, flt, rows, bias):
    """Plain PyTorch K6 over the (G, mb) index ``rows``: returns
    ``(p', m', v', stats (G, N_STATS))``."""
    stats = []
    for step in range(rows.shape[0]):
        r = rows[step].long()
        grad, st = grad_step_twin(p, d, cfg, obs[r], flt[r])
        scale = ppo.clip_scale(torch.sqrt((grad * grad).sum()), cfg.max_grad_norm)
        bc1, bc2 = bias[step].tolist()
        p, m, v = ppo.adam_update(p, grad * scale, m, v, bc1, bc2, cfg)
        stats.append(st)
    return p, m, v, torch.stack(stats)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _sweep_cuda(p, m, v, d: pk.MlpDims, cfg: PPOConfig, obs, flt, idx, order, bias, timers=None):
    n, F = obs.shape
    G = bias.shape[0]
    mbs = cfg.minibatch_size
    S = pk.tower_size(d, d.A) + pk.tower_size(d, 1)
    chk = cuda_lib.check_cuda
    obs = chk("obs", obs, torch.int8, (n, F))
    flt = chk("flt", flt, torch.float32, (n, 4))
    if order is None:
        idx = chk("idx", idx, torch.int32, (G, mbs))
    else:
        idx = chk("rowperm", idx, torch.int32, (n // mbs * mbs,))
        order = chk("order", order, torch.int32, (G,))
    bias = chk("bias", bias, torch.float32, (G, 2))
    p, m, v = (chk(name, t, torch.float32, (S,)).clone() for name, t in (("p", p), ("m", m), ("v", v)))
    grid, R, smem, resident, ppad = cuda_lib.ppo_plan(d.F, d.H, d.A, d.n_layers, mbs)
    if timers is not None:
        timers = chk("timers", timers, torch.int64, (grid, G, PPO_MARKS))
    dev = obs.device
    stats = torch.empty((G, N_STATS), dtype=torch.float32, device=dev)
    # per-CTA gradient slots, stat slots, slice sums of squares, the reduced
    # gradient, per-step advantage statistics, the padded parameter image
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in ((grid, S), (grid, 8), (grid,), (S,), (G, 2), (ppad,))]
    c = cfg.clip_range
    ptr = cuda_lib.ptr
    cuda_lib.launch(
        "k6_ppo", "hex_ppo",
        ptr(obs), ptr(flt), ptr(idx), ptr(order), ptr(bias), ptr(p), ptr(m), ptr(v), ptr(stats),
        *map(ptr, scratch),
        d.F, d.H, d.A, d.n_layers, int(d.relu), mbs, G,
        cfg.learning_rate, c, 1.0 - c, 1.0 + c, cfg.ent_coef / mbs, cfg.vf_coef * 2.0 / mbs,
        cfg.max_grad_norm, cfg.adam_eps, grid, R, smem, resident, ptr(timers),
    )
    return p, m, v, stats


def sweep(pol: pk.PolicyOps, cfg: PPOConfig, p, m, v, obs, flt, idx, bias, order=None,
          timers=None):
    """One sweep on packed vectors: the kernel or the twin by ``pol.impl``
    and the batch's device.  ``idx`` is (G, mb) rows, or with ``order`` the
    (n,) row permutation whose ``order[g]``-th mb-block is step g's rows.
    ``timers``, for the kernel only, is an int64 (grid, G, ``PPO_MARKS``)
    buffer (grid from ``cuda_lib.ppo_plan``) that receives its phase clock
    (``utils/profiling.phase_split`` reads it)."""
    if pk.use_kernel(obs, pol.impl):
        return _sweep_cuda(p, m, v, pol.dims, cfg, obs, flt, idx, order, bias, timers)
    rows = idx if order is None else idx.reshape(-1, cfg.minibatch_size)[order.long()]
    return sweep_twin(p, m, v, pol.dims, cfg, obs, flt, rows, bias)


def batch_streams(batch: ppo.PPOBatch):
    """The kernel's two row streams: obs (n, F) int8 and flt (n, 4)
    ``[action, logp_old, adv, ret]`` (the action is exact in float32)."""
    n = batch.action.shape[0]
    obs = batch.obs.reshape(n, -1).to(torch.int8).contiguous()
    flt = torch.stack(
        [batch.action.to(torch.float32), batch.log_prob_old, batch.advantage, batch.ret], dim=1
    ).contiguous()
    return obs, flt


def _run(pol: pk.PolicyOps, cfg: PPOConfig, params, opt_state: ppo.AdamState, batch, idx, order):
    obs, flt = batch_streams(batch)
    G = idx.shape[0] if order is None else order.shape[0]
    dev = obs.device
    bias = ppo.bias_corrections(opt_state.count, G, dev)
    p, m, v, stats = sweep(
        pol, cfg, pol.pack_agent(params), pol.pack_agent(opt_state.mu),
        pol.pack_agent(opt_state.nu), obs, flt, idx.to(dev, torch.int32).contiguous(), bias,
        None if order is None else order.to(dev, torch.int32).contiguous(),
    )
    new_state = ppo.AdamState(count=opt_state.count + G, mu=pol.unpack_agent(m),
                              nu=pol.unpack_agent(v))
    return pol.unpack_agent(p), new_state, ppo.mean_stats(stats)


def _check_model(model):
    if not supported_policy(model):
        raise ValueError(
            "the PPO sweep kernel packs plain equal-width pi/vf MLP towers; got "
            f"{type(model).__name__}"
        )


def make_kernel_update_fn(model, cfg: PPOConfig, impl: str = "auto"):
    """The counterpart of ``make_pallas_update_fn``: same signature as
    ``train/ppo.make_update_fn``'s update, same permutation stream, one K6
    launch (or its twin) per call."""
    _check_model(model)
    pol = pk.PolicyOps(model, impl)

    def update(params, opt_state: ppo.AdamState, batch: ppo.PPOBatch,
               generator: Optional[torch.Generator] = None, perms=None):
        n = batch.action.shape[0]
        if perms is None:
            perms = ppo.epoch_permutations(generator, n, cfg.n_epochs)
        idx = ppo.minibatch_indices(perms, n, cfg.minibatch_size)
        return _run(pol, cfg, params, opt_state, batch, idx, None)

    return update


def fast_schedule(generator: torch.Generator, n: int, mbs: int, n_epochs: int):
    """The ``pallas-fast`` minibatch schedule: ONE uniform row permutation
    per sweep, cut into ``n // mbs`` blocks, plus a fresh random visit order
    of those blocks per epoch.  Minibatch composition is fixed across the
    epochs of one update (fresh every update); only the visit order varies —
    the documented deviation from SB3's per-epoch full reshuffle.

    Returns ``(rowperm (n,), order (n_epochs * n // mbs,))``, int32."""
    rowperm = ppo.epoch_permutations(generator, n, 1)[0]
    order = ppo.epoch_permutations(generator, n // mbs, n_epochs).reshape(-1)
    return rowperm, order


def make_kernel_fast_update_fn(model, cfg: PPOConfig, impl: str = "auto"):
    """``update_impl='pallas-fast'``: the same kernel fed ``fast_schedule``
    (or an injected ``rowperm``/``order``)."""
    _check_model(model)
    pol = pk.PolicyOps(model, impl)

    def update(params, opt_state: ppo.AdamState, batch: ppo.PPOBatch,
               generator: Optional[torch.Generator] = None, rowperm=None, order=None):
        n = batch.action.shape[0]
        if rowperm is None:
            rowperm, order = fast_schedule(generator, n, cfg.minibatch_size, cfg.n_epochs)
        n_mb = n // cfg.minibatch_size
        return _run(pol, cfg, params, opt_state, batch, rowperm[: n_mb * cfg.minibatch_size],
                    order)

    return update


def resolve(model, cfg: PPOConfig):
    """``PPOConfig.update_impl`` -> an update function.  "lax" the autograd
    path; "pallas" K6 (raising on a CPU batch); "auto" K6 on a CUDA batch and
    the twin on a CPU batch for a supported MLP, else the autograd path;
    "pallas-fast" K6 or its twin fed ``fast_schedule``."""
    impl = cfg.update_impl
    if impl not in ("auto", "lax", "pallas", "pallas-fast"):
        raise ValueError(
            f"update_impl must be one of 'auto'/'lax'/'pallas'/'pallas-fast', got {impl!r}"
        )
    if impl in ("pallas", "pallas-fast") and not supported_policy(model):
        raise ValueError(f"update_impl={impl!r} requires a plain equal-tower MLP policy")
    if impl == "pallas-fast":
        return make_kernel_fast_update_fn(model, cfg)
    if impl == "pallas" or (impl == "auto" and supported_policy(model)):
        return make_kernel_update_fn(model, cfg, impl)
    return ppo.make_update_fn(model, cfg)
