"""The port's PPO learner against the JAX package.

The same numpy-made batch, flax-initialised weights, JAX permutations and
schedules, and optax Adam states (converted with ``models/convert.py``) go
to the JAX update functions (the lax/optax path, and the fused Pallas sweep
in interpret mode) and to the port's autograd path (``train/ppo``) and its
K6 twin (``ops/ppo_kernel.sweep_twin``, the hand backward).  Tolerances are
the JAX package's own pallas==lax bar (``tests/test_pallas_ppo.py``):
params and Adam moments rtol 2e-4, atol 1e-6; stats within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
from hex_gym_env_tpu.models import MlpPolicy as JaxMlpPolicy
from hex_gym_env_tpu.ops import pallas_ppo
from hex_gym_env_tpu.train import ppo as jppo
from hex_gym_env_tpu.utils.config import PPOConfig as JaxPPOConfig

from hex_gym_env_tpu_torch.models.convert import flax_state_dict, optax_adam_to_torch
from hex_gym_env_tpu_torch.models.mlp import MlpPolicy
from hex_gym_env_tpu_torch.ops import policy_kernel as pk
from hex_gym_env_tpu_torch.ops import ppo_kernel
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.utils.config import PPOConfig

N = 5
A = N * N
RTOL, ATOL, STATS_TOL = 2e-4, 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n, seed=0):
    """A JAX ``PPOBatch`` honouring ``legal == (obs == 0)``."""
    rng = np.random.default_rng(seed)
    boards = rng.choice(np.array([-1, 0, 1], np.int8), size=(n, N, N))
    boards.reshape(n, A)[np.arange(n), rng.integers(0, A, n)] = 0
    legal = boards.reshape(n, A) == 0
    u = rng.random((n, A))
    actions = np.argmax(np.where(legal, u, -1.0), axis=1).astype(np.int32)
    return jppo.PPOBatch(
        obs=jnp.asarray(boards, jnp.int8),
        legal=jnp.asarray(legal),
        action=jnp.asarray(actions),
        log_prob_old=jnp.asarray(rng.normal(-2.5, 0.3, n).astype(np.float32)),
        value_old=jnp.asarray(rng.normal(0, 0.5, n).astype(np.float32)),
        advantage=jnp.asarray(rng.normal(0, 1.0, n).astype(np.float32)),
        ret=jnp.asarray(rng.normal(0, 0.7, n).astype(np.float32)),
    )


def _port_batch(batch):
    return ppo.PPOBatch(*(torch.from_numpy(np.array(x)) for x in batch))


def _models(layers, activation):
    jmodel = JaxMlpPolicy(n_actions=A, pi_layers=layers, vf_layers=layers,
                          activation=nn.relu if activation == "relu" else nn.tanh)
    return jmodel, MlpPolicy(A, layers, layers, activation)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params(got: dict, want_flax, rtol=RTOL, atol=ATOL, what="params"):
    want = flax_state_dict(_np(want_flax))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} diverge at {k}")


def _assert_opt(got: ppo.AdamState, want_opt):
    adam = want_opt[1][0]
    assert got.count == int(adam.count)
    _assert_params(got.mu, adam.mu, what="adam mu")
    _assert_params(got.nu, adam.nu, what="adam nu")


def _assert_stats(got, want):
    for name in jppo.PPOStats._fields:
        assert abs(float(getattr(got, name)) - float(getattr(want, name))) < STATS_TOL, name


def _warm_opt_state(jmodel, cfg, variables):
    """An optax state with non-zero moments and count (two lax updates)."""
    optimizer = jppo.make_optimizer(cfg)
    opt_state = optimizer.init(variables["params"])
    update = jax.jit(jppo.make_update_fn(jmodel, JaxPPOConfig(minibatch_size=64, n_epochs=1),
                                         optimizer))
    _, opt_state, _ = update(variables, opt_state, _batch(128, seed=42), jax.random.key(99))
    return opt_state


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
def test_loss_autograd_and_hand_backward_match_jax_grad(ent_coef):
    jmodel, model = _models((64, 64), "tanh")
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, N, N), jnp.float32))
    cfg = JaxPPOConfig(ent_coef=ent_coef)
    mb = _batch(64, seed=1)
    (jloss, (jstats, _)), jgrads = jax.value_and_grad(
        jppo.make_loss_fn(jmodel, cfg), has_aux=True)(variables["params"], {}, mb)

    pcfg = PPOConfig(ent_coef=ent_coef)
    params = {k: v.requires_grad_() for k, v in flax_state_dict(_np(variables)).items()}
    loss, stats = ppo.make_loss_fn(model, pcfg)(params, _port_batch(mb))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-6
    _assert_stats(stats, jstats)
    want = flax_state_dict(_np(jgrads))
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"autograd grad {k}")

    # the K6 twin's hand backward on the packed weights
    pol = pk.PolicyOps(model)
    pb = _port_batch(mb)
    obs, flt = ppo_kernel.batch_streams(pb)
    hand, hstats = ppo_kernel.grad_step_twin(
        pol.pack_agent({k: v.detach() for k, v in params.items()}), pol.dims, pcfg, obs, flt)
    np.testing.assert_allclose(hand.numpy(), pol.pack_agent(want).numpy(), rtol=0, atol=1e-6)
    for i, name in enumerate(jppo.PPOStats._fields):
        assert abs(float(hstats[i]) - float(getattr(jstats, name))) < 1e-6, name
    assert not hstats[5:].any()


CONFIGS = [((64, 64), "tanh", 2, 0.0), ((32, 32, 32), "relu", 1, 0.0), ((64, 64), "tanh", 1, 0.01)]


@functools.lru_cache(maxsize=None)
def _jax_sweeps(layers, activation, n_epochs, ent_coef):
    """Inputs and the JAX lax and Pallas (interpret) updates, once per config."""
    jmodel, _ = _models(layers, activation)
    cfg = JaxPPOConfig(minibatch_size=64, n_epochs=n_epochs, ent_coef=ent_coef)
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, N, N), jnp.float32))
    opt_state = _warm_opt_state(jmodel, cfg, variables)
    batch = _batch(256)  # 4 minibatches per epoch
    key = jax.random.key(11)
    lax = jax.jit(jppo.make_update_fn(jmodel, cfg, jppo.make_optimizer(cfg)))(
        variables, opt_state, batch, key)
    pallas = jax.jit(pallas_ppo.make_pallas_update_fn(jmodel, cfg, interpret=True))(
        variables, opt_state, batch, key)
    perms = np.array(jppo.epoch_permutations(key, 256, n_epochs))
    return variables, opt_state, batch, perms, lax, pallas


@pytest.mark.parametrize("path", ["lax", "twin"])
@pytest.mark.parametrize("layers,activation,n_epochs,ent_coef", CONFIGS)
def test_update_matches_jax(layers, activation, n_epochs, ent_coef, path):
    """Port autograd path == JAX lax/optax update; K6 twin == the Pallas
    sweep in interpret mode; same permutations, non-zero starting moments."""
    variables, opt_state, batch, perms, lax, pallas = _jax_sweeps(
        layers, activation, n_epochs, ent_coef)
    _, model = _models(layers, activation)
    cfg = PPOConfig(minibatch_size=64, n_epochs=n_epochs, ent_coef=ent_coef)
    if path == "lax":
        update, want = ppo.make_update_fn(model, cfg), lax
    else:
        update, want = ppo_kernel.make_kernel_update_fn(model, cfg), pallas
    params, opt, stats = update(
        flax_state_dict(_np(variables)), optax_adam_to_torch(_np(opt_state)), _port_batch(batch),
        perms=torch.from_numpy(perms))
    _assert_params(params, want[0]["params"])
    _assert_opt(opt, want[1])
    _assert_stats(stats, want[2])


def test_adam_count_carries_across_calls():
    jmodel, model = _models((64, 64), "tanh")
    cfg = JaxPPOConfig(minibatch_size=128, n_epochs=1)
    n = 256
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, N, N), jnp.float32))
    optimizer = jppo.make_optimizer(cfg)
    j_update = jax.jit(jppo.make_update_fn(jmodel, cfg, optimizer))
    t_update = ppo_kernel.make_kernel_update_fn(model, PPOConfig(minibatch_size=128, n_epochs=1))

    v_j, o_j = variables, optimizer.init(variables["params"])
    params, opt = flax_state_dict(_np(variables)), ppo.init_adam(flax_state_dict(_np(variables)))
    for i in range(3):
        batch = _batch(n, seed=i)
        key = jax.random.key(100 + i)
        v_j, o_j, _ = j_update(v_j, o_j, batch, key)
        perms = torch.from_numpy(np.array(jppo.epoch_permutations(key, n, 1)))
        params, opt, _ = t_update(params, opt, _port_batch(batch), perms=perms)
    assert opt.count == int(o_j[1][0].count) == 6  # 3 calls x 2 minibatches
    _assert_params(params, v_j["params"], rtol=5e-4, atol=2e-6)


def test_fast_entry_matches_jax_fast_sweep():
    jmodel, model = _models((64, 64), "tanh")
    cfg = JaxPPOConfig(minibatch_size=64, n_epochs=3)
    n = 256
    variables = jmodel.init(jax.random.key(5), jnp.zeros((1, N, N), jnp.float32))
    opt_state = jppo.make_optimizer(cfg).init(variables["params"])
    batch = _batch(n, seed=9)
    key = jax.random.key(21)
    v_f, o_f, s_f = jax.jit(pallas_ppo.make_pallas_fast_update_fn(jmodel, cfg, interpret=True))(
        variables, opt_state, batch, key)
    rowperm, order = pallas_ppo.fast_schedule(key, n, 64, 3)

    update = ppo_kernel.make_kernel_fast_update_fn(model, PPOConfig(minibatch_size=64, n_epochs=3))
    params, opt, stats = update(
        flax_state_dict(_np(variables)), optax_adam_to_torch(_np(opt_state)), _port_batch(batch),
        rowperm=torch.from_numpy(np.array(rowperm)), order=torch.from_numpy(np.array(order)))
    assert opt.count == len(np.asarray(order)) == 12
    _assert_params(params, v_f["params"])
    _assert_opt(opt, o_f)
    _assert_stats(stats, s_f)


def test_schedules_are_permutations_and_partitions():
    g = torch.Generator().manual_seed(3)
    perms = ppo.epoch_permutations(g, 512, 6)
    assert perms.shape == (6, 512) and perms.dtype == torch.int32
    for row in perms:
        assert torch.equal(row.sort().values, torch.arange(512, dtype=torch.int32))
    assert len({tuple(r.tolist()) for r in perms}) == 6
    again = ppo.epoch_permutations(torch.Generator().manual_seed(3), 512, 6)
    assert torch.equal(perms, again)

    rowperm, order = ppo_kernel.fast_schedule(torch.Generator().manual_seed(0), 512, 64, 4)
    assert sorted(rowperm.tolist()) == list(range(512))
    o = order.reshape(4, 8)
    for e in range(4):
        assert sorted(o[e].tolist()) == list(range(8))
    idx = ppo.minibatch_indices(perms, 500, 64)  # tail rows past 7 minibatches dropped
    assert idx.shape == (6 * 7, 64)


@pytest.mark.parametrize("excess", [1e-6, -5e-7])
def test_clip_is_optax_not_clip_grad_norm(excess):
    """Just above ``max_norm`` optax scales by max/gnorm and
    ``clip_grad_norm_`` by max/(gnorm + 1e-6); just below it optax leaves the
    gradient alone while ``clip_grad_norm_`` still shrinks it.  The port's
    clip is optax's."""
    max_norm = 0.5
    g = np.array([0.3, 0.4], np.float32) * np.float32(1.0 + excess)
    want, _ = optax.clip_by_global_norm(max_norm).update({"g": jnp.asarray(g)}, optax.EmptyState())
    gt = torch.from_numpy(g)
    port = gt * ppo.clip_scale(torch.sqrt((gt * gt).sum()), max_norm)
    np.testing.assert_allclose(port.numpy(), np.asarray(want["g"]), rtol=2e-7, atol=0)
    torch_clip = torch.from_numpy(g.copy()).requires_grad_()
    torch_clip.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_([torch_clip], max_norm)
    assert not np.allclose(torch_clip.grad.numpy(), np.asarray(want["g"]), rtol=5e-7, atol=0)


def test_update_gate_and_pinned_kernel():
    _, model = _models((64, 64), "tanh")
    assert ppo_kernel.supported_policy(model)
    assert not ppo_kernel.supported_policy(MlpPolicy(A, (64, 32), (64, 32)))
    cfg = PPOConfig(minibatch_size=64, n_epochs=1)
    assert ppo_kernel.resolve(model, cfg).__qualname__.startswith("make_kernel_update_fn")
    lax_cfg = PPOConfig(minibatch_size=64, n_epochs=1, update_impl="lax")
    assert ppo_kernel.resolve(model, lax_cfg).__qualname__.startswith("make_update_fn")
    with pytest.raises(ValueError, match="update_impl"):
        ppo_kernel.resolve(model, PPOConfig(update_impl="fast"))
    with pytest.raises(ValueError, match="equal-tower"):
        ppo_kernel.resolve(MlpPolicy(A, (64, 32), (64, 32)), PPOConfig(update_impl="pallas"))
    pinned = ppo_kernel.resolve(model, PPOConfig(minibatch_size=64, n_epochs=1,
                                                 update_impl="pallas"))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="pallas"):
        pinned(params, ppo.init_adam(params), _port_batch(_batch(64)),
               torch.Generator().manual_seed(0))
