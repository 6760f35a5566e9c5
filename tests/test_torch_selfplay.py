"""The port's ``SelfplayPPO`` and ``Evaluator`` on the CPU, with counterparts
of the JAX package's ``tests/test_train.py``, and the eval pass and the pool
update held against the JAX package on the same inputs: the fused eval from
the same post-opening state and random bits must give exactly the same
(E,) rewards as ``fused_rollout(eval_mode=True, interpret=True)``, and
``apply_pool_update`` the same bank (scores within 1e-6: ``exp`` is a
library call on either side)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.topology import get_topology as jax_get_topology
from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.ops import pallas_rollout as jpr
from hex_gym_env_tpu.train.bank import OpponentBank as JaxBank
from hex_gym_env_tpu.train.evaluate import Evaluator as JaxEvaluator
from hex_gym_env_tpu.train.rollout import SelfplayRunner as JaxRunner
from hex_gym_env_tpu.utils.config import SelfplayConfig as JaxSelfplayConfig

from hex_gym_env_tpu_torch.experiments import get_config
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.convert import flax_state_dict
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.train.bank import OpponentBank
from hex_gym_env_tpu_torch.train.evaluate import Evaluator, eval_seats, serve_indices
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _small_cfg(**kw):
    sp = dict(board_size=5, n_envs=16, buffer_size=4, n_eval_episodes=4,
              policy="MLP-default", seed=0)
    sp.update(kw.pop("selfplay", {}))
    ppo_kw = dict(n_steps=32, minibatch_size=64, n_epochs=2)
    ppo_kw.update(kw.pop("ppo", {}))
    return TrainConfig(ppo=PPOConfig(**ppo_kw), selfplay=SelfplayConfig(**sp),
                       total_timesteps=kw.pop("total_timesteps", 2048), **kw)


def _algo(cfg):
    return SelfplayPPO(cfg, device="cpu")


def test_train_step_runs_and_counts():
    algo = _algo(_small_cfg())
    assert algo.runner.fused_pol is not None  # the K4 twin on the CPU
    state = algo.init_state(0)
    state, metrics = algo.train_step(state)
    assert algo.timesteps(state) == 32 * 16
    assert state.opt_state.count == 2 * (32 * 16 // 64)
    assert np.isfinite(float(metrics.ppo.policy_loss))
    assert np.isfinite(float(metrics.ppo.value_loss))
    state, _ = algo.train_step(state)
    assert algo.timesteps(state) == 2 * 32 * 16
    state, stacked = algo.train_steps(state, 2)
    assert state.iteration == 4 and stacked.ppo.value_loss.shape == (2,)


def test_eval_step_updates_bank_and_scores():
    algo = _algo(_small_cfg())
    state = algo.init_state(0)
    new_state, result = algo.eval_step(state)
    assert result.rewards.shape == (4,)
    assert set(result.rewards.unique().tolist()) <= {-1.0, 0.0, 1.0}
    # score formula: mean_reward * exp(mean(scores) - 1) with zero scores
    np.testing.assert_allclose(float(result.score), float(result.mean_reward) * np.exp(-1.0),
                               rtol=1e-5)
    assert new_state.eval_accum == 0
    assert bool(result.replaced) == (float(result.mean_reward) > 0)


def test_eval_serve_order_repeats_last_member():
    assert serve_indices(6, 4).tolist() == [0, 1, 2, 3, 3, 3]
    assert serve_indices(3, 4).tolist() == [0, 1, 2]


def test_eval_seats_follow_protocol():
    fixed = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    cfg = SelfplayConfig(board_size=5, n_envs=4, seat_mode="fixed_random")
    seats = eval_seats(cfg, torch.Generator().manual_seed(0), 6, fixed)
    assert seats.tolist() == [0, 1, 1, 0, 0, 1]  # tiled carry seats
    cfg_pe = SelfplayConfig(board_size=5, n_envs=4, seat_mode="per_episode")
    a = eval_seats(cfg_pe, torch.Generator().manual_seed(1), 64, fixed)
    b = eval_seats(cfg_pe, torch.Generator().manual_seed(2), 64, fixed)
    assert set(a.unique().tolist()) <= {0, 1} and not torch.equal(a, b)


def test_eval_step_seat_stability_under_fixed_random():
    cfg = _small_cfg(selfplay=dict(seat_mode="fixed_random"))
    algo = _algo(cfg)
    state = algo.init_state(0)
    seats0 = state.carry.agent_seat.clone()
    results = []
    for _ in range(2):
        state, _ = algo.train_step(state)
        state, r = algo.eval_step(state)
        results.append(r)
    assert torch.equal(state.carry.agent_seat, seats0)
    assert all(r.rewards.shape == (cfg.selfplay.eval_episodes,) for r in results)


def test_n_eval_episodes_flow_through_the_fused_span():
    cfg = _small_cfg(selfplay=dict(n_eval_episodes=7, eval_freq=512))
    algo = _algo(cfg)
    state = algo.init_state(0)
    state, result = algo.eval_step(state)
    assert result.rewards.shape == (7,)
    state, (m, r, did) = algo.train_and_eval_steps(state, 2)
    assert r.rewards.shape == (2, 7) and did.tolist() == [True, True]
    assert m.ppo.policy_loss.shape == (2,)


def test_pool_score_decay_mechanics():
    base = _small_cfg()

    def run_eval(decay):
        cfg = dataclasses.replace(
            base, selfplay=dataclasses.replace(base.selfplay, pool_score_decay=decay))
        algo = _algo(cfg)
        state = algo.init_state(0)
        bank = dataclasses.replace(
            state.bank, scores=torch.full_like(state.bank.scores, 0.9),
            best_score=torch.tensor(0.9))
        bank2, res = algo.evaluator.eval_and_update(
            state.params, bank, torch.Generator().manual_seed(1), state.carry.agent_seat)
        return bank2.scores.numpy(), float(bank2.best_score), bool(res.replaced)

    scores0, _, _ = run_eval(0.0)
    assert np.isclose(scores0, 0.9).sum() >= scores0.size - 1
    scores1, best1, _ = run_eval(0.25)
    assert np.isclose(scores1, 0.9 * 0.75).sum() >= scores1.size - 1
    assert best1 >= 0.9 - 1e-6  # the promotion bar never decays


def test_symmetric_eval_mechanics():
    base = _small_cfg()

    def algo_for(sym, seat_mode="per_episode"):
        return _algo(dataclasses.replace(base, selfplay=dataclasses.replace(
            base.selfplay, symmetric_eval=sym, seat_mode=seat_mode)))

    algo = algo_for(True)
    state = algo.init_state(0)
    E, n_envs = algo.cfg.selfplay.eval_episodes, algo.cfg.selfplay.n_envs
    r_a = algo.evaluator.play_vs_pool(state.params, state.bank, torch.Generator().manual_seed(5),
                                      torch.zeros(n_envs, dtype=torch.int32))
    assert r_a.shape == (E,)
    np.testing.assert_allclose(r_a * 2, torch.round(r_a * 2), atol=1e-6)  # two-seat means
    r_b = algo_for(True, "fixed_random").evaluator.play_vs_pool(
        state.params, state.bank, torch.Generator().manual_seed(5),
        torch.ones(n_envs, dtype=torch.int32))
    assert torch.equal(r_a, r_b)  # seat_mode and fixed seats are overridden
    r_c = algo_for(False).evaluator.play_vs_pool(
        state.params, state.bank, torch.Generator().manual_seed(5),
        torch.zeros(n_envs, dtype=torch.int32))
    assert r_c.shape == (E,)


def test_seed_bank_plants_opponents_and_guards():
    algo = _algo(_small_cfg())
    state = algo.init_state(0)
    seed = {k: torch.randn_like(v) for k, v in state.params.items()}
    state = algo.seed_bank(state, [seed], score=0.5)
    for k in seed:
        assert torch.equal(state.bank.params[k][0], seed[k])
        assert torch.equal(state.bank.best_params[k], seed[k])
    assert float(state.bank.scores[0]) == 0.5 and float(state.bank.best_score) == 0.5
    _, metrics = algo.train_step(state)
    assert np.isfinite(float(metrics.ppo.policy_loss))
    with pytest.raises(ValueError, match="unreachable"):
        algo.seed_bank(state, [seed], score=1.0)
    with pytest.raises(ValueError, match="exceed"):
        algo.seed_bank(state, [seed] * (state.bank.size + 1))


def test_strict_preset_runs_scan_and_lax_paths():
    cfg = get_config("5x5_strict_sb3", n_steps=16, n_eval_episodes=4, buffer_size=4)
    algo = _algo(cfg)
    assert algo.runner.fused_pol is None and algo.runner.pol is None
    assert algo.evaluator.fused_pol is None
    assert algo.update_fn.__qualname__.startswith("make_update_fn")
    state = algo.init_state(0)
    state, metrics = algo.train_step(state)
    state, result = algo.eval_step(state)
    assert state.iteration == 1 and np.isfinite(float(metrics.ppo.value_loss))
    assert result.rewards.shape == (4,)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

N, POOL, E = 4, 3, 5


def _jax_bank(model, key, scores):
    ks = jax.random.split(key, POOL + 2)
    dummy = jnp.zeros((1, N, N), jnp.float32)
    members = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[model.init(ks[i], dummy) for i in range(POOL)])
    return model.init(ks[POOL], dummy), JaxBank(
        params=members, scores=jnp.asarray(scores, jnp.float32),
        best_params=model.init(ks[POOL + 1], dummy), best_score=jnp.float32(0.25))


def _port_bank(bank):
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return OpponentBank(
        params=flax_state_dict(np_(bank.params)), scores=torch.from_numpy(np.array(bank.scores)),
        best_params=flax_state_dict(np_(bank.best_params)),
        best_score=torch.from_numpy(np.array(bank.best_score)))


def _port_model():
    return make_policy("MLP-default", N * N)


def test_fused_eval_matches_jax_eval_kernel():
    """Injected seats, opening actions and bits: the opening move through the
    env step, then K4's twin in eval mode, against the JAX fused rollout in
    eval mode (interpret) from the same post-opening state."""
    topo = jax_get_topology(N)
    model = jax_make_policy("MLP-default", topo.num_cells)
    variables, bank = _jax_bank(model, jax.random.key(4), np.zeros(POOL))
    cfg = JaxSelfplayConfig(board_size=N, n_envs=E, buffer_size=POOL, n_eval_episodes=E,
                            rollout_impl="fused", env_step_impl="lax")
    pol = JaxRunner(topo, model, cfg).fused_pol
    rng = np.random.default_rng(0)
    seats = np.array([0, 1, 1, 0, 1], np.int32)
    opening = rng.integers(0, topo.num_cells, E).astype(np.int32)
    serve = np.minimum(np.arange(E), POOL - 1).astype(np.int32)

    state0 = jax_env.initial_state(topo, E)
    state, _ = jax_env.step(topo, state0, jnp.asarray(opening), active=jnp.asarray(seats == 1))
    stacked = pol.stack_bank(bank)
    P1c = stacked.tensors[-1].shape[0]
    T = topo.num_cells // 2 + 2
    key = jax.random.key(8)
    out = jpr.fused_rollout(
        topo, pol, pol.pack_agent(variables["params"]), stacked.tensors,
        jnp.zeros((P1c, topo.num_cells), jnp.float32), state,
        dict(n_members=stacked.n_members, agent_seat=jnp.asarray(seats),
             use_best=jnp.zeros((E,), bool), opp_idx=jnp.asarray(serve)),
        key, T, cfg.best_prob, False, interpret=True, eval_mode=True)
    want = np.asarray(out.flts[..., jpr.F_REWARD].sum(axis=0))
    A = topo.num_cells
    bits = tuple(masked.bits_from_numpy(np.asarray(jax.random.bits(k, (T, E, w), jnp.uint32)))
                 for k, w in zip(jax.random.split(key, 4), (A, A, A, 128)))

    evaluator = Evaluator(
        topo, _port_model(), SelfplayConfig(board_size=N, n_envs=E, buffer_size=POOL,
                                           n_eval_episodes=E), device="cpu")
    assert evaluator.fused_pol is not None
    got = evaluator._play_vs_pool_fused(
        flax_state_dict(jax.tree.map(np.asarray, variables)), _port_bank(bank), None, None,
        seats=torch.from_numpy(seats), opening=torch.from_numpy(opening), bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0  # games were decided


@pytest.mark.parametrize("decay,mean_sign", [(0.0, 1), (0.25, 1), (0.0, -1)])
def test_apply_pool_update_matches_jax(decay, mean_sign):
    """Same rewards and bank with a unique argmin slot: the replacement is
    deterministic, so the updated banks agree exactly (scores to 1e-6)."""
    topo = jax_get_topology(N)
    model = jax_make_policy("MLP-default", topo.num_cells)
    scores = np.array([0.25, -0.125, 0.5], np.float32)
    variables, bank = _jax_bank(model, jax.random.key(6), scores)
    rewards = np.array([1, 1, 0, mean_sign, 1], np.float32) * mean_sign
    cfg = JaxSelfplayConfig(board_size=N, n_envs=E, buffer_size=POOL, n_eval_episodes=E,
                            pool_score_decay=decay)
    jbank, jres = JaxEvaluator(topo, model, cfg).apply_pool_update(
        variables, bank, jnp.asarray(rewards), jax.random.key(0))

    evaluator = Evaluator(topo, _port_model(), SelfplayConfig(
        board_size=N, n_envs=E, buffer_size=POOL, n_eval_episodes=E, pool_score_decay=decay),
        device="cpu")
    params = flax_state_dict(jax.tree.map(np.asarray, variables))
    tbank, tres = evaluator.apply_pool_update(
        params, _port_bank(bank), torch.from_numpy(rewards), torch.Generator().manual_seed(0))

    assert bool(tres.replaced) == bool(jres.replaced) == (mean_sign > 0)
    np.testing.assert_allclose(float(tres.score), float(jres.score), rtol=1e-6)
    np.testing.assert_allclose(tbank.scores.numpy(), np.asarray(jbank.scores), rtol=1e-6)
    np.testing.assert_allclose(float(tbank.best_score), float(jbank.best_score), rtol=1e-6)
    want = _port_bank(jbank)
    for k in want.params:
        assert torch.equal(tbank.params[k], want.params[k]), k
        assert torch.equal(tbank.best_params[k], want.best_params[k]), k
    if mean_sign > 0:
        assert int(np.argmax(np.asarray(jbank.scores) != scores * (1 - decay))) == 1
