"""The port's data-parallel training (``parallel/``) against the JAX package.

On the CPU: ranks are processes of a gloo group (``tests/torch_dist_worker``,
started with ``torch.multiprocessing`` on a free port, each with a timeout
and killed by PID), one session shared by the tests that need it.  The
sharded eval is held exactly against a JAX loop that mirrors the JAX
package's ``Evaluator.play_vs_pool_sharded`` with the port's bit-to-Gumbel
map and the same injected words; the distributed sweep against the JAX
package's ``ppo.make_update_fn(grad_reduce=pmean)`` under ``shard_map`` on
two of the conftest's virtual CPU devices, each device's permutations
injected (the PPO tolerances: 1e-5 relative after one step, 1e-4 after a
sweep).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.topology import get_topology as jax_get_topology
from hex_gym_env_tpu.models import MlpPolicy as JaxMlpPolicy
from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.ops import masked as jax_masked
from hex_gym_env_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hex_gym_env_tpu.train import ppo as jppo
from hex_gym_env_tpu.train.bank import init_bank as jax_init_bank
from hex_gym_env_tpu.train.evaluate import Evaluator as JaxEvaluator
from hex_gym_env_tpu.utils.config import PPOConfig as JaxPPOConfig
from hex_gym_env_tpu.utils.config import SelfplayConfig as JaxSelfplayConfig

import torch_dist_worker
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.convert import flax_state_dict, optax_adam_to_torch
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO, bootstrap, make_mesh
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.bank import OpponentBank
from hex_gym_env_tpu_torch.train.evaluate import Evaluator, episode_words
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

N = 5
A = N * N
STEP_REL, SWEEP_REL = 1e-5, 1e-4
EVAL_CFG = TrainConfig(ppo=PPOConfig(n_steps=4, minibatch_size=8, n_epochs=1),
                       selfplay=SelfplayConfig(board_size=N, n_envs=4, buffer_size=6))
EVAL_SCORES = [0.3, -0.2, 0.1, 0.4, 0.2, 0.5]  # a unique argmin: the replaced slot is 1
EVAL_SEED = 4  # a state whose eval wins on average, so the pool update replaces


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# inputs of the distributed sweep, and the two-rank session
# ---------------------------------------------------------------------------

def _batch(n, seed):
    """A JAX ``PPOBatch`` honouring ``legal == (obs == 0)``."""
    rng = np.random.default_rng(seed)
    boards = rng.choice(np.array([-1, 0, 1], np.int8), size=(n, N, N))
    boards.reshape(n, A)[np.arange(n), rng.integers(0, A, n)] = 0
    legal = boards.reshape(n, A) == 0
    actions = np.argmax(np.where(legal, rng.random((n, A)), -1.0), axis=1).astype(np.int32)
    return jppo.PPOBatch(
        obs=jnp.asarray(boards), legal=jnp.asarray(legal), action=jnp.asarray(actions),
        log_prob_old=jnp.asarray(rng.normal(-2.5, 0.3, n).astype(np.float32)),
        value_old=jnp.asarray(rng.normal(0, 0.5, n).astype(np.float32)),
        advantage=jnp.asarray(rng.normal(0, 1.0, n).astype(np.float32)),
        ret=jnp.asarray(rng.normal(0, 0.7, n).astype(np.float32)),
    )


# (minibatch, rows per rank, epochs): one grad step; a sweep of 2 x 4 steps
UPDATE_CASES = {"step": (64, 64, 1), "sweep": (32, 128, 2)}


def _update_case(name):
    """Inputs of one distributed sweep and the JAX pmean update on them."""
    mbs, n_local, n_epochs = UPDATE_CASES[name]
    jmodel = JaxMlpPolicy(n_actions=A)
    jcfg = JaxPPOConfig(minibatch_size=mbs, n_epochs=n_epochs)
    variables = jmodel.init(jax.random.key(3), jnp.zeros((1, N, N), jnp.float32))
    optimizer = jppo.make_optimizer(jcfg)
    warm = jax.jit(jppo.make_update_fn(jmodel, JaxPPOConfig(minibatch_size=64, n_epochs=1),
                                       optimizer))
    _, opt_state, _ = warm(variables, optimizer.init(variables["params"]), _batch(128, 42),
                           jax.random.key(99))
    batch = _batch(2 * n_local, 7)
    keys = jax.random.split(jax.random.key(11), 2)
    update = jppo.make_update_fn(jmodel, jcfg, optimizer,
                                 grad_reduce=lambda g: jax.lax.pmean(g, "data"))

    def local(variables, opt_state, batch, key_data):
        params, opt, stats = update(variables, opt_state, batch,
                                    jax.random.wrap_key_data(key_data[0]))
        return params, opt, jax.lax.pmean(stats, "data")

    sharded = jax.jit(jax.shard_map(local, mesh=jax_make_mesh(n_data=2),
                                    in_specs=(P(), P(), P("data"), P("data")),
                                    out_specs=(P(), P(), P()), check_vma=False))
    want = _np(sharded(variables, opt_state, batch, jax.random.key_data(keys)))
    perms = [torch.from_numpy(np.array(jppo.epoch_permutations(k, n_local, n_epochs)))
             for k in keys]
    rows = [slice(r * n_local, (r + 1) * n_local) for r in range(2)]
    port_batch = ppo.PPOBatch(*(
        [torch.from_numpy(np.array(x)[s]) for s in rows] for x in batch))
    cfg = TrainConfig(ppo=PPOConfig(minibatch_size=mbs, n_epochs=n_epochs, n_steps=n_local // 2),
                      selfplay=SelfplayConfig(board_size=N, n_envs=4, buffer_size=2))
    case = {"cfg": cfg, "params": flax_state_dict(_np(variables)),
            "opt": optax_adam_to_torch(_np(opt_state)), "batch": port_batch, "perms": perms}
    return case, want


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """One two-rank gloo session: the sharded eval, the distributed sweeps
    and a ``Trainer.fit`` with a resume."""
    out = tmp_path_factory.mktemp("dist")
    cases, wants = zip(*(_update_case(name) for name in UPDATE_CASES))
    fit_cfg = TrainConfig(
        ppo=PPOConfig(n_steps=4, minibatch_size=8, n_epochs=1),
        selfplay=SelfplayConfig(board_size=4, n_envs=8, buffer_size=2, eval_freq=32,
                                n_eval_episodes=3),
        total_timesteps=64, checkpoint_every=32, model_name="dist_fit",
        log_dir=str(out / "log"), model_dir=str(out / "models"))
    inputs = {"jobs": ["eval", "update", "fit"], "eval_cfg": EVAL_CFG, "eval_seed": EVAL_SEED,
              "eval_scores": torch.tensor(EVAL_SCORES), "update": list(cases),
              "fit_cfg": fit_cfg}
    ranks = torch_dist_worker.run_group(2, str(out), inputs, timeout=150)
    return {"ranks": ranks, "wants": dict(zip(UPDATE_CASES, wants)), "fit_cfg": fit_cfg}


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------

def test_init_distributed_without_torchrun_is_a_noop(monkeypatch):
    for var in bootstrap.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert bootstrap.init_distributed() is False
    assert not dist.is_initialized() and bootstrap.is_main_process()
    mesh = make_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    with pytest.raises(ValueError, match="num_processes"):
        bootstrap.init_distributed("localhost:1")


def test_init_distributed_with_explicit_arguments(session):
    for r, out in enumerate(session["ranks"]):
        assert out["init"] is True
        assert out["is_main"] == (r == 0)
        assert out["mesh"] == (2, r)


# ---------------------------------------------------------------------------
# the sharded eval
# ---------------------------------------------------------------------------

def _jax_gumbel(bits):
    u = (bits >> 8).astype(jnp.int32).astype(jnp.float32) * 2.0**-24 + 2.0**-25
    return -jnp.log(-jnp.log(u))


def _jax_sharded_eval(cfg, variables, bank, words, eids, seats_all):
    """The JAX package's ``play_vs_pool_sharded`` (its ``train/evaluate.py``),
    with its per-episode keys replaced by the injected uint32 ``words``
    through the port's bit-to-Gumbel map."""
    topo = jax_get_topology(cfg.board_size)
    model = jax_make_policy("MLP-default", topo.num_cells)
    ev = JaxEvaluator(topo, model, cfg)
    P_, E = bank.size, cfg.eval_episodes
    n_pairs = topo.num_cells // 2 + 2
    if cfg.symmetric_eval:
        member, seat = np.minimum(eids % E, P_ - 1), eids // E
    else:
        member = np.minimum(eids, P_ - 1)
        if cfg.seat_mode == "fixed_random":
            seat = seats_all[eids % len(seats_all)]
        else:
            seat = ((words[:, 0] >> 8).astype(np.float32) * 2.0**-24 < 0.5).astype(np.int32)
    seat = jnp.asarray(seat, jnp.int32)
    served = jax.tree.map(lambda x: x[jnp.asarray(member)], bank.params)
    plies = jnp.asarray(words[:, 1:].reshape(len(eids), n_pairs + 1, topo.num_cells))

    def opponent_move(st, w, active):
        logits = ev._opponent_logits(served, st)
        legal = jax_env.legal_mask(topo, st)
        a = jnp.argmax(jax_masked.mask_logits(logits, legal) + _jax_gumbel(w),
                       axis=-1).astype(jnp.int32)
        return ev.step(topo, st, a, active=active)

    state = jax_env.initial_state(topo, len(eids))
    state, _ = opponent_move(state, plies[:, 0], seat == 1)
    total = jnp.zeros((len(eids),), jnp.float32)
    for s in range(n_pairs):
        obs = jax_env.observe(topo, state).astype(jnp.float32)
        legal = jax_env.legal_mask(topo, state)
        logits, _ = model.apply(variables, obs)
        state, rew1 = ev.step(topo, state, jax_masked.mode(logits, legal))
        state, rew2 = opponent_move(state, plies[:, s + 1], ~state.done)
        col = seat[:, None]
        total = total + (jnp.take_along_axis(rew1, col, 1)[:, 0]
                         + jnp.take_along_axis(rew2, col, 1)[:, 0])
    return np.asarray(total)


def _jax_agent_and_bank(n_members, seed):
    model = jax_make_policy("MLP-default", A)
    ks = jax.random.split(jax.random.key(seed), n_members + 1)
    dummy = jnp.zeros((1, N, N), jnp.float32)
    members = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[model.init(ks[i], dummy) for i in range(n_members)])
    bank = jax_init_bank(model.init(ks[0], dummy), n_members).replace(params=members)
    return model.init(ks[n_members], dummy), bank


def _port_bank(bank):
    return OpponentBank(params=flax_state_dict(_np(bank.params)),
                        scores=torch.from_numpy(np.array(bank.scores)),
                        best_params=flax_state_dict(_np(bank.best_params)),
                        best_score=torch.from_numpy(np.array(bank.best_score)))


@pytest.mark.parametrize("mode", ["per_episode", "fixed_random", "symmetric_eval"])
def test_sharded_eval_matches_jax_loop(mode):
    E, n_envs = 6, 4
    extra = {"symmetric_eval": True} if mode == "symmetric_eval" else {
        "seat_mode": mode}
    cfg_kw = dict(board_size=N, n_envs=n_envs, buffer_size=4, n_eval_episodes=E, **extra)
    variables, bank = _jax_agent_and_bank(4, seed=5)
    G = 2 * E if mode == "symmetric_eval" else E
    rng = np.random.default_rng(3)
    eids = np.arange(G)
    n_pairs = A // 2 + 2
    words = rng.integers(0, 2**32, size=(G, 1 + (n_pairs + 1) * A), dtype=np.uint32)
    seats_all = rng.integers(0, 2, n_envs).astype(np.int32)
    want = _jax_sharded_eval(JaxSelfplayConfig(**cfg_kw), variables, bank, words, eids,
                             seats_all)

    ev = Evaluator(get_topology(N), make_policy("MLP-default", A), SelfplayConfig(**cfg_kw),
                   device="cpu")
    record = {}
    got = ev.play_vs_pool_sharded(flax_state_dict(_np(variables)), _port_bank(bank), 0,
                                  torch.from_numpy(eids), torch.from_numpy(seats_all),
                                  words=masked.bits_from_numpy(words), record=record)
    np.testing.assert_array_equal(got.numpy(), want)
    assert record["actions"].shape == (1 + 2 * n_pairs, G)
    assert np.abs(want).sum() > 0  # games were decided


@pytest.mark.parametrize("mode", ["per_episode", "symmetric_eval"])
def test_sharded_eval_is_width_invariant(mode):
    """E = 6 over D = 1, 2, 4 by slicing the grid as ``eval_step`` does
    (ceil(G / D) a rank, the last ranks short or empty): bitwise equal."""
    cfg = dataclasses.replace(EVAL_CFG.selfplay, symmetric_eval=mode == "symmetric_eval")
    G = 2 * cfg.eval_episodes if cfg.symmetric_eval else cfg.eval_episodes
    variables, bank = _jax_agent_and_bank(cfg.buffer_size, seed=9)
    params, pbank = flax_state_dict(_np(variables)), _port_bank(bank)
    ev = Evaluator(get_topology(N), make_policy("MLP-default", A), cfg, device="cpu")
    seats = torch.zeros(cfg.n_envs, dtype=torch.int32)
    results = {}
    for D in (1, 2, 4):
        per = -(-G // D)
        parts = [ev.play_vs_pool_sharded(params, pbank, 1234,
                                         torch.arange(r * per, min((r + 1) * per, G)), seats)
                 for r in range(D)]
        results[D] = torch.cat(parts)
    assert results[1].shape == (G,)
    for D in (2, 4):
        assert torch.equal(results[D], results[1])
    # the words are the episodes' own, whatever slice asks for them
    assert torch.equal(episode_words(5, torch.tensor([3]), A, 2)[0],
                       episode_words(5, torch.tensor([1, 2, 3]), A, 2)[2])


def _one_rank_eval():
    mesh = make_mesh("cpu")
    algo = DistributedSelfplayPPO(EVAL_CFG, mesh)
    state = algo.init_sharded_state(EVAL_SEED)
    state.bank.scores = torch.tensor(EVAL_SCORES)
    return algo, state, algo.eval_step(state)


def test_two_rank_eval_step_equals_one_rank(session):
    _, _, (state1, res1) = _one_rank_eval()
    for out in session["ranks"]:
        ev = out["eval"]
        assert torch.equal(ev["rewards"], res1.rewards)
        assert torch.equal(ev["score"], res1.score)
        assert bool(ev["replaced"]) == bool(res1.replaced)
        assert torch.equal(ev["bank_scores"], state1.bank.scores)
        for k in state1.bank.params:
            assert torch.equal(ev["bank"][k], state1.bank.params[k]), k


def test_pool_update_after_the_reduce_matches_jax(session):
    """The gathered rewards of the two-rank eval through JAX's pool update
    on the same bank scores: the same score, decision and slot."""
    algo, state0, _ = _one_rank_eval()
    rewards = session["ranks"][0]["eval"]["rewards"]
    model = jax_make_policy("MLP-default", A)
    variables = model.init(jax.random.key(0), jnp.zeros((1, N, N), jnp.float32))
    bank = jax_init_bank(variables, len(EVAL_SCORES)).replace(
        scores=jnp.asarray(EVAL_SCORES, jnp.float32))
    cfg = JaxSelfplayConfig(board_size=N, n_envs=4, buffer_size=len(EVAL_SCORES))
    jbank, jres = JaxEvaluator(jax_get_topology(N), model, cfg).apply_pool_update(
        variables, bank, jnp.asarray(rewards.numpy()), jax.random.key(1))
    assert bool(jres.replaced)
    for out in session["ranks"]:
        ev = out["eval"]
        assert bool(ev["replaced"]) == bool(jres.replaced)
        np.testing.assert_allclose(float(ev["score"]), float(jres.score), rtol=1e-6)
        np.testing.assert_allclose(ev["bank_scores"].numpy(), np.asarray(jbank.scores),
                                   rtol=1e-6)
        replaced = np.flatnonzero(np.asarray(jbank.scores) != np.float32(EVAL_SCORES))
        for k, v in state0.params.items():
            for slot in range(len(EVAL_SCORES)):
                want = v if slot in replaced else torch.zeros_like(v)
                assert torch.equal(ev["bank"][k][slot], want), (k, slot)


# ---------------------------------------------------------------------------
# the distributed sweep, the trainer
# ---------------------------------------------------------------------------

def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_distributed_update_matches_jax_pmean(session, name):
    bound = STEP_REL if name == "step" else SWEEP_REL
    want_params, want_opt, want_stats = session["wants"][name]
    adam = want_opt[1][0]
    case = list(UPDATE_CASES).index(name)
    outs = [out["update"][case] for out in session["ranks"]]
    mbs, n_local, n_epochs = UPDATE_CASES[name]
    steps = n_epochs * (n_local // mbs)
    for got_key, want_tree in (("params", want_params), ("mu", adam.mu), ("nu", adam.nu)):
        want = flax_state_dict(want_tree)
        for k in want:
            got = outs[0][got_key][k]
            assert torch.equal(got, outs[1][got_key][k]), f"{got_key} {k} not replicated"
            assert _rel(got.numpy(), want[k].numpy()) < bound, (got_key, k)
    for out in outs:
        assert out["count"] == int(adam.count)
        assert out["reduces"] == steps  # one all-reduce a grad step
    stats = (outs[0]["stats"] + outs[1]["stats"]).numpy() / 2
    want_s = np.array([float(getattr(want_stats, f)) for f in jppo.PPOStats._fields])
    np.testing.assert_allclose(stats, want_s, rtol=bound, atol=bound)


def test_two_rank_fit_replicates_logs_once_and_resumes(session):
    cfg = session["fit_cfg"]
    r0, r1 = (out["fit"] for out in session["ranks"])
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert torch.equal(r0["resumed"][k], r0["params"][k]), k
        assert torch.equal(r1["resumed"][k], r1["params"][k]), k
    assert r0["iteration"] == 2 and r0["carry_envs"] == cfg.selfplay.n_envs // 2
    assert (r0["null_logger"], r1["null_logger"]) == (False, True)
    per_iter = cfg.ppo.n_steps * cfg.selfplay.n_envs
    assert r0["saves"] == [per_iter, 2 * per_iter, 2 * per_iter] and r1["saves"] == []
    with open(os.path.join(cfg.log_dir, cfg.model_name, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert sum('"eval/mean_reward"' in line for line in lines) == 2
    saved = os.listdir(os.path.join(cfg.model_dir, cfg.model_name))
    assert sorted(f for f in saved if f.startswith("step_")) == [
        f"step_{per_iter}.pt", f"step_{2 * per_iter}.pt"]


def test_value_errors_and_sample_board_takes_the_replicated_evaluator():
    mesh = dataclasses.replace(make_mesh("cpu"), world_size=3)
    with pytest.raises(ValueError, match="divide over data axis"):
        DistributedSelfplayPPO(EVAL_CFG, mesh)
    cfg = dataclasses.replace(EVAL_CFG, ppo=PPOConfig(n_steps=3, minibatch_size=8))
    mesh2 = dataclasses.replace(make_mesh("cpu"), world_size=2)
    with pytest.raises(ValueError, match="per-device rollout size"):
        DistributedSelfplayPPO(dataclasses.replace(cfg, selfplay=dataclasses.replace(
            cfg.selfplay, n_envs=8)), mesh2)

    sb = dataclasses.replace(EVAL_CFG, selfplay=dataclasses.replace(EVAL_CFG.selfplay,
                                                                     sample_board=True))
    algo = DistributedSelfplayPPO(sb, make_mesh("cpu"))
    with pytest.raises(NotImplementedError, match="sample_board"):
        algo.evaluator.play_vs_pool_sharded(None, algo.init_state(0).bank, 0,
                                            torch.arange(2), None)
    state = algo.init_sharded_state(0)
    calls = []
    replicated = algo.evaluator.eval_and_update

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return replicated(*args, **kwargs)

    algo.evaluator.eval_and_update = spy
    state, res = algo.eval_step(state)
    assert len(calls) == 1 and torch.equal(calls[0]["fixed_seats"], state.carry.agent_seat)
    assert res.rewards.shape == (sb.selfplay.eval_episodes,) and state.eval_accum == 0
