"""The port's sampled-board mode against the JAX package and the scalar oracle.

``labels_from_stones``, ``state_from_boards`` and the reach-set functions of
``ops/connectivity.py`` must equal the JAX package's exactly on the same
numpy boards; ``sample_boards`` must have the JAX sampler's support and,
within a stated tolerance, its means; the runner and the evaluator must
start games from sampled boards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.random_board import sample_boards as jax_sample_boards
from hex_gym_env_tpu.core.topology import get_topology as jax_get_topology
from hex_gym_env_tpu.ops import connectivity as jax_conn
from hex_gym_env_tpu.ops import labels as jax_labels

from hex_gym_env_tpu_torch.core import env as torch_env
from hex_gym_env_tpu_torch.core import random_board
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.ops import connectivity, labels as torch_labels
from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.train.evaluate import Evaluator
from hex_gym_env_tpu_torch.train.rollout import RolloutCarry, SelfplayRunner
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

from golden import GoldenHexEnv

FIELDS = ("stones", "labels", "to_move", "done", "winner", "empty", "move_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_boards(n, batch, seed):
    return np.array(jax.jit(jax_sample_boards, static_argnums=(1, 2))(
        jax.random.key(seed), jax_get_topology(n), batch))


def _random_fills(n, batch, seed):
    """Boards of random -1/0/+1 cells, not only positions of play."""
    return np.random.default_rng(seed).integers(-1, 2, (batch, n, n)).astype(np.int8)


def _boards(kind, n, batch, seed):
    return _jax_boards(n, batch, seed) if kind == "sampled" else _random_fills(n, batch, seed)


@pytest.mark.parametrize("n", [3, 5, 7, 11])
@pytest.mark.parametrize("kind", ["sampled", "random"])
def test_state_from_boards_matches_jax(n, kind):
    boards = _boards(kind, n, 16, n)
    jt, tt = jax_get_topology(n), get_topology(n)
    want = jax.jit(jax_env.state_from_boards, static_argnums=0)(jt, jnp.asarray(boards))
    got = torch_env.state_from_boards(tt, torch.from_numpy(boards))
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    labels = torch_labels.labels_from_stones(tt, got.stones)
    np.testing.assert_array_equal(
        labels.numpy(), np.asarray(jax_labels.labels_from_stones(jt, jnp.asarray(got.stones))))
    seats = torch.from_numpy(np.arange(16) % 2).to(torch.int32)
    assert torch.equal(torch_env.state_from_boards(tt, torch.from_numpy(boards), seats).to_move,
                       seats)


@pytest.mark.parametrize("n", [4, 7, 11])
def test_connectivity_matches_jax_and_labels(n):
    """The reach sets equal JAX's, and their win test equals the label
    table's (``labels_from_stones``) on the same stones."""
    boards = np.concatenate([_random_fills(n, 12, 10 + n), _jax_boards(n, 12, 20 + n)])
    jt, tt = jax_get_topology(n), get_topology(n)
    stones = torch_env.state_from_boards(tt, torch.from_numpy(boards)).stones
    js = jnp.asarray(stones.numpy())
    reach = connectivity.full_reach(stones, tt)
    np.testing.assert_array_equal(reach.numpy(), np.asarray(jax_conn.full_reach(js, jt)))
    np.testing.assert_array_equal(
        connectivity.dilate(stones, tt).numpy(), np.asarray(jax_conn.dilate(js, jt)))
    seeds = torch.from_numpy(tt.edge_masks[0, 0])[None] & stones[:, 0]
    for iters in (1, 3):
        np.testing.assert_array_equal(
            connectivity.propagate_fixed(seeds, stones[:, 0], tt, iters).numpy(),
            np.asarray(jax_conn.propagate_fixed(jnp.asarray(seeds.numpy()), js[:, 0], jt, iters)))
    np.testing.assert_array_equal(
        connectivity.propagate(seeds, stones[:, 0], tt).numpy(),
        np.asarray(jax_conn.propagate(jnp.asarray(seeds.numpy()), js[:, 0], jt)))
    labels = torch_labels.labels_from_stones(tt, stones)
    for seat in range(2):
        w = connectivity.wins(reach[:, seat])
        np.testing.assert_array_equal(w.numpy(), np.asarray(jax_conn.wins(
            jax_conn.full_reach(js, jt)[:, seat])))
        assert torch.equal(w, torch_labels.seat_wins(tt, labels, seat))
        # a stone that reaches an edge carries that edge virtual's label (the
        # labels' groups may run through the edges, so not conversely)
        for end in range(2):
            edge_group = torch_labels.connected_to_edge(tt, labels, seat, end)
            assert not (reach[:, seat, end] & ~edge_group).any()


def test_sampled_board_golden_parity():
    """Games from sampled boards agree with the scalar oracle step by step
    (as the JAX package's ``test_sampled_board_parity``)."""
    tt = get_topology(7)
    G = 12
    boards = random_board.sample_boards(torch.Generator().manual_seed(0), tt, G).numpy()
    goldens = [GoldenHexEnv(7) for _ in range(G)]
    gold_obs = np.stack([g.reset(boards[i]) for i, g in enumerate(goldens)])
    gold_done = np.zeros(G, bool)
    state = torch_env.state_from_boards(tt, torch.from_numpy(boards))
    rng = np.random.default_rng(3)
    for t in range(49 + 2):
        obs = torch_env.observe(tt, state).numpy()
        actions = np.zeros(G, np.int32)
        for i, g in enumerate(goldens):
            if gold_done[i]:
                continue
            np.testing.assert_array_equal(obs[i], gold_obs[i], err_msg=f"obs {i} t {t}")
            actions[i] = rng.choice(np.flatnonzero(g.legal_actions()))
        state, rewards = torch_env.step(tt, state, torch.from_numpy(actions))
        for i, g in enumerate(goldens):
            if gold_done[i]:
                continue
            g_obs, g_rew, g_done, g_winner = g.step(int(actions[i]))
            gold_obs[i] = g_obs
            np.testing.assert_array_equal(rewards[i].numpy(), np.asarray(g_rew, np.float32))
            assert bool(state.done[i]) == g_done
            if g_done:
                gold_done[i] = True
                if g_winner is not None:
                    assert int(state.winner[i]) == g_winner
        if gold_done.all():
            break
    assert gold_done.all()


def _bbox(boards):
    """Height and width of each board's stone bounding box (0 if empty)."""
    occ = boards != 0
    rows, cols = occ.any(axis=2), occ.any(axis=1)

    def extent(a):
        first = np.where(a.any(1), a.argmax(1), 0)
        last = np.where(a.any(1), a.shape[1] - 1 - a[:, ::-1].argmax(1), -1)
        return last - first + 1

    return extent(rows), extent(cols)


@pytest.mark.parametrize("n", [3, 7, 11])
def test_sample_boards_support(n):
    tt = get_topology(n)
    boards = random_board.sample_boards(torch.Generator().manual_seed(n), tt, 512)
    assert boards.dtype == torch.int8 and boards.shape == (512, n, n)
    b = boards.numpy()
    blacks, whites = (b == -1).sum(axis=(1, 2)), (b == 1).sum(axis=(1, 2))
    np.testing.assert_array_equal(blacks, whites)  # even counts, equal halves
    assert torch.equal(torch_env.state_from_boards(tt, boards).to_move,
                       torch.zeros(512, dtype=torch.int32))  # seat 0 to move
    h, w = _bbox(b)
    assert h.max() <= max(n - 2, 1) and w.max() <= max(n - 2, 1)  # in one m x l submatrix
    # at least half of the submatrix, rounded down to even: a stone count
    # below that is impossible for the smallest m, l
    lo = max(n // 4, 0)
    assert (blacks + whites >= 2 * np.floor(lo * lo / 4)).all()
    assert (blacks + whites <= h * w).all()


def test_sample_boards_distribution_matches_jax():
    """Over 2048 boards each, the mean stone count and the mean bounding-box
    height and width of the two samplers agree within 4 standard errors of
    their difference."""
    n, count = 7, 2048
    tt = get_topology(n)
    mine = random_board.sample_boards(torch.Generator().manual_seed(11), tt, count).numpy()
    ref = _jax_boards(n, count, 12)
    for stat in (lambda b: (b != 0).sum(axis=(1, 2)), lambda b: _bbox(b)[0],
                 lambda b: _bbox(b)[1]):
        a, r = stat(mine).astype(float), stat(ref).astype(float)
        se = np.sqrt(a.var() / count + r.var() / count)
        assert abs(a.mean() - r.mean()) < 4 * se, (a.mean(), r.mean(), se)


# ---------------------------------------------------------------------------
# the runner and the evaluator under sample_board
# ---------------------------------------------------------------------------


def _sp_cfg(**kw):
    base = dict(board_size=5, n_envs=8, buffer_size=3, n_eval_episodes=4, sample_board=True)
    base.update(kw)
    return SelfplayConfig(**base)


def test_runner_with_sample_board_takes_the_scan_path():
    tt = get_topology(5)
    model = make_policy("MLP-default", tt.num_cells)
    runner = SelfplayRunner(tt, model, _sp_cfg(), device="cpu")
    assert runner.fused_pol is None and runner.pol is not None
    params = dict(model.state_dict())
    bank = init_bank(params, 3)
    g = torch.Generator().manual_seed(0)
    carry = runner.init_carry(bank, g)
    assert int(carry.env.stones.sum()) > 0
    carry, tr, last_values = runner.run(params, bank, carry, g, 6)
    assert tr.action.shape == (6, 8) and torch.isfinite(last_values).all()
    picked = torch.take_along_dim(tr.legal, tr.action.long()[..., None], -1)
    assert bool(picked.all())


def test_reset_rows_get_sampled_boards_others_untouched():
    tt = get_topology(5)
    model = make_policy("MLP-default", tt.num_cells)
    params = dict(model.state_dict())
    bank = init_bank(params, 3)
    g = torch.Generator().manual_seed(1)
    B = 8
    # mid-game games, half of them over
    env = torch_env.initial_state(tt, B, device="cpu")
    for a in (0, 1, 2, 3):
        env, _ = torch_env.step(tt, env, torch.full((B,), a))
    done = torch.arange(B) % 2 == 0
    env = dataclasses.replace(env, done=done)
    carry = RolloutCarry(env=env, agent_seat=torch.zeros(B, dtype=torch.int32),
                         use_best=torch.zeros(B, dtype=torch.bool),
                         opp_idx=torch.zeros(B, dtype=torch.int32))
    for cfg in (_sp_cfg(n_envs=B, seat_mode="fixed_random"),
                _sp_cfg(n_envs=B, seat_mode="fixed_random", rollout_impl="scan",
                        policy_impl="lax")):
        runner = SelfplayRunner(tt, model, cfg, device="cpu")
        out = runner.reset_finished(carry, bank, g, None,
                                    stacked=runner.pol.stack_bank(bank) if runner.pol else None)
        for name in FIELDS:  # rows that were not over are untouched
            assert torch.equal(getattr(out.env, name)[~done], getattr(env, name)[~done]), name
        fresh = out.env.stones[done]
        # the agent holds seat 0: no opening move, the sampled board as drawn
        assert (out.env.move_count[done] == 0).all() and (out.env.to_move[done] == 0).all()
        assert not out.env.done[done].any()
        assert int(fresh.sum()) > 0 and not torch.equal(fresh, env.stones[done])
        counts = fresh[:, 0].sum(-1) - fresh[:, 1].sum(-1)
        assert (counts == 0).all()  # sampled boards hold equal halves
        assert torch.equal(out.env.empty[done],
                           tt.num_cells - fresh.sum(dim=(1, 2)).to(torch.int32))


def test_evaluator_starts_from_sampled_boards():
    """The repair: under ``sample_board`` the plain eval loop starts its
    episodes from sampled boards, not empty ones."""
    tt = get_topology(5)
    model = make_policy("MLP-default", tt.num_cells)
    evaluator = Evaluator(tt, model, _sp_cfg(), device="cpu")
    assert evaluator.fused_pol is None
    # (a small submatrix may hold no stone: not all boards, but some, are empty)
    starts = evaluator.start_states(6, torch.Generator().manual_seed(2))
    assert int(starts.stones.sum()) > 0 and (starts.to_move == 0).all()

    seen = []
    original = evaluator._opponent_move

    def spy(served, st, generator, active):
        seen.append(st)
        return original(served, st, generator, active)

    evaluator._opponent_move = spy
    params = dict(model.state_dict())
    rewards = evaluator.play_vs_pool(params, init_bank(params, 3),
                                     torch.Generator().manual_seed(3))
    assert rewards.shape == (4,)
    first = seen[0]  # the state before the opening move
    assert int(first.stones.sum()) > 0 and (first.move_count == 0).all()

    empty_eval = Evaluator(tt, model, _sp_cfg(sample_board=False, rollout_impl="scan"),
                           device="cpu")
    assert int(empty_eval.start_states(6, torch.Generator().manual_seed(2)).stones.sum()) == 0


def test_selfplay_ppo_with_sample_board_trains_and_evaluates():
    cfg = TrainConfig(
        ppo=PPOConfig(n_steps=8, minibatch_size=32, n_epochs=2),
        selfplay=_sp_cfg(), total_timesteps=64)
    algo = SelfplayPPO(cfg, device="cpu")
    assert algo.runner.fused_pol is None and algo.evaluator.fused_pol is None
    state = algo.init_state(0)
    state, metrics = algo.train_step(state)
    assert np.isfinite(float(metrics.ppo.policy_loss)) and state.opt_state.count == 2 * 2
    state, result = algo.eval_step(state)
    assert result.rewards.shape == (4,)
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
