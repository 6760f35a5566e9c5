"""The port's env core against the JAX package and the scalar oracle.

Inputs (actions, active masks, reset masks) come from a seeded numpy
generator and go to both packages; every state field, reward, observation
and legal mask must be exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core import topology as jax_topology
from hex_gym_env_tpu.ops import pallas_step

from hex_gym_env_tpu_torch.core import env as torch_env
from hex_gym_env_tpu_torch.core import topology as torch_topology
from hex_gym_env_tpu_torch.core.state import Winner
from hex_gym_env_tpu_torch.models.convert import state_from_numpy
from hex_gym_env_tpu_torch.ops import labels as torch_labels
from hex_gym_env_tpu_torch.ops import step_kernel

from golden import GoldenHexEnv

FIELDS = ("stones", "labels", "to_move", "done", "winner", "empty", "move_count")


def assert_state_equal(jax_state, torch_state, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(torch_state, name).numpy(), np.asarray(getattr(jax_state, name)),
            err_msg=f"{name} {msg}",
        )


@pytest.mark.parametrize("n", [2, 3, 5, 7, 11, 13])
def test_topology_tables_equal(n):
    a, b = jax_topology.get_topology(n), torch_topology.get_topology(n)
    assert (a.n, a.num_cells, a.lanes, a.neighbor_shifts) == (
        b.n, b.num_cells, b.lanes, b.neighbor_shifts)
    for name in ("cell_mask", "neighbor_masks", "edge_masks", "virtual_ids",
                 "uf_nbr_ids", "uf_nbr_valid", "uf_slot_is_virtual"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("n", [3, 4, 5, 7, 9, 11])
def test_random_trajectories_match_jax(n):
    """Illegal moves, inactive games, already-done games and partial resets
    mixed in; observe/legal_mask/step/reset_where checked every step."""
    B = 24
    rng = np.random.default_rng(n)
    jt, tt = jax_topology.get_topology(n), torch_topology.get_topology(n)
    js = jax_env.initial_state(jt, B)
    ts = torch_env.initial_state(tt, B, device="cpu")
    jstep = jax.jit(lambda s, a, act: jax_env.step(jt, s, a, act))
    jreset = jax.jit(lambda s, m: jax_env.reset_where(jt, s, m))
    jobs = jax.jit(lambda s: (jax_env.observe(jt, s), jax_env.legal_mask(jt, s)))
    for t in range(2 * n * n):
        obs_j, legal_j = jobs(js)
        np.testing.assert_array_equal(torch_env.observe(tt, ts).numpy(), np.asarray(obs_j))
        np.testing.assert_array_equal(torch_env.legal_mask(tt, ts).numpy(), np.asarray(legal_j))
        legal = np.asarray(legal_j)
        actions = np.array(
            [rng.choice(np.flatnonzero(row)) if row.any() and rng.random() > 0.1
             else rng.integers(0, n * n) for row in legal], dtype=np.int32)
        active = rng.random(B) > 0.2
        js, jr = jstep(js, jnp.asarray(actions), jnp.asarray(active))
        ts, tr = torch_env.step(tt, ts, torch.from_numpy(actions), torch.from_numpy(active))
        assert_state_equal(js, ts, f"after step {t}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=f"rewards {t}")
        if t % 5 == 4:
            mask = np.asarray(js.done) & (rng.random(B) > 0.5)
            js = jreset(js, jnp.asarray(mask))
            ts = torch_env.reset_where(tt, ts, torch.from_numpy(mask))
            assert_state_equal(js, ts, f"after reset {t}")
    assert np.asarray(js.done).any()
    assert (np.asarray(js.winner) == int(Winner.INVALID)).any()


@pytest.mark.parametrize("n", [3, 6])
def test_step_kernel_twin_matches_pallas_step(n):
    """K1: the port's step on a CPU state (the twin) vs the Pallas step in
    interpret mode, from identical mid-game states."""
    B = 16
    rng = np.random.default_rng(100 + n)
    jt, tt = jax_topology.get_topology(n), torch_topology.get_topology(n)
    js = jax_env.initial_state(jt, B)
    for _ in range(n):
        legal = np.asarray(jax_env.legal_mask(jt, js))
        a = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal], np.int32)
        js, _ = jax_env.step(jt, js, jnp.asarray(a))
    ts = state_from_numpy(js)
    for t in range(3):
        actions = rng.integers(0, n * n, B).astype(np.int32)
        active = rng.random(B) > 0.25
        js, jr = pallas_step.step(
            jt, js, jnp.asarray(actions), jnp.asarray(active), block=16, interpret=True)
        ts, tr = step_kernel.step(tt, ts, torch.from_numpy(actions), torch.from_numpy(active))
        assert_state_equal(js, ts, f"step {t}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("n", [3, 5, 7])
def test_golden_oracle_parity(n):
    """The port's env against the scalar numpy oracle, with invalid moves."""
    G = 8
    tt = torch_topology.get_topology(n)
    rng = np.random.default_rng(7 * n)
    goldens = [GoldenHexEnv(n) for _ in range(G)]
    gold_obs = np.stack([g.reset() for g in goldens])
    gold_done = np.zeros(G, bool)
    ts = torch_env.initial_state(tt, G, device="cpu")
    for t in range(n * n + 3):
        obs = torch_env.observe(tt, ts).numpy()
        mask = torch_env.legal_mask(tt, ts).numpy()
        actions = np.zeros(G, np.int32)
        for i, g in enumerate(goldens):
            if gold_done[i]:
                continue
            np.testing.assert_array_equal(obs[i], gold_obs[i])
            np.testing.assert_array_equal(mask[i], g.legal_actions())
            illegal = np.flatnonzero(~g.legal_actions())
            if len(illegal) and rng.random() < 0.1:
                actions[i] = rng.choice(illegal)
            else:
                actions[i] = rng.choice(np.flatnonzero(g.legal_actions()))
        ts, rewards = torch_env.step(tt, ts, torch.from_numpy(actions))
        for i, g in enumerate(goldens):
            if gold_done[i]:
                continue
            g_obs, g_rew, g_done, g_winner = g.step(int(actions[i]))
            gold_obs[i] = g_obs
            np.testing.assert_array_equal(rewards[i].numpy(), np.asarray(g_rew, np.float32))
            assert bool(ts.done[i]) == g_done
            if g_done:
                gold_done[i] = True
                if g_winner is not None:
                    assert int(ts.winner[i]) == g_winner
        if gold_done.all():
            break
    assert gold_done.all()


def test_labels_helpers_match_jax():
    from hex_gym_env_tpu.ops import labels as jax_labels

    n, B = 5, 12
    rng = np.random.default_rng(3)
    jt, tt = jax_topology.get_topology(n), torch_topology.get_topology(n)
    js = jax_env.initial_state(jt, B)
    for _ in range(14):
        legal = np.asarray(jax_env.legal_mask(jt, js))
        a = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal], np.int32)
        js, _ = jax_env.step(jt, js, jnp.asarray(a))
    labels_t = torch.from_numpy(np.array(js.labels))
    np.testing.assert_array_equal(
        torch_labels.initial_labels(tt, B).numpy(), np.asarray(jax_labels.initial_labels(jt, B)))
    for seat in (0, 1):
        np.testing.assert_array_equal(
            torch_labels.seat_wins(tt, labels_t, seat).numpy(),
            np.asarray(jax_labels.seat_wins(jt, js.labels, seat)))
        for end in (0, 1):
            np.testing.assert_array_equal(
                torch_labels.connected_to_edge(tt, labels_t, seat, end).numpy(),
                np.asarray(jax_labels.connected_to_edge(jt, js.labels, seat, end)))


def test_make_ops_dispatch():
    tt = torch_topology.get_topology(4)
    assert torch_env.resolve_step_impl("lax") is torch_env.step
    assert torch_env.resolve_step_impl("auto") is step_kernel.step
    assert torch_env.resolve_step_impl("pallas") is step_kernel.step_cuda
    with pytest.raises(ValueError):
        torch_env.resolve_step_impl("LAX")
    ops = torch_env.make_ops(tt, impl="auto", device="cpu")
    s = ops.initial_state(3)
    s2, r = ops.step(s, torch.tensor([0, 5, 15]))
    s3, r3 = torch_env.step(tt, s, torch.tensor([0, 5, 15]))
    for name in FIELDS:
        assert torch.equal(getattr(s2, name), getattr(s3, name))
    assert torch.equal(ops.observe(s2), torch_env.observe(tt, s2))
    assert torch.equal(ops.legal_mask(s2), torch_env.legal_mask(tt, s2))
    reset = ops.reset_where(s2, torch.tensor([True, False, True]))
    assert int(reset.move_count[0]) == 0 and int(reset.move_count[1]) == 1
