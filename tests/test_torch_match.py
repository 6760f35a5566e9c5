"""The port's match and tournament scripts against the JAX package's, at
7x7 with the trained agent: with injected random words game for game
against a JAX loop that uses the same bit-to-Gumbel map, deterministic play
against the JAX ``run_match`` exactly, stochastic play in distribution; and
the Bradley-Terry fit (counterparts of ``tests/test_tournament.py``)."""

import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.topology import get_topology
from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.models.loading import load_policy_params as jax_load
from hex_gym_env_tpu.ops import masked as jax_masked

from hex_gym_env_tpu_torch.models.loading import agent_path
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.scripts.match import bits_shape, run_match
from hex_gym_env_tpu_torch.scripts.tournament import fit_elo, run_tournament

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 7
AGENT_ORBAX = os.path.join(REPO, "models", "7x7_strict_sb3", "agent_9437184")
AGENT = f"params:{agent_path(N)}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scripts_match():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_match", os.path.join(REPO, "scripts", "match.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_gumbel(bits):
    """The kernels' map from a uint32 word to Gumbel noise
    (``ops/pallas_policy._gumbel``), in plain jnp."""
    u = (bits >> 8).astype(jnp.int32).astype(jnp.float32) * 2.0**-24 + 2.0**-25
    return -jnp.log(-jnp.log(u))


@functools.partial(jax.jit, static_argnums=0)
def _jax_ply(topo, vars_a, vars_b, st, words, seat_a, a_det, b_det):
    """One ply of the match's plan on the JAX env and model (both sides
    MLP-default), with the injected words; ``a_det``/``b_det`` are traced,
    so the four modes share one compiled program."""
    model = jax_make_policy("MLP-default", topo.num_cells)

    def pick(variables, obs, legal, words, det):
        logits, _ = model.apply(variables, obs)
        drawn = jnp.argmax(jax_masked.mask_logits(logits, legal) + _jax_gumbel(words),
                           axis=-1).astype(jnp.int32)
        return jnp.where(det, jax_masked.mode(logits, legal), drawn)

    obs = jax_env.observe(topo, st).astype(jnp.float32)
    legal = jax_env.legal_mask(topo, st)
    a = pick(vars_a, obs, legal, words[0], a_det)
    b = pick(vars_b, obs, legal, words[1], b_det)
    st, _ = jax_env.step(topo, st, jnp.where(st.to_move == seat_a, a, b))
    return st


def _jax_match_winners(spec_a, spec_b, bits, a_det, b_det):
    """The JAX package's env and model on the match's plan, with the
    injected words: ``bits`` (plies, 2, games, cells) uint32."""
    topo = get_topology(N)
    _, vars_a = jax_load(spec_a, N)
    _, vars_b = jax_load(spec_b, N)
    games = bits.shape[2]
    seat_a = jnp.arange(games, dtype=jnp.int32) % 2
    st = jax_env.initial_state(topo, games)
    for t in range(bits.shape[0]):
        st = _jax_ply(topo, vars_a, vars_b, st, jnp.asarray(bits[t]), seat_a,
                      jnp.asarray(a_det), jnp.asarray(b_det))
    return np.asarray(st.winner)


@pytest.mark.parametrize("mode", ["stochastic", "deterministic", "a-det", "b-det"])
def test_injected_bits_match_jax_loop(mode):
    games = 256
    rng = np.random.default_rng({"stochastic": 0, "deterministic": 1, "a-det": 2, "b-det": 3}[mode])
    bits = rng.integers(0, 2**32, size=bits_shape(N, games), dtype=np.uint32)
    record = {}
    out = run_match(N, games, AGENT, "random", mode=mode, device="cpu",
                    bits=masked.bits_from_numpy(bits), record=record)
    want = _jax_match_winners(f"orbax:{AGENT_ORBAX}", "random", bits,
                              mode in ("deterministic", "a-det"), mode in ("deterministic", "b-det"))
    np.testing.assert_array_equal(record["winners"].numpy(), want)
    assert record["actions"].shape == (N * N + 1, games)
    seat = np.arange(games) % 2
    assert out["a_winrate"] == float((want == seat).mean())
    assert out["a_wins_as_seat0"] + out["a_wins_as_seat1"] == int((want == seat).sum())
    if mode != "b-det":  # the trained agent beats a random player
        assert out["a_winrate"] > 0.9


def test_deterministic_equals_jax_run_match():
    jax_match = _jax_scripts_match()
    want = jax_match.run_match(N, 256, f"orbax:{AGENT_ORBAX}", "random", mode="deterministic")
    got = run_match(N, 256, AGENT, "random", mode="deterministic", device="cpu")
    assert {k: v for k, v in got.items() if k != "a"} == {k: v for k, v in want.items() if k != "a"}
    assert got["a_winrate"] == 1.0


def test_stochastic_winrate_matches_jax_in_distribution():
    """The two packages draw from different streams: the winrates must lie
    within 4 binomial standard errors (of the difference) of each other."""
    games = 1024
    jax_match = _jax_scripts_match()
    want = jax_match.run_match(N, games, f"orbax:{AGENT_ORBAX}", "random", seed=3)
    got = run_match(N, games, AGENT, "random", seed=3, device="cpu")
    p = 0.5 * (want["a_winrate"] + got["a_winrate"])
    se = math.sqrt(max(p * (1 - p), 1.0 / games) * 2.0 / games)
    assert abs(got["a_winrate"] - want["a_winrate"]) <= 4 * se
    assert got["undecided"] == want["undecided"] == 0
    assert got["a_winrate"] > 0.9


def test_seeded_match_repeats_and_bits_are_checked():
    a = run_match(5, 64, "random", "random", seed=11, device="cpu")
    b = run_match(5, 64, "random", "random", seed=11, device="cpu")
    assert a == b and a["undecided"] == 0
    with pytest.raises(ValueError, match="bits"):
        run_match(5, 64, "random", "random", device="cpu",
                  bits=torch.zeros(bits_shape(5, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="mode"):
        run_match(5, 64, "random", "random", mode="greedy", device="cpu")


def test_tournament_self_pair_near_zero_gap():
    """Three players at 5x5: the trained agent twice (``params:`` and
    ``orbax:``) and a random player; the two copies rate alike."""
    players = [f"params:{agent_path(5)}", "random",
               f"orbax:{os.path.join(REPO, 'models', '5x5_strict_sb3', 'agent_9437184')}"]
    results, elo = run_tournament(players, board_size=5, games=256, seed=1, device="cpu")
    assert [(r["a"], r["b"]) for r in results] == [
        (players[0], players[1]), (players[0], players[2]), (players[1], players[2])]
    assert elo[0] == 0.0 and elo[1] < -400
    # 4 standard errors of an Elo gap at p = 0.5 over 256 games
    assert abs(elo[2] - elo[0]) < 4 * 400 / math.log(10) / 0.25 * math.sqrt(0.25 / 256)


def test_two_player_winrate_maps_to_elo_gap():
    # A beats B 75% of 400 games -> Elo gap = 400*log10(3) ~ 190.8
    wins = {(0, 1): 300.0, (1, 0): 100.0}
    games = {(0, 1): 400}
    elo = fit_elo(2, wins, games)
    assert elo[0] == 0.0
    assert abs((elo[0] - elo[1]) - 400 * math.log10(3)) < 1.0


def test_transitive_chain_orders_players():
    # A > B > C with 70% per link
    wins = {(0, 1): 70.0, (1, 0): 30.0, (1, 2): 70.0, (2, 1): 30.0,
            (0, 2): 88.0, (2, 0): 12.0}
    games = {(0, 1): 100, (1, 2): 100, (0, 2): 100}
    elo = fit_elo(3, wins, games)
    assert elo[0] > elo[1] > elo[2]


def test_unplayed_pairs_are_tolerated():
    wins = {(0, 1): 80.0, (1, 0): 20.0}
    games = {(0, 1): 100}  # player 2 never played
    elo = fit_elo(3, wins, games)
    assert elo[0] > elo[1]
