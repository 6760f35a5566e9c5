"""The port's native C engine: trajectory parity against the golden oracle
and the port's ``HexEnv``, and the JAX package's build of the same C source
(counterparts of ``tests/test_native.py``)."""

import os
import shutil

import numpy as np
import pytest

cc_available = shutil.which("cc") or shutil.which("gcc")
pytestmark = pytest.mark.skipif(not cc_available, reason="no C compiler")

from hex_gym_env_tpu_torch import native  # noqa: E402
from hex_gym_env_tpu_torch.native.engine import (  # noqa: E402
    NativeHexEnv,
    random_playout_throughput,
)

from golden import GoldenHexEnv  # noqa: E402


@pytest.mark.parametrize("board_size", [3, 5, 7, 11])
def test_native_matches_golden(board_size):
    rng = np.random.default_rng(board_size * 7)
    for game in range(8):
        env = NativeHexEnv(board_size)
        gold = GoldenHexEnv(board_size)
        obs = env.reset()
        gobs = gold.reset()
        np.testing.assert_array_equal(obs, gobs)
        done = False
        while not done:
            np.testing.assert_array_equal(env.legal_actions(), gold.legal_actions())
            legal = np.flatnonzero(gold.legal_actions())
            a = int(rng.choice(legal))
            obs, reward, done, _ = env.step(a)
            gobs, greward, gdone, gwinner = gold.step(a)
            np.testing.assert_array_equal(obs, gobs)
            assert reward == [float(greward[0]), float(greward[1])]
            assert done == gdone
        assert env.winner == gold.sim.winner


def test_native_invalid_move():
    env = NativeHexEnv(4)
    env.reset()
    env.step(5)
    obs, reward, done, _ = env.step(5)
    assert done and env.winner_code == 3 and reward == [0.0, 0.0]


@pytest.mark.parametrize("board_size", [5, 7])
def test_native_sampled_board_replay(board_size):
    rng = np.random.default_rng(board_size)
    board = rng.choice([-1, 0, 1], size=(board_size, board_size)).astype(np.int8)
    env = NativeHexEnv(board_size)
    env.reset(board)
    gold = GoldenHexEnv(board_size)
    gold.reset(board)
    np.testing.assert_array_equal(env.observation, gold.sim.board)
    np.testing.assert_array_equal(env.world_board(), board)
    done = False
    while not done:
        legal = np.flatnonzero(gold.legal_actions())
        if not len(legal):
            break
        a = int(rng.choice(legal))
        obs, reward, done, _ = env.step(a)
        gobs, greward, gdone, _ = gold.step(a)
        np.testing.assert_array_equal(obs, gobs)
        assert done == gdone


def test_native_playout_helper():
    winners, moves = random_playout_throughput(7, games=200, seed=42)
    assert winners.shape == (200,)
    assert set(np.unique(winners)).issubset({0, 1})  # Hex never draws
    assert moves >= 200 * 13  # shortest 7x7 game is 13 moves of both seats


@pytest.mark.parametrize("board_size, seed", [(5, 1), (7, 42), (11, 7)])
def test_playouts_equal_the_jax_build(board_size, seed, tmp_path, monkeypatch):
    """The JAX package's loader, pointed at a library path of its own so no
    other test process sees a half-built file, builds its ``hexcore.c``; the
    same seed gives the same winners and move count as the port's build."""
    import hex_gym_env_tpu.native as jax_native
    from hex_gym_env_tpu.native.engine import random_playout_throughput as jax_playouts

    monkeypatch.setattr(jax_native, "_SO", str(tmp_path / "libhexcore.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    want_w, want_moves = jax_playouts(board_size, 300, seed)
    got_w, got_moves = random_playout_throughput(board_size, 300, seed)
    assert got_moves == want_moves
    np.testing.assert_array_equal(got_w, want_w)


def test_build_lands_in_the_build_dir_keyed_by_source():
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libhexcore_") and os.path.exists(path)
    assert native.build() == path == native.library_path()
    assert not [f for f in os.listdir(native.BUILD_DIR) if f.endswith(".tmp")
                and f.startswith("libhexcore_")]


@pytest.mark.parametrize("board_size", [4, 7])
def test_native_matches_port_hex_env(board_size):
    """The check ``chip_smoke.py`` makes on the card, on the CPU: the port's
    ``HexEnv`` and the native engine on the same random legal moves."""
    from hex_gym_env_tpu_torch.compat import HexEnv

    rng = np.random.default_rng(board_size)
    env = HexEnv(board_size=board_size, device="cpu")
    for _ in range(4):
        nat = NativeHexEnv(board_size)
        obs, _ = env.reset()
        np.testing.assert_array_equal(obs, nat.observation)
        done = False
        while not done:
            legal = env.legal_actions()
            np.testing.assert_array_equal(legal, nat.legal_actions())
            a = int(rng.choice(np.flatnonzero(legal)))
            obs, reward, done, _ = env.step(a)
            nobs, nreward, ndone, _ = nat.step(a)
            np.testing.assert_array_equal(obs, nobs)
            assert reward == nreward and done == ndone
        assert env.winner == nat.winner
