"""The port's compat surface: the Gymnasium adapters and the selfplay
wrapper, on the CPU, against the scalar oracle and the JAX package's
``HexEnv`` on the same action sequences (counterparts of
``tests/test_compat.py``)."""

import numpy as np
import pytest
import torch

from hex_gym_env_tpu.compat import HexEnv as JaxHexEnv
from hex_gym_env_tpu.compat import register_envs as jax_register_envs

from hex_gym_env_tpu_torch.compat import (
    BaseRandomPolicy,
    HexEnv,
    HexEnvV0,
    OpponentPolicy,
    TorchOpponentPolicy,
    register_envs,
    selfplay_wrapper,
)
from hex_gym_env_tpu_torch.core import env as core_env
from hex_gym_env_tpu_torch.models.loading import agent_path, load_policy_params

from golden import GoldenHexEnv

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hex_env_matches_golden():
    env = HexEnv(board_size=5, device=CPU)
    gold = GoldenHexEnv(5)
    rng = np.random.default_rng(0)
    obs, info = env.reset()
    gobs = gold.reset()
    np.testing.assert_array_equal(obs, gobs)
    done = False
    while not done:
        legal = np.flatnonzero(env.legal_actions())
        np.testing.assert_array_equal(env.legal_actions(), gold.legal_actions())
        a = int(rng.choice(legal))
        obs, reward, done, _ = env.step(a)
        gobs, greward, gdone, gwinner = gold.step(a)
        np.testing.assert_array_equal(obs, gobs)
        assert reward == [float(greward[0]), float(greward[1])]
        assert done == gdone
    assert env.winner == gold.sim.winner


def test_hex_env_invalid_move():
    env = HexEnv(board_size=4, device=CPU)
    env.reset()
    env.step(5)
    obs, reward, done, _ = env.step(5)  # same cell in the new frame: occupied
    assert done and env.winner == 3 and reward == [0.0, 0.0]


def test_registration():
    register_envs()
    import gymnasium as gym

    env = gym.make("hex_gym_env_tpu_torch/hex-v0", board_size=4, device=CPU,
                   disable_env_checker=True)
    obs, _ = env.reset()
    assert obs.shape == (4, 4)
    assert set(np.unique(obs)).issubset({0, 1, 2})


@pytest.mark.parametrize("port_first", [True, False])
def test_gym_ids_of_both_packages_coexist(port_first, monkeypatch):
    """Either package may register first (one test worker imports both):
    ``hex-v0`` and ``hex-single-v0`` still make the JAX package's envs, and
    the namespaced ids make the port's."""
    import gymnasium as gym
    from gymnasium.envs.registration import registry

    from hex_gym_env_tpu.compat.gym_env import HexEnvV0 as JaxHexEnvV0

    ids = ("hex-v0", "hex-single-v0",
           "hex_gym_env_tpu_torch/hex-v0", "hex_gym_env_tpu_torch/hex-single-v0")
    for env_id in ids:
        monkeypatch.delitem(registry, env_id, raising=False)
    order = (register_envs, jax_register_envs) if port_first else (jax_register_envs, register_envs)
    for fn in order:
        fn()
        fn()  # registering twice is a no-op
    kw = dict(board_size=3, disable_env_checker=True)
    assert type(gym.make("hex-v0", **kw).unwrapped) is JaxHexEnvV0
    assert type(gym.make("hex-single-v0", **kw).unwrapped) is JaxHexEnv
    assert type(gym.make("hex_gym_env_tpu_torch/hex-v0", device=CPU, **kw).unwrapped) is HexEnvV0
    assert type(gym.make("hex_gym_env_tpu_torch/hex-single-v0", device=CPU,
                         **kw).unwrapped) is HexEnv


def test_hex_v0_full_episode_rewards():
    env = HexEnvV0(board_size=5, opponent_policy="random", seed=3, device=CPU)
    rng = np.random.default_rng(1)
    for _ in range(3):
        obs, _ = env.reset()
        done, reward = False, 0.0
        while not done:
            legal = np.flatnonzero(env.legal_actions())
            obs, reward, done, trunc, info = env.step(int(rng.choice(legal)))
            assert set(np.unique(obs)).issubset({0, 1, 2})
        assert reward in (1.0, -1.0)


def test_hex_v0_invalid_gives_minus_100():
    env = HexEnvV0(board_size=4, seed=0, device=CPU)
    env.reset()
    obs, r1, d1, _, _ = env.step(0)
    assert not d1
    # cell 0 is now occupied by the agent (world frame); replay it
    obs, r2, d2, _, _ = env.step(0)
    assert d2 and r2 == -100.0


class _ScriptedModel:
    """SB3-predict duck type that always picks the first legal action."""

    def predict(self, board, deterministic=False, action_masks=None):
        return int(np.flatnonzero(action_masks)[0]), None

    def save(self, path):
        pass


def test_selfplay_wrapper_protocol():
    SelfPlay = selfplay_wrapper(HexEnv)
    env = SelfPlay(board_size=5, buffer_size=6, device=CPU)
    assert len(env.get_opponent_models()) == 6
    assert len(env.get_scores()) == 6
    assert all(isinstance(m, BaseRandomPolicy) for m in env.get_opponent_models())

    obs, info = env.reset()
    assert env.agent_player_num in (0, 1)
    seat = env.agent_player_num
    # run one episode: the wrapper returns the scalar agent reward
    rng = np.random.default_rng(2)
    done = False
    while not done:
        legal = np.flatnonzero(env.legal_actions())
        obs, reward, done, trunc, _ = env.step(int(rng.choice(legal)))
    assert reward in (-1.0, 0.0, 1.0)
    # the reference quirk: seat fixed after first reset
    env.reset()
    assert env.agent_player_num == seat

    # pool mutation + best promotion
    m = _ScriptedModel()
    env.set_opponent_model(2, m, 3.5)
    assert isinstance(env.get_opponent_models()[2], OpponentPolicy)
    assert env.best_score == 3.5
    # append (fixed vs reference bug: list append + score growth)
    env.append_opponent_model(_ScriptedModel())
    assert len(env.get_opponent_models()) == 7
    assert len(env.get_scores()) == 7

    # eval mode iterates the pool
    env.set_eval(True)
    seen = []
    for _ in range(3):
        env.reset()
        seen.append(env.opponent_model)
    assert seen[0] is env.get_opponent_models()[0]
    assert seen[1] is env.get_opponent_models()[1]
    env.set_eval(False)


def test_selfplay_wrapper_sampled_board():
    SelfPlay = selfplay_wrapper(HexEnv)
    env = SelfPlay(board_size=7, buffer_size=3, sample_board=True, device=CPU)
    obs, _ = env.reset()
    assert obs.shape == (7, 7)


def test_module_random_policy_matches_reference_semantics():
    """Free-function twin of ``minihex.random_policy`` (__init__.py:8-12):
    uniform over cells == 2 in variant-A encoding."""
    from hex_gym_env_tpu_torch.compat.gym_env import random_policy

    board = np.full((4, 4), 0)
    board[1, 2] = 1
    board[0, 0] = 2  # the single empty cell
    board[3, 3] = 2
    rng = np.random.default_rng(0)
    picks = {random_policy(board, rng) for _ in range(64)}
    assert picks <= {0, 15} and picks == {0, 15}

    # module-level export like `from minihex import random_policy`
    import hex_gym_env_tpu_torch

    assert hex_gym_env_tpu_torch.random_policy is random_policy


def test_hex_v0_render_matches_reference_table():
    """ASCII table layout of HexGame.py:305-330: numbered headers, O/B/W."""
    env = HexEnvV0(board_size=3, opponent_policy="random", seed=1, device=CPU)
    env.reset()
    out = env.render()
    lines = out.splitlines()
    assert "1" in lines[0] and "2" in lines[0] and "3" in lines[0]
    assert "O" in out  # empty cells render as O
    # a move by the agent (seat 0 = BLACK) shows up as B in the world frame
    env.step(4)
    out2 = env.render()
    assert "B" in out2


def test_hex_env_undo_and_board_edit():
    """History-backed undo + editor board commit (compat HexEnv)."""
    env = HexEnv(board_size=4, device=CPU)
    env.reset()
    obs0 = env.observation.copy()
    env.step(5)
    env.step(6)
    back = env.undo_move(2)
    np.testing.assert_array_equal(np.asarray(back), obs0)

    board = np.zeros((4, 4), np.int8)
    board[0, 0] = -1
    board[2, 2] = 1
    env.set_world_board(board)
    world = core_env.world_boards(env.topo, env._state)[0].numpy()
    np.testing.assert_array_equal(world, board)
    # edit is undoable too
    env.undo_move(1)
    np.testing.assert_array_equal(env.observation, obs0)


def test_hex_env_step_before_reset_is_a_clear_error():
    """Stepping before the first reset() raises an actionable error, and
    undo before reset is a no-op."""
    env = HexEnv(board_size=5, device=CPU)
    with pytest.raises(RuntimeError, match="reset"):
        env.step(0)
    env.undo_move(3)  # no history yet -> no-op, no crash
    env.reset(seed=0)
    obs, reward, done, info = env.step(0)
    assert obs.shape == (5, 5)


@pytest.mark.parametrize("n", [4, 5, 7])
def test_hex_env_matches_jax_hex_env(n):
    """The same action sequences (random legal moves, an occasional occupied
    cell, undo and an edited board) through the port's and the JAX package's
    ``HexEnv``: observations, legal masks, rewards, done flags and winners
    exactly equal."""
    rng = np.random.default_rng(100 + n)
    port, ref = HexEnv(board_size=n, device=CPU), JaxHexEnv(board_size=n)
    for game in range(6):
        obs_p, _ = port.reset()
        obs_r, _ = ref.reset()
        np.testing.assert_array_equal(obs_p, np.asarray(obs_r))
        if game == 3:  # an edited mid-game position
            board = rng.choice(np.array([-1, 0, 0, 1], np.int8), size=(n, n))
            port.set_world_board(board)
            ref.set_world_board(board)
        done, t = False, 0
        while not done:
            legal = ref.legal_actions()
            np.testing.assert_array_equal(port.legal_actions(), np.asarray(legal))
            if t == 4 and game % 2:
                np.testing.assert_array_equal(port.undo_move(2), np.asarray(ref.undo_move(2)))
            if not np.asarray(legal).any():
                break
            invalid = game == 5 and t == 3
            a = int(rng.integers(n * n)) if invalid else int(rng.choice(np.flatnonzero(legal)))
            obs_p, rew_p, done, _ = port.step(a)
            obs_r, rew_r, done_r, _ = ref.step(a)
            np.testing.assert_array_equal(obs_p, np.asarray(obs_r))
            assert rew_p == rew_r and done == done_r
            assert port.winner == ref.winner and port.current_player_num == ref.current_player_num
            t += 1


def test_torch_opponent_policy_plays_the_trained_agent():
    """The selfplay wrapper's opponent holding the trained 5x5 agent: legal
    moves, reproducible from its seed, probabilities from the same forward."""
    from hex_gym_env_tpu_torch.compat.selfplay_wrapper import _policy_probs

    model, params = load_policy_params(f"params:{agent_path(5)}", 5, device=CPU)
    env = selfplay_wrapper(HexEnv)(board_size=5, buffer_size=2, agent_player_num=1,
                                   base_model=TorchOpponentPolicy(model, params, seed=4),
                                   device=CPU)
    obs, _ = env.reset()
    assert int((obs != 0).sum()) == 1  # the opponent opened
    picks = [TorchOpponentPolicy(model, params, seed=7).choose_action(obs, env.legal_actions())
             for _ in range(2)]
    assert picks[0] == picks[1] and env.legal_actions()[picks[0]]
    probs = _policy_probs((model, params), obs, env.legal_actions())
    assert probs.shape == (25,) and abs(probs.sum() - 1) < 1e-5
    assert (probs[~env.legal_actions()] == 0).all()
    rng = np.random.default_rng(0)
    done = False
    while not done:
        obs, reward, done, _, _ = env.step(int(rng.choice(np.flatnonzero(env.legal_actions()))))
    assert reward in (-1.0, 1.0)


def test_torch_opponent_policy_save_model(tmp_path):
    model, params = load_policy_params("random", 4, device=CPU)
    path = str(tmp_path / "best" / "model.pt")
    TorchOpponentPolicy(model, params).save_model(path)
    _, back = load_policy_params(f"params:{path}", 4, device=CPU)
    assert all(torch.equal(back[k], params[k]) for k in params)
