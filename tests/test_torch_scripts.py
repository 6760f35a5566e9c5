"""The port's remaining entry points against the JAX package's, on the CPU:
``scripts/train.py`` (the preset list, a tiny run, ``--resume``,
``--seed-pool``, ``--multichip`` in one process), ``export_agent.py`` (with
the JAX script's shape flags), ``--checkpoint`` as a bare orbax directory or
``params:`` file for ``play_cli.py`` and ``play_gui.py``,
``train_legacy.py`` (against a numpy replay of its pool protocol),
``play_cli.py`` (the sessions of ``tests/test_play_cli.py``; ``genmove``'s
logits against the JAX forward of the orbax snapshot), ``play_gui.py``
(headless, SDL_VIDEODRIVER=dummy) and the port's ``__graft_entry__.py`` (the
actor step exactly against the JAX package's ``entry()`` on its converted
params, ``dryrun_multichip(2)`` over gloo)."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.models.loading import load_policy_params as jax_load

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.experiments import list_experiments
from hex_gym_env_tpu_torch.models.convert import flax_state_dict
from hex_gym_env_tpu_torch.models.loading import agent_path, load_policy_params, spec_from_path
from hex_gym_env_tpu_torch.scripts import export_agent, play_cli, train, train_legacy
from hex_gym_env_tpu_torch.utils.checkpoint import CheckpointManager, load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--experiment", "5x5_MLP-default_lr-0.0003", "--n-envs", "8", "--n-steps", "4",
        "--minibatch-size", "16", "--eval-freq", "32", "--checkpoint-every", "32", "--cpu"]
PER_ITER = 32  # TINY's transitions per iteration


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_dir(tmp_path, name="5x5_MLP-default_lr-0.0003"):
    return CheckpointManager(os.path.join(tmp_path, "models", name))


# ---------------------------------------------------------------------------
# scripts/train.py, export_agent.py
# ---------------------------------------------------------------------------

def test_train_list_equals_the_registry(capsys):
    train.main(["--list"])
    assert capsys.readouterr().out.splitlines() == list_experiments()


def test_train_writes_metrics_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train.main(TINY + ["--total-timesteps", str(2 * PER_ITER)])
    out = capsys.readouterr().out
    assert f"training 5x5_MLP-default_lr-0.0003: {2 * PER_ITER} transitions on 1 device(s)" in out
    with open(tmp_path / "log" / "5x5_MLP-default_lr-0.0003" / "metrics.jsonl") as f:
        lines = f.read().splitlines()
    assert sum('"eval/mean_reward"' in line for line in lines) == 2
    assert _run_dir(tmp_path).latest_step() == 2 * PER_ITER

    train.main(TINY + ["--total-timesteps", str(3 * PER_ITER), "--resume"])
    resumed = _run_dir(tmp_path).restore()
    assert resumed.iteration == 3
    train.main(TINY + ["--total-timesteps", str(3 * PER_ITER), "--model-name", "one_go"])
    one_go = _run_dir(tmp_path, "one_go").restore()
    for k in one_go.params:
        assert torch.equal(resumed.params[k], one_go.params[k]), k

    # export_agent: the latest checkpoint's params as a params: file
    path = export_agent.main(["--experiment", "5x5_MLP-default_lr-0.0003", "--cpu"])
    assert path == os.path.join("models", "5x5_MLP-default_lr-0.0003", f"agent_{3 * PER_ITER}.pt")
    exported = load_params(path)
    for k in resumed.params:
        assert torch.equal(exported[k], resumed.params[k]), k
    _, loaded = load_policy_params(f"params:{path}", 5, device="cpu")
    assert all(torch.equal(loaded[k], exported[k]) for k in exported)
    first = export_agent.main(["--experiment", "5x5_MLP-default_lr-0.0003", "--cpu",
                               "--step", str(PER_ITER), "--out", str(tmp_path / "first.pt")])
    first_state = _run_dir(tmp_path).restore(PER_ITER)
    assert all(torch.equal(load_params(first)[k], first_state.params[k])
               for k in first_state.params)


def test_train_seed_pool_plants_the_member(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    spec = f"params:{agent_path(5)}"
    train.main(TINY + ["--total-timesteps", str(PER_ITER), "--eval-freq", "1000000",
                       "--seed-pool", spec])
    state = _run_dir(tmp_path).restore()
    _, planted = load_policy_params(spec, 5, device="cpu")
    for k, v in planted.items():
        assert torch.equal(state.bank.params[k][0], v), k
        assert torch.equal(state.bank.best_params[k], v), k
        assert not state.bank.params[k][1].any()
    assert float(state.bank.scores[0]) == 0.5 and float(state.bank.best_score) == 0.5


def test_train_multichip_on_the_cpu_runs_in_one_process(tmp_path, monkeypatch, capsys):
    from hex_gym_env_tpu_torch.parallel import bootstrap

    for var in bootstrap.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    train.main(TINY + ["--total-timesteps", str(2 * PER_ITER), "--multichip",
                       "--model-name", "mc"])
    assert "training mc: 64 transitions on 1 device(s)" in capsys.readouterr().out
    assert not dist.is_initialized()  # the script's group of one is gone
    single = _run_dir(tmp_path, "mc").restore()
    assert single.iteration == 2 and single.carry.agent_seat.shape == (8,)


def test_export_agent_takes_the_jax_shape_flags(tmp_path, monkeypatch, capsys):
    """The JAX usage line's flags (``scripts/export_agent.py:9-11``): the
    shapes that match the checkpoint export; ``--n-steps`` and
    ``--minibatch-size`` are never refused; a mismatched ``--n-envs`` exits
    naming both values."""
    monkeypatch.chdir(tmp_path)
    train.main(TINY + ["--total-timesteps", str(PER_ITER), "--model-name", "7x7_vs_ref"])
    state = _run_dir(tmp_path, "7x7_vs_ref").restore()
    base = ["--experiment", "5x5_MLP-default_lr-0.0003", "--model-name", "7x7_vs_ref",
            "--step", str(PER_ITER), "--cpu"]
    for n_steps, mbs in (("4", "16"), ("128", "1024")):
        out = str(tmp_path / f"agent_{n_steps}.pt")
        path = export_agent.main(base + ["--n-envs", "8", "--n-steps", n_steps,
                                         "--minibatch-size", mbs, "--out", out])
        assert path == out
        exported = load_params(path)
        assert all(torch.equal(exported[k], state.params[k]) for k in state.params)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        export_agent.main(base + ["--n-envs", "512", "--n-steps", "128",
                                  "--minibatch-size", "1024", "--out", str(tmp_path / "x.pt")])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "--n-envs 512" in err and "holds 8 envs" in err
    assert not os.path.exists(tmp_path / "x.pt")


def test_train_flags_map_to_the_jax_overrides():
    """Every flag of the JAX package's script parses here, to the same
    config fields."""
    args = train.parser().parse_args([
        "--experiment", "7x7_MLP-default_lr-0.0003", "--iters-per-dispatch", "3",
        "--update-impl", "lax", "--policy-impl", "pallas", "--rollout-impl", "scan",
        "--env-step-impl", "lax", "--bank-bf16", "--symmetric-eval", "--pool-score-decay",
        "0.001", "--cnn-bank-mode", "dense", "--learning-rate", "0.001", "--seed", "4"])
    cfg = train.config_from_args(args)
    assert (cfg.iters_per_dispatch, cfg.ppo.update_impl, cfg.selfplay.policy_impl,
            cfg.selfplay.rollout_impl, cfg.selfplay.env_step_impl) == (
        3, "lax", "pallas", "scan", "lax")
    assert cfg.selfplay.rollout_bank_bf16 and cfg.selfplay.symmetric_eval
    assert (cfg.selfplay.pool_score_decay, cfg.selfplay.cnn_bank_mode, cfg.ppo.learning_rate,
            cfg.selfplay.seed) == (0.001, "dense", 0.001, 4)
    with open(os.path.join(REPO, "scripts", "train.py")) as f:
        jax_flags = {tok.split('"')[1] for tok in f.read().split("add_argument(")[1:]}
    port_flags = {a.option_strings[0] for a in train.parser()._actions if a.option_strings}
    assert jax_flags <= port_flags


# ---------------------------------------------------------------------------
# scripts/train_legacy.py
# ---------------------------------------------------------------------------

def test_train_legacy_pool_against_a_numpy_replay(tmp_path, monkeypatch):
    """Three bursts into a history of two: the pool's slots, scores and
    best against a numpy replay of the JAX script's append (its ``:64-84``)."""
    cfg = train_legacy.legacy_config(3, 3, 32, 2, 8)
    snapshots = []
    _, state = train_legacy.run_bursts(
        cfg, 3, "cpu", lambda b, st, m: snapshots.append({k: v.numpy().copy()
                                                          for k, v in st.params.items()}))
    stack = {k: np.zeros((2,) + v.shape, np.float32) for k, v in snapshots[0].items()}
    scores, best, best_score = np.zeros(2, np.float32), None, None
    for burst, params in enumerate(snapshots, start=1):
        slot = (burst - 1) % 2
        for k in stack:
            stack[k][slot] = params[k]
        scores[slot] = burst
        best, best_score = params, np.float32(burst)
    for k in stack:
        np.testing.assert_array_equal(state.bank.params[k].numpy(), stack[k])
        np.testing.assert_array_equal(state.bank.best_params[k].numpy(), best[k])
    np.testing.assert_array_equal(state.bank.scores.numpy(), scores)
    assert float(state.bank.best_score) == best_score == 3.0
    assert state.iteration == 3

    monkeypatch.chdir(tmp_path)
    train_legacy.main(["--board-size", "3", "--bursts", "3", "--history", "2", "--n-envs", "8",
                       "--burst-steps", "32", "--cpu"])
    final = load_params(os.path.join("models", "legacy_3x3", "final"))
    for k in final:
        assert torch.equal(final[k], state.params[k]), k


# ---------------------------------------------------------------------------
# scripts/play_cli.py, play_gui.py
# ---------------------------------------------------------------------------

def run_gtp(commands: str, *flags) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-m", "hex_gym_env_tpu_torch.scripts.play_cli", "--cpu", *flags],
        input=commands, capture_output=True, text=True, cwd=REPO, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def test_gtp_session_plays_a_full_game():
    lines = run_gtp("protocol_version\nname\nboardsize 3\nplay b a1\ngenmove w\nshowboard\n"
                    "final_score\nlist_commands\nquit\n")
    text = "\n".join(lines)
    assert "= 2" in text
    assert any(line.startswith("= ") and "hex" in line.lower() for line in lines)
    assert "?" not in [line[:1] for line in lines if line]
    assert any(line.startswith("= ") and len(line.split()) == 2 and line.split()[1][0].isalpha()
               and line.split()[1][1:].isdigit() for line in lines)


def test_gtp_rejects_illegal_and_scores_win():
    lines = run_gtp("boardsize 3\nplay b a1\nplay w a1\nplay b b1\nplay w a2\nplay b c1\n"
                    "final_score\nquit\n")
    assert any(line.startswith("?") for line in lines), lines


def test_genmove_logits_match_the_jax_forward_of_the_orbax_snapshot():
    game = play_cli.CliGame(7, checkpoint=f"params:{agent_path(7)}", device="cpu")
    _, variables = jax_load(
        f"orbax:{os.path.join(REPO, 'models', '7x7_strict_sb3', 'agent_9437184')}", 7)
    from hex_gym_env_tpu.models import make_policy as jax_make_policy

    jmodel = jax_make_policy("MLP-default", 49)
    for cmd in ("play b d4", "genmove w", "play b c3", None):
        obs = game.env.observation
        want = np.asarray(jmodel.apply(variables, jnp.asarray(obs, jnp.float32)[None])[0])
        np.testing.assert_allclose(game.logits().numpy(), want, rtol=0, atol=2e-5)
        if cmd is not None:
            ok, reply = game.respond(cmd)
            assert ok, reply
    ok, move = game.respond("genmove w")
    assert ok and move[0] in "abcdefg" and 1 <= int(move[1:]) <= 7
    assert play_cli.policy_spec("r.zip", None) == "sb3:r.zip"
    assert play_cli.policy_spec(None, None) == "random"


ORBAX_7X7 = os.path.join(REPO, "models", "7x7_strict_sb3", "agent_9437184")


def test_spec_from_path_maps_bare_paths():
    assert spec_from_path(ORBAX_7X7) == f"orbax:{ORBAX_7X7}"
    assert spec_from_path(agent_path(7)) == f"params:{agent_path(7)}"
    for spec in (f"params:{agent_path(7)}", f"orbax:{ORBAX_7X7}", "random", "sb3:r.zip"):
        assert spec_from_path(spec) == spec
    assert play_cli.policy_spec(None, ORBAX_7X7) == f"orbax:{ORBAX_7X7}"
    assert play_cli.policy_spec(None, agent_path(7)) == f"params:{agent_path(7)}"


def test_play_cli_takes_a_bare_directory_and_a_bare_file():
    """A bare orbax directory (what the JAX script takes) and a bare params:
    file play the same agent as its prefixed spec."""
    for bare in (ORBAX_7X7, agent_path(7)):
        want = play_cli.CliGame(7, checkpoint=f"params:{agent_path(7)}", device="cpu")
        game = play_cli.CliGame(7, checkpoint=bare, device="cpu")
        assert all(torch.equal(game.params[k], want.params[k]) for k in want.params)
        for cmd in ("play b d4", "genmove w", "play b c3", "genmove w"):
            assert game.respond(cmd) == want.respond(cmd)


def test_play_gui_takes_a_bare_directory_and_a_bare_file(monkeypatch):
    from hex_gym_env_tpu_torch.scripts import play_gui

    class Built(Exception):
        pass

    def build(board_size, spec, agent_seat, overlay, device):
        _, params = load_policy_params(spec, board_size, device=device)
        raise Built(spec, params)

    monkeypatch.setattr(play_gui, "build", build)
    _, want = load_policy_params(f"params:{agent_path(7)}", 7, device="cpu")
    for bare, kind in ((ORBAX_7X7, "orbax"), (agent_path(7), "params")):
        with pytest.raises(Built) as e:
            play_gui.main(["--board-size", "7", "--checkpoint", bare, "--cpu"])
        spec, params = e.value.args
        assert spec == f"{kind}:{bare}"
        assert all(torch.equal(params[k], want[k]) for k in want)


def test_play_gui_builds_headless_and_plays_a_move(monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    pygame = pytest.importorskip("pygame")
    from hex_gym_env_tpu_torch.scripts.play_gui import build

    env, act = build(5, f"params:{agent_path(5)}", agent_seat=0, device="cpu")
    try:
        obs, _ = env.reset()
        a = act(obs, env.legal_actions())
        _, params = load_policy_params(f"params:{agent_path(5)}", 5, device="cpu")
        logits = torch.func.functional_call(_module(5), params,
                                            (torch.as_tensor(obs, dtype=torch.float32)[None],))[0]
        assert a == int(torch.argmax(logits))  # the empty board: every cell legal
        gui = env.opponent_model.gui
        y, x = divmod(a, 5)
        reply = next((r, c) for r in range(5) for c in range(5)
                     if (r, c) != (y, x) and (c, r) != (y, x))
        center = gui.get_center(reply[0] + 1, reply[1] + 1)
        pygame.event.post(pygame.event.Event(pygame.MOUSEBUTTONDOWN, button=1,
                                             pos=(int(center[0]), int(center[1]))))
        _, _, done, _, _ = env.step(a)
        assert not done and int((env.world_board() != 0).sum()) == 2
    finally:
        pygame.quit()


def _module(n):
    from hex_gym_env_tpu_torch.models import make_policy

    return make_policy("MLP-default", n * n)


# ---------------------------------------------------------------------------
# __graft_entry__.py
# ---------------------------------------------------------------------------

def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location("jax_graft_entry",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        spec.loader.exec_module(mod)
        return mod.entry()
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)


def test_graft_entry_actor_step_matches_jax():
    """50 actor steps (games finish and reset): JAX's step with its own
    key; the port's on the converted params with words that make its
    Gumbel-max draw JAX's action.  Observations, masks, states and rewards
    exact; logits and values within 2e-5."""
    from hex_gym_env_tpu_torch.__graft_entry__ import entry

    jfn, (jparams, jstate, key) = _jax_graft_entry()
    jstep = jax.jit(jfn)
    fn, (_, state, gen) = entry("cpu")
    params = flax_state_dict(jax.tree.map(np.asarray, {"params": jparams}))
    from hex_gym_env_tpu.models import MlpPolicy as JaxMlpPolicy
    from hex_gym_env_tpu.core.topology import get_topology as jax_topology
    from hex_gym_env_tpu_torch.core.topology import get_topology

    jtopo, topo = jax_topology(7), get_topology(7)
    jmodel = JaxMlpPolicy(n_actions=49)
    resets = 0
    for t in range(50):
        key, k = jax.random.split(key)
        obs_j = np.array(jax_env.observe(jtopo, jstate))
        legal_j = np.asarray(jax_env.legal_mask(jtopo, jstate))
        np.testing.assert_array_equal(hex_env.observe(topo, state).numpy(), obs_j)
        np.testing.assert_array_equal(hex_env.legal_mask(topo, state).numpy(), legal_j)
        logits_j = np.asarray(jmodel.apply({"params": jparams}, obs_j.astype(np.float32))[0])
        jstate, (action_j, rewards_j, value_j) = jstep(jparams, jstate, k)
        action_j = np.array(action_j)
        bits = torch.zeros((1024, 49), dtype=torch.int32)
        bits[torch.arange(1024), torch.from_numpy(action_j).long()] = -1  # the word 0xFFFFFFFF
        with torch.no_grad():
            logits = torch.func.functional_call(_module(7), params, (
                torch.from_numpy(obs_j).to(torch.float32),))[0]
        np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0, atol=2e-5)
        state, (action, rewards, value) = fn(params, state, gen, bits=bits)
        np.testing.assert_array_equal(action.numpy(), action_j)
        np.testing.assert_array_equal(rewards.numpy(), np.asarray(rewards_j))
        np.testing.assert_allclose(value.numpy(), np.asarray(value_j), rtol=0, atol=2e-5)
        for name in ("stones", "to_move", "done", "winner", "empty", "move_count"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        np.testing.assert_array_equal(state.labels.numpy(), np.asarray(jstate.labels))
        resets += int((np.asarray(rewards_j) != 0).any(axis=1).sum())
    assert resets > 0  # games ended and were reset


def test_dryrun_multichip_two_ranks_on_the_cpu():
    from hex_gym_env_tpu_torch.__graft_entry__ import dryrun_multichip

    dryrun_multichip(2, device="cpu")
