"""The port's verify and measure tools against the JAX package's scripts, on
the CPU: ``scripts.selftest`` (each check on the twins at a reduced size,
and a skewed draw refused), ``scripts.verify_train`` (its configuration
field by field against the one ``scripts/verify_train_tpu.py`` builds, and
its loop), ``scripts.breakdown_bench`` (the stage models' operation counts
against the JAX ``utils/roofline.py``, and a ``--cpu`` run) and
``scripts.scaling_bench`` (the multi-host model's closed form, and gloo
ranks whose collectives are counted)."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import pytest
import torch

from hex_gym_env_tpu.utils import roofline as jax_roofline

from hex_gym_env_tpu_torch.scripts import breakdown_bench, scaling_bench, selftest, verify_train
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# scripts/selftest.py
# ---------------------------------------------------------------------------

def test_selftest_step_check_on_the_twin():
    selftest.check_step(CPU, n=7, batch=64, plies=30)


def test_selftest_draw_and_reply_checks_on_generator_bits(capsys):
    stats = selftest.check_draws(CPU, batch=1024)
    assert set(stats) == {"K2 agent pass", "K3 bank pass", "K4 agent openings",
                          "K4 opponent openings"}
    assert all(0.0 < v < selftest.CHI2_CRIT for v in stats.values())
    selftest.check_reply(CPU, batch=256)
    out = capsys.readouterr().out
    assert out.count("opening-move chi-square") == 4 and "3. " in out


def test_selftest_chi_square_refuses_a_skewed_draw():
    assert selftest.chi_square(torch.arange(1000) % 25) == 0.0
    with pytest.raises(AssertionError, match="not uniform"):
        selftest.require_uniform("one cell", torch.zeros(1024, dtype=torch.int32))
    # half the draws on one cell, the rest uniform: far beyond the critical value
    skew = torch.cat([torch.zeros(512, dtype=torch.int32), torch.arange(512) % 25])
    with pytest.raises(AssertionError, match="not uniform"):
        selftest.require_uniform("skewed", skew)


def test_selftest_replay_and_gae_checks():
    selftest.check_replay(CPU, n_envs=32)
    selftest.check_gae(CPU, T=32, B=64)


def test_selftest_fast_sweep_twin_against_the_autograd_replay():
    errs = selftest.check_fast_sweep(CPU)
    # on the CPU the "kernel" is the twin itself
    assert errs["twin_step_rel"] == 0.0 and errs["twin_sweep_rel"] == 0.0
    assert errs["replay_abs"] < 1e-5


def test_selftest_mlp_forward_check_on_the_twin(capsys):
    # on the CPU the module forwards through the twin's image, and the match
    # builds no image
    assert selftest.check_mlp_forward(CPU, batch=64, match_games=16) == 0.0
    assert "launched it 0 times" in capsys.readouterr().out


def test_selftest_mlp_forward_check_keeps_the_callers_launch_counts():
    # chip_smoke.py's [tools] phase counts every kernel's launches over the
    # whole selftest: check 7 reads its match's launches without clearing them
    from hex_gym_env_tpu_torch.utils import profiling

    profiling.count("launch.k2_agent", 3)
    try:
        selftest.check_mlp_forward(CPU, batch=16, boards=(5,), match_games=4,
                                   families=("MLP-default",))
        assert profiling.counters.get("launch.k2_agent") == 3
    finally:
        profiling.take_counters()


def test_selftest_mlp_forward_check_refuses_a_stale_read(monkeypatch):
    monkeypatch.setattr(selftest.mlp_forward.BoundForward, "current", lambda self: True)
    with pytest.raises(AssertionError, match="read stale"):
        selftest.check_mlp_forward(CPU, batch=16, boards=(5,), families=("MLP-default",))


def test_selftest_replay_check_refuses_a_wrong_record(monkeypatch):
    real = selftest.rollout_kernel.verify_rollout_trajectory

    def corrupt(topo, model, params, carry, out, *args, **kwargs):
        out.flts[3, 0, selftest.rollout_kernel.F_VALUE] += 1e-3
        return real(topo, model, params, carry, out, *args, **kwargs)

    monkeypatch.setattr(selftest.rollout_kernel, "verify_rollout_trajectory", corrupt)
    with pytest.raises(AssertionError, match="value"):
        selftest.check_replay(CPU, n_envs=32)


# ---------------------------------------------------------------------------
# scripts/verify_train.py
# ---------------------------------------------------------------------------

def _jax_probe_config(impl, monkeypatch):
    """The TrainConfig that the JAX ``scripts/verify_train_tpu.py`` builds:
    its ``SelfplayPPO`` replaced by a stub that captures it and stops."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "verify_train_tpu", os.path.join(REPO, "scripts", "verify_train_tpu.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)

    class Captured(Exception):
        pass

    def stub(cfg):
        raise Captured(cfg)

    monkeypatch.setattr(mod, "SelfplayPPO", stub)
    monkeypatch.setattr(sys, "argv", ["verify_train_tpu.py", impl])
    with pytest.raises(Captured) as e:
        mod.main()
    return e.value.args[0]


@pytest.mark.parametrize("impl", ["pallas-fast", "pallas"])
def test_probe_config_equals_the_jax_probe(impl, monkeypatch):
    want = dataclasses.asdict(_jax_probe_config(impl, monkeypatch))
    assert dataclasses.asdict(verify_train.probe_config(impl)) == want


def test_probe_loop_reports_the_jax_keys():
    cfg = verify_train.probe_config("pallas-fast")
    cfg = dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, n_steps=4, minibatch_size=32),
        selfplay=dataclasses.replace(cfg.selfplay, n_envs=16, buffer_size=4))
    out = verify_train.probe(cfg, CPU, chunks=1, per_chunk=2)
    assert set(out) == {"update_impl", "transitions", "seconds", "transitions_per_s",
                        "eval_mean_reward_vs_random", "pass"}
    assert out["transitions"] == 2 * 4 * 16 and out["update_impl"] == "pallas-fast"
    assert -1.0 <= out["eval_mean_reward_vs_random"] <= 1.0
    assert out["pass"] == (out["eval_mean_reward_vs_random"] > 0.5)


@pytest.mark.parametrize("passed", [True, False])
def test_probe_main_exits_1_below_the_bar(passed, monkeypatch, capsys):
    seen = {}

    def fake(cfg, device):
        seen["impl"], seen["device"] = cfg.ppo.update_impl, device
        return {"update_impl": cfg.ppo.update_impl, "pass": passed}

    monkeypatch.setattr(verify_train, "probe", fake)
    if passed:
        assert verify_train.main(["pallas", "--cpu"])["pass"]
    else:
        with pytest.raises(SystemExit) as e:
            verify_train.main(["--cpu"])
        assert e.value.code == 1
    assert seen == {"impl": "pallas" if passed else "pallas-fast", "device": CPU}
    assert json.loads(capsys.readouterr().out)["pass"] is passed


# ---------------------------------------------------------------------------
# scripts/breakdown_bench.py
# ---------------------------------------------------------------------------

SHAPES = [
    ["--board-size", "6"],  # the JAX script's defaults
    ["--board-size", "9", "--policy", "MLP-wide-deep", "--buffer-size", "30"],
    ["--board-size", "5", "--policy", "CNN", "--n-envs", "64", "--minibatch-size", "256"],
    ["--board-size", "5", "--policy", "CNN", "--cnn-bank-mode", "dense", "--n-envs", "64",
     "--minibatch-size", "256"],
    ["--board-size", "5", "--policy-impl", "lax"],  # the plain path's dense bank
]


@pytest.mark.parametrize("argv", SHAPES, ids=["mlp-6x6", "mlp-wide-deep-9x9", "cnn-gathered",
                                              "cnn-dense", "mlp-plain-bank"])
def test_stage_models_match_the_jax_roofline(argv):
    args = breakdown_bench.parse_args(argv + ["--cpu"])
    algo = SelfplayPPO(breakdown_bench.make_config(args), CPU)
    got = breakdown_bench.stage_models(args, algo)

    # the JAX script's stage composition (breakdown_bench.py:94-143) on the
    # JAX roofline's functions
    F = A = args.board_size ** 2
    P1 = args.buffer_size + 1
    per_iter, E = args.n_steps * args.n_envs, args.n_epochs
    if args.policy == "CNN":
        fwd = jax_roofline.cnn_forward_flops(F, n_actions=A)
        opp = (P1 * fwd if args.cnn_bank_mode == "dense"
               else jax_roofline.cnn_gathered_bank_flops(F, args.buffer_size, n_actions=A))
    else:
        H, NL = algo.model.pi_layers[0], len(algo.model.pi_layers)
        # the JAX count runs both towers packed block-diagonally; the port's
        # kernels run them apart, so the zero blocks (NL - 1 off-diagonal
        # (H, H) pairs, and the (H, A + 1) head's cross terms) drop out
        fwd = jax_roofline.mlp_forward_flops(F, H, NL, A) - (
            2 * (NL - 1) * 2 * H * H + 2 * H * (A + 1))
        # the JAX bank pass runs all P1 members' towers on every board, as
        # the port's plain path does; the port's bank passes (K4, K3, their
        # twins) run only each game's own member's
        plain_bank = args.policy_impl == "lax"
        opp = (P1 if plain_bank else 1) * jax_roofline.policy_tower_flops(F, H, NL, A)
    want = {
        "rollout": per_iter * (fwd + opp),
        "update": per_iter * E * 3 * fwd,
        "update_lax": per_iter * E * 3 * fwd,
        "gae": per_iter * 5,
        "perm_gather": 0.0,
        "train_step": per_iter * (fwd + opp + E * 3 * fwd),
        "superstep_per_iter": per_iter * (fwd + opp + E * 3 * fwd),
    }
    assert {k: v[0] for k, v in got.items()} == want
    # no kernel of the port runs on the CPU: no stream model of one
    assert got["rollout"][1] is None and got["update"][1] is None and got["train_step"][1] is None


def test_breakdown_cpu_run_prints_every_stage_and_the_summary(capsys):
    recs = breakdown_bench.main([
        "--cpu", "--board-size", "4", "--n-envs", "8", "--n-steps", "4",
        "--minibatch-size", "16", "--buffer-size", "2", "--n-epochs", "2",
        "--repeats", "1", "--superstep", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == recs
    assert [r["stage"] for r in lines[:-1]] == [
        "null_dispatch", "rollout", "gae", "update", "update_lax", "perm_gather", "train_step",
        "superstep_per_iter"]
    assert all(r["ms"] > 0 and set(r) == {"stage", "ms", "transitions_per_s"}
               for r in lines[:-1])  # no roofline share from a CPU run
    summary = lines[-1]["summary"]
    assert summary["backend"] == "cpu" and summary["peak"] == "fp32"
    assert summary["sustained_mfu_pct"] is None and summary["roofline"] == []
    assert summary["per_iter_transitions"] == 32 and summary["shape"]["board_size"] == 4


# ---------------------------------------------------------------------------
# scripts/scaling_bench.py
# ---------------------------------------------------------------------------

def test_scaling_prediction_model():
    """The counterpart of tests/test_utils.py::test_scaling_prediction_model
    for HGX H100 nodes: monotone in hosts, 80 all-reduces of 4 x n_params
    bytes, and the closed form at 2 hosts."""

    class A:  # the argparse shape predict_multihost reads
        n_epochs, n_steps, envs_per_device, minibatch_size = 10, 64, 256, 2048

    report = {"iter_ms": 20.0, "platform": "cuda", "n_params": 32000,
              "stages": {"collective_delta_ms": 0.5}}
    out = scaling_bench.predict_multihost(report, A)["predicted_scaling"]
    effs = [r["predicted_efficiency"] for r in out["hosts"]]
    assert effs == sorted(effs, reverse=True) and effs[0] > effs[-1]
    assert [r["chips"] for r in out["hosts"]] == [8, 16, 32]
    assert out["model"]["grad_allreduces_per_iter"] == 80
    assert out["model"]["grad_bytes_per_allreduce"] == 4 * 32000
    assert out["meets_80pct_at_4_hosts"] is True
    assert "data sheet" in out["model"]["assumptions"]

    # 2 hosts of 8 cards: the in-host reduce-scatter + all-gather over NVLink,
    # each card's 1/8 shard all-reduced over its InfiniBand link, 16 ring steps
    nbytes = 4 * 32000
    t_ar = (2 * 7 / 8 * nbytes / 450e9 + 2 * 1 / 2 * nbytes / 8 / 50e9
            + (2 * 7 + 2 * 1) * 1e-6)
    t_compute = (20.0 - 0.5) / 1e3
    want = t_compute / (t_compute + 80 * t_ar)
    assert out["hosts"][1]["predicted_efficiency"] == round(want, 4)
    assert out["hosts"][1]["allreduce_us_each"] == round(t_ar * 1e6, 2)
    # a sweep measured faster with its all-reduces than without is noise:
    # nothing is taken off the basis
    noisy = dict(report, stages={"collective_delta_ms": -3.0})
    model = scaling_bench.predict_multihost(noisy, A)["predicted_scaling"]["model"]
    assert model["basis_collective_ms"] == 0.0 and model["basis_iter_ms"] == 20.0


def test_scaling_cpu_ranks_count_their_collectives(capsys):
    rows = scaling_bench.main([
        "--cpu", "--devices", "1,2", "--board-size", "4", "--envs-per-device", "8",
        "--n-steps", "4", "--minibatch-size", "16", "--n-epochs", "2", "--buffer-size", "2",
        "--iters", "1", "--predict"])
    grads = 2 * (4 * 8 // 16)
    assert [r["devices"] for r in rows[:2]] == [1, 2]
    for r in rows[:2]:
        assert r["platform"] == "cpu" and r["n_envs"] == 8 * r["devices"]
        assert r["grad_allreduces_per_iter"] == grads
        # a grad all-reduce a grad step, then the two metric reductions; the
        # sharded eval gathers its rewards in one
        assert r["collectives"] == {"train_step": {"all_reduce": grads + 2, "broadcast": 0},
                                    "eval_step": {"all_reduce": 1, "broadcast": 0}}
        assert set(r["stages"]) == {"rollout_gae_ms", "update_allreduce_ms", "update_local_ms",
                                    "collective_delta_ms"}
        assert r["iter_ms"] > 0 and r["eval_sharded_ms"] > 0 and r["eval_replicated_ms"] > 0
    assert rows[0]["efficiency_baseline"] and rows[0]["efficiency_vs_1dev"] == 1.0
    assert rows[0]["n_params"] == rows[1]["n_params"]
    pred = rows[2]["predicted_scaling"]
    assert pred["model"]["basis_platform"] == "cpu" and pred["model"]["grad_allreduces_per_iter"] == grads
    out = capsys.readouterr().out
    assert "timeshare" in out.splitlines()[-1]
    assert not torch.distributed.is_initialized()
