"""Each cell's run, driven on the CPU at a small size past the harness's
look for a card, comes out ``correct`` when the program is sound and not
``correct`` with the timed path broken underneath: a sweep that hands back
its state unchanged, a sweep over half of the batch, a move altered where
the rollout or the match produces it, a match's winner altered, the CNN's
BatchNorm run without its running statistics.  The match runs with the
MLP at 7x7 and with the CNN at 5x5, its agents' BatchNorm drawn (the match
driver's ``AGENT_BN_STD``)."""

import time

import pytest
import torch

from benchmark import harness
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.train import ppo as port_ppo

SMALL = {"n_envs": 8, "n_steps": 16, "minibatch_size": 32, "n_epochs": 2, "buffer_size": 3,
         "n_eval_episodes": 3, "eval_freq": 1, "checkpoint_every": 256}
MLP7 = "7x7_MLP-default_lr-0.0003"
MLP_LIMITS = {"env_faults": 0, "invalid_moves": 0, "pool_faults": 0, "logp_gap": 1e-05,
              "value_gap": 2e-05, "gae_gap": 3e-05, "loss_gap": 5e-07, "delta_gap": 3e-06,
              "moment_gap": 1e-05}
# The training cells, which wait for a repair of the program's draw: the
# workloads they are to come back with, here at a small size.
TRAIN_CELLS = {
    "mlp7-scan-train": (MLP7, {"overrides": {"rollout_impl": "scan"}, "warm_checkpoint": True,
                               "trace_iters": 10, "limits": MLP_LIMITS}),
    "mlp7-sampleboard-train": (MLP7, {"overrides": {"sample_board": True},
                                      "warm_checkpoint": False, "trace_iters": 1,
                                      "limits": MLP_LIMITS}),
    "cnn9-train": ("CNN_lr-0.0003", {
        "overrides": {}, "warm_checkpoint": False, "trace_iters": 1,
        "limits": {"env_faults": 0, "invalid_moves": 0, "pool_faults": 0, "logp_gap": 3e-05,
                   "value_gap": 0.0001, "gae_gap": 0.0001, "delta_median": 0.15,
                   "stats_median": 0.08}}),
}
MATCH = {"games": 64, "check_from": 1, "check_matches": 1}
# the match's policies: (configuration, board, the workload's ``init``)
POLICIES = {
    "mlp7": (MLP7, None, {"action_gain": 2.0, "bias_std": 0.1}),
    "cnn5": ("CNN_lr-0.0003", 5, {"action_gain": 2.0, "bias_std": 0.1}),
}
MATCH_CASES = [("mlp7", "deterministic"), ("mlp7", "stochastic"), ("cnn5", "deterministic")]


def run_cell(cell: str, config: str, tmp_path, hook=None, small: dict = None, driver=None,
             board: int = None, seconds: float = 1.0, **workload):
    """One run of ``cell`` on the CPU for ``seconds``: its workload file
    where the benchmark has one, else its entry in ``TRAIN_CELLS``, with
    ``workload`` laid over; ``board``, where given, replaces the
    configuration's board size; ``driver``, where given, is the driver
    module already loaded."""
    conf = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    if small:
        conf["overrides"] = dict(small)
        conf["train"].update(small)
    if board is not None:
        conf["model"]["board_size"] = board
    path = harness.workload_file(cell)
    base = harness.load_json(path) if path.is_file() else \
        {"driver": "train", "init": {"action_gain": 0.01}, **TRAIN_CELLS[cell][1]}
    wl = {**base, **workload}
    if driver is None:
        driver = harness.load_module(harness.driver_file(wl["driver"]),
                                     f"fault_driver_{wl['driver']}")
    ctx = harness.Context(name=cell, workload=wl, config=conf, seed=2 ** 31 + 11, seconds=seconds,
                          trace=False, t0=time.perf_counter(), device=torch.device("cpu"),
                          run_dir=str(tmp_path), hook=hook)
    return driver.run(ctx)


def unchanged(algo):
    inner = algo.update_fn

    def update(params, opt, batch, generator=None, **kw):
        _, _, stats = inner(params, opt, batch, generator, **kw)
        return params, opt, stats

    algo.update_fn = update


def half_batch(algo):
    inner = algo.update_fn

    def update(params, opt, batch, generator=None, **kw):
        half = batch.action.shape[0] // 2
        return inner(params, opt, port_ppo.PPOBatch(*(x[:half] for x in batch)), generator, **kw)

    algo.update_fn = update


def altered_move(algo):
    inner = algo.runner.run

    def run(*args, **kw):
        carry, tr, last = inner(*args, **kw)
        tr.action[5, 3] = (tr.action[5, 3] + 1) % tr.legal.shape[-1]
        return carry, tr, last

    algo.runner.run = run


@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_sound_training_run_is_correct(cell, tmp_path):
    out = run_cell(cell, TRAIN_CELLS[cell][0], tmp_path, small=SMALL)
    assert all(lim is not None for _, lim in out.checks.values())
    assert out.correct, out.checks


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered_move])
@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_broken_training_run_is_not_correct(cell, fault, tmp_path):
    out = run_cell(cell, TRAIN_CELLS[cell][0], tmp_path, hook=fault, small=SMALL)
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", ["mlp7-scan-train", "mlp7-sampleboard-train"])
def test_sampler_ignoring_the_mask_is_not_correct(cell, tmp_path, monkeypatch):
    """The rollout's draws ignore the legal mask: moves onto stones, each an
    invalid move that the env ends the game on."""
    monkeypatch.setattr(masked, "mask_logits", lambda logits, legal: logits)
    out = run_cell(cell, TRAIN_CELLS[cell][0], tmp_path, small=SMALL)
    assert not out.correct, out.checks
    assert out.checks["invalid_moves"][0] > 0


def match_fault(kind):
    def hook(sut):
        inner = sut.run_match

        def run_match(*args, record=None, **kw):
            out = inner(*args, record=record, **kw)
            if record is not None and kind == "move":
                cells = record["actions"].shape[0] - 1
                record["actions"][3, 7] = (record["actions"][3, 7] + 1) % cells
            elif record is not None:
                record["winners"][11] = 1 - record["winners"][11]
            return out

        sut.run_match = run_match

    return hook


def run_match_cell(policy: str, tmp_path, **kw):
    """One run of the match cell's workload with ``policy``'s agents."""
    config, board, init = POLICIES[policy]
    return run_cell("mlp7-match-det", config, tmp_path, board=board, init=init,
                    **{**MATCH, **kw})


@pytest.mark.parametrize("policy, mode", MATCH_CASES)
def test_sound_match_is_correct(policy, mode, tmp_path):
    out = run_match_cell(policy, tmp_path, mode=mode)
    assert all(lim is not None for _, lim in out.checks.values())
    assert out.correct, out.checks
    assert out.checks["logit_gap"][0] < 1e-5, out.checks


@pytest.mark.parametrize("policy, mode", MATCH_CASES)
@pytest.mark.parametrize("kind", ["move", "winner"])
def test_broken_match_is_not_correct(kind, policy, mode, tmp_path):
    out = run_match_cell(policy, tmp_path, hook=match_fault(kind), mode=mode)
    assert not out.correct, out.checks


@pytest.mark.parametrize("policy, mode", MATCH_CASES)
def test_match_ignoring_the_mask_is_not_correct(policy, mode, tmp_path, monkeypatch):
    """Both sides pick over unmasked logits: moves onto stones."""
    monkeypatch.setattr(masked, "mask_logits", lambda logits, legal: logits)
    out = run_match_cell(policy, tmp_path, mode=mode)
    assert not out.correct, out.checks


@pytest.mark.parametrize("bn_std, caught", [(None, False), (0.1, True)])
def test_batch_norm_ignoring_its_statistics(bn_std, caught, tmp_path, monkeypatch):
    """The program's BatchNorm at inference normalises with mean 0 and
    variance 1 in place of its running statistics.  With the agents'
    BatchNorm drawn, as the match driver draws it (``AGENT_BN_STD``), the
    logits move and ``logit_gap`` fails; at the start values (the constant
    set to None), where BatchNorm is all but the identity, the fault is
    blind."""
    from hex_gym_env_tpu_torch.models import cnn

    inner = cnn.BatchNorm.forward

    def forward(self, x, train):
        if train:
            return inner(self, x, train)
        mul = torch.rsqrt(torch.ones_like(self.var) + cnn.BN_EPS) * self.scale
        return x * mul[:, None, None] + self.bias[:, None, None], None, None

    monkeypatch.setattr(cnn.BatchNorm, "forward", forward)
    driver = harness.load_module(harness.driver_file("match"), "fault_driver_match_bn")
    if bn_std is None:
        monkeypatch.setattr(driver, "AGENT_BN_STD", None)
    assert driver.AGENT_BN_STD == bn_std
    config, board, init = POLICIES["cnn5"]
    out = run_cell("mlp7-match-det", config, tmp_path, driver=driver, board=board, init=init,
                   **MATCH)
    logit_gap, limit = out.checks["logit_gap"]
    assert out.correct is not caught and (logit_gap > limit) is caught, out.checks


def test_picks_the_window_missed_are_judged(tmp_path):
    """The window closes after its first match; the matches picked among
    the first four that it did not reach are played and judged after it.
    A winner flipped in every recorded match shows each judged once."""
    sound = run_match_cell("mlp7", tmp_path, seconds=0.0, check_from=4, check_matches=2)
    assert sound.attempted == 1 and sound.correct, sound.checks
    broken = run_match_cell("mlp7", tmp_path, seconds=0.0, check_from=4, check_matches=2,
                            hook=match_fault("winner"))
    assert broken.checks["winner_mismatch"][0] == 2, broken.checks


@pytest.mark.parametrize("check_from, check_matches", [(1, 2), (4, 0)])
def test_a_run_that_judges_too_few_is_not_correct(check_from, check_matches, tmp_path):
    out = run_match_cell("mlp7", tmp_path, check_from=check_from, check_matches=check_matches)
    assert not out.correct and out.failed == len(out.checks), out.checks


def test_match_judges_a_draw_of_the_top_word(tmp_path, monkeypatch):
    """Every word of ply 10 has its top 24 bits set.  The reference's noise
    of such a word is finite, so a masked cell never wins its draw; the run
    is correct exactly when the program's draw picked no stone's cell."""
    from hex_gym_env_tpu_torch.scripts import match as match_script

    driver = harness.load_module(harness.driver_file("match"), "fault_driver_match")
    inner = driver.words

    def words(seed, shape, device):
        w = inner(seed, shape, device)
        w[10] = -1
        return w

    monkeypatch.setattr(driver, "words", words)
    recorded = []
    run_match = match_script.run_match

    def keep(*args, record=None, **kw):
        out = run_match(*args, record=record, **kw)
        if record is not None:
            recorded.append(record["actions"])
        return out

    monkeypatch.setattr(match_script, "run_match", keep)
    out = run_cell("mlp7-match-det", MLP7, tmp_path, driver=driver, mode="stochastic", **MATCH)
    actions = recorded[-1]  # the checked match; the first is set-up's
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology

    ops = hex_env.make_ops(get_topology(7), "auto", torch.device("cpu"))
    state = ops.initial_state(MATCH["games"])
    for t in range(10):
        state, _ = ops.step(state, actions[t])
    live = state.winner < 0
    onto_stone = ~ops.legal_mask(state).gather(1, actions[10].long()[:, None])[:, 0]
    assert out.correct == (not bool((live & onto_stone).any())), out.checks
