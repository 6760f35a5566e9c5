"""The work counts of ``benchmark/work.py`` against hand counts, and their
independence of how the program computes."""

import pytest

from benchmark import harness, work
from hex_gym_env_tpu_torch.models import make_policy


def conf(name: str) -> dict:
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


MLP7 = work.model_of(conf("7x7_MLP-default_lr-0.0003"))
CNN9 = work.model_of(conf("CNN_lr-0.0003"))


def test_mlp7_iteration_hand_count():
    # agent: two towers 49->64->64 and the heads 64->49, 64->1, 2 FLOPs a MAC
    agent = 2 * 2 * (49 * 64 + 64 * 64) + 2 * 64 * 49 + 2 * 64
    assert agent == 35_328 and work.agent_flops(MLP7) == agent
    opponent = 2 * (49 * 64 + 64 * 64) + 2 * 64 * 49
    assert opponent == 20_736 and work.policy_flops(MLP7) == opponent
    rollout = 256 * 128 * (agent + opponent)
    sweep = 3 * agent * 10 * 32_768
    evaluation = 30 * 49 * opponent
    total = rollout + sweep + evaluation
    assert total == 36_596_424_192  # 36.6 GFLOP an iteration
    assert work.iteration(MLP7, 256, 128, 10, 4096, 30) == total


def test_cnn9_iteration_hand_count():
    convs = 2 * 9 * 1 * 64 * 81 + 4 * 2 * 9 * 64 * 64 * 81
    features = 2 * 81 * 64 * 128
    towers = 2 * (128 * 128 + 128 * 128)
    agent = convs + features + 2 * towers + 2 * 128 * 81 + 2 * 128
    opponent = convs + features + towers + 2 * 128 * 81
    assert work.agent_flops(CNN9) == agent == 25_460_352
    assert work.policy_flops(CNN9) == opponent
    total = 256 * 128 * (agent + opponent) + 3 * agent * 327_680 + 30 * 81 * opponent
    assert work.iteration(CNN9, 256, 128, 10, 4096, 30) == total
    assert 26.5e12 < total < 26.9e12


@pytest.mark.parametrize("m,name,n", [(MLP7, "MLP-default", 49), (CNN9, "CNN", 81)])
def test_param_count_is_the_models(m, name, n):
    sd = make_policy(name, n).state_dict()
    assert work.param_count(m) == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("overrides", [{"cnn_bank_mode": "dense"}, {"cnn_bank_mode": "gathered"},
                                       {"rollout_impl": "scan"}, {"update_impl": "lax"},
                                       {"update_impl": "pallas-fast"}])
def test_counts_ignore_how_the_program_computes(overrides):
    """The counts read the configuration's model and batch alone: the
    program's choice of path does not enter them."""
    for name in ("7x7_MLP-default_lr-0.0003", "CNN_lr-0.0003"):
        base = conf(name)
        other = {**base, "overrides": overrides}
        a, b = work.model_of(base), work.model_of(other)
        assert work.iteration(a, 256, 128, 10, 4096, 30) == work.iteration(b, 256, 128, 10, 4096, 30)


def test_least_time_takes_the_larger_bound():
    assert work.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    flops, nbytes = work.sweep(MLP7, 32_768, 10, 4096)
    assert work.least_seconds(flops, nbytes) == pytest.approx(flops / 67e12)
