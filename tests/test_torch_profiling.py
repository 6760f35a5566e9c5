"""The phase-clock reader ``utils/profiling.phase_split`` on synthetic
stamp buffers, and the phase-clock plumbing of the K4 and K6 wrappers on
the CPU (the clocks are written by the kernels only)."""

import numpy as np
import pytest
import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.ops import policy_kernel as pk
from hex_gym_env_tpu_torch.ops import ppo_kernel as pkk
from hex_gym_env_tpu_torch.ops import rollout_kernel as rk
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.utils import profiling
from hex_gym_env_tpu_torch.utils.config import PPOConfig

NAMES = ("a", "b", "c")


def _stamps(durations, offsets):
    """(units, steps, phases) durations -> stamps, each unit from its offset,
    steps back to back."""
    dur = np.asarray(durations, dtype=np.int64)
    units, steps, _ = dur.shape
    st = np.zeros((units, steps, dur.shape[2] + 1), dtype=np.int64)
    for u in range(units):
        t = offsets[u]
        for s in range(steps):
            st[u, s, 0] = t
            st[u, s, 1:] = t + np.cumsum(dur[u, s])
            t = st[u, s, -1] + 3  # a gap between steps belongs to no phase
    return st


def test_phase_split_medians_max_and_shares():
    dur = np.array([
        [[10, 20, 70], [10, 20, 70]],
        [[30, 20, 50], [10, 20, 50]],
        [[20, 40, 40], [20, 40, 40]],
    ])
    rows = profiling.phase_split(_stamps(dur, [0, 0, 0]), NAMES)
    per_step = dur.mean(axis=1)  # (units, phases)
    med = np.median(per_step, axis=0)
    assert [r["name"] for r in rows] == list(NAMES)
    np.testing.assert_allclose([r["median"] for r in rows], med)
    np.testing.assert_allclose([r["max"] for r in rows], per_step.max(axis=0))
    np.testing.assert_allclose([r["share"] for r in rows], med / med.sum())
    assert abs(sum(r["share"] for r in rows) - 1.0) < 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase_split_ignores_unit_order_and_clock_offsets(seed):
    """Each SM has its own clock: rows may come in any order, each with its
    own offset, and the split is the same."""
    rng = np.random.default_rng(seed)
    dur = rng.integers(1, 1000, size=(7, 5, 3))
    ref = profiling.phase_split(_stamps(dur, [0] * 7), NAMES)
    perm = rng.permutation(7)
    offsets = rng.integers(0, 2**40, size=7)
    got = profiling.phase_split(_stamps(dur[perm], offsets), NAMES)
    for r, g in zip(ref, got):
        assert r == g


def test_phase_split_rejects_a_stamp_out_of_order_within_a_unit():
    st = _stamps(np.ones((2, 2, 3), dtype=np.int64) * 5, [100, 0])
    st[1, 1, 2] = st[1, 1, 1] - 1
    with pytest.raises(ValueError, match="unit 1 step 1"):
        profiling.phase_split(st, NAMES)


def test_phase_split_rejects_a_buffer_of_the_wrong_width():
    with pytest.raises(ValueError, match="stamps must be"):
        profiling.phase_split(np.zeros((2, 2, 3), dtype=np.int64), NAMES)


def test_phase_split_turns_clocks_into_time_with_the_call_time():
    # 2 units, 4 steps of 100 + 300 clocks: a 1600-clock span (3 clocks of
    # gap after each step but the last not counted in it) over 0.8 ms
    dur = np.tile(np.array([100, 300, 0]), (2, 4, 1))
    st = _stamps(dur, [0, 50])
    span = st[0, -1, -1] - st[0, 0, 0]
    rows = profiling.phase_split(st, NAMES, total_ms=0.8)
    per_us = span / 800.0
    np.testing.assert_allclose([r["median_us"] for r in rows], [100 / per_us, 300 / per_us, 0.0])
    assert rows[2]["share"] == 0.0
    line = profiling.format_split(rows)
    assert line.startswith("a ") and "us" in line and line.count(";") == 2


def test_format_split_without_time_shows_clocks():
    rows = profiling.phase_split(_stamps(np.ones((1, 1, 3)) * 4, [0]), NAMES)
    assert profiling.format_split(rows) == "a 4.000 (4.000) 33.3%; b 4.000 (4.000) 33.3%; c 4.000 (4.000) 33.3%"


def test_phase_names_match_the_kernels_mark_counts():
    # csrc/learner_kernels.cu kPpoMarks and csrc/hex_kernels.cu kRollMarks
    src = (pkk.__file__.rsplit("/ops/", 1)[0]) + "/csrc/"
    ppo_src = open(src + "learner_kernels.cu").read()
    roll_src = open(src + "hex_kernels.cu").read()
    assert f"constexpr int kPpoMarks = {pkk.PPO_MARKS};" in ppo_src
    assert f"constexpr int kRollMarks = {rk.ROLLOUT_MARKS};" in roll_src
    assert pkk.PPO_MARKS == len(pkk.PPO_PHASES) + 1
    assert rk.ROLLOUT_MARKS == len(rk.ROLLOUT_PHASES) + 1


def _small_policy():
    topo = get_topology(3)
    g = torch.Generator().manual_seed(0)
    model = make_policy("MLP-default", topo.num_cells, generator=g)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    return topo, model, params, g


def test_rollout_clock_is_the_kernels_alone():
    """On CPU tensors the twin runs and leaves the clock buffer untouched;
    "pallas" still raises there."""
    topo, model, params, g = _small_policy()
    A, B, T = topo.num_cells, 4, 3
    pol = pk.PolicyOps(model, "auto")
    stacked = pol.stack_bank(init_bank(params, 2))
    state = hex_env.initial_state(topo, B, "cpu")
    zeros = torch.zeros(B, dtype=torch.int32)
    args = (pol.pack_agent(params), stacked, rk.first_move_table(stacked, pol.dims), state, zeros,
            zeros.bool(), zeros, T, 0.8, True)
    bits = rk.draw_rollout_bits(g, T, B, A, "cpu")
    timers = torch.zeros((B, T, rk.ROLLOUT_MARKS), dtype=torch.int64)
    clocked = rk.fused_rollout(topo, pol, *args, bits=bits, timers=timers)
    plain = rk.fused_rollout(topo, pol, *args, bits=bits)
    assert torch.equal(clocked.ints, plain.ints) and torch.equal(clocked.flts, plain.flts)
    assert not timers.any()
    with pytest.raises(ValueError, match="pallas"):
        rk.fused_rollout(topo, pk.PolicyOps(model, "pallas"), *args, bits=bits, timers=timers)


def test_sweep_clock_is_the_kernels_alone():
    topo, model, params, g = _small_policy()
    A, n = topo.num_cells, 16
    pol = pk.PolicyOps(model, "auto")
    obs = torch.randint(-1, 2, (n, A), generator=g).to(torch.int8)
    act = ((obs == 0).float() * torch.rand((n, A), generator=g)).argmax(1)
    flt = torch.stack([act.float(), torch.randn(n, generator=g) - 2.0,
                       torch.randn(n, generator=g), torch.randn(n, generator=g)], 1)
    idx = torch.randperm(n, generator=g).to(torch.int32).reshape(2, 8)
    cfg = PPOConfig(minibatch_size=8, n_epochs=1)
    p = pol.pack_agent(params)
    z = torch.zeros_like(p)
    bias = ppo.bias_corrections(0, 2, "cpu")
    timers = torch.zeros((1, 2, pkk.PPO_MARKS), dtype=torch.int64)
    clocked = pkk.sweep(pol, cfg, p, z, z, obs, flt, idx, bias, timers=timers)
    plain = pkk.sweep(pol, cfg, p, z, z, obs, flt, idx, bias)
    for got, want in zip(clocked, plain):
        assert torch.equal(got, want)
    assert not timers.any()
    with pytest.raises(ValueError, match="pallas"):
        pkk.sweep(pk.PolicyOps(model, "pallas"), cfg, p, z, z, obs, flt, idx, bias, timers=timers)
