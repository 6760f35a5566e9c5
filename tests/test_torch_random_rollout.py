"""K7, the random-legal rollout, and the env-throughput benchmark of the port.

The twin gets the bits the JAX interpret path draws for ``seed``
(``jax.random.bits(key(seed), (T, B, L))``, ``ops/pallas_step.py:389-399``)
and must give exactly the state and per-game counts of
``pallas_step.random_rollout(..., interpret=True)``: every comparison is of
integers, so the tolerance is equality.  Also the twin's invariants on
generator bits, the dispatch, the roofline helpers' closed forms, the
profiling helpers and the benchmark's ``main`` at a tiny size on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.topology import get_topology as jax_get_topology
from hex_gym_env_tpu.ops import pallas_step

from hex_gym_env_tpu_torch import bench
from hex_gym_env_tpu_torch.core import env as torch_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models.convert import state_from_numpy
from hex_gym_env_tpu_torch.ops import labels as torch_labels
from hex_gym_env_tpu_torch.ops import masked, step_kernel
from hex_gym_env_tpu_torch.utils import profiling, roofline

FIELDS = ("stones", "labels", "to_move", "done", "winner", "empty", "move_count")


def _full_board(n):
    """A board with every cell taken (a checkerboard of -1/+1)."""
    y, x = np.indices((n, n))
    return np.where((y + x) % 2 == 0, -1, 1).astype(np.int8)


def _jax_mid_state(jt, B, rng):
    """Random legal plies with the JAX env: some games over (and frozen),
    some still on; row 0 is then a full board with no empty cell."""
    js = jax_env.initial_state(jt, B)
    step = jax.jit(lambda s, a: jax_env.step(jt, s, a))
    # at 13x13 no random game ends within half the board
    for _ in range(jt.num_cells // 2 + 4 if jt.n < 13 else jt.num_cells - 20):
        legal = np.asarray(jax_env.legal_mask(jt, js))
        a = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal], np.int32)
        js, _ = step(js, jnp.asarray(a))
    full = jax_env.state_from_boards(jt, jnp.asarray(_full_board(jt.n))[None])
    return jax.tree.map(lambda a, f: a.at[0].set(f[0]), js, full)


@pytest.mark.parametrize("n", [5, 7, 13])  # 13x13: 256 lanes, eight a thread in K7
@pytest.mark.parametrize("start", ["initial", "mid"])
def test_twin_matches_pallas_random_rollout(n, start):
    B, seed = 24, 3 + n
    T = 48 if n < 13 else 200  # long enough for random 13x13 games to end
    jt, tt = jax_get_topology(n), get_topology(n)
    if start == "initial":
        js = jax_env.initial_state(jt, B)
    else:
        js = _jax_mid_state(jt, B, np.random.default_rng(n))
        done = np.asarray(js.done)
        assert done.any() and not done.all() and int(js.empty[0]) == 0
    want, want_games = pallas_step.random_rollout(jt, js, seed, T, block=8, interpret=True)
    bits = masked.bits_from_numpy(
        np.asarray(jax.random.bits(jax.random.key(seed), (T, B, jt.lanes), jnp.uint32)))
    got, games = step_kernel.random_rollout_twin(tt, state_from_numpy(js), T, bits=bits)
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(games.numpy(), np.asarray(want_games))
    assert games.dtype == torch.int32 and int(games.sum()) > 0
    if start == "mid":
        assert int(games[0]) >= 1  # the full board resets at its first step


def test_twin_invariants_on_generator_bits():
    """As the JAX package's test of the kernel: valid states and plausible
    game counts (random 7x7 games last 13..49 plies)."""
    tt = get_topology(7)
    B, T = 64, 200
    state = torch_env.initial_state(tt, B, device="cpu")
    out, games = step_kernel.random_rollout(
        tt, state, T, generator=torch.Generator().manual_seed(7))
    s0, s1 = out.stones[:, 0], out.stones[:, 1]
    assert not (s0 & s1).any()
    assert not s0[:, tt.num_cells:].any() and not s1[:, tt.num_cells:].any()
    assert torch.equal(out.empty, tt.num_cells - (s0 | s1)[:, : tt.num_cells].sum(-1).int())
    assert int(games.min()) >= T // 49 and int(games.max()) <= T // 13 + 1
    fresh = torch_labels.labels_from_stones(tt, out.stones)
    for b in range(B):
        g, f = out.labels[b], fresh[b]
        assert torch.equal(g[:, None] == g[None, :], f[:, None] == f[None, :]), b
    for seat in range(2):
        assert not torch_labels.seat_wins(tt, out.labels, seat).any()
    assert not out.done.any() and (out.winner == -1).all() and (out.move_count == 0).all()


def test_random_rollout_dispatch():
    tt = get_topology(5)
    state = torch_env.initial_state(tt, 4, device="cpu")
    bits = masked.draw_bits(torch.Generator().manual_seed(0), (6, 4, tt.lanes), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        step_kernel.random_rollout(tt, state, 6, bits=bits, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        step_kernel.random_rollout_cuda(tt, state, 6, bits=bits)
    with pytest.raises(ValueError, match="impl"):
        step_kernel.random_rollout(tt, state, 6, bits=bits, impl="fused")
    with pytest.raises(ValueError, match="Generator"):
        step_kernel.random_rollout(tt, state, 6)
    auto, g_auto = step_kernel.random_rollout(tt, state, 6, bits=bits)
    lax, g_lax = step_kernel.random_rollout(tt, state, 6, bits=bits, impl="lax")
    twin, g_twin = step_kernel.random_rollout_twin(tt, state, 6, bits=bits)
    for name in FIELDS:
        assert torch.equal(getattr(auto, name), getattr(twin, name))
        assert torch.equal(getattr(lax, name), getattr(twin, name))
    assert torch.equal(g_auto, g_twin) and torch.equal(g_lax, g_twin)


def test_place_stone_pre_connected_switch():
    """K7's union ignores edges connected before the move; K1's counts them."""
    tt = get_topology(3)
    # seat 0 already joins top and bottom down column 0; it now plays (1, 2),
    # touching none of its stones and no edge
    board = np.array([[-1, 1, 0], [-1, 1, 0], [-1, 0, 0]], np.int8)
    st = torch_env.state_from_boards(tt, torch.from_numpy(board)[None])
    c = torch.tensor([5], dtype=torch.int32)
    stones_s = st.stones[:, 0].clone()
    stones_s[0, 5] = True
    act = torch.ones(1, dtype=torch.bool)
    _, win = torch_labels.place_stone(tt, st.labels, stones_s, st.to_move, c, act)
    _, joined = torch_labels.place_stone(
        tt, st.labels, stones_s, st.to_move, c, act, pre_connected=False)
    assert bool(win[0]) and not bool(joined[0])


# ---------------------------------------------------------------------------
# roofline, profiling, benchmark
# ---------------------------------------------------------------------------


def test_roofline_peaks_and_flop_counts():
    assert (roofline.PEAK_FLOPS_FP32, roofline.PEAK_FLOPS_BF16, roofline.PEAK_HBM_BPS) == (
        67e12, 989e12, 3.35e12)
    F, H, L, A = 49, 64, 2, 49
    tower = 2 * F * H + 2 * (L - 1) * H * H
    assert roofline.mlp_forward_flops(F, H, L, A) == 2 * tower + 2 * H * A + 2 * H
    assert roofline.mlp_forward_flops(F, H, L, A, towers=1) == tower + 2 * H * A
    assert roofline.policy_tower_flops(F, H, L, A) == tower + 2 * H * A
    assert roofline.mlp_forward_flops(F, 128, 4, A) == (
        2 * (2 * F * 128 + 2 * 3 * 128 * 128) + 2 * 128 * A + 2 * 128)
    f, feat, w = 64, 128, 128
    conv = 2 * 9 * f * F + 4 * 2 * 9 * f * f * F
    assert roofline.cnn_forward_flops(F) == (
        conv + 2 * F * f * feat + 2 * (2 * feat * w + 2 * w * w) + 2 * w * A + 2 * w)
    assert roofline.cnn_gathered_bank_flops(F, 3) == conv + 4 * (
        2 * F * f * feat + 2 * feat * w + 2 * w * w + 2 * w * A)


def test_roofline_stage_classifies_its_bound():
    compute = roofline.stage("c", 1e-3, 100, 0.5 * roofline.PEAK_FLOPS_FP32 * 1e-3, 1e3)
    assert compute["bound"] == "compute" and compute["pct_peak_flops"] == 50.0
    hbm = roofline.stage("h", 1e-3, 100, 1e3, 0.25 * roofline.PEAK_HBM_BPS * 1e-3)
    assert hbm["bound"] == "hbm" and hbm["pct_peak_hbm"] == 25.0
    assert roofline.stage("l", 1.0, 100, 1e6, 1e6)["bound"] == "latency"
    no_model = roofline.stage("n", 1e-3, 100, 1e3, None, note="x")
    assert no_model["bound"] == "latency" and no_model["hbm_model"] and no_model["note"] == "x"
    fp32 = roofline.stage("f", 1e-3, 1, roofline.PEAK_FLOPS_FP32 * 1e-3, None)
    assert fp32["pct_peak_flops"] == 100.0 and fp32["bound"] == "compute"


def test_profiling_helpers_on_cpu(tmp_path):
    calls = []
    out = profiling.time_fn(lambda x: calls.append(x), 3, warmup=2, repeats=4)
    assert calls == [3] * 6 and out["seconds_per_call"] > 0
    assert out["calls_per_s"] == pytest.approx(1.0 / out["seconds_per_call"])
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("hex_region"):
            torch.ones(8).sum()
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "hex_region" in text


def test_bench_main_tiny_on_cpu(capsys):
    record = bench.main(repeats=2, device="cpu", board=3, batch=8, steps=6, calls=1)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == bench.METRIC and record["device"] == "cpu"
    for route in ("pallas", "api", "lax"):
        assert record[route]["median"] > 0 and len(record[route]["samples"]) == 2
        assert record[f"{route}_steps_per_s"] == record[route]["median"]
    assert record["winner"] in ("pallas", "api", "lax")
    assert record["value"] == record[f"{record['winner']}_steps_per_s"]
    assert record["roofline"]["composable_bytes_per_env_step_model"] > 0
