"""The port's rollout against the JAX package.

The K4 twin runs from the same carry, params, bank, first-move table and
random bits as ``pallas_rollout.fused_rollout`` in interpret mode (bits
regenerated from the key as that function splits it), with the float32 and
the bf16 bank; the record and final carry must be exactly equal, log-probs
and values within 1e-5.  Then the port's runner drives both of its paths on
the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core.topology import get_topology as jax_get_topology
from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.ops import pallas_rollout as jpr
from hex_gym_env_tpu.train.bank import OpponentBank as JaxBank
from hex_gym_env_tpu.train.bank import init_bank as jax_init_bank
from hex_gym_env_tpu.train.rollout import SelfplayRunner as JaxRunner
from hex_gym_env_tpu.utils.config import SelfplayConfig as JaxSelfplayConfig

from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.convert import flax_state_dict, state_from_numpy
from hex_gym_env_tpu_torch.ops import masked
from hex_gym_env_tpu_torch.ops import rollout_kernel as rk
from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank
from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
from hex_gym_env_tpu_torch.utils.config import SelfplayConfig

N, B, T, POOL = 5, 16, 12, 4
ATOL = 1e-5  # float32 sums taken in another order than XLA's
# games of the bf16-bank case: enough opponent draws that bf16 changes some
BF16_B = 128


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_setup(seat_mode, member_scale=None, n_envs=B):
    """Non-trivial, mutually distinct opponents, as the JAX package's own
    rollout test builds them; with ``member_scale``, every member's and the
    best's weights drawn N(0, member_scale^2) instead (trained magnitudes)."""
    topo = jax_get_topology(N)
    model = jax_make_policy("MLP-default", topo.num_cells)
    ks = jax.random.split(jax.random.key(7), POOL + 3)
    dummy = jnp.zeros((1, N, N), jnp.float32)
    variables = model.init(ks[0], dummy)
    bank0 = jax_init_bank(variables, POOL)
    members = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[model.init(ks[i + 1], dummy) for i in range(POOL)])
    best = model.init(ks[POOL + 1], dummy)
    if member_scale is not None:
        def scaled(tree, key):
            leaves, treedef = jax.tree.flatten(tree)
            keys = jax.random.split(key, len(leaves))
            return jax.tree.unflatten(treedef, [jax.random.normal(k, x.shape) * member_scale
                                                for k, x in zip(keys, leaves)])

        members, best = scaled(members, ks[1]), scaled(best, ks[POOL + 1])
    bank = JaxBank(params=members, scores=bank0.scores, best_params=best,
                   best_score=bank0.best_score)
    cfg = JaxSelfplayConfig(board_size=N, n_envs=n_envs, buffer_size=POOL, seat_mode=seat_mode,
                            rollout_impl="fused", policy_impl="lax", env_step_impl="lax")
    runner = JaxRunner(topo, model, cfg)
    carry = runner.init_carry(bank, ks[POOL + 2])
    return topo, model, runner, variables, bank, carry, cfg


def _port_inputs(variables, bank, carry):
    params = flax_state_dict(_np(variables))
    tbank = OpponentBank(
        params=flax_state_dict(_np(bank.params)), scores=torch.from_numpy(np.array(bank.scores)),
        best_params=flax_state_dict(_np(bank.best_params)),
        best_score=torch.from_numpy(np.array(bank.best_score)))
    return params, tbank, state_from_numpy(carry)


def _jax_record(topo, model, runner, variables, bank, carry, cfg, key, eval_mode, bank_bf16):
    pol = runner.fused_pol
    stacked = pol.stack_bank(bank)
    dummy = jnp.zeros((1, N, N), jnp.float32)
    members = jax.vmap(lambda v: model.apply(v, dummy)[0][0])(bank.params)
    best = model.apply(bank.best_params, dummy)[0][0]
    ft = jnp.concatenate([members, best[None]], axis=0)
    P1, P1c = stacked.n_members, stacked.tensors[-1].shape[0]
    ft_pad = jnp.pad(ft, ((0, P1c - P1), (0, 0)))
    out = jpr.fused_rollout(
        topo, pol, pol.pack_agent(variables["params"]), stacked.tensors, ft_pad, carry.env,
        dict(n_members=P1, agent_seat=carry.agent_seat, use_best=carry.use_best,
             opp_idx=carry.opp_idx),
        key, T, cfg.best_prob, cfg.seat_mode == "per_episode", interpret=True,
        bank_bf16=bank_bf16, eval_mode=eval_mode)
    kb = jax.random.split(key, 4)
    A = topo.num_cells
    bits = tuple(
        masked.bits_from_numpy(np.asarray(jax.random.bits(k, (T, cfg.n_envs, w), jnp.uint32)))
        for k, w in zip(kb, (A, A, A, 128)))
    return out, np.asarray(ft), bits


@pytest.mark.parametrize("bank_bf16", [False, True])
@pytest.mark.parametrize(
    "seat_mode,eval_mode",
    [("per_episode", False), ("fixed_random", False), ("per_episode", True)],
)
def test_k4_twin_matches_pallas_rollout(seat_mode, eval_mode, bank_bf16):
    """With ``bank_bf16`` both sides run the opponent on the bf16 bank
    (weights and each dot's left-hand side in bf16, float32 sums); the
    opening-move table stays float32 in both.  That case takes a bank at
    trained magnitudes (members N(0, 0.3^2)), where bf16 changes opponent
    actions: the port's float32 bank must leave JAX's bf16 record."""
    topo, model, runner, variables, bank, carry, cfg = _jax_setup(
        seat_mode, *((0.3, BF16_B) if bank_bf16 else ()))
    key = jax.random.key(11)
    jout, ft, bits = _jax_record(topo, model, runner, variables, bank, carry, cfg, key, eval_mode,
                                 bank_bf16)
    params, tbank, tcarry = _port_inputs(variables, bank, carry)

    tt = get_topology(N)
    pol = rk.resolve(make_policy("MLP-default", tt.num_cells), SelfplayConfig(
        board_size=N, n_envs=cfg.n_envs, buffer_size=POOL, rollout_impl="fused"))
    stacked = pol.stack_bank(tbank)
    table = rk.first_move_table(stacked, pol.dims)
    np.testing.assert_allclose(table.numpy(), ft, atol=ATOL)
    out = rk.fused_rollout(
        tt, pol, pol.pack_agent(params), stacked, torch.from_numpy(ft), tcarry.env,
        tcarry.agent_seat, tcarry.use_best, tcarry.opp_idx, T, cfg.best_prob,
        seat_mode == "per_episode", bits=bits, eval_mode=eval_mode, bank_bf16=bank_bf16)

    F = tt.num_cells
    np.testing.assert_array_equal(out.obs.numpy(), np.asarray(jout.obs)[:, :, :F])
    np.testing.assert_array_equal(out.ints.numpy(), np.asarray(jout.ints))
    jf = np.asarray(jout.flts)
    np.testing.assert_allclose(out.flts.numpy()[..., :2], jf[..., :2], atol=ATOL)
    np.testing.assert_array_equal(out.flts.numpy()[..., 2:], jf[..., 2:])
    np.testing.assert_array_equal(out.state.stones[:, 0].numpy(), np.asarray(jout.s0) != 0)
    np.testing.assert_array_equal(out.state.stones[:, 1].numpy(), np.asarray(jout.s1) != 0)
    np.testing.assert_array_equal(out.state.labels.numpy()[:, : F + 4],
                                  np.asarray(jout.labels)[:, : F + 4])
    meta = np.asarray(jout.meta)
    for got, lane in ((out.state.to_move, jpr.M_TO_MOVE), (out.state.done, jpr.M_DONE),
                      (out.state.empty, jpr.M_EMPTY), (out.state.move_count, jpr.M_MOVES),
                      (out.agent_seat, jpr.M_SEAT), (out.use_best, jpr.M_USE_BEST),
                      (out.opp_idx, jpr.M_OPP_IDX)):
        np.testing.assert_array_equal(got.numpy().astype(np.int32), meta[:, lane])
    assert out.ints[..., rk.I_DONE].sum() > 0  # episodes finished: resets were exercised
    if bank_bf16:  # the case tells the modes apart: float32 does not give JAX's bf16 record
        f32 = rk.fused_rollout(
            tt, pol, pol.pack_agent(params), stacked, torch.from_numpy(ft), tcarry.env,
            tcarry.agent_seat, tcarry.use_best, tcarry.opp_idx, T, cfg.best_prob,
            seat_mode == "per_episode", bits=bits, eval_mode=eval_mode)
        assert not np.array_equal(f32.ints.numpy(), np.asarray(jout.ints))
    if not eval_mode:
        rk.verify_rollout_trajectory(
            tt, make_policy("MLP-default", F), params, tcarry, out, T, seat_mode, POOL)


def _port_setup(rollout_impl, policy_impl="auto", env_step_impl="auto", seat_mode="per_episode"):
    topo = get_topology(N)
    g = torch.Generator().manual_seed(0)
    model = make_policy("MLP-default", topo.num_cells, generator=g)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    snaps = [make_policy("MLP-default", topo.num_cells, generator=g).state_dict()
             for _ in range(POOL + 1)]
    bank0 = init_bank(params, POOL)
    bank = OpponentBank(
        params={k: torch.stack([s[k] for s in snaps[:POOL]]) for k in params},
        scores=bank0.scores, best_params=snaps[POOL], best_score=bank0.best_score)
    cfg = SelfplayConfig(board_size=N, n_envs=B, buffer_size=POOL, rollout_impl=rollout_impl,
                         policy_impl=policy_impl, env_step_impl=env_step_impl,
                         seat_mode=seat_mode)
    runner = SelfplayRunner(topo, model, cfg, device="cpu")
    return topo, model, params, bank, runner, g


def _check_transitions(topo, model, params, carry2, tr, last_values):
    A = topo.num_cells
    legal = tr.legal.reshape(T, B, A)
    assert torch.take_along_dim(legal, tr.action.long()[..., None], -1).all()
    assert torch.equal(legal, tr.obs.reshape(T, B, A) == 0)
    assert set(tr.reward.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert (tr.reward[~tr.done] == 0).all()
    assert tr.done.any()
    assert (tr.log_prob <= 1e-6).all() and torch.isfinite(tr.value).all()
    from hex_gym_env_tpu_torch.core import env as hex_env

    with torch.no_grad():
        _, value = model(hex_env.observe(topo, carry2.env))
    torch.testing.assert_close(last_values, value, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seat_mode", ["per_episode", "fixed_random"])
def test_runner_fused_on_cpu_replays(seat_mode):
    topo, model, params, bank, runner, g = _port_setup("fused", seat_mode=seat_mode)
    assert runner.fused_pol is not None
    carry = runner.init_carry(bank, g)
    bits = rk.draw_rollout_bits(g, T, B, topo.num_cells, "cpu")
    carry2, tr, last_values = runner.run_fused(params, bank, carry, g, T, bits=bits)
    _check_transitions(topo, model, params, carry2, tr, last_values)
    # the record behind the transitions replays exactly
    pol = runner.fused_pol
    stacked = pol.stack_bank(bank)
    out = rk.fused_rollout(
        topo, pol, pol.pack_agent(params), stacked, rk.first_move_table(stacked, pol.dims),
        carry.env, carry.agent_seat, carry.use_best, carry.opp_idx, T, runner.cfg.best_prob,
        seat_mode == "per_episode", bits=bits)
    assert torch.equal(out.ints[..., rk.I_ACTION], tr.action)
    rk.verify_rollout_trajectory(topo, model, params, carry, out, T, seat_mode, POOL)
    # and the runner's own generator path runs too
    _check_transitions(topo, model, params, *runner.run(params, bank, carry2, g, T))


def test_runner_fused_bf16_bank_on_cpu_replays(monkeypatch):
    """``rollout_impl="fused"`` with ``rollout_bank_bf16``: the runner passes
    the flag and a float32 opening-move table to the fused pass, its record
    is the bf16 twin's on the same bits, and it replays exactly through the
    plain env ops (bf16 changes only the opponent's logits)."""
    topo, model, params, bank, runner, g = _port_setup("fused")
    runner = SelfplayRunner(topo, model, dataclasses.replace(runner.cfg, rollout_bank_bf16=True),
                            device="cpu")
    assert runner.fused_pol is not None
    seen = []
    fused = rk.fused_rollout

    def spy(*args, **kwargs):
        seen.append((args[4], kwargs["bank_bf16"]))
        return fused(*args, **kwargs)

    monkeypatch.setattr(rk, "fused_rollout", spy)
    carry = runner.init_carry(bank, g)
    bits = rk.draw_rollout_bits(g, T, B, topo.num_cells, "cpu")
    carry2, tr, last_values = runner.run_fused(params, bank, carry, g, T, bits=bits)
    _check_transitions(topo, model, params, carry2, tr, last_values)
    pol = runner.fused_pol
    stacked = pol.stack_bank(bank)
    table = rk.first_move_table(stacked, pol.dims)
    (got_table, got_bf16), = seen
    assert got_bf16 is True and torch.equal(got_table, table)
    out = fused(topo, pol, pol.pack_agent(params), stacked, table, carry.env, carry.agent_seat,
                carry.use_best, carry.opp_idx, T, runner.cfg.best_prob, True, bits=bits,
                bank_bf16=True)
    assert torch.equal(runner.last_record.ints, out.ints)
    assert torch.equal(runner.last_record.obs, out.obs)
    rk.verify_rollout_trajectory(topo, model, params, carry, out, T, "per_episode", POOL)


@pytest.mark.parametrize("bank_bf16", [False, True])
def test_opp_logits_are_the_opponents_draws(bank_bf16):
    """``fused_rollout(..., opp_logits=buf)`` fills (T, B, A) with the
    opponent's bank logits: where the opponent moved, its recorded action is
    the Gumbel-max of those logits under the legal mask and its bits, and
    at step 0 they are ``bank_logits_twin`` of the board it saw."""
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk

    topo, model, params, bank, runner, g = _port_setup("fused")
    pol = runner.fused_pol
    d, A = pol.dims, topo.num_cells
    stacked = torch.randn(pol.stack_bank(bank).shape, generator=g) * 0.3
    carry = runner.init_carry(bank, g)
    bits = rk.draw_rollout_bits(g, T, B, A, "cpu")
    buf = torch.full((T, B, A), float("nan"))
    out = rk.fused_rollout(
        topo, pol, pol.pack_agent(params), stacked, rk.first_move_table(stacked, d), carry.env,
        carry.agent_seat, carry.use_best, carry.opp_idx, T, runner.cfg.best_prob, True,
        bits=bits, bank_bf16=bank_bf16, opp_logits=buf)
    assert torch.isfinite(buf).all()
    # replay step 0's agent move to get the board the opponent saw
    st1, _ = hex_env.step(topo, carry.env, out.ints[0, :, rk.I_ACTION])
    idx = torch.where(carry.use_best, stacked.shape[0] - 1, carry.opp_idx)
    obs2 = hex_env.observe(topo, st1).reshape(B, A)
    assert torch.equal(buf[0], pk.bank_logits_twin(stacked, d, obs2, idx, bf16=bank_bf16))
    legal2 = hex_env.legal_mask(topo, st1)
    moved = ~st1.done
    draw = masked.argmax_first(masked.mask_logits(buf[0], legal2) + masked.gumbel(bits[1][0]))
    assert moved.any() and torch.equal(draw[moved], out.ints[0, moved, rk.I_OPP_ACTION])
    if bank_bf16:  # the bf16 bank's logits are not the float32 bank's
        assert not torch.equal(buf[0], pk.bank_logits_twin(stacked, d, obs2, idx))


def test_runner_scan_twins_match_plain_path():
    """The scan path through the K1-K3 twins draws the same bits as the
    plain model path, so both collect the same transitions."""
    results = []
    for impl in ("auto", "lax"):
        topo, model, params, bank, runner, _ = _port_setup("scan", impl, impl)
        assert (runner.pol is None) == (impl == "lax") and runner.fused_pol is None
        g = torch.Generator().manual_seed(5)
        carry = runner.init_carry(bank, g)
        carry2, tr, last_values = runner.run(params, bank, carry, g, T)
        _check_transitions(topo, model, params, carry2, tr, last_values)
        results.append((carry2, tr))
    (c_a, tr_a), (c_b, tr_b) = results
    for name in ("obs", "legal", "action", "reward", "done"):
        assert torch.equal(getattr(tr_a, name), getattr(tr_b, name)), name
    torch.testing.assert_close(tr_a.log_prob, tr_b.log_prob, atol=ATOL, rtol=0)
    torch.testing.assert_close(tr_a.value, tr_b.value, atol=ATOL, rtol=0)
    assert torch.equal(c_a.env.labels, c_b.env.labels)


def test_rollout_gate():
    mlp11 = make_policy("MLP-default", 121)
    assert rk.supported(mlp11, SelfplayConfig(board_size=11))
    assert not rk.supported(make_policy("MLP-default", 144), SelfplayConfig(board_size=12))
    assert not rk.supported(mlp11, SelfplayConfig(board_size=11, sample_board=True))
    assert rk.supported(mlp11, SelfplayConfig(board_size=11, rollout_bank_bf16=True))
    mlp = make_policy("MLP-default", 25)
    assert rk.resolve(mlp, SelfplayConfig(board_size=5, rollout_impl="fused",
                                          rollout_bank_bf16=True)) is not None
    assert rk.resolve(mlp, SelfplayConfig(board_size=5, rollout_impl="scan")) is None
    assert rk.resolve(mlp, SelfplayConfig(board_size=5, policy_impl="lax")) is None
    assert rk.resolve(mlp, SelfplayConfig(board_size=5)).impl == "auto"
    assert rk.resolve(mlp, SelfplayConfig(board_size=5, policy_impl="pallas")).impl == "pallas"
    with pytest.raises(ValueError):
        rk.resolve(make_policy("MLP-default", 144),
                   SelfplayConfig(board_size=12, rollout_impl="fused"))
    with pytest.raises(ValueError):
        rk.resolve(mlp, SelfplayConfig(board_size=5, rollout_impl="FUSED"))
