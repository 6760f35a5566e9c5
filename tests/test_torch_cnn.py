"""The port's CNN family against the JAX package.

The same numpy-made weights (flax variables, converted with
``models/convert.py``), BatchNorm statistics, boards and batches go to the
JAX package's ``models/cnn.py`` and learner and to the port's.  Tolerances:

- the forward: logits and values within 1e-5 absolute + 1e-5 relative, the
  new running statistics within 1e-6 of each tensor's largest value
  (float32 sums in another order);
- the banks in float32: within 1e-5 of the largest logit (their logits at
  trained scale run to 1e5, where an absolute bound means nothing);
- the bf16 bank: layer by layer, from the same input, every activation the
  JAX layer's except at most ``BF16_LAYER_SHARE`` of them, each one bf16
  ulp apart (a float32 sum in another order lands across a rounding
  boundary, measured ~5e-5 of the activations); end to end no logit beyond
  2^-8 of the largest.  Such flips then cascade through the five rounded
  layers, so K4-bf16's 1%-of-rows rule cannot hold here; the float32 stack
  in the bf16 one's place fails the layer rule, a control;
- the learner: params, Adam moments and running statistics within 1e-5 of
  each tensor's largest value after one grad step, 1e-4 after a sweep.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.models import cnn as jcnn
from hex_gym_env_tpu.ops import masked as jmasked
from hex_gym_env_tpu.train import ppo as jppo
from hex_gym_env_tpu.utils.config import PPOConfig as JaxPPOConfig

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.experiments import get_config
from hex_gym_env_tpu_torch.models import cnn, make_policy
from hex_gym_env_tpu_torch.models.convert import (
    flax_state_dict, flax_to_torch, optax_adam_to_torch)
from hex_gym_env_tpu_torch.train import ppo
from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils import checkpoint as ckpt_lib
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

N = 5
A = N * N
NARROW = dict(filters=8, features_dim=16, pi_layers=(16, 16), vf_layers=(16, 16))
FAMILY = {}  # the family's widths (64 filters, features 128, towers [128, 128])
WIDTHS = {"narrow": NARROW, "family": FAMILY}
BF16_LAYER_SHARE = 1e-3
BF16_REL = 2.0**-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmodel(widths):
    return jcnn.CnnPolicy(n_actions=A, **widths)


def _variables(widths, seed, trained=False):
    """flax variables (numpy leaves) of a CNN: the flax init with BatchNorm
    statistics and affine parameters moved off their init, or with
    ``trained`` every weight and bias N(0, 0.3^2) (trained magnitudes)."""
    rng = np.random.default_rng(seed)
    init = _jmodel(widths).init(jax.random.key(seed), jnp.zeros((1, N, N)), train=False)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        if "'mean'" in name:
            return rng.normal(0.0, 0.3 if trained else 0.1, x.shape).astype(np.float32)
        if "'scale'" in name:
            return (1.0 + rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        if "BatchNorm_0" in name or not trained:
            return (np.asarray(x) + rng.normal(0.0, 0.05, x.shape)).astype(np.float32)
        return rng.normal(0.0, 0.3, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, init))


def _stack(members):
    return jax.tree.map(lambda *xs: np.stack(xs), *members)


def _boards(n, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 0, 1], np.int8), size=(n, N, N))


def _close_to_max(got, want, tol, what=""):
    """max |got - want| within ``tol`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: error {err:.3g} of the largest value > {tol}"


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("width", ["narrow", "family"])
def test_forward_matches_jax(width, train):
    widths = WIDTHS[width]
    v = _variables(widths, seed=1)
    obs = _boards(32, seed=2)
    model = flax_to_torch(v)
    assert isinstance(model, cnn.CnnPolicy) and model.filters == widths.get("filters", 64)
    x = torch.from_numpy(obs)
    if train:
        (jl, jv), upd = _jmodel(widths).apply(v, jnp.asarray(obs, jnp.float32), train=True,
                                              mutable=["batch_stats"])
        logits, value, new_stats = model(x, train=True)
        want = flax_state_dict({"params": v["params"],
                                "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
        assert set(new_stats) == {k for k, _ in model.named_buffers()}
        for k, s in new_stats.items():
            _close_to_max(s, want[k], 1e-6, k)
        # the statistics moved, and the module's own buffers did not
        assert not torch.equal(new_stats["conv_in.bn.var"], model.conv_in.bn.var)
        assert torch.equal(model.conv_in.bn.var, flax_state_dict(v)["conv_in.bn.var"])
    else:
        jl, jv = _jmodel(widths).apply(v, jnp.asarray(obs, jnp.float32))
        logits, value = model(x)
        # flat rows (the runner's layout) give the same
        flat = model(x.reshape(32, A))
        assert torch.equal(flat[0], logits) and torch.equal(flat[1], value)
    assert float(np.abs(np.asarray(jl)).max()) > 1e-3  # the weights reach the logits
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def test_family_shapes_and_init():
    g = torch.Generator().manual_seed(0)
    model = make_policy("CNN", 81, generator=g)
    assert isinstance(model, cnn.CnnPolicy)
    sd = model.state_dict()
    assert sd["conv_in.conv.weight"].shape == (64, 1, 3, 3)
    assert sd["block2_b.conv.weight"].shape == (64, 64, 3, 3)
    assert sd["features.weight"].shape == (128, 81 * 64)
    assert model.pi_layers == model.vf_layers == (128, 128)
    assert {k for k, _ in model.named_buffers()} == {
        f"{name}.bn.{s}" for name in cnn.CONV_LAYERS for s in ("mean", "var")}
    # orthogonal with gain sqrt(2): each output filter of a 64 -> 64 conv has
    # norm sqrt(2), and conv_in's nine input taps are orthogonal
    w = sd["block1_a.conv.weight"].reshape(64, -1)
    torch.testing.assert_close(w.norm(dim=1), torch.full((64,), 2.0**0.5), atol=1e-5, rtol=0)
    w0 = sd["conv_in.conv.weight"].reshape(64, 9)
    torch.testing.assert_close(w0.T @ w0, 2.0 * torch.eye(9), atol=1e-5, rtol=0)
    assert float(sd["conv_in.conv.bias"].abs().max()) == 0.0
    assert torch.equal(sd["conv_in.bn.var"], torch.ones(64))
    again = make_policy("CNN", 81, generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ---------------------------------------------------------------------------
# the opponent bank
# ---------------------------------------------------------------------------

P, BB = 3, 16


def _bank_inputs(widths=FAMILY):
    members = [_variables(widths, seed=10 + i, trained=True) for i in range(P)]
    best = _variables(widths, seed=20, trained=True)
    obs = _boards(BB, seed=3)
    rng = np.random.default_rng(4)
    use_best = rng.random(BB) < 0.3
    opp_idx = rng.integers(0, P, BB).astype(np.int32)
    return members, best, obs, use_best, opp_idx


def _port(members, best, obs, use_best, opp_idx):
    return (flax_state_dict(_stack(members)), flax_state_dict(best), torch.from_numpy(obs),
            torch.from_numpy(use_best), torch.from_numpy(opp_idx))


def test_fold_bn_matches_jax():
    members, *_ = _bank_inputs()
    stacked = _stack(members)
    want = jcnn.fold_bn(stacked)
    got = cnn.fold_bn(flax_state_dict(stacked))
    for name in cnn.CONV_LAYERS:
        wk, wb = (np.asarray(x) for x in want[name])
        _close_to_max(got[name][0], np.transpose(wk, (0, 4, 3, 1, 2)), 1e-6, f"{name} weight")
        _close_to_max(got[name][1], wb, 1e-6, f"{name} bias")


def test_zero_member_folds_to_zero_logits():
    """A fresh bank's members (every tensor 0: BatchNorm scale and variance
    too) fold to zero filters, not NaN, and give zero logits."""
    model = make_policy("CNN", A)
    bank = init_bank(dict(model.state_dict()), 2)
    folded = cnn.fold_bn(bank.params)
    assert all(not w.any() and not b.any() for w, b in folded.values())
    obs = torch.from_numpy(_boards(4, seed=5))
    assert not cnn.bank_logits(model, bank.params, obs).any()
    assert not cnn.gathered_bank_logits(
        model, bank.params, bank.best_params, torch.tensor([True, False, False, True]),
        torch.tensor([0, 1, 0, 1], dtype=torch.int32), obs).any()


@pytest.mark.parametrize("kind", ["dense", "paired", "gathered"])
def test_bank_logits_match_jax(kind):
    members, best, obs, use_best, opp_idx = _bank_inputs()
    stacked = _stack(members)
    jm = _jmodel(FAMILY)
    model = make_policy("CNN", A)
    sd, bsd, x, ub, oi = _port(members, best, obs, use_best, opp_idx)
    if kind == "dense":
        want = jcnn.bank_logits(jm, stacked, jnp.asarray(obs, jnp.float32))
        got = cnn.bank_logits(model, sd, x)
    elif kind == "paired":
        want = jcnn.bank_logits(jm, stacked, jnp.asarray(obs[:P], jnp.float32), paired=True)
        got = cnn.bank_logits(model, sd, x[:P].reshape(P, A), paired=True)
        # member i on board i: its own forward
        for i in range(P):
            ref = jm.apply(members[i], jnp.asarray(obs[i:i + 1], jnp.float32))[0][0]
            _close_to_max(got[i], ref, 1e-5, f"paired member {i}")
    else:
        want = jcnn.gathered_bank_logits(jm, stacked, best, jnp.asarray(use_best),
                                         jnp.asarray(opp_idx), jnp.asarray(obs, jnp.float32))
        got = cnn.gathered_bank_logits(model, sd, bsd, ub, oi, x)
        # the rows equal the dense pass's selection
        dense = cnn.bank_logits(model, sd, x)[oi.long(), torch.arange(BB)]
        best_rows = cnn.bank_logits(model, {k: v[None] for k, v in bsd.items()}, x)[0]
        _close_to_max(got, torch.where(ub[:, None], best_rows, dense), 1e-5, "gathered vs dense")
    want = np.asarray(want)
    assert np.abs(want).max() > 1.0  # trained magnitudes
    _close_to_max(got, want, 1e-5, kind)


def _ulp_apart(got, want):
    """(share of activations that differ, True if every difference is at
    most one bf16 ulp): both hold bf16 values; a difference may also be a
    ReLU zero against a value within float32 rounding of zero."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    scale = float(want.abs().max())
    ok = diff <= 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6 * scale
    return float((diff > 0).double().mean()), bool(ok.all())


def _jax_bf16_layer(x, w, b, groups):
    """One layer of the JAX bf16 bank as ``models/cnn.py`` writes it, on
    the port's (1, G*Cin, N, N) input and (G*Cout, Cin, 3, 3) weights."""
    dtype = jnp.bfloat16
    cout, cin = w.shape[0] // groups, w.shape[1]
    lhs = jnp.asarray(x.permute(0, 2, 3, 1).numpy()).astype(dtype)
    rhs = jnp.asarray(w.reshape(groups, cout, cin, 3, 3).permute(3, 4, 2, 0, 1)
                      .reshape(3, 3, cin, groups * cout).numpy()).astype(dtype)
    y = jax.lax.conv_general_dilated(lhs, rhs, (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     feature_group_count=groups,
                                     preferred_element_type=jnp.float32)
    y = jnp.maximum(y + jnp.asarray(b.numpy()), 0.0).astype(dtype).astype(jnp.float32)
    return torch.from_numpy(np.array(y)).permute(0, 3, 1, 2)


def test_bf16_bank_layers_match_jax_and_refuse_float32():
    """The gathered bf16 conv stack layer by layer against the JAX bank's
    layer (bf16 operands, float32 sums, bias in float32, rounded after the
    ReLU), each layer from the JAX layer's input; the float32 stack in the
    bf16 one's place is refused."""
    members, best, obs, use_best, opp_idx = _bank_inputs()
    sd, bsd, x, ub, oi = _port(members, best, obs, use_best, opp_idx)
    filters = cnn.gathered_filters(cnn.fold_bn(sd), cnn.fold_bn(bsd), ub, oi)
    h = x.to(torch.float32).reshape(1, BB, N, N)
    refused = []
    for w, b in filters:
        want = _jax_bf16_layer(h, w, b, BB)
        share, ok = _ulp_apart(cnn.conv_relu(h, w, b, BB, bf16=True), want)
        assert ok and share <= BF16_LAYER_SHARE, (share, ok)
        share32, ok32 = _ulp_apart(cnn.conv_relu(h, w, b, BB, bf16=False), want)
        refused.append(share32 > BF16_LAYER_SHARE)
        h = want
    assert all(refused)


@pytest.mark.parametrize("kind", ["dense", "gathered"])
def test_bf16_bank_logits_match_jax(kind):
    """End to end, the bf16 bank's logits lie within 2^-8 of the largest
    logit of JAX's bf16 bank, and differ from the float32 bank's."""
    members, best, obs, use_best, opp_idx = _bank_inputs()
    stacked = _stack(members)
    jm = _jmodel(FAMILY)
    model = make_policy("CNN", A)
    sd, bsd, x, ub, oi = _port(members, best, obs, use_best, opp_idx)
    jx = jnp.asarray(obs, jnp.float32)
    if kind == "dense":
        want = jcnn.bank_logits(jm, stacked, jx, dtype=jnp.bfloat16)
        got = cnn.bank_logits(model, sd, x, bf16=True)
        f32 = cnn.bank_logits(model, sd, x)
    else:
        want = jcnn.gathered_bank_logits(jm, stacked, best, jnp.asarray(use_best),
                                         jnp.asarray(opp_idx), jx, dtype=jnp.bfloat16)
        got = cnn.gathered_bank_logits(model, sd, bsd, ub, oi, x, bf16=True)
        f32 = cnn.gathered_bank_logits(model, sd, bsd, ub, oi, x)
    _close_to_max(got, np.asarray(want), BF16_REL, f"bf16 {kind}")
    assert float((got - f32).abs().max()) > 1e-4 * float(f32.abs().max())


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------


def _ppo_batch(n, seed):
    rng = np.random.default_rng(seed)
    boards = _boards(n, seed)
    boards.reshape(n, A)[np.arange(n), rng.integers(0, A, n)] = 0
    legal = boards.reshape(n, A) == 0
    actions = np.argmax(np.where(legal, rng.random((n, A)), -1.0), axis=1).astype(np.int32)
    return jppo.PPOBatch(
        obs=jnp.asarray(boards), legal=jnp.asarray(legal), action=jnp.asarray(actions),
        log_prob_old=jnp.asarray(rng.normal(-2.5, 0.3, n).astype(np.float32)),
        value_old=jnp.asarray(rng.normal(0, 0.5, n).astype(np.float32)),
        advantage=jnp.asarray(rng.normal(0, 1.0, n).astype(np.float32)),
        ret=jnp.asarray(rng.normal(0, 0.7, n).astype(np.float32)),
    )


def _assert_tree(got: dict, want: dict, tol, what, per_tensor=True):
    """Each tensor within ``tol`` of its own largest value, or with
    ``per_tensor=False`` of the largest over the tree: Adam's moments of the
    conv biases, whose gradient under a train-mode BatchNorm is 0 in exact
    arithmetic, hold round-off (~1e-9), as K6's check on the card holds p, m
    and v each as a whole."""
    assert set(got) == set(want), what
    scale = 1.0 if per_tensor else max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        w = np.asarray(want[k], np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        ref = np.abs(w).max() if per_tensor else scale
        assert err <= tol * ref, f"{what} {k}: error {err:.3g} > {tol} x {ref:.3g}"


@pytest.mark.parametrize("n_epochs,n,tol", [(1, 32, 1e-5), (2, 96, 1e-4)])
def test_sweep_with_batch_stats_matches_jax(n_epochs, n, tol):
    """The port's autograd sweep against JAX's lax/optax sweep from the same
    variables, warm Adam state and permutations: params, moments and the
    running statistics carried through the minibatches."""
    jm = _jmodel(NARROW)
    jcfg = JaxPPOConfig(minibatch_size=32, n_epochs=n_epochs)
    v = _variables(NARROW, seed=7)
    optimizer = jppo.make_optimizer(jcfg)
    warm = jax.jit(jppo.make_update_fn(jm, JaxPPOConfig(minibatch_size=32, n_epochs=1),
                                       optimizer))
    _, opt_state, _ = warm(v, optimizer.init(v["params"]), _ppo_batch(32, seed=8),
                           jax.random.key(1))
    batch = _ppo_batch(n, seed=9)
    key = jax.random.key(2)
    jv, jopt, jstats = jax.jit(jppo.make_update_fn(jm, jcfg, optimizer))(v, opt_state, batch, key)
    perms = torch.from_numpy(np.array(jppo.epoch_permutations(key, n, n_epochs)))

    model = flax_to_torch(v)
    cfg = PPOConfig(minibatch_size=32, n_epochs=n_epochs)
    adam = optax_adam_to_torch(jax.tree.map(np.asarray, opt_state))
    keys = set(ppo.trainable_keys(model))
    assert set(adam.mu) == set(adam.nu) == keys
    assert not any(k.endswith((".bn.mean", ".bn.var")) for k in keys)
    params, opt, stats = ppo.make_update_fn(model, cfg)(
        flax_state_dict(v), adam, ppo.PPOBatch(*(torch.from_numpy(np.array(x)) for x in batch)),
        perms=perms)
    assert opt.count == int(jopt[1][0].count) and set(opt.mu) == keys
    _assert_tree(params, flax_state_dict(jax.tree.map(np.asarray, jv)), tol, "params")
    for name, got in (("mu", opt.mu), ("nu", opt.nu)):
        want = flax_state_dict(jax.tree.map(np.asarray, getattr(jopt[1][0], name)))
        _assert_tree(got, want, tol, name, per_tensor=False)
    for name in jppo.PPOStats._fields:
        assert abs(float(getattr(stats, name)) - float(getattr(jstats, name))) < tol * 10, name
    # the running statistics moved in the sweep
    assert not torch.equal(params["conv_in.bn.mean"], flax_state_dict(v)["conv_in.bn.mean"])


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _cnn_cfg(**selfplay):
    sp = dict(board_size=N, n_envs=8, buffer_size=2, policy="CNN", eval_freq=1,
              n_eval_episodes=2)
    sp.update(selfplay)
    return TrainConfig(ppo=PPOConfig(n_steps=8, minibatch_size=16, n_epochs=2),
                       selfplay=SelfplayConfig(**sp))


def _replay(topo, carry0, tr, calls, seats):
    """Replay the scan rollout through the plain env ops: each step's agent
    move, the opponent's reply where the game goes on, then the resets and
    the opponent's opening moves.  ``calls`` are the runner's env-step calls
    (three per step: (action, active)), ``seats`` the carry's seats after
    each step's resets."""
    state, seat = carry0.env, carry0.agent_seat
    for t in range(tr.action.shape[0]):
        (a1, act1), (a2, act2), (a3, act3) = calls[3 * t: 3 * t + 3]
        assert act1 is None and torch.equal(a1, tr.action[t])
        assert torch.equal(hex_env.observe(topo, state), tr.obs[t])
        assert torch.equal(hex_env.legal_mask(topo, state), tr.legal[t])
        assert tr.legal[t].gather(1, tr.action[t][:, None].long()).all()
        s1, r1 = hex_env.step(topo, state, tr.action[t])
        assert torch.equal(act2, ~s1.done)
        s2, r2 = hex_env.step(topo, s1, a2, active=act2)
        col = seat[:, None].long()
        assert torch.equal(r1.gather(1, col)[:, 0] + r2.gather(1, col)[:, 0], tr.reward[t])
        assert torch.equal(s2.done, tr.done[t])
        seat = seats[t]
        assert torch.equal(act3, s2.done & (seat == 1))
        state, _ = hex_env.step(topo, hex_env.reset_where(topo, s2, s2.done), a3, active=act3)
    return state


def test_cnn_train_step_against_jax(tmp_path, monkeypatch):
    """One CNN ``train_step`` on the CPU at the family's widths: the record
    replays through the plain env ops; JAX's forward on the recorded boards
    gives the recorded values and log-probs; JAX's sweep on the recorded
    batch with the port's permutations gives the port's params and running
    statistics; then ``eval_step`` and the pool update carry the statistics
    with the weights, and a checkpoint resumes bitwise."""
    algo = SelfplayPPO(_cnn_cfg(), device="cpu")
    assert algo.runner.pol is None and algo.runner.fused_pol is None
    assert algo.evaluator.fused_pol is None
    jm = _jmodel(FAMILY)
    v = _variables(FAMILY, seed=30)
    state = algo.init_state(0)
    params = flax_state_dict(v)
    state = dataclasses.replace(state, params=params, opt_state=ppo.init_adam(
        {k: params[k] for k in ppo.trainable_keys(algo.model)}))
    seeds = [flax_state_dict(_variables(FAMILY, seed=31 + i)) for i in range(2)]
    state = algo.seed_bank(state, seeds, score=0.5)
    carry0 = state.carry

    calls, seats, seen = [], [], {}
    runner = algo.runner
    step, reset, run, update = runner.step, runner.reset_finished, runner.run, algo.update_fn

    def spy_step(topo, st, action, active=None):
        calls.append((action, active))
        return step(topo, st, action, active=active)

    def spy_reset(*args, **kwargs):
        c = reset(*args, **kwargs)
        seats.append(c.agent_seat)
        return c

    def spy_run(*args, **kwargs):
        seen["rollout"] = run(*args, **kwargs)
        return seen["rollout"]

    def spy_update(p, opt, batch, generator=None, perms=None):
        seen.update(batch=batch, gstate=generator.get_state())
        return update(p, opt, batch, generator, perms)

    monkeypatch.setattr(runner, "step", spy_step)
    monkeypatch.setattr(runner, "reset_finished", spy_reset)
    monkeypatch.setattr(runner, "run", spy_run)
    monkeypatch.setattr(algo, "update_fn", spy_update)
    state1, metrics = algo.train_step(state)
    assert np.isfinite(float(metrics.ppo.policy_loss))
    carry1, tr, _ = seen["rollout"]
    b = seen["batch"]
    assert torch.equal(b.obs, tr.obs.reshape(64, N, N))

    # the record replays through the plain env ops
    assert len(calls) == 3 * 8 and len(seats) == 8
    final = _replay(algo.topo, carry0, tr, calls, seats)
    for name in ("stones", "labels", "to_move", "done", "empty", "move_count"):
        assert torch.equal(getattr(final, name), getattr(carry1.env, name)), name

    # JAX's forward on the recorded boards: values and log-probs
    flat_obs = jnp.asarray(b.obs.numpy(), jnp.float32)
    jl, jval = jm.apply(v, flat_obs)
    jlp = jmasked.log_prob(jl, jnp.asarray(b.legal.numpy()), jnp.asarray(b.action.numpy()))
    np.testing.assert_allclose(b.value_old.numpy(), np.asarray(jval), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b.log_prob_old.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)

    # JAX's sweep on the recorded batch with the port's permutations
    gp = torch.Generator()
    gp.set_state(seen["gstate"])
    perms = ppo.epoch_permutations(gp, 64, 2).numpy()
    monkeypatch.setattr(jppo, "epoch_permutations", lambda key, n, e: jnp.asarray(perms))
    jcfg = JaxPPOConfig(minibatch_size=16, n_epochs=2)
    optimizer = jppo.make_optimizer(jcfg)
    jbatch = jppo.PPOBatch(*(jnp.asarray(x.numpy()) for x in b))
    jv, _, _ = jax.jit(jppo.make_update_fn(jm, jcfg, optimizer))(
        v, optimizer.init(v["params"]), jbatch, jax.random.key(0))
    _assert_tree(state1.params, flax_state_dict(jax.tree.map(np.asarray, jv)), 1e-4, "swept")
    assert not torch.equal(state1.params["block2_b.bn.var"], params["block2_b.bn.var"])

    # eval + pool update; a replacement carries the statistics with the weights
    state2, result = algo.eval_step(state1)
    assert np.isfinite(float(result.mean_reward))
    bank, res = algo.evaluator.apply_pool_update(state2.params, state2.bank, torch.ones(2),
                                                 torch.Generator().manual_seed(1))
    assert bool(res.replaced)
    slot = int(torch.nonzero(bank.scores == res.score)[0])
    for k in state2.params:
        assert torch.equal(bank.params[k][slot], state2.params[k]), k
    state2 = dataclasses.replace(state2, bank=bank)

    # a checkpoint resumes bitwise, the statistics included
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state2)
    resumed = mgr.restore()
    a, _ = algo.train_step(state2)
    r, _ = algo.train_step(resumed)
    for k in a.params:
        assert torch.equal(a.params[k], r.params[k]), k
        assert torch.equal(a.bank.params[k], r.bank.params[k]), k
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], r.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], r.opt_state.nu[k]), k
    assert torch.equal(a.carry.env.labels, r.carry.env.labels)
    path = str(tmp_path / "best" / "cnn.pt")
    ckpt_lib.save_params(path, a.params)
    loaded = ckpt_lib.load_params(path)
    assert set(loaded) == set(a.params)
    assert all(torch.equal(loaded[k], a.params[k]) for k in a.params)


# ---------------------------------------------------------------------------
# gates and other modes
# ---------------------------------------------------------------------------


def test_cnn_gates():
    for lr in ("0.0003", "0.003", "0.03"):
        algo = SelfplayPPO(get_config(f"CNN_lr-{lr}"), device="cpu")
        assert isinstance(algo.model, cnn.CnnPolicy) and algo.runner.fused_pol is None
        assert algo.runner.pol is None and algo.evaluator.fused_pol is None
        assert algo.update_fn.__qualname__.startswith("make_update_fn")
    model = make_policy("CNN", A)
    topo = SelfplayPPO(_cnn_cfg(), device="cpu").topo
    for bad in (dict(policy_impl="pallas"), dict(rollout_impl="fused"),
                dict(cnn_bank_mode="bogus")):
        with pytest.raises(ValueError):
            SelfplayRunner(topo, model, _cnn_cfg(**bad).selfplay, device="cpu")
    for impl in ("pallas", "pallas-fast"):
        cfg = dataclasses.replace(_cnn_cfg(), ppo=PPOConfig(n_steps=8, minibatch_size=16,
                                                            update_impl=impl))
        with pytest.raises(ValueError):
            SelfplayPPO(cfg, device="cpu")


@pytest.mark.parametrize("mode", ["sample_board", "symmetric_eval", "dense", "bf16"])
def test_cnn_other_modes(mode):
    """``sample_board`` (fresh games from random mid-game boards),
    ``symmetric_eval``, ``cnn_bank_mode="dense"`` and ``rollout_bank_bf16``
    run a CNN iteration; the runner's opponent pass is the bank function the
    mode names."""
    selfplay = {"sample_board": dict(sample_board=True), "symmetric_eval":
                dict(symmetric_eval=True), "dense": dict(cnn_bank_mode="dense"),
                "bf16": dict(rollout_bank_bf16=True)}[mode]
    algo = SelfplayPPO(_cnn_cfg(**selfplay), device="cpu")
    state = algo.init_state(3)
    seeds = [flax_state_dict(_variables(FAMILY, seed=40 + i)) for i in range(2)]
    state = algo.seed_bank(state, seeds, score=0.5)
    state, metrics = algo.train_step(state)
    state, result = algo.eval_step(state)
    assert np.isfinite(float(metrics.ppo.policy_loss)) and np.isfinite(float(result.mean_reward))
    assert result.rewards.shape == (2,)
    assert all(bool(torch.isfinite(x).all()) for x in state.params.values())

    runner, bank = algo.runner, state.bank
    st = state.carry.env
    ub, oi = torch.tensor([True, False] * 4), torch.tensor([0, 1, 1, 0] * 2, dtype=torch.int32)
    logits, _ = runner.opponent_logits(bank, ub, oi, st)
    obs = hex_env.observe(algo.topo, st).reshape(8, A)
    bf16 = mode == "bf16"
    if mode == "dense":
        members = cnn.bank_logits(algo.model, bank.params, obs)[oi.long(), torch.arange(8)]
        best = torch.func.functional_call(algo.model, bank.best_params, (obs.float(),))[0]
        assert torch.equal(logits, torch.where(ub[:, None], best, members))
    else:
        assert torch.equal(logits, cnn.gathered_bank_logits(
            algo.model, bank.params, bank.best_params, ub, oi, obs, bf16=bf16))
