"""The port's policy pieces against the JAX package: MLP forward with
converted weights (random and the in-repo checkpoints), the masked
distribution, and the twins of the agent pass (K2) and bank pass (K3)
against the Pallas kernels in interpret mode, fed the same random bits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.topology import get_topology
from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.ops import masked as jax_masked
from hex_gym_env_tpu.ops.pallas_policy import PolicyOps as JaxPolicyOps
from hex_gym_env_tpu.train.bank import init_bank as jax_init_bank

from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.convert import flax_state_dict, flax_to_torch
from hex_gym_env_tpu_torch.ops import masked, policy_kernel
from hex_gym_env_tpu_torch.train.bank import OpponentBank

ATOL = 1e-5  # float32 sums taken in another order than XLA's
ACT = {"MLP-default": "tanh", "MLP-deep": "relu", "MLP-wide-deep": "relu"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wide_logits(variables):
    """The orthogonal init's action head (gain 0.01) gives near-equal logits;
    widen them to O(1) so that the checks below bite."""
    head = variables["params"]["action_head"]
    params = dict(variables["params"], action_head=dict(head, kernel=head["kernel"] * 100.0))
    return {"params": params}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_positions(n, B, seed, n_moves=6):
    topo = get_topology(n)
    rng = np.random.default_rng(seed)
    state = jax_env.initial_state(topo, B)
    for _ in range(n_moves):
        legal = np.asarray(jax_env.legal_mask(topo, state))
        a = np.array([rng.choice(np.flatnonzero(r)) for r in legal], np.int32)
        state, _ = jax_env.step(topo, state, jnp.asarray(a))
        state = jax_env.reset_where(topo, state, state.done)
    return np.asarray(jax_env.observe(topo, state)), np.asarray(jax_env.legal_mask(topo, state))


def _forward_pair(n, family, variables, seed):
    obs, _ = _random_positions(n, 32, seed)
    jl, jv = jax_make_policy(family, n * n).apply(variables, jnp.asarray(obs, jnp.float32))
    model = flax_to_torch(_np_tree(variables), ACT[family])
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("family", ["MLP-default", "MLP-deep", "MLP-wide-deep"])
def test_mlp_forward_matches_flax(family):
    n = 5
    model = jax_make_policy(family, n * n)
    variables = _wide_logits(model.init(jax.random.key(1), jnp.zeros((1, n, n), jnp.float32)))
    _forward_pair(n, family, variables, seed=2)


@pytest.mark.parametrize("n", [5, 6, 7])
def test_checkpoint_forward_matches_flax(n):
    from hex_gym_env_tpu.models.loading import load_policy_params

    path = os.path.join(REPO, "models", f"{n}x{n}_strict_sb3", "agent_9437184")
    _, variables = load_policy_params(f"orbax:{path}", n)
    _forward_pair(n, "MLP-default", variables, seed=n)


@pytest.mark.parametrize("family", ["MLP-default", "MLP-deep", "MLP-wide-deep"])
def test_make_policy_families_match_shapes(family):
    n = 4
    jvars = jax_make_policy(family, n * n).init(jax.random.key(0), jnp.zeros((1, n, n)))
    expected = {k: v.shape for k, v in flax_state_dict(_np_tree(jvars)).items()}
    model = make_policy(family, n * n, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == expected
    assert model.activation == ACT[family]
    # orthogonal init: hidden rows orthonormal up to the sqrt(2) gain
    w = model.pi[1].weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 2.0 * np.eye(w.shape[0]), atol=1e-5)
    assert torch.all(model.pi[0].bias == 0)


def test_cnn_family_not_ported():
    """The CNN family builds, but not on the policy kernels: K2/K3 (and K4)
    take plain MLPs, as the JAX package's do, so a CNN's passes are the
    model's own (``tests/test_torch_cnn.py``)."""
    from hex_gym_env_tpu_torch.models.cnn import CnnPolicy
    from hex_gym_env_tpu_torch.utils.config import SelfplayConfig

    model = make_policy("CNN", 25)
    assert isinstance(model, CnnPolicy) and not policy_kernel.supported(model)
    assert policy_kernel.resolve_policy_ops(model, SelfplayConfig(board_size=5)) is None
    with pytest.raises(ValueError, match="MlpPolicy"):
        policy_kernel.resolve_policy_ops(model, SelfplayConfig(board_size=5, policy_impl="pallas"))


def _expected_sample(masked_logits, bits):
    ub = (np.asarray(bits) >> 8).astype(np.float32)
    u = ub * np.float32(2.0**-24) + np.float32(2.0**-25)
    g = -np.log(-np.log(u))
    return np.argmax(np.asarray(masked_logits) + g, axis=1).astype(np.int32)


def test_masked_ops_match_jax():
    rng = np.random.default_rng(0)
    B, A = 32, 25
    logits = rng.normal(size=(B, A)).astype(np.float32) * 3
    legal = rng.random((B, A)) > 0.4
    legal[:, 0] = True
    legal[3] = False
    legal[3, 7] = True  # a single legal action
    actions = np.array([rng.choice(np.flatnonzero(r)) for r in legal], np.int32)
    jl, jm = jnp.asarray(logits), jnp.asarray(legal)
    tl, tm = torch.from_numpy(logits), torch.from_numpy(legal)

    np.testing.assert_array_equal(
        masked.mask_logits(tl, tm).numpy(), np.asarray(jax_masked.mask_logits(jl, jm)))
    np.testing.assert_array_equal(masked.mode(tl, tm).numpy(), np.asarray(jax_masked.mode(jl, jm)))
    np.testing.assert_allclose(
        masked.log_prob(tl, tm, torch.from_numpy(actions)).numpy(),
        np.asarray(jax_masked.log_prob(jl, jm, jnp.asarray(actions))), atol=ATOL)
    ent = masked.entropy(tl, tm)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jax_masked.entropy(jl, jm)), atol=ATOL)
    assert float(ent[3]) == 0.0  # masked terms contribute exactly zero
    np.testing.assert_allclose(
        masked.probs(tl, tm).numpy(), np.asarray(jax_masked.probs(jl, jm)), atol=ATOL)

    bits = np.asarray(jax.random.bits(jax.random.key(5), (B, A), jnp.uint32))
    tb = masked.bits_from_numpy(bits)
    expected = _expected_sample(np.asarray(jax_masked.mask_logits(jl, jm)), bits)
    np.testing.assert_array_equal(masked.sample(tb, tl, tm).numpy(), expected)
    info = masked.sample_with_info(tb, tl, tm)
    np.testing.assert_array_equal(info.action.numpy(), expected)
    np.testing.assert_allclose(
        info.log_prob.numpy(),
        np.asarray(jax_masked.log_prob(jl, jm, jnp.asarray(expected))), atol=ATOL)
    assert legal[np.arange(B), expected].all()


def test_draw_bits_are_uniform_words():
    g = torch.Generator().manual_seed(0)
    bits = masked.draw_bits(g, (4096,), "cpu")
    assert bits.dtype == torch.int32
    u = masked.unit_uniform(bits)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("n,family", [(5, "MLP-default"), (5, "MLP-deep"), (5, "MLP-wide-deep"),
                                      (13, "MLP-default")])
def test_agent_twin_matches_pallas_agent_kernel(n, family):
    """13x13 (169 actions, 256 lanes) is a board the scan path takes where
    the fused rollout refuses."""
    B = 32
    model = jax_make_policy(family, n * n)
    variables = _wide_logits(model.init(jax.random.key(0), jnp.zeros((1, n, n), jnp.float32)))
    obs, legal = _random_positions(n, B, seed=11)
    key = jax.random.key(7)
    jpol = JaxPolicyOps(model, interpret=True)
    res = jpol.agent_act(jpol.pack_agent(variables["params"]), jnp.asarray(obs),
                         jnp.asarray(legal), key)
    bits = masked.bits_from_numpy(np.asarray(jax.random.bits(key, (B, n * n), jnp.uint32)))

    tmodel = flax_to_torch(_np_tree(variables), ACT[family])
    pol = policy_kernel.PolicyOps(tmodel)
    got = pol.agent_act(pol.agent_operand(tmodel.state_dict()), torch.from_numpy(obs),
                        torch.from_numpy(legal), bits=bits)
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(res.action))
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(res.log_prob), atol=ATOL)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(res.value), atol=ATOL)
    np.testing.assert_allclose(got.masked_logits.numpy(), np.asarray(res.masked_logits), atol=ATOL)


@pytest.mark.parametrize("n,family", [(5, "MLP-default"), (5, "MLP-deep"), (13, "MLP-default")])
def test_bank_twin_matches_pallas_bank_kernel(n, family):
    """13x13 (169 actions, 256 lanes) is a board the scan path takes where
    the fused rollout refuses; the JAX bank kernel runs it in interpret
    mode."""
    B, P = 32, 4
    model = jax_make_policy(family, n * n)
    template = model.init(jax.random.key(0), jnp.zeros((1, n, n), jnp.float32))["params"]
    bank = jax_init_bank(template, P)
    leaves, treedef = jax.tree.flatten(bank.params)
    keys = jax.random.split(jax.random.key(3), len(leaves))
    bank = bank.replace(
        params=jax.tree.unflatten(
            treedef, [jax.random.normal(k, x.shape) * 0.3 for k, x in zip(keys, leaves)]),
        best_params=jax.tree.map(
            lambda x: jax.random.normal(jax.random.key(4), x.shape) * 0.3, template),
    )
    obs, legal = _random_positions(n, B, seed=12)
    use_best = np.arange(B) % 3 == 0
    opp_idx = (np.arange(B) % P).astype(np.int32)
    key = jax.random.key(11)
    jpol = JaxPolicyOps(model, interpret=True)
    ja, jmasked = jpol.bank_act(jpol.stack_bank(bank), jnp.asarray(use_best),
                                jnp.asarray(opp_idx), jnp.asarray(obs), jnp.asarray(legal), key)
    bits = masked.bits_from_numpy(np.asarray(jax.random.bits(key, (B, n * n), jnp.uint32)))

    tbank = OpponentBank(
        params=flax_state_dict(_np_tree(bank.params)),
        scores=torch.zeros(P),
        best_params=flax_state_dict(_np_tree(bank.best_params)),
        best_score=torch.zeros(()),
    )
    pol = policy_kernel.PolicyOps(make_policy(family, n * n))
    stacked = pol.stack_bank(tbank)
    assert stacked.shape[0] == P + 1
    ta, tmasked = pol.bank_act(pol.bank_operand(tbank), torch.from_numpy(use_best),
                               torch.from_numpy(opp_idx),
                               torch.from_numpy(obs), torch.from_numpy(legal), bits=bits)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tmasked.numpy(), np.asarray(jmasked), atol=ATOL)


def test_policy_gate():
    from hex_gym_env_tpu_torch.utils.config import SelfplayConfig

    mlp = make_policy("MLP-default", 25)
    assert policy_kernel.resolve_policy_ops(mlp, SelfplayConfig(policy_impl="lax")) is None
    assert policy_kernel.resolve_policy_ops(mlp, SelfplayConfig()).impl == "auto"
    assert policy_kernel.resolve_policy_ops(mlp, SelfplayConfig(policy_impl="pallas")).impl == "pallas"
    with pytest.raises(ValueError):
        policy_kernel.resolve_policy_ops(mlp, SelfplayConfig(policy_impl="LAX"))


def _np_bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32: the bit
    rule of XLA's and torch's casts, written out."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# bf16 logits of the twin against numpy: the same bf16 values summed in
# float32 in another order agree to 1e-5.  A hidden unit whose tanh lands one
# float32 ulp apart in the two libraries can round to neighbouring bf16
# values (one bf16 ulp, 2^-8 relative, of a unit below 1), which moves its
# row's logits by about that ulp times the weights after it: such entries
# must stay rare (1%), and none may move by more than one bf16 ulp (2^-8) of
# the largest logit, the bound chip_smoke.py holds the card's K4 to.
BF16_REL = 2.0**-8


@pytest.mark.parametrize("family", ["MLP-default", "MLP-deep"])
def test_bf16_bank_logits_match_numpy_cast_rule(family):
    """``bank_logits_twin(..., bf16=True)`` is JAX's ``bank_bf16`` rule
    (ops/pallas_rollout.py): members' weights and biases cast to bf16, each
    dot's left-hand side cast to bf16, float32 sums, the bias after the dot;
    the first-move table stays the float32 forward."""
    n, B, P1 = 5, 64, 5
    rng = np.random.default_rng(3)
    model = make_policy(family, n * n)
    pol = policy_kernel.PolicyOps(model)
    d = pol.dims
    stacked = rng.normal(size=(P1, policy_kernel.tower_size(d, d.A))).astype(np.float32) * 0.3
    obs = rng.integers(-1, 2, size=(B, d.F)).astype(np.int8)
    idx = rng.integers(0, P1, size=B).astype(np.int32)

    act = np.tanh if ACT[family] == "tanh" else (lambda v: np.maximum(v, np.float32(0)))
    views = policy_kernel.tower_views(torch.from_numpy(_np_bf16(stacked)), d, d.A)
    want = np.empty((B, d.A), np.float32)
    for r in range(B):
        h = obs[r].astype(np.float32)
        for li, (W, b) in enumerate(views):
            z = _np_bf16(h) @ W[idx[r]].numpy() + b[idx[r]].numpy()
            h = act(z).astype(np.float32) if li < len(views) - 1 else z
        want[r] = h
    t_stacked, t_obs, t_idx = (torch.from_numpy(x) for x in (stacked, obs, idx))
    got = policy_kernel.bank_logits_twin(t_stacked, d, t_obs, t_idx, bf16=True).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= BF16_REL * np.abs(want).max() and np.mean(diff > ATOL) <= 0.01
    f32 = policy_kernel.bank_logits_twin(t_stacked, d, t_obs, t_idx).numpy()
    assert np.abs(f32 - want).max() > 10 * ATOL  # the mode does round

    from hex_gym_env_tpu_torch.ops import rollout_kernel

    zeros = torch.zeros((P1, d.F))
    table = rollout_kernel.first_move_table(t_stacked, d)
    assert torch.equal(table, policy_kernel.bank_logits_twin(t_stacked, d, zeros, torch.arange(P1)))


@pytest.mark.parametrize("n,family", [(7, "MLP-default"), (13, "MLP-default"), (5, "MLP-wide-deep")])
def test_bank_image_layout(n, family):
    """K3's bank image (the layout of csrc/hex_common.cuh team_mlp_towers):
    per layer, n_out rows of n_in weights at a stride of a multiple of 4
    floats whose quarter is odd, pads zero, then the biases padded to 4."""
    pk = policy_kernel
    g = torch.Generator().manual_seed(0)
    pol = pk.PolicyOps(make_policy(family, n * n, generator=g))
    d, P1 = pol.dims, 3
    stacked = torch.randn((P1, pk.tower_size(d, d.A)), generator=g)
    image = pk.bank_image_twin(stacked, d)
    assert image.shape == (P1, pk.ttower_size(d, d.A)) and image.dtype == torch.float32
    views = pk.tower_views(stacked, d, d.A)
    off = 0
    for W, b in views:
        n_in, n_out = W.shape[-2:]
        S = pk.row_stride(n_in)
        assert S % 4 == 0 and (S // 4) % 2 == 1 and n_in <= S < n_in + 8
        rows = image[:, off : off + n_out * S].reshape(P1, n_out, S)
        assert torch.equal(rows[:, :, :n_in], W.transpose(1, 2))
        assert not rows[:, :, n_in:].any()
        off += n_out * S
        bias = image[:, off : off + pk.round4(n_out)]
        assert torch.equal(bias[:, :n_out], b) and not bias[:, n_out:].any()
        off += pk.round4(n_out)
    assert off == image.shape[1] == sum(pk.tlayer_size(*W.shape[-2:]) for W, _ in views)
    assert pk.bank_operand(stacked, d).image is None  # on the CPU the twin reads stacked


def test_bank_pass_use_best_and_image_rule():
    """``use_best`` picks the best (P1 - 1) as the twin's ``torch.where``
    did; the kernel path refuses to run without the bank image."""
    pk = policy_kernel
    n, B, P1 = 4, 16, 4
    g = torch.Generator().manual_seed(2)
    pol = pk.PolicyOps(make_policy("MLP-default", n * n, generator=g))
    d = pol.dims
    stacked = torch.randn((P1, pk.tower_size(d, d.A)), generator=g) * 0.3
    obs = torch.randint(-1, 2, (B, d.F), generator=g).to(torch.int8)
    legal = obs == 0
    use_best = torch.arange(B) % 3 == 0
    opp_idx = torch.arange(B, dtype=torch.int32) % (P1 - 1)
    bits = masked.draw_bits(g, (B, d.A), "cpu")
    a, m = pol.bank_act(pk.bank_operand(stacked, d), use_best, opp_idx, obs, legal, bits=bits)
    member = torch.where(use_best, P1 - 1, opp_idx)
    a2, m2 = pk.bank_forward_sample(pk.BankOperand(stacked), d, obs, legal, member, bits)
    assert torch.equal(a, a2) and torch.equal(m, m2)
    with pytest.raises(ValueError, match="CUDA"):
        pk.bank_image_cuda(stacked, d)


def _np_tower_image(tower, n_in0, H, n_layers, out):
    """A packed tower (in, out kernels, then biases, layer by layer) as its
    image, in numpy: per layer the transposed kernel, each row padded with
    zeros to a multiple of 4 floats whose quarter is odd, then the biases
    padded with zeros to a multiple of 4."""
    parts, off, n_in = [], 0, n_in0
    for n_out in [H] * n_layers + [out]:
        W = tower[off : off + n_in * n_out].reshape(n_in, n_out)
        off += n_in * n_out
        stride = -(-n_in // 4) * 4
        stride += 4 if (stride // 4) % 2 == 0 else 0
        rows = np.zeros((n_out, stride), np.float32)
        rows[:, :n_in] = W.T
        bias = np.zeros(-(-n_out // 4) * 4, np.float32)
        bias[:n_out] = tower[off : off + n_out]
        off += n_out
        parts += [rows.ravel(), bias]
        n_in = n_out
    assert off == tower.size
    return np.concatenate(parts)


@pytest.mark.parametrize("n,family", [(7, "MLP-default"), (13, "MLP-default"), (9, "MLP-wide-deep")])
def test_agent_image_layout(n, family):
    """K2's agent image: the pi tower's image (action head last), then the vf
    tower's (value head last), each in the layout of csrc/hex_common.cuh
    team_mlp_towers, against a numpy transpose-and-pad of the packed towers."""
    pk = policy_kernel
    g = torch.Generator().manual_seed(1)
    model = make_policy(family, n * n, generator=g)
    pol = pk.PolicyOps(model)
    d = pol.dims
    packed = pol.pack_agent({k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()})
    image = pk.agent_image_twin(packed, d)
    assert image.dtype == torch.float32
    assert image.shape == (pk.ttower_size(d, d.A) + pk.ttower_size(d, 1),)
    split = pk.tower_size(d, d.A)
    want = np.concatenate([
        _np_tower_image(packed[:split].numpy(), d.F, d.H, d.n_layers, d.A),
        _np_tower_image(packed[split:].numpy(), d.F, d.H, d.n_layers, 1)])
    np.testing.assert_array_equal(image.numpy(), want)
    assert pol.agent_operand(model.state_dict()).image is None  # on the CPU the twin reads packed


def test_agent_pass_operand_rule(monkeypatch):
    """The twin path builds no image and reads the packing; "pallas" on a
    CPU tensor raises; the kernel path refuses an operand without its image."""
    from hex_gym_env_tpu_torch.ops import cuda_lib

    pk = policy_kernel
    n, B = 4, 16
    g = torch.Generator().manual_seed(3)
    model = make_policy("MLP-default", n * n, generator=g)
    params = model.state_dict()
    pol = pk.PolicyOps(model)
    d = pol.dims
    obs = torch.randint(-1, 2, (B, d.F), generator=g).to(torch.int8)
    legal = obs == 0
    bits = masked.draw_bits(g, (B, d.A), "cpu")
    cuda_lib.reset_launches()
    for impl in ("auto", "lax"):
        op = pk.PolicyOps(model, impl).agent_operand(params)
        assert op.image is None and torch.equal(op.packed, pol.pack_agent(params))
        got = pk.PolicyOps(model, impl).agent_act(op, obs, legal, bits=bits)
        want = pk.agent_forward_sample_twin(op.packed, d, obs, legal, bits)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert cuda_lib.launches["k2_agent_image"] == 0 and cuda_lib.launches["k2_agent"] == 0
    with pytest.raises(ValueError, match="pallas"):
        pk.PolicyOps(model, "pallas").agent_operand(params)
    with pytest.raises(ValueError, match="CUDA"):
        pk.agent_image_cuda(pol.pack_agent(params), d)
    monkeypatch.setattr(pk, "use_kernel", lambda t, impl: True)
    with pytest.raises(ValueError, match="agent image"):
        pk.agent_forward_sample(pk.AgentOperand(pol.pack_agent(params)), d, obs, legal, bits)
