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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_policy("CNN", 25)


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


@pytest.mark.parametrize("family", ["MLP-default", "MLP-deep"])
def test_agent_twin_matches_pallas_agent_kernel(family):
    n, B = 5, 32
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
    got = pol.agent_act(pol.pack_agent(tmodel.state_dict()), torch.from_numpy(obs),
                        torch.from_numpy(legal), bits=bits)
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(res.action))
    np.testing.assert_allclose(got.log_prob.numpy(), np.asarray(res.log_prob), atol=ATOL)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(res.value), atol=ATOL)
    np.testing.assert_allclose(got.masked_logits.numpy(), np.asarray(res.masked_logits), atol=ATOL)


@pytest.mark.parametrize("family", ["MLP-default", "MLP-deep"])
def test_bank_twin_matches_pallas_bank_kernel(family):
    n, B, P = 5, 32, 4
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
    ta, tmasked = pol.bank_act(stacked, torch.from_numpy(use_best), torch.from_numpy(opp_idx),
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
