"""The port's policy loading against the JAX package's: the SB3 import, the
``random``, ``orbax:`` and ``params:`` specs, and the committed ``params:``
copies of the repo's trained agents."""

import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.core import env as jax_env
from hex_gym_env_tpu.core.topology import get_topology
from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.models import sb3_import as jax_sb3
from hex_gym_env_tpu.models.loading import load_policy_params as jax_load

from hex_gym_env_tpu_torch.models import loading, sb3_import
from hex_gym_env_tpu_torch.models.convert import flax_state_dict

ATOL = 1e-5  # tests/test_torch_policy.py's: float32 sums in another order than XLA's
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _orbax_dir(n):
    return os.path.join(REPO, "models", f"{n}x{n}_strict_sb3", "agent_9437184")


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _sb3_zip(tmp_path, n, hidden=(64, 64), seed=0):
    """An SB3 MaskablePPO zip holding only ``policy.pth``, from a numpy state
    dict (the reference's layout: Linear weights (out, in))."""
    rng = np.random.default_rng(seed)
    sd = {}
    dims = (n * n,) + tuple(hidden)
    for tower in ("policy_net", "value_net"):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            sd[f"mlp_extractor.{tower}.{2 * i}.weight"] = rng.normal(size=(b, a))
            sd[f"mlp_extractor.{tower}.{2 * i}.bias"] = rng.normal(size=(b,))
    sd["action_net.weight"] = rng.normal(size=(n * n, hidden[-1]))
    sd["action_net.bias"] = rng.normal(size=(n * n,))
    sd["value_net.weight"] = rng.normal(size=(1, hidden[-1]))
    sd["value_net.bias"] = rng.normal(size=(1,))
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}, buf)
    path = tmp_path / "agent.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("policy.pth", buf.getvalue())
    return str(path)


def _positions(n, B, seed, n_moves=8):
    topo = get_topology(n)
    rng = np.random.default_rng(seed)
    state = jax_env.initial_state(topo, B)
    for _ in range(n_moves):
        legal = np.asarray(jax_env.legal_mask(topo, state))
        a = np.array([rng.choice(np.flatnonzero(r)) for r in legal], np.int32)
        state, _ = jax_env.step(topo, state, jnp.asarray(a))
        state = jax_env.reset_where(topo, state, state.done)
    return np.asarray(jax_env.observe(topo, state), np.float32)


@pytest.mark.parametrize("hidden", [(64, 64), (32, 32, 32)])
def test_sb3_import_matches_jax(tmp_path, hidden):
    path = _sb3_zip(tmp_path, 4, hidden)
    want = jax_sb3.sb3_to_mlp_params(path)["params"]
    got = sb3_import.sb3_to_mlp_params(path)["params"]
    assert sorted(got) == sorted(want)
    for layer in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(want[layer][leaf]))
    assert sb3_import.sb3_num_hidden_layers(path) == jax_sb3.sb3_num_hidden_layers(path)


def test_sb3_spec_matches_jax(tmp_path):
    path = _sb3_zip(tmp_path, 4, seed=3)
    _, jvars = jax_load(f"sb3:{path}", 4)
    model, params = loading.load_policy_params(f"sb3:{path}", 4, device="cpu")
    _assert_sd_equal(params, flax_state_dict(_np_tree(jvars)))
    obs = _positions(4, 16, seed=1)
    jl, jv = jax_make_policy("MLP-default", 16).apply(jvars, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = torch.func.functional_call(model, params, (torch.from_numpy(obs),))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("family", ["MLP-default", "CNN"])
def test_random_spec_is_zeros_of_jax_shapes(family):
    _, jvars = jax_load("random", 5, family=family)
    want = flax_state_dict(_np_tree(jvars))
    model, params = loading.load_policy_params("random", 5, family=family, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(bool((v == 0).all()) for v in params.values())
    with torch.no_grad():
        logits, _ = torch.func.functional_call(model, params, (torch.zeros(3, 5, 5),))
    assert bool((logits == 0).all())  # uniform over the legal moves


@pytest.mark.parametrize("n", [5, 6, 7])
def test_orbax_spec_matches_jax_bitwise(n):
    _, jvars = jax_load(f"orbax:{_orbax_dir(n)}", n)
    _, params = loading.load_policy_params(f"orbax:{_orbax_dir(n)}", n, device="cpu")
    _assert_sd_equal(params, flax_state_dict(_np_tree(jvars)))


@pytest.mark.parametrize("n", [5, 6, 7])
def test_committed_agent_copy_equals_orbax_and_plays_like_flax(n):
    """``models/agents/NxN_strict_sb3.pt`` is the orbax snapshot bit for bit,
    and its forward matches flax's on the same positions."""
    _, jvars = jax_load(f"orbax:{_orbax_dir(n)}", n)
    _, from_orbax = loading.load_policy_params(f"orbax:{_orbax_dir(n)}", n, device="cpu")
    model, params = loading.load_policy_params(f"params:{loading.agent_path(n)}", n,
                                               device="cpu")
    _assert_sd_equal(params, {k: v.numpy() for k, v in from_orbax.items()})
    obs = _positions(n, 32, seed=n)
    jl, jv = jax_make_policy("MLP-default", n * n).apply(jvars, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = torch.func.functional_call(model, params, (torch.from_numpy(obs),))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_orbax_cnn_snapshot_with_batch_stats(tmp_path):
    """A CNN snapshot of the JAX package's ``save_params`` (params and
    BatchNorm statistics) reads back whole through ``tensorstore``."""
    from hex_gym_env_tpu.utils.checkpoint import save_params

    n = 4
    jmodel = jax_make_policy("CNN", n * n)
    jvars = jmodel.init(jax.random.key(2), jnp.zeros((1, n, n), jnp.float32))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype),
                         jvars["batch_stats"])
    jvars = {"params": jvars["params"], "batch_stats": stats}
    path = str(tmp_path / "cnn")
    save_params(path, jvars)
    model, params = loading.load_policy_params(f"orbax:{path}", n, family="CNN", device="cpu")
    _assert_sd_equal(params, flax_state_dict(_np_tree(jvars)))
    assert any(k.endswith("bn.var") for k in params)


def test_params_spec_round_trip(tmp_path):
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.utils.checkpoint import save_params

    model = make_policy("MLP-deep", 16, generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "snap" / "agent.pt")
    save_params(path, model.state_dict())
    _, params = loading.load_policy_params(f"params:{path}", 4, family="MLP-deep", device="cpu")
    _assert_sd_equal(params, {k: v.numpy() for k, v in model.state_dict().items()})


def test_bad_specs_raise():
    with pytest.raises(ValueError, match="unknown policy spec"):
        loading.load_policy_params("pickle:x", 5, device="cpu")
    # the 7x7 agent does not fit a 5x5 board
    with pytest.raises(ValueError, match="does not fit"):
        loading.load_policy_params(f"params:{loading.agent_path(7)}", 5, device="cpu")
