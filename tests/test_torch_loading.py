"""The port's policy loading against the JAX package's: the SB3 import, the
``random``, ``orbax:`` and ``params:`` specs, and the committed ``params:``
copies of the repo's trained agents; the loader's bare template
(``models.policy_template``) against the initialised ``make_policy``, alone
and in recorded matches."""

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

from hex_gym_env_tpu_torch.models import cnn, loading, make_policy, sb3_import
from hex_gym_env_tpu_torch.models.convert import flax_state_dict
from hex_gym_env_tpu_torch.models.mlp import Bare
from hex_gym_env_tpu_torch.scripts import match
from hex_gym_env_tpu_torch.utils import profiling
from hex_gym_env_tpu_torch.utils.checkpoint import save_params

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


# ---------------------------------------------------------------------------
# the loader's bare template
# ---------------------------------------------------------------------------

FAMILY_WIDTHS = {"MLP-default": (64, 64), "MLP-deep": (64,) * 4, "MLP-wide-deep": (128,) * 4,
                 "CNN": (128, 128)}


def _agent(family, n, seed):
    """An initialised module's state dict with every tensor moved off its
    init (BatchNorm's variances kept positive): a ``params:`` agent."""
    g = torch.Generator().manual_seed(seed)
    sd = make_policy(family, n * n, generator=g).state_dict()
    out = {}
    for k, v in sd.items():
        w = v + 0.3 * torch.randn(v.shape, generator=g)
        out[k] = w.abs() + 0.5 if k.endswith("bn.var") else w
    return out


def _params_file(tmp_path, family, n, seed=0):
    sd = _agent(family, n, seed)
    path = str(tmp_path / f"{family}_{n}_{seed}.pt")
    save_params(path, sd)
    return f"params:{path}", sd


def _sb3_state(path):
    """The SB3 zip's ``policy.pth`` under the port's names, read straight
    from the zip."""
    with zipfile.ZipFile(path) as z:
        raw = torch.load(io.BytesIO(z.read("policy.pth")), weights_only=True)
    names = {"action_net": "action_head", "value_net": "value_head"}
    out = {}
    for k, v in raw.items():
        prefix, _, leaf = k.rpartition(".")
        if prefix.startswith("mlp_extractor."):
            _, tower, idx = prefix.split(".")
            prefix = f"{'pi' if tower == 'policy_net' else 'vf'}.{int(idx) // 2}"
        out[f"{names.get(prefix, prefix)}.{leaf}"] = v
    return out


LOADS = [(f, n, kind) for f in ("MLP-default", "CNN") for n in (7, 9)
         for kind in ("params", "random")] + [("MLP-default", n, "sb3") for n in (7, 9)]


@pytest.mark.parametrize("family, n, kind", LOADS)
def test_load_gives_the_files_tensors_bit_for_bit(tmp_path, family, n, kind):
    """Whatever the template's values, the loaded state dict is the file's
    tensors (``random``: zeros of the initialised module's shapes), in keys,
    shapes, dtypes and bits."""
    shapes = make_policy(family, n * n).state_dict()
    if kind == "params":
        spec, want = _params_file(tmp_path, family, n, seed=n)
    elif kind == "sb3":
        spec = f"sb3:{_sb3_zip(tmp_path, n, seed=n)}"
        want = _sb3_state(spec[4:])
    else:
        spec, want = "random", {k: torch.zeros_like(v) for k, v in shapes.items()}
    model, params = loading.load_policy_params(spec, n, family=family, device="cpu")
    assert sorted(params) == sorted(want) == sorted(shapes)
    for k, v in params.items():
        assert v.dtype == want[k].dtype == shapes[k].dtype == torch.float32, k
        assert v.shape == want[k].shape == shapes[k].shape and v.device.type == "cpu", k
        assert torch.equal(v, want[k]), k
    assert sorted(model.state_dict()) == sorted(shapes)


@pytest.mark.parametrize("family", ["MLP-default", "CNN"])
def test_a_load_counts_no_init_and_reads_no_generator(tmp_path, family):
    """A load builds its template with no initialisation: no
    ``policy_inits``, and torch's default generator as it was; the
    initialised ``make_policy`` counts one and draws from it."""
    spec, _ = _params_file(tmp_path, family, 7)
    profiling.take_counters()
    state = torch.random.get_rng_state()
    for s in (spec, "random"):
        loading.load_policy_params(s, 7, family=family, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    assert profiling.take_counters() == {"policy_loads": 2}
    make_policy(family, 49, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(torch.random.get_rng_state(), state)
    assert profiling.take_counters() == {"policy_inits": 1}


@pytest.mark.parametrize("family", ["MLP-default", "CNN"])
def test_two_loads_give_distinct_modules(tmp_path, family):
    spec, _ = _params_file(tmp_path, family, 7)
    (m1, p1), (m2, p2) = (loading.load_policy_params(spec, 7, family=family, device="cpu")
                          for _ in range(2))
    assert m1 is not m2
    assert not any(a is b for a, b in zip(m1.parameters(), m2.parameters()))
    fired = []
    m1.register_forward_hook(lambda *_: fired.append(1))
    m2.bind(p2)
    with torch.no_grad():
        m2(torch.zeros(2, 7, 7))
    assert fired == []
    m1.bind(p1)
    with torch.no_grad():
        m1(torch.zeros(2, 7, 7))
    assert fired == [1]


@pytest.mark.parametrize("family", ["MLP-default", "MLP-deep", "CNN"])
def test_an_unbound_template_plays_as_random(tmp_path, family):
    """The template holds defined values, never uninitialised memory:
    before ``bind`` its forward gives finite logits, the ``random``
    spec's zeros."""
    spec, _ = _params_file(tmp_path, family, 5)
    model, _ = loading.load_policy_params(spec, 5, family=family, device="cpu")
    obs = torch.from_numpy(_positions(5, 8, seed=2))
    with torch.no_grad():
        logits, value = model(obs)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(value).all())
    assert bool((logits == 0).all())


def test_a_spec_of_the_wrong_shape_raises(tmp_path):
    spec, _ = _params_file(tmp_path, "CNN", 9)
    with pytest.raises(ValueError, match="does not fit"):
        loading.load_policy_params(spec, 7, family="CNN", device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        loading.load_policy_params(spec, 9, family="MLP-default", device="cpu")
    mlp_spec, _ = _params_file(tmp_path, "MLP-default", 9)
    with pytest.raises(ValueError, match="does not fit"):
        loading.load_policy_params(mlp_spec, 9, family="CNN", device="cpu")


def _initialised_layer_by_layer(family, n_actions, generator) -> dict:
    """The state dict of the initialised path written out layer by layer:
    each layer a plain ``nn.Linear`` or ``nn.Conv2d`` (their own draws from
    torch's default generator), in the modules' order, its weight
    orthogonal from ``generator``, its bias zero; BatchNorm's ones and
    zeros."""
    sd = {}

    def layer(name, module, gain):
        torch.nn.init.orthogonal_(module.weight, gain=gain, generator=generator)
        sd[f"{name}.weight"] = module.weight.detach()
        sd[f"{name}.bias"] = torch.zeros_like(module.bias)

    hidden = 2.0**0.5
    widths = FAMILY_WIDTHS[family]
    features = n_actions
    if family == "CNN":
        cin = 1
        for name in cnn.CONV_LAYERS:
            layer(f"{name}.conv", torch.nn.Conv2d(cin, 64, 3, padding=1), hidden)
            sd.update({f"{name}.bn.scale": torch.ones(64), f"{name}.bn.bias": torch.zeros(64),
                       f"{name}.bn.mean": torch.zeros(64), f"{name}.bn.var": torch.ones(64)})
            cin = 64
        layer("features", torch.nn.Linear(n_actions * 64, 128), hidden)
        features = 128
    for tower in ("pi", "vf"):
        dims = (features,) + widths
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            layer(f"{tower}.{i}", torch.nn.Linear(a, b), hidden)
    layer("action_head", torch.nn.Linear(widths[-1], n_actions), 0.01)
    layer("value_head", torch.nn.Linear(widths[-1], 1), 1.0)
    return sd


@pytest.mark.parametrize("family", list(FAMILY_WIDTHS))
def test_make_policy_initialises_layer_by_layer(family):
    """``make_policy(family, n, generator)`` still gives the state dict the
    seeded tests expect, bit for bit, and leaves both generators where the
    layer-by-layer construction leaves them."""
    A = 49
    torch.manual_seed(1234)
    got = make_policy(family, A, generator=torch.Generator().manual_seed(0))
    got_state = torch.random.get_rng_state()
    torch.manual_seed(1234)
    g = torch.Generator().manual_seed(0)
    want = _initialised_layer_by_layer(family, A, g)
    assert torch.equal(torch.random.get_rng_state(), got_state)
    sd = got.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k]) for k in want)
    again = make_policy(family, A, generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not any(isinstance(m, Bare) for m in got.modules())


def _recorded_match(monkeypatch, n, games, specs, family, mode, initialised):
    """One recorded match of ``specs`` through ``run_match``: its result,
    actions, winners and every forward's logits by side.  ``initialised``
    hands the loader each side's module built by ``make_policy`` (its
    weights initialised) in place of the bare template."""
    inner, taps = match.load_policy_params, []

    def load(spec, board_size, model=None, **kwargs):
        if initialised:
            model = make_policy(kwargs["family"], board_size * board_size,
                                generator=torch.Generator().manual_seed(len(taps)))
        model, params = inner(spec, board_size, model, **kwargs)
        kept = []
        taps.append(kept)
        model.register_forward_hook(lambda module, inputs, out: kept.append(out[0].clone()))
        return model, params

    monkeypatch.setattr(match, "load_policy_params", load)
    rec = {}
    out = match.run_match(n, games, *specs, seed=5, mode=mode, family_a=family,
                          family_b=family, device="cpu", record=rec)
    monkeypatch.setattr(match, "load_policy_params", inner)
    return out, rec, taps


@pytest.mark.parametrize("family, n", [("CNN", 9), ("MLP-default", 7)])
@pytest.mark.parametrize("mode", ["a-det", "stochastic"])
def test_a_match_on_bare_templates_plays_as_on_initialised_modules(tmp_path, monkeypatch,
                                                                   family, n, mode):
    """Two ``params:`` agents, each side's module the loader's bare
    template or an initialised ``make_policy`` module bound alike: the same
    result, actions, winners and tapped logits, bit for bit."""
    specs = [_params_file(tmp_path, family, n, seed)[0] for seed in (1, 2)]
    games = 8
    bare = _recorded_match(monkeypatch, n, games, specs, family, mode, initialised=False)
    init = _recorded_match(monkeypatch, n, games, specs, family, mode, initialised=True)
    assert bare[0] == init[0]
    assert torch.equal(bare[1]["actions"], init[1]["actions"])
    assert torch.equal(bare[1]["winners"], init[1]["winners"])
    assert len(bare[2]) == len(init[2]) == 2
    for side_bare, side_init in zip(bare[2], init[2]):
        assert len(side_bare) == len(side_init) == n * n + 1
        assert all(torch.equal(a, b) for a, b in zip(side_bare, side_init))
    # the agents' logits differ: the match plays its weights, not the template's
    assert not torch.equal(bare[2][0][0], bare[2][1][0])
