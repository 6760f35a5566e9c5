"""The match's policy forward (``ops/mlp_forward``) on the CPU: its twin
against ``MlpPolicy``'s plain forward for every MLP family at boards 5 to
11, the image's layout, the rule by which a module takes the kernel, and
``run_match``'s forwards as a hook and the counters see them.  The kernel
itself runs on the card only (``chip_smoke.py``, ``scripts.selftest``)."""

import pytest
import torch

from benchmark import harness
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.loading import agent_path
from hex_gym_env_tpu_torch.ops import mlp_forward, policy_kernel
from hex_gym_env_tpu_torch.scripts import match
from hex_gym_env_tpu_torch.utils import profiling

ATOL = 1e-5  # float32 sums taken in another order (as tests/test_torch_policy.py)
FAMILIES = ("MLP-default", "MLP-deep", "MLP-wide-deep")


@pytest.fixture(autouse=True)
def _clean():
    profiling.take_counters()
    yield
    profiling.take_counters()


def _model(family, n, seed=0):
    """A family's module at board n, its action head widened to O(1)
    logits (the orthogonal init's gain 0.01 gives near-equal ones), and
    its state dict."""
    model = make_policy(family, n * n, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.action_head.weight.mul_(100.0)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _boards(n, B, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 2, (B, n, n), generator=g).to(torch.float32)


def _bind_cpu(model, params):
    """What ``bind`` does on the card, with the twin's image on the CPU."""
    mlp_forward.assign(model, params)
    d = policy_kernel.mlp_dims(model)
    model.bound_forward = mlp_forward.BoundForward(model, mlp_forward.image_twin(params, d))


@pytest.mark.parametrize("n", [5, 7, 9, 11])
@pytest.mark.parametrize("family", FAMILIES)
def test_twin_computes_the_plain_forward(family, n):
    model, params = _model(family, n, seed=n)
    d = policy_kernel.mlp_dims(model)
    x = _boards(n, 64, seed=n)
    with torch.no_grad():
        want_l, want_v = model(x)
        got_l, got_v = mlp_forward.forward(mlp_forward.image_twin(params, d), d,
                                           x.reshape(64, -1))
    assert got_l.shape == (64, n * n) and got_v.shape == (64,)
    assert float(want_l.abs().max()) > 0.5  # the widened head gives O(1) logits
    torch.testing.assert_close(got_l, want_l, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_v, want_v, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,family", [(7, "MLP-default"), (11, "MLP-default"), (5, "MLP-deep"),
                                      (9, "MLP-wide-deep")])
def test_image_layout_round_trips(n, family):
    model, params = _model(family, n)
    d = policy_kernel.mlp_dims(model)
    image = mlp_forward.image_twin(params, d)
    assert image.shape == (mlp_forward.image_floats(d),)
    views = mlp_forward.image_views(image, d)
    assert sorted(f"{k}.{p}" for k in views for p in ("weight", "bias")) == sorted(params)
    for name, (w, b) in views.items():
        assert torch.equal(w, params[f"{name}.weight"]) and torch.equal(b, params[f"{name}.bias"])
    # K2's agent image from the packing: the same floats, pads included
    packed = policy_kernel.PolicyOps(model).pack_agent(params)
    assert torch.equal(image, policy_kernel.agent_image_twin(packed, d))
    # every pad is zero: the image holds the parameters' floats and nothing else
    assert int((image != 0).sum()) == sum(int((v != 0).sum()) for v in params.values())
    # weights held as transposed views (as a params: file may hold them) give the same image
    strided = {k: v.t().contiguous().t() if v.dim() == 2 else v for k, v in params.items()}
    assert not strided["pi.0.weight"].is_contiguous()
    assert torch.equal(mlp_forward.image_twin(strided, d), image)


def test_a_current_image_takes_the_twin_and_its_rule():
    model, params = _model("MLP-default", 7)
    x = _boards(7, 32, seed=1)
    with torch.no_grad():
        plain = model(x)
    _bind_cpu(model, params)
    bound = model.bound_forward
    assert bound.current() and all(
        getattr(model.get_submodule(k.rsplit(".", 1)[0]), k.rsplit(".", 1)[1]).data_ptr()
        == v.data_ptr() for k, v in params.items())  # bound with no copy
    with torch.no_grad():
        assert bound.takes(x)
        got = model(x)
        twin = mlp_forward.forward_twin(bound.image, bound.dims, x.reshape(32, -1))
    assert all(torch.equal(g, t) for g, t in zip(got, twin))
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    assert not bound.takes(x)  # grad enabled here
    with torch.no_grad():
        assert not bound.takes(x.double()) and not bound.takes(x.to(torch.int8))


def _plain(model, x):
    """The plain path's output of ``model`` as it stands (no bound forward)."""
    bound, model.bound_forward = model.bound_forward, None
    try:
        with torch.no_grad():
            return model(x)
    finally:
        model.bound_forward = bound


@pytest.mark.parametrize("case", ["unbound", "grad", "in_place", "replaced", "moved"])
def test_the_plain_path_whenever_the_rule_fails(case):
    model, params = _model("MLP-deep", 5)
    x = _boards(5, 16, seed=2)
    if case != "unbound":
        _bind_cpu(model, params)
    if case == "in_place":
        with torch.no_grad():
            model.action_head.bias.add_(0.5)  # after binding: the image is stale
    elif case == "replaced":
        model.pi[1].weight = torch.nn.Parameter(model.pi[1].weight.detach() * 2.0)
    elif case == "moved":
        model.to(torch.float64)
        model.to(torch.float32)
    if model.bound_forward is not None:
        assert not model.bound_forward.current() or case == "grad"
    want = _plain(model, x)
    if case == "grad":
        got = model(x)
    else:
        with torch.no_grad():
            got = model(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if case == "in_place":  # and the plain path reads the new bias
        image_out = mlp_forward.forward_twin(model.bound_forward.image, model.bound_forward.dims,
                                             x.reshape(16, -1))
        assert float((got[0] - image_out[0]).abs().min()) > 0.4


def test_assign_is_load_state_dict_with_assign():
    model, params = _model("MLP-wide-deep", 5)
    other, _ = _model("MLP-wide-deep", 5, seed=1)
    twin, _ = _model("MLP-wide-deep", 5, seed=1)
    mlp_forward.assign(other, params)
    twin.load_state_dict(params, assign=True)
    for (k, p), (k2, q) in zip(other.named_parameters(), twin.named_parameters()):
        assert k == k2 and type(p) is type(q) and p.requires_grad == q.requires_grad
        assert p.data_ptr() == q.data_ptr() == params[k].data_ptr()
    with pytest.raises(ValueError, match="params name"):
        mlp_forward.assign(other, {k: v for k, v in params.items() if k != "pi.0.bias"})


def test_bind_leaves_what_the_kernel_does_not_take():
    model, params = _model("MLP-default", 5)
    before = {k: v.data_ptr() for k, v in model.state_dict().items()}
    assert not mlp_forward.bind(model, params)  # CPU parameters
    assert model.bound_forward is None
    assert {k: v.data_ptr() for k, v in model.state_dict().items()} == before
    cnn = make_policy("CNN", 25)
    assert not mlp_forward.bind(cnn, cnn.state_dict())
    uneven = type(model)(25, (64, 32), (64, 32))
    assert not mlp_forward.bind(uneven, uneven.state_dict())


@pytest.mark.parametrize("spec_b", ["random", f"params:{agent_path(5)}"])
def test_run_match_hands_the_hook_every_forward(spec_b):
    n, games = 5, 12
    taps, handles = [], []
    inner = match.load_policy_params

    def load(*args, **kwargs):
        model, params = inner(*args, **kwargs)
        kept = []
        taps.append(kept)
        handles.append(model.register_forward_hook(lambda m, i, out: kept.append(out[0])))
        return model, params

    match.load_policy_params = load
    try:
        rec = {}
        match.run_match(n, games, f"params:{agent_path(n)}", spec_b, mode="deterministic",
                        device="cpu", record=rec)
    finally:
        match.load_policy_params = inner
        for h in handles:
            h.remove()
    plies = n * n + 1
    assert len(taps) == 2 and all(len(side) == plies for side in taps)
    assert all(t.shape == (games, n * n) and t.dtype == torch.float32 for side in taps
               for t in side)
    counters = profiling.take_counters()
    assert counters["forwards"] == 2 * plies
    assert counters.get("launch.mlp_forward", 0) == 0  # the CPU keeps functional_call


def _reader():
    return harness.load_module(harness.metric_file("forward_kernel_pct.match"),
                               "test_forward_kernel_pct_match")


def test_forward_kernel_pct_reads_the_share_of_forwards_through_the_kernel(monkeypatch):
    read = _reader().read
    match_r, train_r = harness.Readings(kind="match"), harness.Readings(kind="train")
    assert read(match_r) is None  # a program that counts no forwards
    profiling.count("launch.mlp_forward", 300)
    assert read(match_r) is None
    profiling.count("forwards", 400)
    assert read(match_r) == 75.0 and read(train_r) is None
    profiling.count("launch.mlp_forward", 100)
    assert read(match_r) == 100.0
    assert profiling.counters == {"launch.mlp_forward": 400, "forwards": 400}
    monkeypatch.delattr(profiling, "counters")
    assert read(match_r) is None
