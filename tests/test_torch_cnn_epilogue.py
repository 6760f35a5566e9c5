"""The CNN forward's epilogue (``ops/cnn_epilogue``): on the CPU its twin
against the eager chain bit for bit, the wrapper's checks, the rule by which
``CnnPolicy.forward`` takes the kernel, the fused forward's wiring through
the twin, the benchmark's reader of the kernel's share and the ctypes
declaration of every C entry; on the card (the ``chip`` marker) the kernel
against its twin bit for bit, the forward with and without it, its
launches, the learner's backward beside it, and a 4,096-game 9x9 match
played the same on both paths.  The card's tests run
there with ``python -m pytest tests/test_torch_cnn_epilogue.py -m chip
--noconftest``."""

import re
import types

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness
from hex_gym_env_tpu_torch.models import cnn, make_policy
from hex_gym_env_tpu_torch.ops import cnn_epilogue, cuda_lib
from hex_gym_env_tpu_torch.scripts import match
from hex_gym_env_tpu_torch.utils import profiling

C = 64  # the CNN family's filters
# The std of the drawn BatchNorm and conv biases, as the benchmark's match
# cells draw their agents' (AGENT_BN_STD and the cell's bias_std)
BN_STD = 0.1
# A CPU conv with its bias sums it in with the products, cuDNN's path adds it
# after; the fused forward's twin adds it after, so on the CPU it differs
# from the eager forward by float32 rounding on logits of a few units.
WIRING_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    """One torch thread, and no counters before or after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_counters()
    yield
    profiling.take_counters()
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _draw_layer(layer, g, stats: str) -> None:
    """A ``ConvBnRelu``'s conv bias and BatchNorm drawn as a trained agent's
    (``stats`` "drawn"), with every other channel's ``scale`` and ``var``
    zero besides (``stats`` "zero")."""
    with torch.no_grad():
        cout = layer.conv.bias.shape[0]
        noise = torch.randn((5, cout), generator=g) * BN_STD
        layer.conv.bias.copy_(noise[0])
        layer.bn.scale.copy_(1.0 + noise[1])
        layer.bn.bias.copy_(noise[2])
        layer.bn.mean.copy_(noise[3])
        layer.bn.var.copy_(torch.exp(noise[4]))
        if stats == "zero":
            layer.bn.scale[::2] = 0.0
            layer.bn.var[::2] = 0.0


def _cnn(n: int, seed: int, device="cpu") -> cnn.CnnPolicy:
    """The CNN family's module at board n, conv biases and BatchNorm drawn,
    its action head widened to logits of a few units (gain 2, as the
    benchmark's agents)."""
    g = torch.Generator().manual_seed(seed)
    model = make_policy("CNN", n * n, generator=g)
    for name in cnn.CONV_LAYERS:
        _draw_layer(getattr(model, name), g, "drawn")
    with torch.no_grad():
        model.action_head.weight.mul_(200.0)
    return model.to(device)


def _boards(n: int, B: int, seed: int, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 2, (B, n, n), generator=g).to(device, torch.float32)


def _eager_layer(layer, y: torch.Tensor) -> torch.Tensor:
    """The eager chain after a conv without its bias: the bias add (as
    ATen's cuDNN path adds it), ``BatchNorm.forward``, ``torch.relu``."""
    out, _, _ = layer.bn(y + layer.conv.bias[:, None, None], False)
    return torch.relu(out)


def _epilogue_args(layer) -> tuple:
    bn = layer.bn
    return layer.conv.bias, bn.mean, bn.mul(bn.var), bn.bias


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The float32 tensor's bit patterns (NaN payloads and zero signs kept)."""
    return t.contiguous().view(torch.int32)


# -- the CPU -------------------------------------------------------------------------


@pytest.mark.parametrize("stats", ["drawn", "zero"])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("n", [5, 7, 9, 11])
def test_twin_is_the_eager_chain_bit_for_bit(n, B, stats):
    g = torch.Generator().manual_seed(100 * n + B)
    layer = cnn.ConvBnRelu(C, C, g)
    _draw_layer(layer, g, stats)
    x = torch.relu(torch.randn((B, C, n, n), generator=g))
    with torch.no_grad():
        y = F.conv2d(x, layer.conv.weight, None, padding=1)
        want = _eager_layer(layer, y)
        args = _epilogue_args(layer)
        if stats == "zero":
            assert float(args[2][::2].abs().max()) == 0.0
        for hwc in (False, True):
            got = cnn_epilogue.epilogue_twin(y, *args, hwc=hwc)
            assert torch.equal(got, want)
            assert torch.equal(cnn_epilogue.epilogue(y, *args, hwc=hwc), want)  # the CPU's
            assert got.permute(0, 2, 3, 1).is_contiguous() == hwc
    assert float(want.max()) > 0.5 and float(want.min()) == 0.0


def _rule_case(model, x, case: str):
    """The forward's output for ``case``, run as the case says."""
    if case == "train":
        return model(x, train=True)[:2]
    if case == "grad":
        return model(x)
    if case == "float64":
        model.double()
    with torch.no_grad():
        return model(x)


@pytest.mark.parametrize("case", ["train", "grad", "cpu", "float64"])
def test_the_rule_sends_each_case_to_the_eager_chain(case, monkeypatch):
    """What the rule observes sends the forward to the eager chain: ``train``,
    a grad-enabled call with parameters that require grad, a CPU input, a
    float64 module; no epilogue is called and none launched."""
    model = _cnn(5, seed=1)
    x = _boards(5, 6, seed=2)
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32, requires_grad=False)
    with torch.no_grad():
        assert model._fuses(card, train=False)  # the card's inference takes the kernel
    observed = {
        "train": dict(x=card, train=True),
        "grad": dict(x=card, train=False),
        "cpu": dict(x=x, train=False),
        "float64": dict(x=types.SimpleNamespace(is_cuda=True, dtype=torch.float64,
                                                requires_grad=False), train=False),
    }[case]
    assert torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())
    assert not model._fuses(**observed)
    calls = []
    monkeypatch.setattr(cnn_epilogue, "epilogue", lambda *a, **k: calls.append(a))
    logits, value = _rule_case(model, x, case)
    assert calls == [] and cuda_lib.launches["cnn_epilogue"] == 0
    assert logits.shape == (6, 25) and value.shape == (6,) and bool(torch.isfinite(logits).all())


def test_the_rule_follows_grad_mode():
    """The kernel has no backward: grad off takes it, grad on does not, even
    where nothing requires grad."""
    model = _cnn(5, seed=1).requires_grad_(False)
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32, requires_grad=False)
    with torch.no_grad():
        assert model._fuses(card, train=False)
    with torch.inference_mode():
        assert model._fuses(card, train=False)
    assert torch.is_grad_enabled() and not model._fuses(card, train=False)


@pytest.mark.parametrize("n", [5, 9])
def test_the_fused_forward_through_the_twin(n, monkeypatch):
    """The fused forward's wiring on the CPU (the rule forced, so the twin
    runs): five epilogues a forward on the conv's output without its bias,
    the last one in (H, W, C) order with the features' input a view of it,
    and the eager forward's logits and value up to the CPU conv's rounding
    of its bias."""
    model = _cnn(n, seed=n)
    x = _boards(n, 16, seed=3)
    with torch.no_grad():
        want = model(x)
    calls, feats_in = [], []
    twin = cnn_epilogue.epilogue

    def spy(y, *args, hwc=False):
        calls.append((y.shape, hwc))
        out = twin(y, *args, hwc=hwc)
        calls[-1] += (out,)
        return out

    monkeypatch.setattr(cnn_epilogue, "epilogue", spy)
    monkeypatch.setattr(cnn.CnnPolicy, "_fuses", lambda self, x, train: not train)
    model.features.register_forward_pre_hook(lambda mod, inp: feats_in.append(inp[0]))
    with torch.no_grad():
        got = model(x)
    assert [(s, h) for s, h, _ in calls] == [((16, C, n, n), False)] * 4 + [((16, C, n, n), True)]
    last = calls[-1][2]
    assert last.permute(0, 2, 3, 1).is_contiguous()
    assert feats_in[0].data_ptr() == last.data_ptr() and feats_in[0].shape == (16, n * n * C)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=WIRING_ATOL, rtol=0)
    assert float(want[0].abs().max()) > 0.5


def _refusal_inputs(case: str):
    C = {"y_channels": 12, "y_board_floats": 2}.get(case, 4)
    y = torch.randn((2, C, 3, 3))
    vec = {k: torch.randn(C) for k in ("conv_bias", "mean", "mul", "bn_bias")}
    if case == "y_unaligned":  # one float past the allocation's aligned base
        y = torch.empty(y.numel() + 1)[1:].view(y.shape).copy_(y)
    elif case == "y_strided":
        y = y.transpose(2, 3)
    elif case == "y_float64":
        y = y.double()
    elif case == "y_3d":
        y = y[0]
    elif case == "vector_shape":
        vec["mean"] = torch.randn(5)
    elif case == "vector_float64":
        vec["mul"] = vec["mul"].double()
    elif case == "vector_strided":
        vec["bn_bias"] = torch.randn(8)[::2]
    return y, vec


@pytest.mark.parametrize("case,message", [
    ("y_strided", "y must be contiguous"), ("y_float64", "y must be torch.float32"),
    ("y_3d", r"y must be \(B, C, H, W\)"), ("vector_shape", r"mean must have shape \(4,\)"),
    ("vector_float64", "mul must be torch.float32"),
    ("vector_strided", "bn_bias must be contiguous"),
    ("y_unaligned", "y must be 16-byte aligned"),
    ("y_channels", "y's channels must divide 256, got 12"),
    ("y_board_floats", "y's boards must be a multiple of 4 floats, got 2 x 3 x 3"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, message):
    y, vec = _refusal_inputs(case)
    with pytest.raises(ValueError, match=message):
        cnn_epilogue.epilogue(y, **vec)
    with pytest.raises(ValueError, match=message):
        cnn_epilogue.epilogue(y, **vec, hwc=True)


def _c_entries() -> dict:
    """Each C entry of ``csrc/*.cu`` (``int hex_...(...)``) and its number of
    parameters."""
    src = "".join((cuda_lib.CSRC / unit).read_text() for unit in cuda_lib.UNITS)
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r"^int (hex_\w+)\(([^)]*)\)", src, re.M)}


@pytest.mark.parametrize("entry", sorted(cuda_lib._ARGTYPES))
def test_each_c_entry_declares_every_argument(entry):
    """ctypes passes an argument beyond ``argtypes`` as a C int, so a
    pointer (the stream, last) left out of them is cut to 32 bits."""
    entries = _c_entries()
    assert set(entries) == set(cuda_lib._ARGTYPES)
    assert len(cuda_lib._ARGTYPES[entry]) == entries[entry]


def test_epilogue_kernel_pct_reads_the_share_of_layers_through_the_kernel(monkeypatch):
    read = harness.load_module(harness.metric_file("epilogue_kernel_pct.match"),
                               "test_epilogue_kernel_pct_match").read
    match_r, train_r = harness.Readings(kind="match"), harness.Readings(kind="train")
    assert read(match_r) is None  # a program that counts no forwards
    profiling.count("forwards", 40)
    assert read(match_r) == 0.0  # a program without the kernel
    profiling.count("launch.cnn_epilogue", 150)
    assert read(match_r) == 75.0 and read(train_r) is None
    profiling.count("launch.cnn_epilogue", 50)
    assert read(match_r) == 100.0
    monkeypatch.delattr(profiling, "counters")
    assert read(match_r) is None


# -- the card --------------------------------------------------------------------------


def _card_layer(n: int, B: int, cin: int, cout: int, stats: str, dev, seed: int):
    g = torch.Generator().manual_seed(seed)
    layer = cnn.ConvBnRelu(cin, cout, g)
    _draw_layer(layer, g, stats)
    layer = layer.to(dev)
    x = torch.relu(torch.randn((B, cin, n, n), generator=g)).to(dev)
    with torch.no_grad(), cnn.full_float32():
        y = F.conv2d(x, layer.conv.weight, None, padding=1)
    return layer, y


@pytest.mark.chip
@pytest.mark.parametrize("n,B,cin,cout,stats,shift", [
    (9, 4096, 64, 64, "drawn", 0),    # the cell's shape: the whole board a tile
    (9, 4097, 64, 64, "zero", 0),
    (5, 7, 1, 64, "drawn", 0),
    (11, 1, 64, 64, "zero", 0),
    (19, 33, 64, 64, "drawn", 0),     # a board in tiles of 94 positions
    (5, 5, 64, 32, "drawn", 0),       # 8 positions a CTA's pass over a tile
    (9, 9, 64, 64, "drawn", 4),       # y at an offset of 16 bytes
    (7, 3, 4, 256, "drawn", 0),       # a channel a thread: tiles of 23 positions
])
def test_kernel_is_its_twin_bit_for_bit(cuda_device, n, B, cin, cout, stats, shift):
    layer, y = _card_layer(n, B, cin, cout, stats, cuda_device, seed=n + B + cout)
    y.view(-1)[:: 997] = float("nan")  # relu keeps torch.relu's NaN
    y.view(-1)[1:: 1009] = -0.0

    def placed():  # a copy of y, ``shift`` floats past the allocation's base
        return torch.empty(y.numel() + shift, device=cuda_device)[shift:].view(y.shape).copy_(y)

    args = _epilogue_args(layer)
    with torch.no_grad():
        want = cnn_epilogue.epilogue_twin(y, *args)
        assert torch.equal(_bits(want), _bits(_eager_layer(layer, y)))
        hwc = cnn_epilogue.epilogue(placed(), *args, hwc=True)
        inplace = placed()
        assert inplace.data_ptr() % 16 == 0
        got = cnn_epilogue.epilogue(inplace, *args)
    torch.cuda.synchronize()
    assert got.data_ptr() == inplace.data_ptr()
    assert torch.equal(_bits(got), _bits(want))
    assert hwc.permute(0, 2, 3, 1).is_contiguous() and hwc.shape == want.shape
    assert torch.equal(_bits(hwc), _bits(want))
    assert cuda_lib.launches["cnn_epilogue"] == 2


@pytest.mark.chip
@pytest.mark.parametrize("B", [1, 7, 4096, 4097])
@pytest.mark.parametrize("n", [5, 9, 11])
def test_forward_with_and_without_the_kernel_is_bit_for_bit(cuda_device, n, B):
    """The card's inference forward through the kernel, and forced onto the
    eager chain by the grad rule, give equal logits and values; five
    launches a forward, none on the eager chain."""
    model = _cnn(n, seed=n, device=cuda_device)
    x = _boards(n, B, seed=B, device=cuda_device)
    with torch.no_grad():
        fused = model(x)
    assert cuda_lib.launches["cnn_epilogue"] == len(cnn.CONV_LAYERS)
    eager = model(x)  # grad enabled, the parameters require it
    torch.cuda.synchronize()
    assert cuda_lib.launches["cnn_epilogue"] == len(cnn.CONV_LAYERS)
    for f, e in zip(fused, eager):
        assert torch.equal(f, e.detach())
    assert float(fused[0].abs().max()) > 0.5


@pytest.mark.chip
def test_last_layer_writes_hwc_and_features_reads_a_view(cuda_device, monkeypatch):
    model = _cnn(9, seed=3, device=cuda_device)
    x = _boards(9, 256, seed=4, device=cuda_device)
    outs, feats_in = [], []
    kernel = cnn_epilogue.epilogue

    def spy(*args, **kwargs):
        outs.append(kernel(*args, **kwargs))
        return outs[-1]

    monkeypatch.setattr(cnn_epilogue, "epilogue", spy)
    model.features.register_forward_pre_hook(lambda mod, inp: feats_in.append(inp[0]))
    with torch.no_grad():
        for _ in range(3):
            model(x)
    assert cuda_lib.launches["cnn_epilogue"] == 3 * len(cnn.CONV_LAYERS)
    last = outs[len(cnn.CONV_LAYERS) - 1]
    assert last.shape == (256, C, 9, 9) and last.permute(0, 2, 3, 1).is_contiguous()
    assert all(o.is_contiguous() for o in outs[: len(cnn.CONV_LAYERS) - 1])
    assert feats_in[0].data_ptr() == last.data_ptr() and feats_in[0].is_contiguous()


@pytest.mark.chip
def test_a_train_step_still_backpropagates(cuda_device):
    model = _cnn(9, seed=5, device=cuda_device)
    x = _boards(9, 64, seed=6, device=cuda_device)
    logits, value, stats = model(x, train=True)
    (logits.square().mean() + value.square().mean()).backward()
    torch.cuda.synchronize()
    assert cuda_lib.launches["cnn_epilogue"] == 0
    for name in cnn.CONV_LAYERS:
        layer = getattr(model, name)
        for p in (layer.conv.weight, layer.bn.scale, layer.bn.bias):
            assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert float(layer.conv.weight.grad.abs().max()) > 0
        assert stats[f"{name}.bn.mean"].shape == (C,)


@pytest.mark.chip
def test_a_match_plays_the_same_on_both_paths(cuda_device, tmp_path, monkeypatch):
    """A 4,096-game 9x9 argmax match between two CNN ``params:`` agents:
    the same moves and winners with the kernel and on the eager chain (the
    rule refused), 5 launches a forward on the kernel, none on the eager."""
    specs = []
    for side, seed in (("a", 11), ("b", 12)):
        path = tmp_path / f"agent_{side}.pt"
        torch.save({k: v.cpu() for k, v in _cnn(9, seed=seed).state_dict().items()}, path)
        specs.append(f"params:{path}")

    def play():
        rec = {}
        profiling.take_counters()
        match.run_match(9, 4096, *specs, mode="deterministic", family_a="CNN", family_b="CNN",
                        device=cuda_device, record=rec)
        torch.cuda.synchronize()
        return rec, dict(profiling.counters)

    fused, fused_counts = play()
    monkeypatch.setattr(cnn.CnnPolicy, "_fuses", lambda self, x, train: False)
    eager, eager_counts = play()
    assert fused_counts["launch.cnn_epilogue"] == len(cnn.CONV_LAYERS) * fused_counts["forwards"]
    assert fused_counts["forwards"] == 2 * 82
    assert eager_counts.get("launch.cnn_epilogue", 0) == 0
    assert torch.equal(fused["actions"], eager["actions"])
    assert torch.equal(fused["winners"], eager["winners"])
    assert bool((fused["winners"] >= 0).all())
