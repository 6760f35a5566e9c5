"""The residual tower's Winograd F(4x4, 3x3) conv (``ops/winograd.py``) and
its place in ``models/resnet.ResNetPolicy``.

On the CPU: the transform matrices against the 1-D F(4, 3) identity in
float64; the plain version (``conv_twin``, through ``winograd.conv``)
against float64 ``F.conv2d`` at 256 channels on boards of 7, 9, 11 and 13
(ragged tiles) and 19, one board and several; the filter image against the
float64 transform rounded once; the rule (``winograd.takes``) and ``bind``:
no image on the CPU, in float64 or for the 1 -> 256 input conv; the CPU
forward unchanged bit for bit; the rule forced on the CPU, so the twin
stands in for the kernels; the wrapper's refusals.

On the card (the ``chip`` marker; run there with ``python -m pytest
tests/test_torch_winograd.py -m chip --noconftest``): the kernels against
float64 ``F.conv2d`` and the twin, and the AZ-ResNet forward at 19 blocks:
38 launches a forward, the logits against the eager forward's.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from hex_gym_env_tpu_torch.models import cnn
from hex_gym_env_tpu_torch.models.resnet import ResNetPolicy
from hex_gym_env_tpu_torch.ops import cuda_lib, winograd
from hex_gym_env_tpu_torch.utils import profiling

# The float32 Winograd conv against float64 F.conv2d, as a share of the
# output's RMS (``RMS_TOL``) and of its largest magnitude (``MAX_TOL``).
# The direct float32 conv reads ~1.7e-7 RMS at 256 channels (a rounding of
# 2^-24 a term over 9 x 256 products); F(4x4, 3x3)'s transforms weight the
# roundings by their entries (B^T's up to 5/2, A^T's up to 8), about ten
# times that: 1.60e-6 to 1.74e-6 RMS and at most 5.3e-6 of the largest
# output over 30 draws (boards 7 to 19, one and three boards, 256
# channels).  The limits leave 2.3 and 2.8 times the largest reading; a
# wrong transform entry or tile offset moves outputs by a share of order 1.
RMS_TOL = 4e-6
MAX_TOL = 1.5e-5
C = 256


@pytest.fixture(autouse=True)
def _clean():
    """One torch thread, and no counters before or after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_counters()
    yield
    profiling.take_counters()
    torch.set_num_threads(n)


def drawn(B: int, n: int, seed: int, channels: int = C, device="cpu"):
    """Boards of ReLU'd activations (B, channels, n, n) and a conv weight of
    He's scale, float32."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((B, channels, n, n), generator=g))
    w = torch.randn((channels, channels, 3, 3), generator=g) * (2.0 / (9 * channels)) ** 0.5
    return x.to(device), w.to(device)


def assert_near_float64(y: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> None:
    want = F.conv2d(x.double(), w.double(), padding=1)
    err = y.double() - want
    rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    worst = float(err.abs().max() / want.abs().max())
    assert rms < RMS_TOL and worst < MAX_TOL, (rms, worst)
    assert rms > 0.0  # the float32 algorithm, not a float64 one


# -- the transforms --------------------------------------------------------------------


def test_the_transforms_satisfy_the_1d_identity():
    """y_i = sum_k g_k d_{i+k} (i < 4, k < 3) is A^T [(G g) * (B^T d)]: the
    identity is bilinear, so it holds for every d and g where it holds for
    each pair of unit vectors, in float64 and exactly in fractions."""
    at, g, bt = (winograd.matrix(m) for m in (winograd.AT, winograd.G, winograd.BT))
    assert at.shape == (4, 6) and g.shape == (6, 3) and bt.shape == (6, 6)
    for i in range(6):
        for k in range(3):
            got = at @ ((g[:, k]) * bt[:, i])
            want = torch.tensor([float(i == j + k) for j in range(4)], dtype=torch.float64)
            torch.testing.assert_close(got, want, atol=1e-15, rtol=0)
            exact = [sum(winograd.AT[j][a] * winograd.G[a][k] * winograd.BT[a][i]
                         for a in range(6)) for j in range(4)]
            assert exact == [int(i == j + k) for j in range(4)]


@pytest.mark.parametrize("n", [7, 9, 11, 13, 19])
@pytest.mark.parametrize("B", [1, 3])
def test_the_plain_version_is_the_conv(n, B):
    x, w = drawn(B, n, 100 * n + B)
    y = winograd.conv(x, winograd.filter_image(w))  # the twin, for a CPU tensor
    assert y.shape == (B, C, n, n) and y.dtype == torch.float32 and y.is_contiguous()
    assert_near_float64(y, x, w)


def test_the_tiles_cover_the_board():
    assert [winograd.tiles(n) for n in (1, 4, 5, 7, 11, 13, 19)] == [1, 1, 2, 2, 3, 4, 5]
    assert winograd.padded_rows(400, 11) == 3712  # 3,600 tiles up to 29 x 128
    assert winograd.padded_rows(1, 5) == 128


def test_the_image_is_the_float64_transform_rounded_once():
    """Each float of the image is within half a float32 ulp of the float64
    transform (computed here in another order, G g then G^T), up to that
    transform's own rounding (1e-15 of the sum of its terms' magnitudes,
    which decides a float that lies on a midpoint); a transform computed in
    float32 misses that on many floats."""
    _, w = drawn(1, 5, 3)
    u = winograd.filter_image(w)
    assert u.shape == (36, C, C) and u.dtype == torch.float32 and u.is_contiguous()
    g = winograd.matrix(winograd.G)

    def transform(g, w):  # (36, C, K) of (K, C, 3, 3), point (a, b) first
        return (g @ w @ g.T).permute(2, 3, 1, 0).reshape(36, C, C)

    exact = transform(g, w.double())
    slack = 1e-15 * transform(g.abs(), w.double().abs())

    def misses(img: torch.Tensor) -> int:
        ulp = (torch.nextafter(img.abs(), torch.tensor(float("inf"))) - img.abs()).double()
        return int(((img.double() - exact).abs() > 0.5 * ulp + slack).sum())

    assert misses(u) == 0
    g32 = winograd.matrix(winograd.G, torch.float32)
    single = torch.einsum("ai,kcij,bj->abck", g32, w, g32).reshape(36, C, C)
    assert misses(single) > 1000


# -- the rule and bind -----------------------------------------------------------------


def weight_like(shape, cuda: bool = True, dtype=torch.float32):
    """A stand-in for a conv weight, on a CUDA device or not, for the rule
    on a machine without a card."""
    return types.SimpleNamespace(shape=torch.Size(shape), is_cuda=cuda, dtype=dtype,
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("shape,board,cuda,dtype,takes", [
    ((256, 256, 3, 3), 11, True, torch.float32, True),
    ((128, 128, 3, 3), 19, True, torch.float32, True),
    ((256, 256, 3, 3), 11, False, torch.float32, False),  # the CPU
    ((256, 256, 3, 3), 11, True, torch.float64, False),
    ((256, 1, 3, 3), 11, True, torch.float32, False),  # the input conv
    ((2, 256, 1, 1), 11, True, torch.float32, False),  # a head's 1x1 conv
    ((64, 64, 3, 3), 9, True, torch.float32, True),  # the narrow product tile's width
    ((192, 192, 3, 3), 11, True, torch.float32, True),  # the KataGo tower's
    ((192, 128, 3, 3), 11, True, torch.float32, True),  # C_in 128, C_out 192
    ((192, 96, 3, 3), 11, True, torch.float32, False),
    ((96, 96, 3, 3), 11, True, torch.float32, False),
    ((256, 256, 3, 3), 21, True, torch.float32, False),  # past the largest board
])
def test_the_rule(shape, board, cuda, dtype, takes):
    assert winograd.takes(weight_like(shape, cuda, dtype), board) is takes


def _tower_layers(model):
    return [model.conv_in] + [h for block in model.blocks for h in (block.a, block.b)]


def small_model(filters: int = 128, blocks: int = 2, board: int = 5, dtype=torch.float32):
    model = ResNetPolicy(board * board, filters=filters, blocks=blocks, value_hidden=16,
                         generator=torch.Generator().manual_seed(filters + blocks))
    model = model.to(dtype)
    with torch.no_grad():  # BatchNorm off its start values
        g = torch.Generator().manual_seed(7)
        for layer in _tower_layers(model):
            noise = torch.randn((4, filters), generator=g, dtype=dtype) * 0.1
            layer.bn.scale.copy_(1.0 + noise[0])
            layer.bn.bias.copy_(noise[1])
            layer.bn.mean.copy_(noise[2])
            layer.bn.var.copy_(noise[3].exp())
    model.bind(dict(model.state_dict()))
    return model


def _takes_anywhere(monkeypatch):
    """The rule without its device condition, so the CPU builds images."""
    rule = winograd.takes

    def takes(weight, board):
        return rule(weight_like(tuple(weight.shape), True, weight.dtype), board)

    monkeypatch.setattr(winograd, "takes", takes)


def test_bind_builds_no_image_on_the_cpu():
    model = small_model()
    assert all(layer.image is None for layer in _tower_layers(model))


def test_bind_builds_an_image_for_each_conv_the_rule_takes(monkeypatch):
    _takes_anywhere(monkeypatch)
    model = small_model()
    assert model.conv_in.image is None  # 1 -> 128
    for layer in _tower_layers(model)[1:]:
        image = layer.image
        assert image.weight is layer.conv.weight and image.current(layer.conv.weight)
        assert torch.equal(image.u, winograd.filter_image(layer.conv.weight.detach()))
    assert all(layer.image is None for layer in _tower_layers(small_model(dtype=torch.float64)))
    model.bind(dict(small_model(filters=128).state_dict()))  # a new bind: new images
    assert all(layer.image.current(layer.conv.weight) for layer in _tower_layers(model)[1:])


def boards(n: int, B: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 2, (B, n, n), generator=g).to(torch.float32)


def test_the_cpu_forward_is_unchanged_bit_for_bit():
    """The CPU forward is the eager chain, each conv ``F.conv2d``, as it was
    before the images: the same ops in the same order, bit for bit."""
    model = small_model()
    x = boards(5, 6, 1)
    with torch.no_grad():
        logits, value = model(x)
        h = x.reshape(6, 1, 5, 5)
        with cnn.full_float32():
            def layer(conv_bn, h, skip=None):
                y, _, _ = conv_bn.bn(F.conv2d(h, conv_bn.conv.weight, None, padding=1), False)
                return torch.relu(y if skip is None else y + skip)

            h = layer(model.conv_in, h)
            for block in model.blocks:
                h = layer(block.b, layer(block.a, h), skip=h)
            p = torch.relu(model.policy.bn(model.policy.conv(h), False)[0]).reshape(6, -1)
            v = torch.relu(model.value.bn(model.value.conv(h), False)[0]).reshape(6, -1)
            want_value = torch.tanh(model.value_head(torch.relu(model.value_fc(v))))[..., 0]
    assert torch.equal(logits, model.action_head(p)) and torch.equal(value, want_value)


def test_the_rule_forced_on_the_cpu_runs_the_tower_through_the_twin(monkeypatch):
    """With images built and the fused rule forced on the CPU, each block's
    two convs go to ``winograd.conv`` (the twin here) and the input conv to
    ``F.conv2d``; the logits stay within the conv's tolerance of the eager
    forward's.  An image whose weight was written since bind is not taken."""
    _takes_anywhere(monkeypatch)
    model = small_model(blocks=3)
    x = boards(5, 4, 2)
    with torch.no_grad():
        want = model(x)
    calls = []
    inner = winograd.conv

    def spy(x, u):
        calls.append(u.shape)
        return inner(x, u)

    monkeypatch.setattr(winograd, "conv", spy)
    monkeypatch.setattr(ResNetPolicy, "_fuses", lambda self, x, train: not train)
    with torch.no_grad():
        got = model(x)
        assert calls == [(36, 128, 128)] * 6
        gap = float((got[0] - want[0]).abs().max() / want[0].abs().max())
        assert 0.0 < gap < 10 * MAX_TOL, gap
        model.blocks[1].a.conv.weight.mul_(1.0)  # a write: the version moves
        calls.clear()
        model(x)
    assert calls == [(36, 128, 128)] * 5


# -- the wrapper's refusals -----------------------------------------------------------


def _refusal(case: str):
    x, u = torch.randn((2, 128, 5, 5)), torch.randn((36, 128, 128))
    if case == "channels":
        x, u = torch.randn((2, 96, 5, 5)), torch.randn((36, 96, 96))
    elif case == "board":
        x = torch.randn((2, 128, 21, 21))
    elif case == "square":
        x = torch.randn((2, 128, 5, 6))
    elif case == "image":
        u = torch.randn((36, 128, 96))
    elif case == "dtype":
        x = x.double()
    elif case == "strided":
        x = x.transpose(2, 3)
    elif case == "unaligned":
        x = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    elif case == "device":
        u = torch.empty(u.shape, device="meta")
    return x, u


@pytest.mark.parametrize("case,message", [
    ("channels", "x's channels must be a multiple of 64, got 96"),
    ("board", "x's boards must be 1 to 19 a side, got 21"),
    ("square", r"x must be \(B, C, n, n\), got shape \(2, 128, 5, 6\)"),
    ("image", r"u must have shape \(36, 128, K\), K a multiple of 64, got \(36, 128, 96\)"),
    ("dtype", "x must be torch.float32"), ("strided", "x must be contiguous"),
    ("unaligned", "x must be 16-byte aligned"), ("device", "u lies on meta, x on cpu"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, message):
    with pytest.raises(ValueError, match=message):
        winograd.conv(*_refusal(case))


# -- the card --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("B,channels,n", [(400, 256, 11), (3, 256, 13), (1, 128, 7),
                                          (5, 128, 19), (130, 256, 9), (2, 128, 1)])
def test_the_kernel_is_the_conv(cuda_device, B, channels, n):
    """The kernels against float64 ``F.conv2d`` within the twin's tolerance,
    and against the twin on the card within twice it (two float32 sums in
    other orders); one launch counted a call."""
    x, w = drawn(B, n, B + channels + n, channels, cuda_device)
    u = winograd.filter_image(w)
    with torch.no_grad():
        y = winograd.conv(x, u)
        twin = winograd.conv_twin(x, u)
    torch.cuda.synchronize()
    assert cuda_lib.launches["winograd_conv"] == 1
    assert y.shape == x.shape and y.is_contiguous()
    assert_near_float64(y, x, w)
    want = F.conv2d(x.double(), w.double(), padding=1)
    assert float((y - twin).abs().max()) < 2 * MAX_TOL * float(want.abs().max())


@pytest.mark.chip
def test_a_forward_launches_the_kernels_for_the_tower(cuda_device):
    """At 19 blocks, 256 filters, 400 11x11 boards, the benchmark cell's
    agent (its driver's draw, BatchNorm calibrated): 38 conv launches a
    forward (the input conv stays cuDNN's), the epilogue's 20 plain and 19
    residual launches; the logits within the cell's ``logit_gap`` limit
    (1e-3) of the eager forward's (grad on: ``F.conv2d`` throughout)."""
    from benchmark import harness, work_resnet

    driver = harness.load_module(harness.driver_file("match_resnet"), "test_winograd_driver")
    m = work_resnet.ResNet("ResNet", 11, 256, 19, 256)
    params, _ = driver.make(m, 24, cuda_device, 2.0, 0.1, driver.match.AGENT_BN_STD)
    model = ResNetPolicy(121, init=False).to(cuda_device)
    model.bind(params)
    assert model.conv_in.image is None
    assert all(h.image is not None for block in model.blocks for h in (block.a, block.b))
    x = boards(11, 400, 5).to(cuda_device)
    cuda_lib.reset_launches()
    with torch.no_grad():
        logits, value = model(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches["winograd_conv"] == 38
    assert cuda_lib.launches["cnn_epilogue"] == 20
    assert cuda_lib.launches["cnn_epilogue_residual"] == 19
    model.requires_grad_(True)
    e_logits, e_value = model(x)
    assert cuda_lib.launches["winograd_conv"] == 38
    gap = float((logits - e_logits.detach()).abs().max())
    assert 0.0 < gap < 1e-3, gap
    assert float((value - e_value.detach()).abs().max()) < 1e-3
    assert float(logits.std()) > 0.5
