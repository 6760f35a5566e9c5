"""The KataGo tower's 1x1 conv (``ops/pointwise.py``) and its place in
``models/nbt.NbtPolicy``.

On the CPU: the rule (``pointwise.takes``) over kernel size, widths, device
and dtype; the image (the weight's transpose) and ``bind``: none on the
CPU, one for each 1x1 conv of the blocks where the rule takes it, none for
the heads'; the wrapper's refusals; the plain version (``conv_twin``)
against ``F.conv2d`` in float64, and through ``pointwise.conv`` in float32
against float64; the KataGo forward on the CPU unchanged bit for bit (every
conv ``F.conv2d``, no image); the rule forced on the CPU, so the twin
stands in for the kernel: the 36 1x1 convs of 18 blocks through
``pointwise.conv``, no launch counted, an image whose weight was written
since bind not taken; the benchmark's reader
``pointwise_kernel_pct.match``.

On the card (the ``chip`` marker; run there with ``python -m pytest
tests/test_torch_pointwise.py -m chip --noconftest``): the kernel against
float64 ``F.conv2d`` at the tower's two shapes and at small, ragged and
large boards; the KataGo forward at the published widths: 36 launches of
the kernel and 72 of the Winograd conv a forward, the logits within the
``[nbt]`` tolerance of the eager forward's; the AZ-ResNet forward: no
launch of the kernel, 38 of the Winograd conv.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import nbt as ref_nbt
from hex_gym_env_tpu_torch.models.nbt import NbtPolicy
from hex_gym_env_tpu_torch.ops import cuda_lib, pointwise
from hex_gym_env_tpu_torch.utils import profiling

# The float32 kernel against float64 F.conv2d, as a share of the output's
# RMS (``RMS_TOL``) and of its largest magnitude (``MAX_TOL``).  Each output
# is the direct float32 sum of C products (a rounding of 2^-24 a term): the
# kernel read 1.0e-7 to 2.5e-7 of the RMS and at most 7.8e-7 of the largest
# output at 64 to 384 channels on the card, the same as cuDNN's float32
# conv; a wrong channel, position or board offset moves outputs by a share
# of order 1.
RMS_TOL = 1e-6
MAX_TOL = 1e-5
# 18 blocks at narrow widths that the rule still takes: 128 -> 64 and
# 64 -> 128 1x1 convs, 36 a forward
DEEP = {"trunk": 128, "mid": 64, "gpool": 32, "blocks": 18, "gpool_every": 3, "p1": 16,
        "g1": 16, "v1": 32, "v2": 32}
PUBLISHED = {"trunk": 384, "mid": 192, "gpool": 64, "blocks": 18, "gpool_every": 3, "p1": 48,
             "g1": 48, "v1": 96, "v2": 128}
# chip_smoke.py's NBT_FORWARD_TOL: the forward through the kernels against
# the eager forward, as a share of the eager forward's largest logit
NBT_FORWARD_TOL = 2e-4


@pytest.fixture(autouse=True)
def _clean():
    """One torch thread, and no counters before or after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_counters()
    yield
    profiling.take_counters()
    torch.set_num_threads(n)


def drawn(B: int, C: int, K: int, n: int, seed: int, device="cpu", dtype=torch.float32):
    """Boards of ReLU'd activations (B, C, n, n) and a 1x1 conv weight (K, C,
    1, 1) of He's scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((B, C, n, n), generator=g, dtype=dtype))
    w = torch.randn((K, C, 1, 1), generator=g, dtype=dtype) * (2.0 / C) ** 0.5
    return x.to(device), w.to(device)


def errors(y: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> tuple[float, float]:
    """``y``'s error against float64 ``F.conv2d``: as a share of the RMS, of
    the largest output."""
    want = F.conv2d(x.double(), w.double())
    err = y.double() - want
    return (float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
            float(err.abs().max() / want.abs().max()))


def boards(n: int, B: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 2, (B, n, n), generator=g).to(torch.float32)


def model_of(widths: dict, n: int, seed: int) -> NbtPolicy:
    """The tower at ``widths`` on an n x n board, orthogonal weights and
    BatchNorm moved off its start values, bound."""
    model = NbtPolicy(n * n, generator=torch.Generator().manual_seed(seed), **widths)
    g = torch.Generator().manual_seed(seed + 1)
    params = dict(model.state_dict())
    with torch.no_grad():
        for key, value in params.items():
            if key.endswith("bn.var"):
                value.copy_((torch.randn(value.shape, generator=g) * 0.1).exp())
            elif key.endswith(("bn.mean", "bn.bias")):
                value.copy_(torch.randn(value.shape, generator=g) * 0.1)
    model.bind(params)
    return model


# -- the rule and the wrapper ----------------------------------------------------------


def weight_like(shape, cuda: bool = True, dtype=torch.float32):
    """A stand-in for a conv weight, on a CUDA device or not, for the rule
    on a machine without a card."""
    return types.SimpleNamespace(shape=torch.Size(shape), is_cuda=cuda, dtype=dtype,
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("shape,cuda,dtype,takes", [
    ((192, 384, 1, 1), True, torch.float32, True),  # a block's first 1x1 conv
    ((384, 192, 1, 1), True, torch.float32, True),  # a block's last
    ((128, 64, 1, 1), True, torch.float32, True),  # the narrowest tile's width
    ((64, 128, 1, 1), True, torch.float32, True),
    ((192, 192, 3, 3), True, torch.float32, False),  # a 3x3 conv: the Winograd conv's
    ((48, 384, 1, 1), True, torch.float32, False),  # the policy head's
    ((96, 384, 1, 1), True, torch.float32, False),  # the value head's
    ((1, 48, 1, 1), True, torch.float32, False),  # the policy's last
    ((192, 48, 1, 1), True, torch.float32, False),
    ((192, 384, 1, 1), False, torch.float32, False),  # the CPU
    ((192, 384, 1, 1), True, torch.float64, False),
    ((192, 384, 1), True, torch.float32, False),
])
def test_the_rule(shape, cuda, dtype, takes):
    assert pointwise.takes(weight_like(shape, cuda, dtype)) is takes


def _refusal(case: str):
    x, wt = torch.randn((2, 128, 5, 5)), torch.randn((128, 64))
    if case == "rank":
        x = torch.randn((2, 128, 25))
    elif case == "square":
        x = torch.randn((2, 128, 5, 6))
    elif case == "channels":
        x, wt = torch.randn((2, 96, 5, 5)), torch.randn((96, 64))
    elif case == "outputs":
        wt = torch.randn((128, 48))
    elif case == "weight":
        wt = torch.randn((64, 128, 1, 1))  # the weight, not its image
    elif case == "inputs":
        wt = torch.randn((192, 64))
    elif case == "dtype":
        x, wt = x.double(), wt.double()
    elif case == "image dtype":
        wt = wt.double()
    elif case == "contiguity":
        x = torch.randn((2, 5, 5, 128)).permute(0, 3, 1, 2)
    elif case == "image contiguity":
        wt = torch.randn((64, 128)).t()
    elif case == "unaligned":
        x = torch.randn(2 * 128 * 25 + 1)[1:].reshape(2, 128, 5, 5)
    elif case == "image unaligned":
        wt = torch.randn(128 * 64 + 1)[1:].reshape(128, 64)
    elif case == "device":
        wt = torch.empty((128, 64), device="meta")
    return x, wt


@pytest.mark.parametrize("case,message", [
    ("rank", r"x must be \(B, C, n, n\)"), ("square", r"x must be \(B, C, n, n\)"),
    ("channels", "x's channels must be a multiple of 64, got 96"),
    ("outputs", r"wt must have shape \(128, K\), K a multiple of 64"),
    ("weight", r"wt must have shape \(128, K\)"),
    ("inputs", r"wt must have shape \(128, K\)"),
    ("dtype", "x must be torch.float32"), ("image dtype", "wt must be torch.float32"),
    ("contiguity", "x must be contiguous"), ("image contiguity", "wt must be contiguous"),
    ("unaligned", "x must be 16-byte aligned"), ("image unaligned", "wt must be 16-byte aligned"),
    ("device", "wt lies on meta, x on cpu"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, message):
    with pytest.raises(ValueError, match=message):
        pointwise.conv(*_refusal(case))


# -- the plain version ---------------------------------------------------------------


@pytest.mark.parametrize("B,C,K,n", [(3, 384, 192, 11), (2, 192, 384, 5), (1, 64, 128, 7),
                                     (4, 128, 64, 13), (2, 64, 64, 1)])
def test_the_twin_is_the_conv(B, C, K, n):
    """In float64 the twin is ``F.conv2d`` to float64's rounding; through
    ``pointwise.conv`` in float32 within the kernel's tolerance of float64."""
    x, w = drawn(B, C, K, n, B + C + K + n, dtype=torch.float64)
    y = pointwise.conv_twin(x, pointwise.image_of(w).u)
    want = F.conv2d(x, w)
    assert y.shape == (B, K, n, n) and y.dtype == torch.float64
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    x32, w32 = x.float(), w.float()
    got = pointwise.conv(x32, pointwise.image_of(w32).u)
    assert got.shape == (B, K, n, n) and got.is_contiguous() and got.dtype == torch.float32
    rms, worst = errors(got, x32, w32)
    assert 0.0 < rms < RMS_TOL and worst < MAX_TOL, (rms, worst)
    assert cuda_lib.launches["pointwise_conv"] == 0


def test_the_image_is_the_weight_transposed():
    """The image holds the weight's own numbers, W^T (C, K) contiguous, and
    goes stale when the weight is written in place (``FilterImage``'s
    rule)."""
    _, w = drawn(1, 128, 64, 1, 9)
    image = pointwise.image_of(w)
    assert image.weight is w and image.current(w)
    assert image.u.shape == (128, 64) and image.u.is_contiguous()
    assert torch.equal(image.u, w[:, :, 0, 0].t())
    w.mul_(1.0)
    assert not image.current(w)


# -- the KataGo forward ----------------------------------------------------------------


def _takes_anywhere(monkeypatch):
    """The rule without its device condition, so the CPU builds images."""
    rule = pointwise.takes
    monkeypatch.setattr(pointwise, "takes",
                        lambda w: rule(weight_like(tuple(w.shape), True, w.dtype)))


def test_bind_builds_an_image_for_each_1x1_conv_of_the_blocks(monkeypatch):
    model = model_of(DEEP, 5, 1)
    assert all(layer.image is None for layer in model.convs1x1())  # the CPU: none
    _takes_anywhere(monkeypatch)
    model.bind(dict(model.state_dict()))
    layers = model.convs1x1()
    assert len(layers) == 2 * DEEP["blocks"]
    T, M = DEEP["trunk"], DEEP["mid"]
    assert [tuple(layer.image.u.shape) for layer in layers] == [(T, M), (M, T)] * DEEP["blocks"]
    assert all(layer.image.current(layer.conv.weight) for layer in layers)
    assert model.policy_out.image is None  # a head's 1x1 conv, 16 -> 1


def test_the_cpu_forward_is_unchanged_bit_for_bit(monkeypatch):
    """On the CPU every conv is ``F.conv2d`` as before: no image, nothing
    through ``pointwise.conv``, the plain reference's forward
    (``benchmark/reference/nbt.py``, the same ops in one process) bit for
    bit."""
    model = model_of(DEEP, 5, 1)
    assert all(layer.image is None for layer in model.convs1x1())
    asked = []
    monkeypatch.setattr(pointwise, "conv", lambda x, wt: asked.append(wt))
    x = boards(5, 6, 2)
    with torch.no_grad():
        logits, value = model(x)
        want_logits, want_value = ref_nbt.forward(dict(model.state_dict()), x)
    assert asked == [] and cuda_lib.launches["pointwise_conv"] == 0
    assert torch.equal(logits, want_logits) and torch.equal(value, want_value)
    assert float(logits.std()) > 0.3


def test_the_rule_forced_on_the_cpu_runs_the_1x1_convs_through_the_twin(monkeypatch):
    """With the rule taken without its device condition and the fused path
    forced on the CPU, each block's two 1x1 convs (128 -> 64, 64 -> 128) go
    to ``pointwise.conv`` on their images, 36 a forward of 18 blocks, the
    twin here (no launch counted); the heads' 1x1 convs do not; the logits
    within the twin's rounding of the eager forward's.  An image whose
    weight was written since bind is not taken."""
    model = model_of(DEEP, 5, 3)
    x = boards(5, 4, 4)
    with torch.no_grad():
        want = model(x)
    inner = pointwise.conv
    calls = []

    def spy(a, wt):
        calls.append((tuple(wt.shape), a.shape[1]))
        return inner(a, wt)

    _takes_anywhere(monkeypatch)
    model.bind(dict(model.state_dict()))
    monkeypatch.setattr(pointwise, "conv", spy)
    monkeypatch.setattr(NbtPolicy, "_fuses", lambda self, x, train: not train)
    with torch.no_grad():
        got = model(x)
        T, M = DEEP["trunk"], DEEP["mid"]
        assert calls == [((T, M), T), ((M, T), M)] * DEEP["blocks"]
        assert cuda_lib.launches["pointwise_conv"] == 0
        gap = float((got[0] - want[0]).abs().max() / want[0].abs().max())
        assert gap < 1e-4, gap
        assert float((got[1] - want[1]).abs().max()) < 1e-4
        model.blocks[4].post.conv.weight.mul_(1.0)  # a write: the version moves
        calls.clear()
        model(x)
    assert len(calls) == 2 * DEEP["blocks"] - 1


# -- the benchmark's reader -------------------------------------------------------------


def test_pointwise_kernel_pct_reads_the_share_of_1x1_convs_through_the_kernel(monkeypatch):
    from benchmark import harness

    read = harness.load_module(harness.metric_file("pointwise_kernel_pct.match"),
                               "pointwise_kernel_pct_match").read
    match_r, train_r = harness.Readings(kind="match"), harness.Readings(kind="train")
    assert read(match_r) is None  # a program that counts no such blocks
    profiling.count("residual_blocks", 38)  # an AZ-ResNet's count does not stand in
    assert read(match_r) is None
    profiling.count("nbt_blocks", 36)  # two forwards of 18 blocks
    assert read(match_r) == 0.0  # the kernel never launched: 72 convs on cuDNN
    profiling.count("launch.winograd_conv", 144)  # the 3x3 convs' kernel does not stand in
    assert read(match_r) == 0.0
    profiling.count("launch.pointwise_conv", 36)
    assert read(match_r) == pytest.approx(50.0) and read(train_r) is None
    profiling.count("launch.pointwise_conv", 36)
    assert read(match_r) == 100.0
    monkeypatch.setattr(cuda_lib, "KERNELS", tuple(k for k in cuda_lib.KERNELS
                                                   if k != "pointwise_conv"))
    assert read(match_r) is None  # a program without the kernel
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "counters")
    assert read(match_r) is None


# -- the card --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("B,C,K,n", [(400, 384, 192, 11), (400, 192, 384, 11), (1, 64, 128, 7),
                                     (3, 128, 64, 13), (2, 192, 384, 19)])
def test_the_kernel_is_the_conv(cuda_device, B, C, K, n):
    """The kernel against float64 ``F.conv2d`` within the direct sum's
    tolerance, every output written (the ragged last tile too); one launch
    counted a call."""
    x, w = drawn(B, C, K, n, B + C + K + n, cuda_device)
    with torch.no_grad():
        y = pointwise.conv(x, pointwise.image_of(w).u)
    torch.cuda.synchronize()
    assert cuda_lib.launches["pointwise_conv"] == 1 and cuda_lib.launches["winograd_conv"] == 0
    assert y.shape == (B, K, n, n) and y.is_contiguous()
    rms, worst = errors(y, x, w)
    assert 0.0 < rms < RMS_TOL and worst < MAX_TOL, (rms, worst)


@pytest.mark.chip
def test_a_katago_forward_launches_the_kernel_for_the_1x1_convs(cuda_device):
    """The published widths at 400 11x11 boards: 36 launches of the kernel
    (the blocks' 1x1 convs; not the heads') and 72 of the Winograd conv a
    forward; the logits within ``NBT_FORWARD_TOL`` of the eager forward's
    largest (grad on: ``F.conv2d`` throughout)."""
    model = model_of(PUBLISHED, 11, 26).to(cuda_device)
    model.bind(dict(model.state_dict()))
    x = boards(11, 400, 5).to(cuda_device)
    cuda_lib.reset_launches()
    with torch.no_grad():
        logits, value = model(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches["pointwise_conv"] == 36
    assert cuda_lib.launches["winograd_conv"] == 72
    model.requires_grad_(True)
    e_logits, e_value = (t.detach() for t in model(x))
    assert cuda_lib.launches["pointwise_conv"] == 36
    scale = float(e_logits.abs().max())
    gap = float((logits - e_logits).abs().max())
    assert 0.0 < gap < NBT_FORWARD_TOL * scale, (gap, scale)
    assert float((value - e_value).abs().max()) < 1e-3


@pytest.mark.chip
def test_an_az_resnet_forward_launches_no_1x1_conv(cuda_device):
    """The AZ-ResNet tower at 19 blocks: its 38 3x3 convs on the Winograd
    conv as before, and no launch of this kernel (its heads' 1x1 convs, 256
    -> 2 and 256 -> 1, fail the rule and are not the KataGo tower's)."""
    from hex_gym_env_tpu_torch.models.resnet import ResNetPolicy

    model = ResNetPolicy(121, generator=torch.Generator().manual_seed(19)).to(cuda_device)
    model.bind(dict(model.state_dict()))
    x = boards(11, 64, 6).to(cuda_device)
    cuda_lib.reset_launches()
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches["winograd_conv"] == 38
    assert cuda_lib.launches["pointwise_conv"] == 0
