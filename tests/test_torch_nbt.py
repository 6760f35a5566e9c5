"""KataGo's nested-bottleneck tower (``models/nbt.py``, family
``KataGo-NBT``), the widened Winograd conv and the pre-activation epilogue it
runs on, and its benchmark cell, ``nbt11-match-det``.

On the CPU: the module against the benchmark's plain reference
(``benchmark/reference/nbt.py``) on seeded weights drawn as the cell's
driver draws them, at inference and in training; the pooling's three
features against a hand computation; the draw's calibration; the template
at the published widths; the pre-activation twin bit for bit the eager
chain and the wrapper's refusals; the forward with the kernels' rule
forced (the twins standing in) and the BatchNorm factors ``bind`` keeps
for it; the widened Winograd twin against float64
``F.conv2d`` at 192 -> 192 and 128 -> 192, and the 256 -> 256 conv's rule
and shapes as they were; ``run_match`` between two ``params:`` agents
judged by the cell's driver, sound and with four planted faults; a
tournament; the cell's files and metrics; the four new readers; the
trainer's refusal.  The family is registered smaller where a test plays it
(``SMALL``: 2 blocks, trunk 128, mid 64, 32 pooled, at 5x5 and 7x7).

On the card (the ``chip`` marker; run there with ``python -m pytest
tests/test_torch_nbt.py -m chip --noconftest``): the pre-activation launch
bit for bit its twin, with and without a skip and a board bias, on a
channel slice; the widened conv's 64-column instance bit for bit the
128-column instance's outputs; the forward with and without the kernels
(the 1x1 convs' too) within the cell's ``logit_gap`` limit; and the kept
BatchNorm factors bit for bit the computed ones.
"""

import time
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, work, work_nbt
from benchmark.reference import models as ref_models
from benchmark.reference import nbt as ref_nbt
from hex_gym_env_tpu_torch import models
from hex_gym_env_tpu_torch.models import cnn, nbt, policy_template
from hex_gym_env_tpu_torch.models.nbt import NbtPolicy
from hex_gym_env_tpu_torch.ops import cnn_epilogue, cuda_lib, winograd
from hex_gym_env_tpu_torch.scripts import match
from hex_gym_env_tpu_torch.scripts.tournament import run_tournament
from hex_gym_env_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "nbt11-match-det"
CONFIG = "benchmark/configs/KataGo-b18c384nbt-11x11.json"
SMALL = {"trunk": 128, "mid": 64, "gpool": 32, "blocks": 2, "gpool_every": 2, "p1": 16,
         "g1": 16, "v1": 32, "v2": 32}
PUBLISHED = {"trunk": 384, "mid": 192, "gpool": 64, "blocks": 18, "gpool_every": 3, "p1": 48,
             "g1": 48, "v1": 96, "v2": 128}
BOARD, GAMES = 5, 64
# The module and the reference run the same float32 ops on the CPU (they
# agree bit for bit in one process); 1e-5 leaves room for a build that sums
# a conv or a dense layer in another order, and stays a hundred times below
# the cell's limit.
TOL = 1e-5
# The widened Winograd conv against float64 F.conv2d (the limits of
# tests/test_torch_winograd.py, set at 256 channels: fewer input channels
# sum fewer roundings).
RMS_TOL, MAX_TOL = 4e-6, 1.5e-5


@pytest.fixture(autouse=True)
def _clean():
    """One torch thread, and no counters before or after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.take_counters()
    yield
    profiling.take_counters()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def driver():
    return harness.load_module(harness.driver_file("match_nbt"), "test_nbt_match_driver")


@pytest.fixture
def small(monkeypatch):
    """The family registered at ``SMALL``'s widths."""
    monkeypatch.setitem(models._FAMILIES, "KataGo-NBT", (NbtPolicy, SMALL))


def shape_of(board: int, widths=None) -> work_nbt.Nbt:
    return work_nbt.Nbt("NBT", board, **(widths or SMALL))


def cell_context(tmp_path, seed: int, board: int = BOARD) -> harness.Context:
    """The cell's workload and configuration at ``board``, ``GAMES`` and
    ``SMALL``'s widths."""
    man = harness.manifest(ROOT)
    entry = harness.entry(man["workloads"], CELL, "workload")
    conf = harness.load_json(ROOT / harness.entry(man["configs"], entry["config"],
                                                  "configuration")["file"])
    conf["model"].update(board_size=board, **SMALL)
    wl = {**harness.load_json(harness.workload_file(CELL)), "games": GAMES}
    return harness.Context(name=CELL, workload=wl, config=conf, seed=seed, seconds=0.0,
                           trace=False, t0=time.perf_counter(), device=torch.device("cpu"),
                           run_dir=str(tmp_path))


def drawn(driver, seed: int, board: int = BOARD):
    """The driver's agent weights (BatchNorm calibrated and moved) and the
    module of ``SMALL``'s widths holding them."""
    m = shape_of(board)
    params, trained = driver.make(m, seed, torch.device("cpu"), 2.0, 0.1,
                                  driver.match.AGENT_BN_STD)
    model = NbtPolicy(board * board, init=False, **SMALL)
    model.bind(params)
    return m, params, trained, model


def boards(n: int, B: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 2, (B, n, n), generator=g).to(torch.float32)


# -- the module against the reference ---------------------------------------------


@pytest.mark.parametrize("seed,board", [(2 ** 31 + 5, 5), (11, 7)])
def test_the_module_is_the_reference(seed, board, driver):
    _, params, _, model = drawn(driver, seed, board)
    x = boards(board, 32, seed)
    with torch.no_grad():
        logits, value = model(x)
        want_logits, want_value = ref_nbt.forward(params, x)
        only = ref_nbt.policy_logits(params, x)
    assert logits.shape == (32, board * board) and value.shape == (32,)
    torch.testing.assert_close(logits, want_logits, atol=TOL, rtol=0)
    torch.testing.assert_close(value, want_value, atol=TOL, rtol=0)
    assert torch.equal(only, want_logits)
    # logits of a trained agent's size, values inside tanh's range
    assert 0.3 < float(logits.std()) < 10.0 and float(value.abs().max()) < 1.0
    assert profiling.counters["nbt_blocks"] == SMALL["blocks"]
    assert profiling.counters["gpool_layers"] == 1
    assert "residual_blocks" not in profiling.counters


def test_train_mode_returns_the_reference_statistics(driver):
    _, params, trained, model = drawn(driver, 3, 7)
    x = boards(7, 16, 4)
    logits, value, stats = model(x, train=True)
    want_logits, want_value, want_stats = ref_nbt.forward(params, x, train=True)
    torch.testing.assert_close(logits, want_logits, atol=TOL, rtol=0)
    torch.testing.assert_close(value, want_value, atol=TOL, rtol=0)
    assert sorted(stats) == sorted(want_stats) == sorted(
        k for k in model.state_dict() if k.endswith((".bn.mean", ".bn.var")))
    for k in stats:
        torch.testing.assert_close(stats[k], want_stats[k], atol=TOL, rtol=1e-5)
        assert not torch.equal(stats[k], params[k])  # moved by the batch
    assert set(trained) | set(stats) == set(model.state_dict())
    assert logits.requires_grad  # the eager chain, with its backward


def test_the_pooling_features_are_the_hand_computation():
    """mean, mean x (sqrt(A) - 14) / 10 and max (or the value head's third
    moment, mean x ((sqrt(A) - 14)^2 / 100 - 0.1)), channel by channel, by
    plain Python sums over the cells."""
    g = torch.Generator().manual_seed(5)
    a = torch.relu(torch.randn((2, 3, 5, 5), generator=g, dtype=torch.float64))
    off = 5 - 14
    for third in ("max", "moment"):
        got = nbt.pool_features(a, third)
        assert torch.equal(got, ref_nbt.pool(a, third))
        assert got.shape == (2, 9)
        for b in range(2):
            for c in range(3):
                cells = [float(v) for v in a[b, c].flatten()]
                mean = sum(cells) / 25
                last = max(cells) if third == "max" else mean * (off * off / 100 - 0.1)
                want = [mean, mean * off / 10, last]
                for k in range(3):
                    assert float(got[b, 3 * k + c]) == pytest.approx(want[k], rel=1e-12)
    assert float(nbt.pool_features(torch.ones((1, 1, 11, 11)), "moment")[0, 2]) == \
        pytest.approx(-0.01)  # (11 - 14)^2 / 100 - 0.1


def test_the_draw_calibrates_and_moves_batch_norm(driver):
    """The drawn statistics sit near each BatchNorm's input statistics on the
    calibration's boards and off BatchNorm's start values, so a program that
    ignored them would differ; the draw repeats from its seed."""
    m, params, _, _ = drawn(driver, 9)
    names = ["blocks.0.pre", "blocks.0.inner.0.a", "blocks.1.inner.0.g", "blocks.1.inner.0.b",
             "blocks.1.post", "final", "policy_pool", "policy_out", "value_norm"]
    for name in names:
        assert float(params[f"{name}.bn.mean"].abs().max()) > 0.05
        assert float((params[f"{name}.bn.var"] - 1).abs().max()) > 0.05
    again = driver.make(m, 9, torch.device("cpu"), 2.0, 0.1, driver.match.AGENT_BN_STD)[0]
    assert all(torch.equal(params[k], again[k]) for k in params)
    # without the move, each running statistic is its BatchNorm's input's
    # batch statistic on the calibration's boards, drawn after the weights
    exact, _ = driver.make(m, 9, torch.device("cpu"), 2.0, 0.1, None)
    shapes, scales, zero, ones, norms = driver.layout(m, 2.0, 0.1)
    g = torch.Generator().manual_seed(9)
    harness.make_weights(shapes, scales, g, torch.device("cpu"), zero, ones)
    x = driver.positions(m, driver.CALIBRATION, g, torch.device("cpu"))
    seen = []

    def norm(name, t):
        seen.append(name)
        torch.testing.assert_close(t.mean(dim=(0, 2, 3)), exact[f"{name}.bn.mean"],
                                   atol=1e-6, rtol=1e-5)
        return torch.relu(ref_models._batch_norm(exact, name, t, False, {}))

    with torch.no_grad():
        ref_nbt.forward(exact, x, norm=norm)
    assert sorted(seen) == sorted(norms)


# -- the template at the published widths -------------------------------------------


def test_the_template_at_the_published_widths(driver):
    model = policy_template("KataGo-NBT", 121)
    sd = model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    assert len(model.blocks) == 18
    assert shapes["conv_in.weight"] == (384, 1, 3, 3)
    pooled = [i for i in range(18) if "blocks.%d.inner.0.g.fc.weight" % i in shapes]
    assert pooled == [2, 5, 8, 11, 14, 17]
    for i in range(18):
        b = f"blocks.{i}"
        assert shapes[f"{b}.pre.conv.weight"] == (192, 384, 1, 1)
        assert shapes[f"{b}.post.conv.weight"] == (384, 192, 1, 1)
        assert shapes[f"{b}.inner.0.a.conv.weight"] == (192, 192, 3, 3)
        assert shapes[f"{b}.inner.0.b.conv.weight"] == ((192, 128, 3, 3) if i in pooled
                                                        else (192, 192, 3, 3))
        assert shapes[f"{b}.inner.1.b.conv.weight"] == (192, 192, 3, 3)
    assert shapes["blocks.2.inner.0.g.fc.weight"] == (128, 192)
    assert shapes["blocks.2.inner.0.g.bn.mean"] == (64,)
    assert shapes["policy_pool.fc.weight"] == (48, 144)
    assert shapes["policy_out.conv.weight"] == (1, 48, 1, 1)
    assert shapes["value_fc.weight"] == (128, 288) and shapes["value_head.weight"] == (1, 128)
    assert all(float(v.abs().max()) == float(k.endswith((".scale", ".var"))) for k, v in sd.items())
    m = work_nbt.model_of(harness.load_json(ROOT / CONFIG))
    assert m == work_nbt.Nbt("NBT", 11, **PUBLISHED)
    count = sum(v.numel() for v in sd.values())
    assert work_nbt.param_count(m) == count == 26_246_321
    trunk = sum(v.numel() for k, v in model.named_parameters()
                if k.startswith(("conv_in", "blocks")))
    assert 25.9e6 < trunk < 26.1e6  # the published net's ~26.0 M trunk parameters
    assert driver.layout(m, 2.0, 0.1)[0] == shapes  # the driver's agents fit the loader
    assert work_nbt.policy_flops(m) == pytest.approx(6.2727e9, rel=1e-4)
    assert len(work_nbt.convs3x3(m)) == 72 and len(work_nbt.preacts(m)) == 115


def test_make_policy_initialises_with_sb3_gains():
    g = torch.Generator().manual_seed(0)
    model = models.make_policy("KataGo-NBT", 9, generator=g)
    assert profiling.counters.get("policy_inits") == 1
    w = model.blocks[0].inner[0].a.conv.weight.reshape(192, -1)
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(192), atol=1e-4, rtol=0)
    head = model.policy_out.conv.weight.reshape(1, -1)
    torch.testing.assert_close(head @ head.T, 1e-4 * torch.eye(1), atol=1e-7, rtol=0)
    assert float(model.value_fc.bias.detach().abs().max()) == 0.0


# -- the pre-activation epilogue ----------------------------------------------------


def _bn(C: int, g):
    layer = cnn.BatchNorm(C)
    with torch.no_grad():
        noise = torch.randn((4, C), generator=g) * 0.1
        layer.scale.copy_(1.0 + noise[0])
        layer.bias.copy_(noise[1])
        layer.mean.copy_(noise[2])
        layer.var.copy_(noise[3].exp())
    return layer


@pytest.mark.parametrize("shape", [(1, 16, 5, 5), (7, 64, 9, 9), (3, 384, 11, 11)])
@pytest.mark.parametrize("case", ["plain", "skip", "board"])
def test_the_preact_twin_is_the_eager_chain_bit_for_bit(shape, case):
    g = torch.Generator().manual_seed(sum(shape))
    bn = _bn(shape[1], g)
    y, skip = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    skip = skip if case == "skip" else None
    board = torch.randn(shape[:2], generator=g) if case == "board" else None
    with torch.no_grad():
        s = y if skip is None else y + skip
        eager, _, _ = bn(s if board is None else s + board[:, :, None, None], False)
        args = (bn.mean, bn.mul(bn.var), bn.bias)
        got_s, got_a = cnn_epilogue.preact_twin(y, skip, *args, board)
        assert torch.equal(got_s, s) and torch.equal(got_a, torch.relu(eager))
        wrapped = cnn_epilogue.preact(y, skip, *args, board)  # the CPU's
        assert torch.equal(wrapped[0], s) and torch.equal(wrapped[1], torch.relu(eager))
    assert float(got_a.min()) == 0.0 and float(got_a.max()) > 1.0


def test_the_preact_takes_a_channel_slice():
    """The pooled conv's output split in two, each part a slice of one
    (B, mid, N, N) tensor: the twin on each equals it on a copy."""
    g = torch.Generator().manual_seed(3)
    y = torch.randn((4, 192, 11, 11), generator=g)
    for part, C in ((y[:, :128], 128), (y[:, 128:], 64)):
        bn = _bn(C, g)
        args = (bn.mean, bn.mul(bn.var), bn.bias)
        board = torch.randn((4, C), generator=g)
        got = cnn_epilogue.preact(part, None, *args, board)[1]
        assert got.is_contiguous()
        assert torch.equal(got, cnn_epilogue.preact_twin(part.contiguous(), None, *args, board)[1])


def _preact_case(case: str):
    y, skip, board = torch.randn((2, 4, 3, 3)), None, None
    if case == "odd":
        y = torch.randn((2, 3, 3, 3))
    elif case == "strided":
        y = torch.randn((2, 4, 3, 3)).transpose(2, 3)
    elif case == "dtype":
        y = y.double()
    elif case == "skip shape":
        skip = torch.randn((2, 4, 3, 4))
    elif case == "skip strided":
        skip = torch.randn((2, 4, 3, 3)).transpose(2, 3)
    elif case == "both":
        skip, board = torch.randn((2, 4, 3, 3)), torch.randn((2, 4))
    elif case == "board shape":
        board = torch.randn((2, 5))
    elif case == "board dtype":
        board = torch.randn((2, 4)).double()
    return y, skip, board


@pytest.mark.parametrize("case,message", [
    ("odd", r"y's boards must be a multiple of 4 floats, got 3 x 3 x 3"),
    ("strided", "y's boards must each be contiguous"), ("dtype", "y must be torch.float32"),
    ("skip shape", r"skip must have y's shape \(2, 4, 3, 3\), got \(2, 4, 3, 4\)"),
    ("skip strided", "skip must be contiguous"),
    ("both", "a board bias is taken only without a skip"),
    ("board shape", r"board_bias must have shape \(2, 4\), got \(2, 5\)"),
    ("board dtype", "board_bias must be torch.float32"),
])
def test_the_wrapper_refuses_what_the_preact_launch_does_not_take(case, message):
    y, skip, board = _preact_case(case)
    vec = {k: torch.randn(4) for k in ("mean", "mul", "bn_bias")}
    with pytest.raises(ValueError, match=message):
        cnn_epilogue.preact(y, skip, **vec, board_bias=board)


# -- the widened Winograd conv -------------------------------------------------------


@pytest.mark.parametrize("cin,cout,n,B", [(192, 192, 11, 2), (128, 192, 11, 3), (192, 192, 7, 1),
                                          (64, 128, 9, 2)])
def test_the_widened_twin_is_the_conv(cin, cout, n, B):
    g = torch.Generator().manual_seed(cin + cout + n)
    x = torch.relu(torch.randn((B, cin, n, n), generator=g))
    w = torch.randn((cout, cin, 3, 3), generator=g) * (2.0 / (9 * cin)) ** 0.5
    u = winograd.filter_image(w)
    assert u.shape == (36, cin, cout)
    y = winograd.conv(x, u)  # the twin, for a CPU tensor
    assert y.shape == (B, cout, n, n) and y.is_contiguous()
    want = F.conv2d(x.double(), w.double(), padding=1)
    err = y.double() - want
    rms = float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    worst = float(err.abs().max() / want.abs().max())
    assert 0.0 < rms < RMS_TOL and worst < MAX_TOL, (rms, worst)


def test_the_256_conv_keeps_its_rule_and_shapes(monkeypatch):
    """The AZ-ResNet's 256 -> 256 conv: taken by the rule, its image (36,
    256, 256), its output (B, 256, n, n), and the twin's outputs the first
    of a wider conv's bit for bit (each output channel's sum is its own, as
    in the kernels' two instances)."""
    assert winograd.takes(weight_like((256, 256, 3, 3)), 11)
    g = torch.Generator().manual_seed(256)
    x = torch.relu(torch.randn((2, 256, 11, 11), generator=g))
    w = torch.randn((320, 256, 3, 3), generator=g) * (2.0 / (9 * 256)) ** 0.5
    u = winograd.filter_image(w[:256])
    y = winograd.conv(x, u)
    assert u.shape == (36, 256, 256) and y.shape == (2, 256, 11, 11)
    wide = winograd.conv(x, winograd.filter_image(w))
    assert torch.equal(wide[:, :256], y)


def weight_like(shape, cuda: bool = True, dtype=torch.float32):
    """A stand-in for a conv weight, on a CUDA device or not, for the rule
    on a machine without a card."""
    return types.SimpleNamespace(shape=torch.Size(shape), is_cuda=cuda, dtype=dtype,
                                 dim=lambda: len(shape))


def _takes_anywhere(monkeypatch):
    """The rule without its device condition, so the CPU builds images."""
    rule = winograd.takes

    def takes(weight, board):
        return rule(weight_like(tuple(weight.shape), True, weight.dtype), board)

    monkeypatch.setattr(winograd, "takes", takes)


def test_bind_builds_an_image_for_each_3x3_conv(driver, monkeypatch):
    _, _, _, model = drawn(driver, 2)
    assert all(layer.image is None for layer in model.convs3x3())  # the CPU: none
    _takes_anywhere(monkeypatch)
    C = SMALL["mid"]
    model.bind(dict(model.state_dict()))
    shapes = [None if layer.image is None else tuple(layer.image.u.shape)
              for layer in model.convs3x3()]
    # the pooled block's second conv takes mid - gpool = 32 channels, not a
    # multiple of 64: the rule leaves it on F.conv2d
    assert shapes == [(36, C, C)] * 5 + [None] + [(36, C, C)] * 2
    for layer in model.convs3x3():
        assert layer.image is None or layer.image.current(layer.conv.weight)


def test_bind_keeps_each_batch_norm_factor_while_it_is_current(driver, monkeypatch):
    """``bind`` keeps every BatchNorm's factor, bit for bit
    ``BatchNorm.mul``; the fused forward (the rule forced on the CPU) takes
    it while the scale and the variance are the tensors, at the versions,
    it was computed from, and computes the factor again once the variance
    is written in place."""
    _, _, _, model = drawn(driver, 3)
    norms = {name.removesuffix(".bn"): bn for name, bn in model.named_modules()
             if isinstance(bn, cnn.BatchNorm)}
    # 6 a block and the pooling's, the final one, the heads' three
    assert model.factors.keys() == norms.keys() and len(norms) == 6 * 2 + 1 + 1 + 3
    for name, bn in norms.items():
        kept = model.factors[name]
        assert kept.current(bn) and torch.equal(kept.mul, bn.mul(bn.var))
    muls = []
    preact = cnn_epilogue.preact

    def spy_preact(y, skip, mean, mul, bn_bias, board_bias=None):
        muls.append(mul)
        return preact(y, skip, mean, mul, bn_bias, board_bias)

    monkeypatch.setattr(cnn_epilogue, "preact", spy_preact)
    monkeypatch.setattr(NbtPolicy, "_fuses", lambda self, x, train: not train)
    x = boards(BOARD, 4, 1)
    with torch.no_grad():
        want = model(x)
    # each of the trunk's BNRs once on its kept factor, the input conv's first
    trunk = [name for name in norms if name.startswith(("blocks.", "final"))]
    assert len(muls) == len(trunk) == 14 and muls[0] is model.factors["blocks.0.pre"].mul
    assert {id(mul) for mul in muls} == {id(model.factors[name].mul) for name in trunk}
    first, bn = model.factors["blocks.0.pre"], norms["blocks.0.pre"]
    with torch.no_grad():
        bn.var.mul_(2.0)
    assert not first.current(bn)
    muls.clear()
    with torch.no_grad():
        got = model(x)
    assert muls[0] is not first.mul and torch.equal(muls[0], bn.mul(bn.var))
    assert not torch.equal(got[0], want[0])
    model.factors = {}
    with torch.no_grad():
        computed = model(x)
    assert torch.equal(computed[0], got[0]) and torch.equal(computed[1], got[1])


def test_the_fused_forward_through_the_twins(driver, monkeypatch):
    """The rule forced on the CPU with images built, so the twins stand in
    for the kernels: every 3x3 conv the rule takes through ``winograd.conv``
    (4 a block, less the pooled block's 32 -> 64),
    every BNR through ``cnn_epilogue.preact`` (1 + 6 a block, 7 a pooled
    one), the pooled bias on the 32 r channels; with the images dropped the
    eager forward's logits bit for bit, with them within the conv's
    tolerance."""
    _, _, _, model = drawn(driver, 7, 7)
    x = boards(7, 8, 8)
    with torch.no_grad():
        want = model(x)
    convs, preacts = [], []
    conv, preact = winograd.conv, cnn_epilogue.preact

    def spy_conv(a, u):
        convs.append(tuple(u.shape))
        return conv(a, u)

    def spy_preact(y, skip, mean, mul, bn_bias, board_bias=None):
        preacts.append((y.shape[1], skip is not None, board_bias is not None))
        return preact(y, skip, mean, mul, bn_bias, board_bias)

    monkeypatch.setattr(winograd, "conv", spy_conv)
    monkeypatch.setattr(cnn_epilogue, "preact", spy_preact)
    monkeypatch.setattr(NbtPolicy, "_fuses", lambda self, x, train: not train)
    with torch.no_grad():
        held = model(x)  # no images: every conv F.conv2d
        assert convs == [] and torch.equal(held[0], want[0]) and torch.equal(held[1], want[1])
        T, M, G = SMALL["trunk"], SMALL["mid"], SMALL["gpool"]
        plain = [(M, False, False), (M, False, False), (M, True, False), (M, False, False),
                 (M, True, False), (T, True, False)]
        pooled = [(M, False, False), (G, False, False), (M - G, False, True), (M, True, False),
                  (M, False, False), (M, True, False), (T, True, False)]
        assert preacts == [(T, False, False)] + plain + pooled
        _takes_anywhere(monkeypatch)
        model.bind(dict(model.state_dict()))
        got = model(x)
    assert len(convs) == 4 * SMALL["blocks"] - 1
    gap = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    assert 0.0 < gap < 1e-4, gap


@pytest.mark.parametrize("case", ["train", "grad", "cpu"])
def test_the_rule_sends_each_case_to_the_eager_chain(case, driver, monkeypatch):
    assert NbtPolicy._fuses is cnn.CnnPolicy._fuses
    _, _, _, model = drawn(driver, 5)
    x = boards(BOARD, 4, 6)
    calls = []
    monkeypatch.setattr(cnn_epilogue, "preact", lambda *a, **k: calls.append(a))
    if case == "train":
        model(x, train=True)
    elif case == "grad":
        model(x)
    else:
        with torch.no_grad():
            model(x)
    assert calls == [] and cuda_lib.launches["cnn_epilogue_preact"] == 0
    assert profiling.counters["nbt_blocks"] == SMALL["blocks"]


# -- the match and its judge ---------------------------------------------------------


def play_and_judge(ctx, driver, nudge: bool = False) -> dict:
    """One recorded match of the cell's agents through ``run_match``, judged
    by the cell's driver against the reference; with ``nudge`` one logit of
    the program's raised by 0.01."""
    model = driver.match.work.model_of(ctx.config)
    family, mode = ctx.config["model"]["name"], ctx.workload["mode"]
    (wa, spec_a), (wb, spec_b) = driver.make_agents(ctx, model)
    rec = {}
    with driver.logit_tap() as taps:
        match.run_match(model.board, GAMES, spec_a, spec_b, mode=mode, family_a=family,
                        family_b=family, device="cpu", record=rec)
    if nudge:
        taps[1][5] = taps[1][5].clone()
        taps[1][5][9, 4] += 1e-2
    ref = driver.replay(wa, wb, model, mode, GAMES, None, rec["actions"], taps)
    per_ply = [max(float((taps[side][t].double() - ref["logits"][side][t].double())
                         .abs().max()) for side in (0, 1))
               for t in range(model.cells + 1)]
    judged = driver.judge(wa, wb, model, mode, GAMES, None, rec["actions"], rec["winners"],
                          taps)
    return {"judged": judged, "winners": (rec["winners"].long(), ref["winners"]),
            "per_ply": per_ply}


@pytest.mark.parametrize("seed,board", [(2 ** 31 + 23, 5), (5, 7)])
def test_the_match_agrees_with_the_reference(seed, board, driver, small, tmp_path):
    ctx = cell_context(tmp_path, seed, board)
    out = play_and_judge(ctx, driver)
    got, want = out["winners"]
    assert torch.equal(got, want)
    assert max(out["per_ply"]) < TOL, out["per_ply"]
    assert max(out["per_ply"]) == out["judged"]["logit_gap"]
    limits = ctx.workload["limits"]
    assert out["judged"]["winner_mismatch"] == 0
    assert all(harness.within(v, limits[k]) for k, v in out["judged"].items()), out["judged"]
    plies = board * board + 1
    assert profiling.counters["nbt_blocks"] == SMALL["blocks"] * 2 * plies
    assert profiling.counters["gpool_layers"] == 2 * plies


def _mean_for_max(monkeypatch):
    """The pooling's max replaced by a mean."""
    inner = nbt.pool_features

    def pool(a, third="max"):
        out = inner(a, third)
        if third == "max":
            C = a.shape[1]
            out = torch.cat((out[:, :2 * C], out[:, :C]), dim=1)
        return out

    monkeypatch.setattr(nbt, "pool_features", pool)


def _drop_the_inner_skip(monkeypatch):
    """The inner blocks' skip left out: each inner block's output alone."""
    inner = NbtPolicy._norm

    def norm(self, name, bn, y, skip, *rest):
        if name.endswith((".inner.1.a", ".post")):
            skip = None
        return inner(self, name, bn, y, skip, *rest)

    monkeypatch.setattr(NbtPolicy, "_norm", norm)


def _norm_then_add(monkeypatch):
    """Post-activation order where a skip closes: the conv's output
    normalized before the skip is added, not the stream."""
    inner = NbtPolicy._norm

    def norm(self, name, bn, y, skip, *rest):
        if skip is None:
            return inner(self, name, bn, y, skip, *rest)
        _, a = inner(self, name, bn, y, None, *rest)
        return y + skip, a

    monkeypatch.setattr(NbtPolicy, "_norm", norm)


@pytest.mark.parametrize("fault", ["nudge", _mean_for_max, _drop_the_inner_skip,
                                   _norm_then_add])
def test_a_planted_fault_fails_the_cell(fault, driver, small, tmp_path, monkeypatch):
    if fault != "nudge":
        fault(monkeypatch)
    ctx = cell_context(tmp_path, 2 ** 31 + 23)
    out = play_and_judge(ctx, driver, nudge=fault == "nudge")
    limit = ctx.workload["limits"]["logit_gap"]
    assert not harness.within(out["judged"]["logit_gap"], limit), out["judged"]
    if fault != "nudge":
        assert out["per_ply"][0] > limit


def test_the_driver_refuses_a_program_without_the_family(driver, tmp_path):
    ctx = cell_context(tmp_path, 1)
    ctx.config["model"]["name"] = "KataGo-NBT-absent"
    with pytest.raises(harness.HarnessError, match="cannot play this cell"):
        driver.run(ctx)


def test_the_trace_wraps_the_conv_and_the_epilogue(driver, tmp_path, monkeypatch):
    """``start`` wraps ``winograd.conv`` and ``cnn_epilogue.preact`` in bench
    spans; ``stop`` stops the profiler and unwraps both; the reduction
    waits for the first read of ``result``."""
    monkeypatch.setattr(driver._Trace, "_profile", staticmethod(
        lambda: torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])))
    conv, preact = winograd.conv, cnn_epilogue.preact
    trace = driver.match.harness.Trace(str(tmp_path), ["match"])
    assert driver._Trace.last is trace
    trace.start()
    assert winograd.conv is not conv and cnn_epilogue.preact is not preact
    with torch.profiler.record_function("bench.match"):
        torch.ones(64).sum()
    trace.stop()
    assert winograd.conv is conv and cnn_epilogue.preact is preact
    assert trace.prof is not None and trace._result is None
    red = trace.result
    assert red["calls"] == {"match": 1, driver.CONV_SPAN: 0, driver.PREACT_SPAN: 0}
    assert trace.prof is None and trace.result is red


def test_the_tournament_rates_katago_nbt_players(small, tmp_path):
    players = []
    for s in (1, 2):
        path = tmp_path / f"nbt_{s}.pt"
        policy = models.make_policy("KataGo-NBT", BOARD * BOARD,
                                    generator=torch.Generator().manual_seed(s))
        torch.save(policy.state_dict(), path)
        players.append(f"params:{path}")
    players.append("random")
    results, elo = run_tournament(players, board_size=BOARD, games=16, seed=4, device="cpu",
                                  family="KataGo-NBT")
    assert [(r["a"], r["b"]) for r in results] == [
        (players[0], players[1]), (players[0], players[2]), (players[1], players[2])]
    assert profiling.counters["nbt_blocks"] > 0
    want = match.run_match(BOARD, 16, players[0], players[2], seed=4 + 2,
                           family_a="KataGo-NBT", family_b="KataGo-NBT", device="cpu")
    assert results[1] == want
    assert elo[0] == 0.0 and len(elo) == 3


def test_the_work_count_takes_the_tower_alone():
    conf = harness.load_json(ROOT / CONFIG)
    assert work_nbt.model_of(conf) == shape_of(11, PUBLISHED)
    conf["model"]["family"] = "ResNet"
    with pytest.raises(ValueError, match="not the nested-bottleneck"):
        work_nbt.model_of(conf)


# -- the cell and its readers ------------------------------------------------------


NEW = ("nbt_conv_kernel_pct.match", "nbt_conv_roofline_pct.match", "preact_roofline_pct.match",
       "gpool_device_us.match")


def test_the_cell_finds_its_files_and_reports_its_metrics(monkeypatch):
    for key in ("USE_FLAX", "USE_JAX", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, "")  # recorded as it was, put back after
        monkeypatch.delenv(key)
    from benchmark import run

    man = harness.manifest(ROOT)
    cell = harness.entry(man["workloads"], CELL, "workload")
    conf_entry = harness.entry(man["configs"], cell["config"], "configuration")
    assert cell["chips"] == 1 and cell["traffic"] == "match400_argmax"
    assert conf_entry["reduced"] == [] and conf_entry["file"] == CONFIG
    conf = harness.load_json(ROOT / conf_entry["file"])
    assert conf["model"] == {"name": "KataGo-NBT", "family": "NBT", "board_size": 11,
                             **PUBLISHED}
    assert conf["precision"] == "float32, TF32 off" and conf["source"] == conf_entry["source"]
    wl = harness.load_json(harness.workload_file(CELL))
    assert (wl["driver"], wl["games"], wl["mode"], wl["trace_matches"], wl["check_matches"],
            wl["check_from"]) == ("match_nbt", 400, "deterministic", 2, 2, 4)
    assert wl["init"] == {"action_gain": 2.0, "bias_std": 0.1}
    assert wl["limits"]["gap"] == 1e-4 and wl["limits"]["winner_mismatch"] == 0
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", "games_per_s"}
    per_layer = {m["name"] for m in harness.cell_metrics(man, CELL, "per_layer")}
    assert per_layer == {"device_idle_pct.match", "mfu_pct.match", "host_syncs.match",
                         "h2d_bytes.match", "ply_us.match", "load_ms.match",
                         "forward_device_us.match", "pointwise_kernel_pct.match", *NEW}
    for name in (*NEW, "pointwise_kernel_pct.match"):
        assert harness.entry(man["per_layer"], name, "metric")["workloads"] == [CELL]
    for trace in ("0", "1"):
        args = run.parse(["--workload", CELL, "--seed", str(2 ** 31 + 1), "--seconds", "1",
                          "--trace", trace])
        _, _, got_wl, got_conf, got_driver, metrics, readers = run.prepare(args)
        assert got_wl == wl and got_conf == conf and hasattr(got_driver, "run")
        assert {m["name"] for m in metrics} == (per_layer if trace == "1" else e2e)
        assert all(hasattr(readers[m], "read") for m in readers)


def reader(name):
    return harness.load_module(harness.metric_file(name), "nbt11_" + name.replace(".", "_"))


def test_nbt_conv_kernel_pct_reads_the_share_of_3x3_convs_through_the_kernel(monkeypatch):
    read = reader("nbt_conv_kernel_pct.match").read
    match_r, train_r = harness.Readings(kind="match"), harness.Readings(kind="train")
    assert read(match_r) is None  # a program that counts no such blocks
    profiling.count("residual_blocks", 38)  # an AZ-ResNet's count does not stand in
    assert read(match_r) is None
    profiling.count("nbt_blocks", 36)  # two forwards of 18 blocks
    assert read(match_r) == 0.0  # the kernels never launched: 144 convs on cuDNN
    profiling.count("launch.winograd_conv", 72)
    assert read(match_r) == pytest.approx(50.0) and read(train_r) is None
    profiling.count("launch.winograd_conv", 72)
    assert read(match_r) == 100.0
    monkeypatch.setattr(cuda_lib, "KERNELS", tuple(k for k in cuda_lib.KERNELS
                                                   if k != "winograd_conv"))
    assert read(match_r) is None  # a program without the kernel
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "counters")
    assert read(match_r) is None


@pytest.mark.parametrize("name,span,least", [
    ("nbt_conv_roofline_pct.match", "conv.winograd",
     lambda m: work_nbt.conv_least_s(m, 400)),
    ("preact_roofline_pct.match", "epilogue.preact",
     lambda m: work_nbt.preact_least_s(m, 400)),
])
def test_a_roofline_reads_the_least_time_over_the_device_time(name, span, least):
    read = reader(name).read
    m = shape_of(11, PUBLISHED)
    r = harness.Readings(kind="match")
    assert read(r) is None  # an untraced run, or a program without the family
    calls = 2 * 244 * 72
    r.traced_calls[span] = calls
    r.device_s[span] = calls * 2 * least(m)
    assert read(r) is None  # no least time
    r.least_s[span] = least(m)
    assert read(r) == pytest.approx(50.0, rel=1e-12)
    r.device_s[span] = 0.0
    assert read(r) is None
    assert read(harness.Readings(kind="train")) is None


def test_the_least_times_count_what_the_kernels_run():
    """The conv: the Winograd products of the 3,600 tiles it needs (the
    kernel pads them to 3,712 rows, which the bound does not count), 36 x
    3,600 x 192 x 192 x 2 = 9.555 GFLOP, 142.6 us at 67 TFLOP/s, above its
    79.6 MB over 3.35 TB/s; 128 -> 192 two thirds of it; the epilogue:
    297.4 MB at 384 channels with a skip."""
    m = shape_of(11, PUBLISHED)
    assert work_nbt.tiles(400, 11) == 3600 and winograd.padded_rows(400, 11) == 3712
    full = 2.0 * 36 * 3600 * 192 * 192 / work.PEAK_FLOPS_FP32
    assert work_nbt.conv_least_s(m, 400) == pytest.approx((66 * full + 6 * full * 2 / 3) / 72)
    assert work_nbt.preact_bytes(400, 384, 11, 11, skip=True) == (4 * 400 * 384 * 121
                                                                   + 3 * 384) * 4
    assert work_nbt.preact_bytes(400, 128, 11, 11, board=True) == (2 * 400 * 128 * 121
                                                                    + 400 * 128 + 3 * 128) * 4


def test_gpool_device_us_reads_the_pooling_time_a_forward():
    read = reader("gpool_device_us.match").read
    r = harness.Readings(kind="match")
    assert read(r) is None
    r.program_spans = {"ply.forward": {"calls": 488, "device_ms": 488 * 30.0},
                       "forward.gpool": {"calls": 6 * 488, "device_ms": 488 * 0.12}}
    assert read(r) == pytest.approx(120.0)
    r.program_spans["forward.gpool"]["device_ms"] = None  # no device clock
    assert read(r) is None
    assert read(harness.Readings(kind="train")) is None


# -- the trainer ---------------------------------------------------------------------


def test_the_trainer_refuses_the_family():
    from hex_gym_env_tpu_torch.train import SelfplayPPO
    from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

    cfg = TrainConfig(ppo=PPOConfig(n_steps=4, minibatch_size=8),
                      selfplay=SelfplayConfig(board_size=3, n_envs=2, buffer_size=2,
                                              policy="KataGo-NBT"))
    with pytest.raises(ValueError, match="'KataGo-NBT' has no opponent-bank path"):
        SelfplayPPO(cfg, device="cpu")
    assert "policy_inits" not in profiling.counters


# -- the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.chip
@pytest.mark.parametrize("B,C,n", [(400, 384, 11), (401, 192, 11), (7, 64, 9), (3, 16, 5),
                                   (1, 4, 7)])
@pytest.mark.parametrize("case", ["plain", "skip", "board"])
def test_the_preact_kernel_is_its_twin_bit_for_bit(cuda_device, B, C, n, case):
    g = torch.Generator().manual_seed(B + C + n)
    bn = _bn(C, g).to(cuda_device)
    y = torch.randn((B, C, n, n), generator=g).to(cuda_device)
    skip = torch.randn((B, C, n, n), generator=g).to(cuda_device) if case == "skip" else None
    board = torch.randn((B, C), generator=g).to(cuda_device) if case == "board" else None
    y.view(-1)[:: 997] = float("nan")  # relu keeps torch.relu's NaN
    y.view(-1)[1:: 1009] = -0.0
    args = (bn.mean, bn.mul(bn.var), bn.bias)
    with torch.no_grad():
        want_s, want_a = cnn_epilogue.preact_twin(y, skip, *args, board)
        inplace = y.clone()
        s, a = cnn_epilogue.preact(inplace, skip, *args, board)
    torch.cuda.synchronize()
    assert s.data_ptr() == inplace.data_ptr() and a.is_contiguous()
    assert torch.equal(_bits(s), _bits(want_s)) and torch.equal(_bits(a), _bits(want_a))
    assert cuda_lib.launches["cnn_epilogue_preact"] == 1


@pytest.mark.chip
def test_the_preact_kernel_takes_the_pooled_slices(cuda_device):
    g = torch.Generator().manual_seed(11)
    y = torch.randn((400, 192, 11, 11), generator=g).to(cuda_device)
    for part, C in ((y[:, :128], 128), (y[:, 128:], 64)):
        bn = _bn(C, g).to(cuda_device)
        args = (bn.mean, bn.mul(bn.var), bn.bias)
        board = torch.randn((400, C), generator=g).to(cuda_device) if C == 128 else None
        want = cnn_epilogue.preact_twin(part.contiguous(), None, *args, board)[1]
        got = cnn_epilogue.preact(part, None, *args, board)[1]
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.chip
@pytest.mark.parametrize("cin,n,B", [(192, 11, 400), (128, 11, 400), (64, 7, 3), (192, 19, 5)])
def test_the_narrow_instance_is_the_wide_one_bit_for_bit(cuda_device, cin, n, B):
    """A conv of 192 outputs (the 64-column product) equals the first 192
    outputs of a conv of 256 (the 128-column product) whose first 192
    filters are its own, bit for bit; and within the twin's tolerance of
    float64 ``F.conv2d``."""
    g = torch.Generator().manual_seed(cin + n + B)
    x = torch.relu(torch.randn((B, cin, n, n), generator=g)).to(cuda_device)
    w = (torch.randn((256, cin, 3, 3), generator=g) * (2.0 / (9 * cin)) ** 0.5).to(cuda_device)
    narrow = winograd.conv(x, winograd.filter_image(w[:192]))
    wide = winograd.conv(x, winograd.filter_image(w))
    torch.cuda.synchronize()
    assert narrow.shape == (B, 192, n, n)
    assert torch.equal(_bits(narrow), _bits(wide[:, :192]))
    want = F.conv2d(x.double(), w[:192].double(), padding=1)
    err = narrow.double() - want
    assert float(err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()) < RMS_TOL
    assert float(err.abs().max() / want.abs().max()) < MAX_TOL


@pytest.mark.chip
def test_the_kept_factors_change_no_bit(cuda_device, driver):
    """The card's inference forward at the published widths on the factors
    ``bind`` kept, bit for bit the forward that computes them (115 times
    three small launches fewer)."""
    m = shape_of(11, PUBLISHED)
    params, _ = driver.make(m, 6, cuda_device, 2.0, 0.1, driver.match.AGENT_BN_STD)
    model = NbtPolicy(121, init=False, **PUBLISHED).to(cuda_device)
    model.bind(params)
    x = boards(11, 64, 4).to(cuda_device)
    with torch.no_grad():
        kept = model(x)
        model.factors = {}
        computed = model(x)
    assert torch.equal(kept[0], computed[0]) and torch.equal(kept[1], computed[1])


@pytest.mark.chip
@pytest.mark.parametrize("widths,n,B", [({}, 11, 400), (SMALL, 5, 33)])
def test_the_forward_with_and_without_the_kernels(cuda_device, driver, widths, n, B):
    """The card's inference forward through the epilogue, the Winograd
    kernels and the 1x1 conv's: 115 pre-activation launches, 72 Winograd
    conv launches and 36 1x1 conv launches a forward at the published widths
    (7 of 8 3x3 convs and all 4 1x1 convs at SMALL's); with the images
    dropped, bit for bit the eager forward (grad on); with them within the
    cell's ``logit_gap`` limit of it."""
    widths = {**PUBLISHED, **widths}
    m = shape_of(n, widths)
    params, _ = driver.make(m, 5, cuda_device, 2.0, 0.1, driver.match.AGENT_BN_STD)
    model = NbtPolicy(n * n, init=False, **widths).to(cuda_device)
    model.bind(params)
    layers = model.convs3x3()
    taken = sum(layer.image is not None for layer in layers)
    # every 3x3 conv at the published widths; at SMALL's each pooled block's
    # 32 -> 64 stays on F.conv2d
    pooled = sum(block.inner[0].g is not None for block in model.blocks)
    assert taken == len(layers) - (pooled if (widths["mid"] - widths["gpool"]) % 64 else 0)
    x = boards(n, B, 3).to(cuda_device)
    with torch.no_grad():
        through = model(x)
    assert cuda_lib.launches["winograd_conv"] == taken
    assert cuda_lib.launches["pointwise_conv"] == 2 * widths["blocks"]
    assert cuda_lib.launches["cnn_epilogue_preact"] == len(work_nbt.preacts(m))
    imaged = layers + model.convs1x1()
    assert all(layer.image is not None for layer in model.convs1x1())
    images = [layer.image for layer in imaged]
    for layer in imaged:
        layer.image = None
    with torch.no_grad():
        held = model(x)
    for layer, image in zip(imaged, images):
        layer.image = image
    assert cuda_lib.launches["pointwise_conv"] == 2 * widths["blocks"]
    model.requires_grad_(True)
    eager = model(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches["cnn_epilogue_preact"] == 2 * len(work_nbt.preacts(m))
    limit = harness.load_json(harness.workload_file(CELL))["limits"]["logit_gap"]
    for h, w, e in zip(held, through, eager):
        assert torch.equal(h, e.detach())
        assert float((w - e.detach()).abs().max()) < limit
    assert float(held[0].abs().max()) > 0.5
