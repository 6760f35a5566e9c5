"""The AlphaZero residual tower (``models/resnet.py``, family ``AZ-ResNet``)
and its benchmark cell, ``az11-match-det``.

On the CPU: the module against the benchmark's plain reference
(``benchmark/reference/resnet.py``) on seeded weights drawn as the cell's
driver draws them, BatchNorm calibrated and moved; the template's names
and shapes at the published widths; the epilogue's skip operand (its twin
bit for bit the eager chain, the wrapper's refusals); the forward through
the twin; ``run_match`` between two ``params:`` agents judged by the
cell's driver, sound and with two planted faults; a tournament of the
family; the cell's files and metrics; the two new readers; the trainer's refusal.  The family is
registered smaller where a test plays it (16 filters, 2 blocks at 5x5).

On the card (the ``chip`` marker; run there with ``python -m pytest
tests/test_torch_resnet.py -m chip --noconftest``): the residual launch
against its twin bit for bit, and the forward with and without the kernel
(the convs held on one path), and with the Winograd conv.
"""

import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, weights, work, work_resnet
from benchmark.reference import resnet as ref_resnet
from hex_gym_env_tpu_torch import models
from hex_gym_env_tpu_torch.models import cnn, policy_template
from hex_gym_env_tpu_torch.models.resnet import ResNetPolicy
from hex_gym_env_tpu_torch.ops import cnn_epilogue, cuda_lib
from hex_gym_env_tpu_torch.scripts import match
from hex_gym_env_tpu_torch.scripts.tournament import run_tournament
from hex_gym_env_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "az11-match-det"
SMALL = {"filters": 16, "blocks": 2, "value_hidden": 32}
BOARD, GAMES = 5, 64
# The module and the reference run the same float32 ops on the CPU, up to the
# order of the sums inside the convs and the dense layers, which each build
# may choose otherwise; through five conv layers and the heads that is a
# few ulps of logits of a few units: ~1e-6 expected.  1e-5 leaves ten times
# that, and stays a hundred times below the cell's limit on the card.
TOL = 1e-5


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
    return harness.load_module(harness.driver_file("match_resnet"), "test_resnet_match_driver")


@pytest.fixture
def small(monkeypatch):
    """The family registered at ``SMALL``'s widths."""
    monkeypatch.setitem(models._FAMILIES, "AZ-ResNet", (ResNetPolicy, SMALL))


def cell_context(tmp_path, seed: int, board: int = BOARD, **model) -> harness.Context:
    """The cell's workload and configuration, at ``board`` and ``GAMES`` and
    with ``model``'s widths (``SMALL``'s by default)."""
    man = harness.manifest(ROOT)
    entry = harness.entry(man["workloads"], CELL, "workload")
    conf = harness.load_json(ROOT / harness.entry(man["configs"], entry["config"],
                                                  "configuration")["file"])
    conf["model"].update(board_size=board, **(model or SMALL))
    wl = {**harness.load_json(harness.workload_file(CELL)), "games": GAMES}
    return harness.Context(name=CELL, workload=wl, config=conf, seed=seed, seconds=0.0,
                           trace=False, t0=time.perf_counter(), device=torch.device("cpu"),
                           run_dir=str(tmp_path))


def drawn(driver, seed: int, board: int = BOARD):
    """The driver's agent weights (BatchNorm calibrated and moved) and the
    module of ``SMALL``'s widths holding them."""
    m = work_resnet.ResNet("ResNet", board, SMALL["filters"], SMALL["blocks"],
                           SMALL["value_hidden"])
    params, trained = driver.make(m, seed, torch.device("cpu"), 2.0, 0.1,
                                  driver.match.AGENT_BN_STD)
    model = ResNetPolicy(board * board, init=False, **SMALL)
    model.bind(params)
    return m, params, trained, model


def boards(n: int, B: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-1, 2, (B, n, n), generator=g).to(torch.float32)


# -- the module against the reference ---------------------------------------------


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 11])
def test_the_module_is_the_reference(seed, driver):
    m, params, _, model = drawn(driver, seed)
    x = boards(BOARD, 32, seed)
    with torch.no_grad():
        logits, value = model(x)
        want_logits, want_value = ref_resnet.forward(params, x, SMALL["blocks"])
        only = ref_resnet.policy_logits(params, x, SMALL["blocks"])
    assert logits.shape == (32, 25) and value.shape == (32,)
    torch.testing.assert_close(logits, want_logits, atol=TOL, rtol=0)
    torch.testing.assert_close(value, want_value, atol=TOL, rtol=0)
    assert torch.equal(only, want_logits)
    # logits of a trained agent's size, values inside tanh's range
    assert 0.3 < float(logits.std()) < 10.0 and float(value.abs().max()) < 1.0


def test_train_mode_returns_the_reference_statistics(driver):
    _, params, trained, model = drawn(driver, 3)
    x = boards(BOARD, 16, 4)
    logits, value, stats = model(x, train=True)
    want_logits, want_value, want_stats = ref_resnet.forward(params, x, SMALL["blocks"],
                                                             train=True)
    torch.testing.assert_close(logits, want_logits, atol=TOL, rtol=0)
    torch.testing.assert_close(value, want_value, atol=TOL, rtol=0)
    assert sorted(stats) == sorted(want_stats) == sorted(
        k for k in model.state_dict() if k.endswith((".bn.mean", ".bn.var")))
    for k in stats:
        torch.testing.assert_close(stats[k], want_stats[k], atol=TOL, rtol=1e-5)
    assert set(trained) | set(stats) == set(model.state_dict())


def test_the_draw_calibrates_and_moves_batch_norm(driver):
    """The drawn statistics sit near each layer's batch statistics and off
    BatchNorm's start values, so a program that ignored them would differ."""
    _, params, _, _ = drawn(driver, 9)
    for name in ("conv_in", "blocks.0.a", "blocks.1.b", "policy", "value"):
        assert float(params[f"{name}.bn.mean"].abs().max()) > 0.05
        assert float((params[f"{name}.bn.var"] - 1).abs().max()) > 0.05
    again = drawn(driver, 9)[1]
    assert all(torch.equal(params[k], again[k]) for k in params)


# -- the template at the published widths -------------------------------------------


def test_the_template_at_the_published_widths(driver):
    model = policy_template("AZ-ResNet", 121)
    sd = model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    assert len(model.blocks) == 19 and model.filters == 256 and model.value_hidden == 256
    assert shapes["conv_in.conv.weight"] == (256, 1, 3, 3)
    for i in range(19):
        for half in "ab":
            assert shapes[f"blocks.{i}.{half}.conv.weight"] == (256, 256, 3, 3)
            for stat in ("scale", "bias", "mean", "var"):
                assert shapes[f"blocks.{i}.{half}.bn.{stat}"] == (256,)
    assert shapes["policy.conv.weight"] == (2, 256, 1, 1)
    assert shapes["action_head.weight"] == (121, 242) and shapes["action_head.bias"] == (121,)
    assert shapes["value.conv.weight"] == (1, 256, 1, 1)
    assert shapes["value_fc.weight"] == (256, 121) and shapes["value_head.weight"] == (1, 256)
    assert not any(k.endswith("conv.bias") for k in sd)  # BatchNorm follows every conv
    assert all(float(v.abs().max()) == float(k.endswith((".scale", ".var"))) for k, v in sd.items())
    m = work_resnet.model_of(harness.load_json(
        ROOT / "benchmark/configs/AZ-ResNet-20x256-11x11.json"))
    assert work_resnet.param_count(m) == sum(v.numel() for v in sd.values())
    assert driver.layout(m, 2.0, 0.1)[0] == shapes  # the driver's agents fit the loader
    assert work_resnet.policy_flops(m) == 5_424_761_540
    assert work_resnet.residual_bytes(400, 256, 11, 11) == 148_687_872


def test_make_policy_initialises_with_sb3_gains():
    g = torch.Generator().manual_seed(0)
    model = models.make_policy("AZ-ResNet", 9, generator=g)
    assert profiling.counters.get("policy_inits") == 1
    w = model.blocks[0].a.conv.weight.reshape(256, -1)
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(256), atol=1e-4, rtol=0)
    head = model.action_head.weight
    torch.testing.assert_close(head @ head.T, 1e-4 * torch.eye(9), atol=1e-7, rtol=0)
    assert float(model.action_head.bias.detach().abs().max()) == 0.0


# -- the epilogue's skip operand ---------------------------------------------------


def _layer(C: int, g):
    layer = cnn.BatchNorm(C)
    with torch.no_grad():
        noise = torch.randn((4, C), generator=g) * 0.1
        layer.scale.copy_(1.0 + noise[0])
        layer.bias.copy_(noise[1])
        layer.mean.copy_(noise[2])
        layer.var.copy_(noise[3].exp())
    return layer


@pytest.mark.parametrize("shape", [(1, 16, 5, 5), (7, 64, 9, 9), (3, 256, 11, 11)])
def test_the_residual_twin_is_the_eager_chain_bit_for_bit(shape):
    g = torch.Generator().manual_seed(sum(shape))
    bn = _layer(shape[1], g)
    y, skip = torch.randn(shape, generator=g), torch.relu(torch.randn(shape, generator=g))
    with torch.no_grad():
        eager, _, _ = bn(y, False)
        want = torch.relu(eager + skip)
        args = (bn.mean, bn.mul(bn.var), bn.bias)
        got = cnn_epilogue.epilogue_twin(y, None, *args, skip=skip)
        assert torch.equal(got, want)
        assert torch.equal(cnn_epilogue.residual(y, *args, skip), want)  # the CPU's
        plain = torch.relu(eager)
        assert torch.equal(cnn_epilogue.epilogue(y, None, *args), plain)
    assert float(want.min()) == 0.0 and float(want.max()) > 1.0


def _skip_case(case: str):
    y = torch.randn((2, 4, 3, 3))
    skip = torch.randn((2, 4, 3, 3))
    if case == "shape":
        skip = torch.randn((2, 4, 3, 4))
    elif case == "dtype":
        skip = skip.double()
    elif case == "device":
        skip = torch.empty(skip.shape, device="meta")
    elif case == "strided":
        skip = skip.transpose(2, 3)
    elif case == "unaligned":
        skip = torch.empty(skip.numel() + 1)[1:].view(skip.shape).copy_(skip)
    return y, skip


@pytest.mark.parametrize("case,message", [
    ("shape", r"skip must have y's shape \(2, 4, 3, 3\), got \(2, 4, 3, 4\)"),
    ("dtype", "skip must be torch.float32"), ("device", "skip lies on meta, y on cpu"),
    ("strided", "skip must be contiguous"), ("unaligned", "skip must be 16-byte aligned"),
])
def test_the_wrapper_refuses_a_skip_the_kernel_does_not_take(case, message):
    y, skip = _skip_case(case)
    vec = {k: torch.randn(4) for k in ("mean", "mul", "bn_bias")}
    with pytest.raises(ValueError, match=message):
        cnn_epilogue.residual(y, skip=skip, **vec)


def test_the_wrapper_refuses_an_hwc_launch_without_a_bias():
    y = torch.randn((2, 4, 3, 3))
    vec = {k: torch.randn(4) for k in ("mean", "mul", "bn_bias")}
    with pytest.raises(ValueError, match=r"the \(H, W, C\) launch takes a conv bias"):
        cnn_epilogue.epilogue(y, None, **vec, hwc=True)
    got = cnn_epilogue.epilogue(y, torch.randn(4), **vec, hwc=True)
    assert got.permute(0, 2, 3, 1).is_contiguous()


@pytest.mark.parametrize("case", ["train", "grad", "cpu"])
def test_the_rule_sends_each_case_to_the_eager_chain(case, driver, monkeypatch):
    """The rule is the CNN's (``CnnPolicy._fuses``: inference, float32 on the
    card, grad off); on the CPU a training call, a call with grad and one
    without call no epilogue, and count a block each."""
    assert ResNetPolicy._fuses is cnn.CnnPolicy._fuses
    _, _, _, model = drawn(driver, 5)
    x = boards(BOARD, 4, 6)
    calls = []
    monkeypatch.setattr(cnn_epilogue, "epilogue", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(cnn_epilogue, "residual", lambda *a, **k: calls.append(a))
    if case == "train":
        model(x, train=True)
    elif case == "grad":
        model(x)
    else:
        with torch.no_grad():
            model(x)
    assert calls == [] and cuda_lib.launches["cnn_epilogue_residual"] == 0
    assert profiling.counters["residual_blocks"] == SMALL["blocks"]


def test_the_fused_forward_through_the_twin_is_the_eager_forward(driver, monkeypatch):
    """The rule forced on the CPU, so the twin stands in for the kernel:
    1 + 2 x blocks epilogues a forward, a block's second with the block's
    input as its skip, and the eager forward's logits and values bit for
    bit (the same ops in the same order)."""
    _, _, _, model = drawn(driver, 7)
    x = boards(BOARD, 8, 8)
    with torch.no_grad():
        want = model(x)
    calls = []
    plain, residual = cnn_epilogue.epilogue, cnn_epilogue.residual

    def spy_plain(y, conv_bias, *args, **kwargs):
        calls.append(("plain", conv_bias))
        return plain(y, conv_bias, *args, **kwargs)

    def spy_residual(y, mean, mul, bn_bias, skip):
        calls.append(("residual", skip.shape))
        return residual(y, mean, mul, bn_bias, skip)

    monkeypatch.setattr(cnn_epilogue, "epilogue", spy_plain)
    monkeypatch.setattr(cnn_epilogue, "residual", spy_residual)
    monkeypatch.setattr(ResNetPolicy, "_fuses", lambda self, x, train: not train)
    with torch.no_grad():
        got = model(x)
    C = SMALL["filters"]
    assert calls == [("plain", None)] + [("plain", None), ("residual", (8, C, 5, 5))] * 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the match and its judge ---------------------------------------------------------


def play_and_judge(ctx, driver) -> dict:
    """One recorded match of the cell's agents through ``run_match``, judged
    by the cell's driver against the reference."""
    model = driver.match.work.model_of(ctx.config)
    family, mode = ctx.config["model"]["name"], ctx.workload["mode"]
    (wa, spec_a), (wb, spec_b) = driver.make_agents(ctx, model)
    rec = {}
    with driver.logit_tap() as taps:
        match.run_match(model.board, GAMES, spec_a, spec_b, mode=mode, family_a=family,
                        family_b=family, device="cpu", record=rec)
    ref = driver.replay(wa, wb, model, mode, GAMES, None, rec["actions"], taps)
    per_ply = [max(float((taps[side][t].double() - ref["logits"][side][t].double())
                         .abs().max()) for side in (0, 1))
               for t in range(model.cells + 1)]
    judged = driver.judge(wa, wb, model, mode, GAMES, None, rec["actions"], rec["winners"],
                          taps)
    return {"judged": judged, "winners": (rec["winners"].long(), ref["winners"]),
            "per_ply": per_ply}


@pytest.mark.parametrize("seed", [2 ** 31 + 23, 5])
def test_the_match_agrees_with_the_reference(seed, driver, small, tmp_path):
    ctx = cell_context(tmp_path, seed)
    out = play_and_judge(ctx, driver)
    got, want = out["winners"]
    assert torch.equal(got, want)
    assert max(out["per_ply"]) < TOL, out["per_ply"]
    assert max(out["per_ply"]) == out["judged"]["logit_gap"]
    limits = ctx.workload["limits"]
    assert out["judged"]["winner_mismatch"] == 0
    assert all(harness.within(v, limits[k]) for k, v in out["judged"].items()), out["judged"]
    assert profiling.counters["residual_blocks"] == (
        SMALL["blocks"] * 2 * (BOARD * BOARD + 1))


def _drop_the_skip(monkeypatch):
    """A block's second layer without its skip (the plain ReLU chain)."""
    inner = ResNetPolicy._layer

    def layer(name, layer_, x, fused, train, new_stats, skip=None):
        return inner(name, layer_, x, fused, train, new_stats)

    monkeypatch.setattr(ResNetPolicy, "_layer", staticmethod(layer))


def _ignore_the_statistics(monkeypatch):
    """BatchNorm at inference with mean 0 and variance 1."""
    inner = cnn.BatchNorm.forward

    def forward(self, x, train):
        if train:
            return inner(self, x, train)
        mul = torch.rsqrt(torch.ones_like(self.var) + cnn.BN_EPS) * self.scale
        return x * mul[:, None, None] + self.bias[:, None, None], None, None

    monkeypatch.setattr(cnn.BatchNorm, "forward", forward)


@pytest.mark.parametrize("fault", [_drop_the_skip, _ignore_the_statistics])
def test_a_planted_fault_fails_the_cell(fault, driver, small, tmp_path, monkeypatch):
    fault(monkeypatch)
    ctx = cell_context(tmp_path, 2 ** 31 + 23)
    out = play_and_judge(ctx, driver)
    limit = ctx.workload["limits"]["logit_gap"]
    assert out["per_ply"][0] > limit
    assert not harness.within(out["judged"]["logit_gap"], limit), out["judged"]


def test_the_driver_refuses_a_program_without_the_family(driver, tmp_path):
    ctx = cell_context(tmp_path, 1)
    ctx.config["model"]["name"] = "AZ-ResNet-absent"
    with pytest.raises(harness.HarnessError, match="cannot play this cell"):
        driver.run(ctx)


def test_the_trace_reduces_the_profiled_matches_after_the_window(driver, tmp_path,
                                                                 monkeypatch):
    """``stop`` stops the profiler and unwraps the residual entry; the
    reduction waits for the first read of ``result``."""
    monkeypatch.setattr(driver._Trace, "_profile", staticmethod(
        lambda: torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])))
    residual = cnn_epilogue.residual
    trace = driver.match.harness.Trace(str(tmp_path), ["match"])
    assert driver._Trace.last is trace
    trace.start()
    assert cnn_epilogue.residual is not residual  # the bench span's wrap
    with torch.profiler.record_function("bench.match"):
        torch.ones(64).sum()
    trace.stop()
    assert cnn_epilogue.residual is residual
    assert trace.prof is not None and trace._result is None
    assert trace.after_stop(time.perf_counter())
    trace.stop()  # the window's end stops it again: nothing more
    red = trace.result
    assert red["calls"] == {"match": 1, driver.SPAN: 0} and red["window_s"] > 0.0
    assert trace.prof is None and trace.result is red


def test_the_tournament_rates_az_resnet_players(small, tmp_path):
    """Two ``params:`` AZ-ResNet players and the random one: each pair is
    ``run_match`` of the family, seeded as the tournament seeds it."""
    players = []
    for s in (1, 2):
        path = tmp_path / f"az_{s}.pt"
        policy = models.make_policy("AZ-ResNet", BOARD * BOARD,
                                    generator=torch.Generator().manual_seed(s))
        torch.save(policy.state_dict(), path)
        players.append(f"params:{path}")
    players.append("random")
    results, elo = run_tournament(players, board_size=BOARD, games=32, seed=4, device="cpu",
                                  family="AZ-ResNet")
    assert [(r["a"], r["b"]) for r in results] == [
        (players[0], players[1]), (players[0], players[2]), (players[1], players[2])]
    assert profiling.counters["residual_blocks"] > 0
    want = match.run_match(BOARD, 32, players[0], players[2], seed=4 + 2, family_a="AZ-ResNet",
                           family_b="AZ-ResNet", device="cpu")
    assert results[1] == want
    assert elo[0] == 0.0 and len(elo) == 3


def test_the_driver_draws_other_families_as_the_match_driver(driver):
    m = work.Model(family="MLP", board=5, hidden=(8, 8))
    want, want_trained = weights.make(m, 3, torch.device("cpu"), 2.0, 0.1)
    got, trained = driver.make(m, 3, torch.device("cpu"), 2.0, 0.1)
    assert trained == want_trained and all(torch.equal(got[k], want[k]) for k in want)


# -- the cell and its readers ------------------------------------------------------


def test_the_cell_finds_its_files_and_reports_its_metrics(monkeypatch):
    # importing the run sets these for its own process: keep them out of
    # the processes later tests start
    for key in ("USE_FLAX", "USE_JAX", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, "")  # recorded as it was, put back after
        monkeypatch.delenv(key)
    from benchmark import run

    man = harness.manifest(ROOT)
    cell = harness.entry(man["workloads"], CELL, "workload")
    conf_entry = harness.entry(man["configs"], cell["config"], "configuration")
    assert cell["chips"] == 1 and conf_entry["reduced"] == []
    conf = harness.load_json(ROOT / conf_entry["file"])
    assert conf["model"] == {"name": "AZ-ResNet", "family": "ResNet", "board_size": 11,
                             "filters": 256, "blocks": 19, "value_hidden": 256}
    assert conf["precision"] == "float32, TF32 off" and conf["source"] == conf_entry["source"]
    wl = harness.load_json(harness.workload_file(CELL))
    assert (wl["driver"], wl["games"], wl["mode"], wl["trace_matches"], wl["check_matches"],
            wl["check_from"]) == ("match_resnet", 400, "deterministic", 2, 2, 4)
    assert wl["init"] == {"action_gain": 2.0, "bias_std": 0.1}
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", "games_per_s"}
    per_layer = {m["name"] for m in harness.cell_metrics(man, CELL, "per_layer")}
    assert per_layer == {"device_idle_pct.match", "mfu_pct.match", "host_syncs.match",
                         "h2d_bytes.match", "ply_us.match", "load_ms.match",
                         "forward_device_us.match", "norm_device_us.match",
                         "forward_flop_pct.match", "residual_kernel_pct.match",
                         "residual_roofline_pct.match", "conv_kernel_pct.match"}
    for name in ("residual_kernel_pct.match", "residual_roofline_pct.match",
                 "conv_kernel_pct.match"):
        assert harness.entry(man["per_layer"], name, "metric")["workloads"] == [CELL]
    for trace in ("0", "1"):
        args = run.parse(["--workload", CELL, "--seed", str(2 ** 31 + 1), "--seconds", "1",
                          "--trace", trace])
        _, _, got_wl, got_conf, got_driver, metrics, readers = run.prepare(args)
        assert got_wl == wl and got_conf == conf and hasattr(got_driver, "run")
        assert {m["name"] for m in metrics} == (per_layer if trace == "1" else e2e)
        assert all(hasattr(readers[m], "read") for m in readers)


def reader(name):
    return harness.load_module(harness.metric_file(name), "az11_" + name.replace(".", "_"))


def test_residual_kernel_pct_reads_the_share_of_blocks_through_the_kernel(monkeypatch):
    read = reader("residual_kernel_pct.match").read
    match_r, train_r = harness.Readings(kind="match"), harness.Readings(kind="train")
    assert read(match_r) is None  # a program that counts no residual blocks
    profiling.count("residual_blocks", 38)  # two forwards of 19 blocks
    assert read(match_r) is None  # nor forwards
    profiling.count("forwards", 2)
    assert read(match_r) == 0.0  # a program without the kernel: 78 layers on the eager chain
    profiling.count("launch.cnn_epilogue", 40)  # the input blocks and each block's first layer
    assert read(match_r) == pytest.approx(100.0 * 40 / 78) and read(train_r) is None
    profiling.count("launch.cnn_epilogue_residual", 19)
    assert read(match_r) == pytest.approx(100.0 * 59 / 78)
    profiling.count("launch.cnn_epilogue_residual", 19)
    assert read(match_r) == 100.0
    monkeypatch.delattr(profiling, "counters")
    assert read(match_r) is None


def test_conv_kernel_pct_reads_the_share_of_block_convs_through_the_kernel(monkeypatch):
    read = reader("conv_kernel_pct.match").read
    match_r, train_r = harness.Readings(kind="match"), harness.Readings(kind="train")
    assert read(match_r) is None  # a program that counts no residual blocks
    profiling.count("residual_blocks", 38)  # two forwards of 19 blocks
    assert read(match_r) == 0.0  # the kernels never launched: 76 convs on cuDNN
    profiling.count("launch.winograd_conv", 38)
    assert read(match_r) == pytest.approx(50.0) and read(train_r) is None
    profiling.count("launch.winograd_conv", 38)
    assert read(match_r) == 100.0
    monkeypatch.setattr(cuda_lib, "KERNELS", tuple(k for k in cuda_lib.KERNELS
                                                   if k != "winograd_conv"))
    assert read(match_r) is None  # a program without the kernel
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "counters")
    assert read(match_r) is None


def test_residual_roofline_pct_reads_the_least_time_over_the_device_time():
    read = reader("residual_roofline_pct.match").read
    least = work.least_seconds(0.0, work_resnet.residual_bytes(400, 256, 11, 11))
    r = harness.Readings(kind="match")
    assert read(r) is None  # an untraced run, or a program without the entry
    calls = 2 * 244 * 19
    r.traced_calls["epilogue.residual"] = calls
    r.device_s["epilogue.residual"] = calls * 55e-6
    assert read(r) is None  # no least time
    r.least_s["epilogue.residual"] = least
    assert read(r) == pytest.approx(100.0 * least / 55e-6, rel=1e-12)
    assert 80.0 < read(r) < 81.0  # 44.38 us over 55 us
    r.device_s["epilogue.residual"] = 0.0
    assert read(r) is None
    assert read(harness.Readings(kind="train")) is None


# -- the trainer ---------------------------------------------------------------------


def test_the_trainer_refuses_a_family_without_a_bank_path():
    from hex_gym_env_tpu_torch.train import SelfplayPPO
    from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

    cfg = TrainConfig(ppo=PPOConfig(n_steps=4, minibatch_size=8),
                      selfplay=SelfplayConfig(board_size=3, n_envs=2, buffer_size=2,
                                              policy="AZ-ResNet"))
    with pytest.raises(ValueError, match="'AZ-ResNet' has no opponent-bank path"):
        SelfplayPPO(cfg, device="cpu")
    assert "policy_inits" not in profiling.counters  # refused before any module is built


# -- the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.chip
@pytest.mark.parametrize("B,C,n", [(400, 256, 11), (401, 256, 11), (7, 64, 9), (3, 16, 5),
                                   (1, 4, 7)])
def test_the_residual_kernel_is_its_twin_bit_for_bit(cuda_device, B, C, n):
    g = torch.Generator().manual_seed(B + C + n)
    bn = _layer(C, g).to(cuda_device)
    y = torch.randn((B, C, n, n), generator=g).to(cuda_device)
    skip = torch.relu(torch.randn((B, C, n, n), generator=g)).to(cuda_device)
    y.view(-1)[:: 997] = float("nan")  # relu keeps torch.relu's NaN
    y.view(-1)[1:: 1009] = -0.0
    args = (bn.mean, bn.mul(bn.var), bn.bias)
    with torch.no_grad():
        eager, _, _ = bn(y, False)
        want = torch.relu(eager + skip)
        assert torch.equal(_bits(cnn_epilogue.epilogue_twin(y, None, *args, skip=skip)),
                           _bits(want))
        plain = cnn_epilogue.epilogue(y.clone(), None, *args)
        inplace = y.clone()
        got = cnn_epilogue.residual(inplace, *args, skip)
    torch.cuda.synchronize()
    assert got.data_ptr() == inplace.data_ptr()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(plain), _bits(torch.relu(eager)))
    assert cuda_lib.launches["cnn_epilogue_residual"] == 1
    assert cuda_lib.launches["cnn_epilogue"] == 1


@pytest.mark.chip
@pytest.mark.parametrize("case", ["hwc without a bias", "hwc with a skip", "bias with a skip"])
def test_the_entry_refuses_an_instance_nothing_launches(cuda_device, case):
    """The C entry builds the four instances the CNN and the tower launch,
    and refuses the others' arguments before any launch."""
    y, skip = (torch.randn((2, 4, 3, 4), device=cuda_device) for _ in range(2))
    vec = [torch.randn(4, device=cuda_device) for _ in range(4)]  # conv bias, mean, mul, bias
    out = torch.empty((2, 3, 4, 4), device=cuda_device)
    bias = None if case == "hwc without a bias" else vec[0]
    with pytest.raises(RuntimeError, match="hex_cnn_epilogue launch failed"):
        cuda_lib.launch("cnn_epilogue", "hex_cnn_epilogue", y.data_ptr(), cuda_lib.ptr(bias),
                        *(v.data_ptr() for v in vec[1:]),
                        None if case == "hwc without a bias" else skip.data_ptr(),
                        out.data_ptr(), 2, 4, 12, int(case != "bias with a skip"))
    assert cuda_lib.launches["cnn_epilogue"] == 0


@pytest.mark.chip
@pytest.mark.parametrize("widths,n,B", [({}, 11, 400), (SMALL, 5, 33)])
def test_the_forward_with_and_without_the_kernel_is_bit_for_bit(cuda_device, driver, widths,
                                                                  n, B):
    """The card's inference forward through the epilogue kernel, and on the
    eager chain by the grad rule, with every conv held on ``F.conv2d`` (the
    filter images dropped): equal logits and values; 1 + blocks plain
    launches and blocks residual launches a forward, none on the eager.
    With the images (the tower's convs at 256 filters through the Winograd
    kernels, 2 x blocks launches; none at 16 filters) the logits stay within
    the cell's ``logit_gap`` limit (1e-3) of the eager forward's."""
    widths = {**{"filters": 256, "blocks": 19, "value_hidden": 256}, **widths}
    m = work_resnet.ResNet("ResNet", n, widths["filters"], widths["blocks"],
                           widths["value_hidden"])
    params, _ = driver.make(m, 5, cuda_device, 2.0, 0.1, driver.match.AGENT_BN_STD)
    model = ResNetPolicy(n * n, init=False, **widths).to(cuda_device)
    model.bind(params)
    layers = [model.conv_in] + [h for b in model.blocks for h in (b.a, b.b)]
    images = [layer.image for layer in layers]
    for layer in layers:
        layer.image = None
    x = boards(n, B, 3).to(cuda_device)
    with torch.no_grad():
        fused = model(x)
    blocks = widths["blocks"]
    assert cuda_lib.launches["cnn_epilogue"] == 1 + blocks
    assert cuda_lib.launches["cnn_epilogue_residual"] == blocks
    assert cuda_lib.launches["winograd_conv"] == 0
    for layer, image in zip(layers, images):
        layer.image = image
    with torch.no_grad():
        through = model(x)
    convs = 2 * blocks if widths["filters"] == 256 else 0
    assert cuda_lib.launches["winograd_conv"] == convs
    model.requires_grad_(True)
    eager = model(x)
    torch.cuda.synchronize()
    assert cuda_lib.launches["cnn_epilogue_residual"] == 2 * blocks
    for f, e in zip(fused, eager):
        assert torch.equal(f, e.detach())
    for w, e in zip(through, eager):
        assert float((w - e.detach()).abs().max()) < 1e-3
    assert float(fused[0].abs().max()) > 0.5
