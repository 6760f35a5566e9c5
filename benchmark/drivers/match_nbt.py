"""Driver of the nested-bottleneck tower's match cells: ``drivers/match.py``,
the one match judge, loaded as a module instance of its own and given the
tower's family, as ``drivers/match_resnet.py`` gives it AZ-ResNet's.

The instance's ``work`` is ``work_nbt`` (the tower's shape and operations),
its ``weights`` draws the tower's agents (``make``), and its ``ref_models``
judges with ``reference/nbt.py``; ``run``, ``replay``, ``judge`` and
``control`` are the instance's, so every family meets the same judge.  It
draws and judges the tower alone.  A match of 400 11x11 games takes ~11
s, profiled or not; stopping the profiler after the cell's two profiled
matches (``trace_matches``) takes ~12 s of the window, which leaves one
clean match in it.  The instance plays ``SPAN_MATCHES`` = 2 matches inside
the program's tracing, and its trace reduces the profiled matches after
the window (``_Trace``).

The weights' draw.  Each conv normal with std sqrt(2) / sqrt(fan in) (the
policy's last conv ``action_gain`` / sqrt(fan in)), the pooled blocks' and
the policy head's dense maps sqrt(2) / sqrt(fan in), the value head's
layers as ``weights.make`` draws a tower's (sqrt(2), then 1, biases
``bias_std``).  BatchNorm's scale and bias are drawn as 1 + N(0, s) and
N(0, s); its running statistics are calibrated on ``CALIBRATION`` seeded
positions, as training leaves them (each BatchNorm's input's batch mean
and biased variance, those before it already calibrated), and then moved
by the match driver's ``AGENT_BN_STD``, as ``match_resnet`` moves them:
the mean by N(0, s) of the channel's standard deviation, the variance by a
factor exp(N(0, s)).  Uncalibrated, the stream would grow block by block
and the logits would be far from a trained agent's.

In a traced run the profiled matches also hold two bench spans: around
each call of the program's Winograd conv (``ops/winograd.conv``), for
``nbt_conv_roofline_pct.match``, and around each call of its
pre-activation epilogue (``ops/cnn_epilogue.preact``), for
``preact_roofline_pct.match``: a call's least time (``work_nbt``) over the
device time of the kernels launched inside.  A program without the family
fails the run at once.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness, weights, work_nbt
from benchmark.reference import models as ref_models
from benchmark.reference import nbt as ref_nbt

CONV_SPAN = "conv.winograd"
PREACT_SPAN = "epilogue.preact"
CALIBRATION = 400  # seeded positions that BatchNorm's statistics are calibrated on

resnet = harness.load_module(harness.driver_file("match_resnet"), "bench_driver_resnet_of_nbt")
positions = resnet.positions


# -- the weights -------------------------------------------------------------------


def layout(m, action_gain: float, bias_std: float = 0.0):
    """``(shapes, scales, zero, ones, norms)`` of the tower's parameters
    under the program's state-dict names, as the module docstring draws
    them: BatchNorm at its start values (``zero`` and ``ones``), ``norms``
    the BatchNorms' names in the forward's order."""
    T, M, G = m.trunk, m.mid, m.gpool
    shapes, scales, zero, ones, norms = {}, {}, [], [], []

    def conv(key, cin, cout, k, gain=math.sqrt(2.0)):
        shapes[key] = (cout, cin, k, k)
        scales[key] = gain / math.sqrt(cin * k * k)

    def norm(name, c):
        norms.append(name)
        for stat, fill in (("scale", ones), ("bias", zero), ("mean", zero), ("var", ones)):
            shapes[f"{name}.bn.{stat}"] = (c,)
            fill.append(f"{name}.bn.{stat}")

    def dense(name, n_in, n_out, gain, bias):
        shapes[f"{name}.weight"] = (n_out, n_in)
        scales[f"{name}.weight"] = gain / math.sqrt(n_in)
        if bias:
            shapes[f"{name}.bias"] = (n_out,)
            scales[f"{name}.bias"] = bias_std
            if bias_std == 0.0:
                zero.append(f"{name}.bias")

    conv("conv_in.weight", 1, T, 3)
    for i in range(m.blocks):
        b = f"blocks.{i}"
        norm(f"{b}.pre", T)
        conv(f"{b}.pre.conv.weight", T, M, 1)
        pooled = (i + 1) % m.gpool_every == 0
        for j in range(2):
            inner = f"{b}.inner.{j}"
            norm(f"{inner}.a", M)
            conv(f"{inner}.a.conv.weight", M, M, 3)
            cin = M
            if pooled and j == 0:
                norm(f"{inner}.g", G)
                dense(f"{inner}.g.fc", 3 * G, M - G, math.sqrt(2.0), False)
                cin = M - G
            norm(f"{inner}.b", cin)
            conv(f"{inner}.b.conv.weight", cin, M, 3)
        norm(f"{b}.post", M)
        conv(f"{b}.post.conv.weight", M, T, 1)
    norm("final", T)
    conv("policy_p.weight", T, m.p1, 1)
    conv("policy_g.weight", T, m.g1, 1)
    norm("policy_pool", m.g1)
    dense("policy_pool.fc", 3 * m.g1, m.p1, math.sqrt(2.0), False)
    norm("policy_out", m.p1)
    conv("policy_out.conv.weight", m.p1, 1, 1, action_gain)
    conv("value_conv.weight", T, m.v1, 1)
    norm("value_norm", m.v1)
    dense("value_fc", 3 * m.v1, m.v2, math.sqrt(2.0), True)
    dense("value_head", m.v2, 1, 1.0, True)
    return shapes, scales, tuple(zero), tuple(ones), norms


@torch.no_grad()
def calibrate(params: dict, boards: torch.Tensor) -> None:
    """Set every BatchNorm's running ``mean`` and ``var`` to the batch
    statistics of its input on ``boards``, in the forward's order (flax's
    biased variance), as training leaves them: the reference's forward,
    each BNR setting its statistics before it normalises."""

    def norm(name, x):
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        params[f"{name}.bn.mean"], params[f"{name}.bn.var"] = mean, var
        return torch.relu(ref_models._batch_norm(params, name, x, False, {}))

    with ref_models.precision(False):
        ref_nbt.forward(params, boards, norm=norm)


def make(m, seed: int, device, action_gain: float, bias_std: float = 0.0,
         bn_std: float = None):
    """``(params, trained names)`` of the tower ``m`` drawn on ``device``
    from ``seed``, as the module docstring says."""
    shapes, scales, zero, ones, norms = layout(m, action_gain, bias_std)
    g = torch.Generator(device=device).manual_seed(seed)
    params = harness.make_weights(shapes, scales, g, device, zero, ones)
    if bn_std is not None:
        for name in norms:
            c = params[f"{name}.bn.scale"].shape[0]
            noise = torch.randn((2, c), generator=g, device=device) * bn_std
            params[f"{name}.bn.scale"] = 1.0 + noise[0]
            params[f"{name}.bn.bias"] = noise[1]
    calibrate(params, positions(m, CALIBRATION, g, device))
    if bn_std is not None:
        for name in norms:
            mean, var = params[f"{name}.bn.mean"], params[f"{name}.bn.var"]
            noise = torch.randn((2, mean.shape[0]), generator=g, device=device) * bn_std
            params[f"{name}.bn.mean"] = mean + noise[0] * var.sqrt()
            params[f"{name}.bn.var"] = var * noise[1].exp()
    stats = {f"{name}.bn.{s}" for name in norms for s in ("mean", "var")}
    return params, tuple(k for k in shapes if k not in stats)


# -- the judge ---------------------------------------------------------------------


def policy_logits(model, params, obs: torch.Tensor):
    """The action logits of the tower on boards ``obs``, by
    ``reference/nbt.py``."""
    return ref_nbt.policy_logits(params, obs)


class _Trace(harness.Trace):
    """``harness.Trace`` that also times the program's Winograd conv and
    its pre-activation epilogue: while it profiles, each call of
    ``winograd.conv`` is a bench span ``conv.winograd`` and each call of
    ``cnn_epilogue.preact`` one ``epilogue.preact``.  The last one made is
    ``_Trace.last``.  As ``match_resnet``'s, ``stop`` stops the profiler
    and leaves its reduction to the first read of ``result``, after the
    window."""

    last = None

    def __init__(self, run_dir: str, spans: list):
        super().__init__(run_dir, [*spans, CONV_SPAN, PREACT_SPAN])
        # ranges alone, no CUDA events: 187 calls a forward, read by the trace
        self.wraps = harness.Spans(cuda=False)
        _Trace.last = self

    @property
    def result(self):
        if self._result is None and self.prof is not None and self.t_stop is not None:
            self._result = self._reduce(self.spans)
            self.prof = None
        return self._result

    @result.setter
    def result(self, value) -> None:
        self._result = value

    def start(self) -> None:
        from hex_gym_env_tpu_torch.ops import cnn_epilogue, winograd

        self.wraps.wrap(winograd, "conv", CONV_SPAN)
        self.wraps.wrap(cnn_epilogue, "preact", PREACT_SPAN)
        super().start()

    def stop(self) -> None:
        if self.prof is not None and self.t_stop is None:
            self.prof.stop()
            self.t_stop = time.perf_counter()
        self.wraps.unwrap_all()


match = harness.load_module(harness.driver_file("match"), "bench_driver_match_of_nbt")
match.SPAN_MATCHES = 2
match.work = work_nbt
match.weights = resnet._module(weights, "bench_weights_of_nbt", make=make)
match.ref_models = resnet._module(ref_models, "bench_ref_models_of_nbt",
                                  policy_logits=policy_logits)
match.harness = resnet._module(harness, "bench_harness_of_nbt", Trace=_Trace)
make_agents, replay, judge, control = match.make_agents, match.replay, match.judge, match.control
logit_tap = match.logit_tap


def run(ctx) -> harness.Outcome:
    """``match.run`` on the instance; a traced run's readings gain the
    Winograd conv's and the pre-activation epilogue's device time, calls
    and mean least time a call."""
    try:
        from hex_gym_env_tpu_torch.models import family_class

        family_class(ctx.config["model"]["name"])
    except (ImportError, ValueError) as e:
        raise harness.HarnessError(f"the program cannot play this cell: {e}") from e
    _Trace.last = None
    outcome = match.run(ctx)
    trace = _Trace.last
    if trace is not None and trace.result is not None:
        m = work_nbt.model_of(ctx.config)
        games = int(ctx.workload["games"])
        r = outcome.readings
        for span, least in ((CONV_SPAN, work_nbt.conv_least_s(m, games)),
                            (PREACT_SPAN, work_nbt.preact_least_s(m, games))):
            r.device_s[span] = trace.result["device_s"][span]
            r.traced_calls[span] = trace.result["calls"][span]
            r.least_s[span] = least
    return outcome
