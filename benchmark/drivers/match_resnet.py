"""Driver of the residual tower's match cells: ``drivers/match.py``, the one
match judge, loaded as a module instance of its own and given the tower's
family.

The instance's ``work`` is ``work_resnet`` (the tower's shape and
operations), its ``weights`` draws the tower's agents (``make``), and its
``ref_models`` judges with ``reference/resnet.py``; ``run``, ``replay``,
``judge`` and ``control`` are the instance's, so both families meet the
same judge.  A match of 400 11x11 games takes ~9 s, so the instance plays
``SPAN_MATCHES`` = 2 matches inside the program's tracing, not 10, and
its trace reduces the profiled matches after the window (``_Trace``).

The weights' draw.  ``weights.make``'s draw (normal, std ``gain /
sqrt(fan_in)``) left as it is would give the tower BatchNorm at its start
values, the identity, and a residual stream whose scale doubles a block,
with logits hundreds of units wide, far from a trained agent's.  So after
the draw BatchNorm's running statistics are calibrated on ``CALIBRATION``
seeded positions, as training leaves them (each layer's batch mean and
biased variance, the layers before it already calibrated), and then moved
by the match driver's ``AGENT_BN_STD``, as the other families' are drawn:
scale 1 + N(0, s), bias N(0, s), the mean by N(0, s) of the channel's
standard deviation, the variance by a factor exp(N(0, s)).

In a traced run the profiled matches also hold a bench span,
``epilogue.residual``, around each call of the program's residual
epilogue (``ops/cnn_epilogue.residual``), for ``residual_roofline_pct.match``:
the launch's least time (``work_resnet.residual_bytes``) over its kernel's
device time.  A program without the family fails the run at once.
"""

from __future__ import annotations

import math
import time
import types

import torch
import torch.nn.functional as F

from benchmark import harness, weights, work, work_resnet
from benchmark.reference import models as ref_models
from benchmark.reference import resnet as ref_resnet

SPAN = "epilogue.residual"
CALIBRATION = 400  # seeded positions that BatchNorm's statistics are calibrated on


def _module(base, name: str, **over) -> types.ModuleType:
    """A module holding ``base``'s names with ``over`` in their place."""
    mod = types.ModuleType(name, base.__doc__)
    mod.__dict__.update({k: v for k, v in vars(base).items() if not k.startswith("__")})
    mod.__dict__.update(over)
    return mod


# -- the weights -------------------------------------------------------------------


def _convs(m) -> list:
    """``(name, cin, cout, kernel)`` of each conv, in the forward's order."""
    F_ = m.filters
    out = [("conv_in", 1, F_, 3)]
    for i in range(m.blocks):
        out += [(f"blocks.{i}.a", F_, F_, 3), (f"blocks.{i}.b", F_, F_, 3)]
    return out + [("policy", F_, 2, 1), ("value", F_, 1, 1)]


def layout(m, action_gain: float, bias_std: float = 0.0):
    """``(shapes, scales, zero, ones)`` of the tower's parameters, as
    ``weights.layout`` gives the other families': convs sqrt(2) / sqrt(fan
    in), BatchNorm at its start values, dense layers ``gain / sqrt(fan
    in)`` (sqrt(2) hidden, ``action_gain`` the action head, 1 the value
    head) with biases ``bias_std``."""
    shapes, scales, zero, ones = {}, {}, [], []
    for name, cin, cout, k in _convs(m):
        shapes[f"{name}.conv.weight"] = (cout, cin, k, k)
        scales[f"{name}.conv.weight"] = math.sqrt(2.0) / math.sqrt(cin * k * k)
        for stat, fill in (("scale", ones), ("bias", zero), ("mean", zero), ("var", ones)):
            shapes[f"{name}.bn.{stat}"] = (cout,)
            fill.append(f"{name}.bn.{stat}")
    for name, n_in, n_out, gain in (("action_head", 2 * m.cells, m.cells, action_gain),
                                    ("value_fc", m.cells, m.value_hidden, math.sqrt(2.0)),
                                    ("value_head", m.value_hidden, 1, 1.0)):
        shapes[f"{name}.weight"] = (n_out, n_in)
        scales[f"{name}.weight"] = gain / math.sqrt(n_in)
        shapes[f"{name}.bias"] = (n_out,)
        scales[f"{name}.bias"] = bias_std
        if bias_std == 0.0:
            zero.append(f"{name}.bias")
    return shapes, scales, tuple(zero), tuple(ones)


def positions(m, count: int, generator, device) -> torch.Tensor:
    """``count`` seeded positions in the mover's frame (B, N, N): each with
    a number of stones drawn uniformly below a full board, on random cells,
    the mover's (-1) as many as the opponent's (1) or one fewer."""
    A = m.cells
    stones = torch.randint(0, A, (count, 1), generator=generator, device=device)
    order = torch.rand((count, A), generator=generator, device=device).argsort(dim=1)
    theirs = (stones + 1) // 2  # the opponent moved first where the count is odd
    value = torch.where(order < stones - theirs, -1.0, torch.where(order < stones, 1.0, 0.0))
    return value.reshape(count, m.board, m.board)


@torch.no_grad()
def calibrate(params: dict, m, boards: torch.Tensor) -> None:
    """Set every BatchNorm's running ``mean`` and ``var`` to the batch
    statistics of its input on ``boards``, layer by layer in the forward's
    order (flax's biased variance), as training leaves them."""

    def conv_bn(name, x):
        w = params[f"{name}.conv.weight"]
        y = F.conv2d(x, w, None, padding=w.shape[-1] // 2)
        mean = y.mean(dim=(0, 2, 3))
        var = torch.clamp((y * y).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        params[f"{name}.bn.mean"], params[f"{name}.bn.var"] = mean, var
        mul = torch.rsqrt(var + ref_models.BN_EPS) * params[f"{name}.bn.scale"]
        shift = params[f"{name}.bn.bias"]
        return (y - mean[:, None, None]) * mul[:, None, None] + shift[:, None, None]

    with ref_models.precision(False):
        x = torch.relu(conv_bn("conv_in", boards.reshape(-1, 1, m.board, m.board)))
        for i in range(m.blocks):
            h = torch.relu(conv_bn(f"blocks.{i}.a", x))
            x = torch.relu(conv_bn(f"blocks.{i}.b", h) + x)
        conv_bn("policy", x)
        conv_bn("value", x)


def make(m, seed: int, device, action_gain: float, bias_std: float = 0.0,
         bn_std: float = None):
    """``(params, trained names)`` drawn on ``device`` from ``seed``: the
    tower's as the module docstring says, any other family's by
    ``weights.make``."""
    if m.family != work_resnet.FAMILY:
        return weights.make(m, seed, device, action_gain, bias_std, bn_std)
    shapes, scales, zero, ones = layout(m, action_gain, bias_std)
    g = torch.Generator(device=device).manual_seed(seed)
    params = harness.make_weights(shapes, scales, g, device, zero, ones)
    bn = [name for name, _, _, _ in _convs(m)]
    if bn_std is not None:
        for name in bn:
            cout = params[f"{name}.bn.scale"].shape[0]
            noise = torch.randn((2, cout), generator=g, device=device) * bn_std
            params[f"{name}.bn.scale"] = 1.0 + noise[0]
            params[f"{name}.bn.bias"] = noise[1]
    calibrate(params, m, positions(m, CALIBRATION, g, device))
    if bn_std is not None:
        for name in bn:
            mean, var = params[f"{name}.bn.mean"], params[f"{name}.bn.var"]
            noise = torch.randn((2, mean.shape[0]), generator=g, device=device) * bn_std
            params[f"{name}.bn.mean"] = mean + noise[0] * var.sqrt()
            params[f"{name}.bn.var"] = var * noise[1].exp()
    stats = {f"{name}.bn.{s}" for name in bn for s in ("mean", "var")}
    return params, tuple(k for k in shapes if k not in stats)


# -- the judge ---------------------------------------------------------------------


def policy_logits(model, params, obs: torch.Tensor):
    """The action logits of ``model`` on boards ``obs``: the tower's by
    ``reference/resnet.py``, any other family's by ``reference/models.py``."""
    if model.family == work_resnet.FAMILY:
        return ref_resnet.policy_logits(params, obs, model.blocks)
    return ref_models.policy_logits(model, params, obs)


class _Trace(harness.Trace):
    """``harness.Trace`` that also times the program's residual epilogue:
    while it profiles, each call of ``cnn_epilogue.residual`` is a bench
    span ``epilogue.residual``.  The last one made is ``_Trace.last``.

    ``stop`` stops the profiler and leaves its reduction to the first read
    of ``result``, after the window: two profiled matches of this cell hold
    ~190,000 device events, whose reduction takes ~20 s, and inside the
    45 s window it would leave one match or none to time outside the
    profiled part."""

    last = None

    def __init__(self, run_dir: str, spans: list):
        super().__init__(run_dir, [*spans, SPAN])
        self.wraps = harness.Spans(cuda=True)
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
        from hex_gym_env_tpu_torch.ops import cnn_epilogue

        self.wraps.wrap(cnn_epilogue, "residual", SPAN)
        super().start()

    def stop(self) -> None:
        if self.prof is not None and self.t_stop is None:
            self.prof.stop()
            self.t_stop = time.perf_counter()
        self.wraps.unwrap_all()


match = harness.load_module(harness.driver_file("match"), "bench_driver_match_of_resnet")
match.SPAN_MATCHES = 2
match.work = work_resnet
match.weights = _module(weights, "bench_weights_of_resnet", make=make)
match.ref_models = _module(ref_models, "bench_ref_models_of_resnet", policy_logits=policy_logits)
match.harness = _module(harness, "bench_harness_of_resnet", Trace=_Trace)
make_agents, replay, judge, control = match.make_agents, match.replay, match.judge, match.control
logit_tap = match.logit_tap


def run(ctx) -> harness.Outcome:
    """``match.run`` on the instance; a traced run's readings gain the
    residual epilogue's device time, calls and least time."""
    try:
        from hex_gym_env_tpu_torch.models import family_class

        family_class(ctx.config["model"]["name"])
    except (ImportError, ValueError) as e:
        raise harness.HarnessError(f"the program cannot play this cell: {e}") from e
    _Trace.last = None
    outcome = match.run(ctx)
    trace = _Trace.last
    if trace is not None and trace.result is not None:
        m = work_resnet.model_of(ctx.config)
        r = outcome.readings
        r.device_s[SPAN] = trace.result["device_s"][SPAN]
        r.traced_calls[SPAN] = trace.result["calls"][SPAN]
        nbytes = work_resnet.residual_bytes(int(ctx.workload["games"]), m.filters, m.board,
                                            m.board)
        r.least_s[SPAN] = work.least_seconds(0.0, nbytes)
    return outcome
