"""The parameters of a cell's agents, made from the seed.

The names and shapes are those of the configuration's model family, as
``reference/models.py`` reads them.  Every drawn tensor is normal with a
standard deviation of ``gain / sqrt(fan_in)``: gain sqrt(2) for hidden
layers and the convs, ``action_gain`` for the action head (SB3's 0.01 at
the start of training; near 1 for agents whose logits are of a trained
agent's size), 1 for the value head; biases ``bias_std``; BatchNorm starts
at scale 1, bias 0, running mean 0 and variance 1, as training does.
``make``'s ``bn_std`` draws BatchNorm as a trained agent's would have
moved instead: scale 1 + N(0, bn_std), bias and running mean N(0, bn_std),
running variance exp(N(0, bn_std)).  At the start values BatchNorm at
inference is all but the identity, so a program that ignored its running
statistics would agree with the reference.
"""

from __future__ import annotations

import math

from benchmark import harness
from benchmark.reference.models import CONV_LAYERS
from benchmark.work import Model


def layout(m: Model, action_gain: float, bias_std: float = 0.0):
    """``(shapes, scales, zero, ones, trained)``: name -> shape and std, the
    names filled with zeros and with ones, and the trained names in order
    (the rest are BatchNorm's running statistics)."""
    shapes, scales, zero, ones, buffers = {}, {}, [], [], []

    def dense(name, n_in, n_out, gain):
        shapes[f"{name}.weight"] = (n_out, n_in)
        scales[f"{name}.weight"] = gain / math.sqrt(n_in)
        shapes[f"{name}.bias"] = (n_out,)
        scales[f"{name}.bias"] = bias_std
        if bias_std == 0.0:
            zero.append(f"{name}.bias")

    width = m.cells
    if m.family == "CNN":
        cin = 1
        for layer in CONV_LAYERS[: m.conv_layers]:
            shapes[f"{layer}.conv.weight"] = (m.filters, cin, 3, 3)
            scales[f"{layer}.conv.weight"] = math.sqrt(2.0) / math.sqrt(9 * cin)
            shapes[f"{layer}.conv.bias"] = (m.filters,)
            zero.append(f"{layer}.conv.bias")
            for stat, fill in (("scale", ones), ("bias", zero), ("mean", zero), ("var", ones)):
                shapes[f"{layer}.bn.{stat}"] = (m.filters,)
                fill.append(f"{layer}.bn.{stat}")
            buffers += [f"{layer}.bn.mean", f"{layer}.bn.var"]
            cin = m.filters
        dense("features", m.cells * m.filters, m.features, math.sqrt(2.0))
        width = m.features
    for tower in ("pi", "vf"):
        prev = width
        for i, h in enumerate(m.hidden):
            dense(f"{tower}.{i}", prev, h, math.sqrt(2.0))
            prev = h
    dense("action_head", m.hidden[-1], m.cells, action_gain)
    dense("value_head", m.hidden[-1], 1, 1.0)
    trained = tuple(k for k in shapes if k not in buffers)
    return shapes, scales, tuple(zero), tuple(ones), trained


def make(m: Model, seed: int, device, action_gain: float, bias_std: float = 0.0,
         bn_std: float = None):
    """``(params, trained names)`` drawn on ``device`` from ``seed``; with
    ``bn_std``, BatchNorm drawn after the rest, in one call."""
    import torch

    shapes, scales, zero, ones, trained = layout(m, action_gain, bias_std)
    g = torch.Generator(device=device).manual_seed(seed)
    params = harness.make_weights(shapes, scales, g, device, zero, ones)
    bn = [k for k in shapes if ".bn." in k]
    if bn_std is not None and bn:
        drawn = torch.randn((len(bn), m.filters), generator=g, device=device) * bn_std
        for k, row in zip(bn, drawn):
            if k.endswith(".scale"):
                row = row + 1.0
            elif k.endswith(".var"):
                row = row.exp()
            params[k] = row
    return params, trained
