"""The match's policy forward as one CUDA launch, on weights bound once a
match.

It replaces no TPU kernel: the JAX package's match calls the model, which
XLA compiles whole.  The port's eager forward cost ``scripts/match.py``
~370 us of host time a side each ply (``torch.func.functional_call``
swapping twelve tensors in and out, then ten or eleven ATen ops); here it
is one launch of ``csrc/hex_kernels.cu`` ``mlp_forward_kernel`` (counter
``launch.mlp_forward``; its note there gives the bound and the design).

- ``bind(model, params)`` binds a side's parameters to its ``MlpPolicy``
  with no copy (``assign``, as ``load_state_dict(..., assign=True)``) and
  builds the
  side's image in one launch (``mlp_image_kernel``, counter
  ``launch.mlp_image``): K2's agent-image layout (``policy_kernel``), built
  straight from the module's ``nn.Linear`` parameters.  It binds only where
  the kernel takes the model: equal towers of one width, float32 parameters
  on a CUDA device.
- The module's ``forward`` then takes the kernel (``BoundForward``) while
  grad is disabled, the input is float32 on the image's device, and every
  parameter is still the tensor, at the same ``_version`` and address, that
  the image was built from; else its plain path.  A write through
  ``.data`` escapes the version counter, as it escapes autograd.
- ``forward(image, d, x)``: the kernel for a CUDA tensor, the plain PyTorch
  twin (``forward_twin``, reading the image) for a CPU one.

The kernel returns the raw logits and the value: no mask, no draw.
"""

from __future__ import annotations

import ctypes
import operator

import torch
import torch.nn.functional as F

from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.ops.policy_kernel import (
    MlpDims, mlp_dims, round4, row_stride, supported, ttower_size,
)

MAX_LAYERS = 8  # hidden layers a tower (kFwdMaxLayers)
TOWERS = (("pi", "action_head"), ("vf", "value_head"))


def image_floats(d: MlpDims) -> int:
    """Floats of a side's image: the pi tower's, then the vf tower's."""
    return ttower_size(d, d.A) + ttower_size(d, 1)


def _layers(d: MlpDims):
    """Each tower's ``[(name, n_in, n_out), ...]``, the pi tower first, the
    head last."""
    for (tower, head), out in zip(TOWERS, (d.A, 1)):
        names = [f"{tower}.{i}" for i in range(d.n_layers)] + [head]
        ins = [d.F] + [d.H] * d.n_layers
        outs = [d.H] * d.n_layers + [out]
        yield list(zip(names, ins, outs))


def image_twin(params, d: MlpDims) -> torch.Tensor:
    """Plain PyTorch of ``mlp_image_kernel``: the image of a state dict (each
    layer's weight rows padded to ``row_stride(n_in)``, then its biases
    padded to ``round4(n_out)``), (``image_floats(d)``,) float32."""
    parts = []
    for layers in _layers(d):
        for name, n_in, n_out in layers:
            w, b = params[f"{name}.weight"], params[f"{name}.bias"]
            rows = w.new_zeros((n_out, row_stride(n_in)), dtype=torch.float32)
            rows[:, :n_in] = w
            bias = b.new_zeros((round4(n_out),), dtype=torch.float32)
            bias[:n_out] = b
            parts += [rows.reshape(-1), bias]
    return torch.cat(parts)


def image_views(image: torch.Tensor, d: MlpDims) -> dict:
    """Each layer's ``(weight (n_out, n_in), bias (n_out,))`` as views of
    ``image``, by state-dict name (``pi.0``, ..., ``action_head``, ...)."""
    views, off = {}, 0
    for layers in _layers(d):
        for name, n_in, n_out in layers:
            S = row_stride(n_in)
            w = image[off: off + n_out * S].view(n_out, S)[:, :n_in]
            off += n_out * S
            views[name] = (w, image[off: off + n_out])
            off += round4(n_out)
    return views


def forward_twin(image: torch.Tensor, d: MlpDims, x: torch.Tensor):
    """Plain PyTorch of ``mlp_forward_kernel`` on the image: ``(logits (B,
    A), value (B,))`` of boards ``x`` (B, F) float32."""
    act = torch.relu if d.relu else torch.tanh
    views = image_views(image, d)
    out = []
    for layers in _layers(d):
        h = x
        for name, _, _ in layers[:-1]:
            h = act(F.linear(h, *views[name]))
        out.append(F.linear(h, *views[layers[-1][0]]))
    return out[0], out[1][:, 0]


def _forward_cuda(image: torch.Tensor, d: MlpDims, x: torch.Tensor):
    B = x.shape[0]
    x = cuda_lib.check_cuda("x", x, torch.float32, (B, d.F))
    image = cuda_lib.check_cuda("image", image, torch.float32, (image_floats(d),))
    # one output buffer: the logits, then the values
    out = torch.empty((B * (d.A + 1),), dtype=torch.float32, device=x.device)
    p = out.data_ptr()
    cuda_lib.launch("mlp_forward", "hex_mlp_forward", image.data_ptr(), d.F, d.H, d.A,
                    d.n_layers, int(d.relu), x.data_ptr(), p, p + 4 * B * d.A, B)
    return out[: B * d.A].view(B, d.A), out[B * d.A:]


def forward(image: torch.Tensor, d: MlpDims, x: torch.Tensor):
    """``(logits (B, A), value (B,))`` of boards ``x`` (B, F) float32 on a
    side's image: the kernel for a CUDA tensor, the twin for a CPU one."""
    if x.is_cuda:
        return _forward_cuda(image, d, x)
    return forward_twin(image, d, x)


def _image_cuda(model, d: MlpDims) -> torch.Tensor:
    """The image of ``model``'s own parameters, in one launch."""
    ptrs, strides = [], []
    for tower, head in TOWERS:
        for layer in [*getattr(model, tower), getattr(model, head)]:
            ptrs += [layer.weight.data_ptr(), layer.bias.data_ptr()]
            strides += [*layer.weight.stride(), *layer.bias.stride()]
    ptr_table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    stride_table = (ctypes.c_longlong * len(strides))(*strides)
    image = torch.empty((image_floats(d),), dtype=torch.float32, device=model.pi[0].weight.device)
    cuda_lib.launch("mlp_image", "hex_mlp_image", ctypes.addressof(ptr_table),
                    ctypes.addressof(stride_table), d.F, d.H, d.A, d.n_layers, image.data_ptr())
    return image


_version = operator.attrgetter("_version")


class BoundForward:
    """An ``MlpPolicy``'s forward on ``image``, the image of the parameters
    the module holds now (``bind`` sets it as the module's
    ``bound_forward``)."""

    def __init__(self, model, image: torch.Tensor):
        self.image = image
        self.dims = mlp_dims(model)
        slots = [(mod._parameters, name) for mod in model.modules() for name in mod._parameters]
        self._dicts = [d for d, _ in slots]
        self._names = [name for _, name in slots]
        self._params = [d[name] for d, name in slots]
        self._versions = list(map(_version, self._params))
        self._addresses = list(map(torch.Tensor.data_ptr, self._params))

    def current(self) -> bool:
        """Every parameter is still the tensor, at the version and address,
        that the image was built from (no sync with the device)."""
        return (all(map(operator.is_, map(dict.get, self._dicts, self._names), self._params))
                and list(map(_version, self._params)) == self._versions
                and list(map(torch.Tensor.data_ptr, self._params)) == self._addresses)

    def takes(self, obs: torch.Tensor) -> bool:
        """The rule of the module's forward: grad disabled, ``obs`` float32
        on the image's device, the image current."""
        return (not torch.is_grad_enabled() and obs.dtype == torch.float32
                and obs.device == self.image.device and self.current())

    def __call__(self, obs: torch.Tensor):
        return forward(self.image, self.dims, obs.reshape(obs.shape[0], -1))


def assign(model, params) -> None:
    """``model.load_state_dict(params, assign=True)`` for a state dict that
    names every parameter of ``model`` and nothing else (as
    ``load_policy_params`` gives it), without the loader's checks and hooks,
    which cost ~0.2 ms a call: each parameter becomes an ``nn.Parameter``
    on ``params``' tensor, no copy, keeping its ``requires_grad``."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise ValueError(f"params name {sorted(params)}, the model {sorted(own)}")
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
            t, requires_grad=own[name].requires_grad)


def bind(model, params) -> bool:
    """Bind ``params`` (a state dict) to ``model`` with no copy and give it
    the kernel's forward, where the kernel takes the model: an MLP with equal
    towers of one width (``policy_kernel.supported``), at most ``MAX_LAYERS``
    deep, its parameters float32 on a CUDA device (of any strides: a
    ``params:`` file may hold transposed views).  Returns whether it did;
    elsewhere the model is left as it was."""
    if not supported(model) or len(model.pi_layers) > MAX_LAYERS:
        return False
    if not all(v.is_cuda and v.dtype == torch.float32 for v in params.values()):
        return False
    assign(model, params)
    model.bound_forward = BoundForward(model, _image_cuda(model, mlp_dims(model)))
    return True
