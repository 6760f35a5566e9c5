"""The CNN forward's epilogue: a conv layer's bias, BatchNorm and ReLU as
one pass over its output.

It replaces no TPU kernel: the JAX package's CNN is one XLA program, which
fuses the elementwise ops after each conv by itself.  The port's eager
forward ran them as five ATen passes over each layer's activation (the
conv's bias add, BatchNorm's subtract, mul and add, then the ReLU) and the
flatten's permute as one more copy after the last layer; at 4,096 9x9
boards an activation is 84.9 MB, above the L2, so each pass is a round trip
to device memory.  Here each layer is one launch of ``csrc/hex_kernels.cu``
``cnn_epilogue_kernel`` (counter ``launch.cnn_epilogue``; its note there
gives the bound and the design).

``epilogue(y, conv_bias, mean, mul, bn_bias, hwc)`` takes the conv's raw
output ``y`` (B, C, H, W), float32, contiguous and 16-byte aligned, with C
a divisor of 256 and C H W a multiple of 4 (what the CNN's and the residual
tower's 3x3 convs give: C is 64 or 256), and computes per element,
in this order and with each op rounded to float32 as ATen rounds it,

    relu(((y + conv_bias) - mean) * mul + bn_bias)

with ``mul = rsqrt(var + eps) * scale`` (``models/cnn.BatchNorm.mul``): bit
for bit what ``conv(x) + bias``, ``BatchNorm.forward`` and ``torch.relu``
give.  ``conv_bias`` None (a conv without a bias, as the residual tower's)
leaves out the first add.  Without ``hwc`` the result is written over
``y``; with it, into a new (B, H, W, C) buffer, returned as its (B, C, H,
W) view, so the features' flatten in (H, W, C) order is a view.  ``hwc``
takes a conv bias (the CNN's last layer is the only caller): the kernel
builds no (H, W, C) launch without one.

``residual(y, mean, mul, bn_bias, skip)`` is a residual block's second
layer (``models/resnet.py``): the skip operand, the block's input, of
``y``'s shape, dtype and device, contiguous and 16-byte aligned, is added
after BatchNorm and before the ReLU,

    relu((((y - mean) * mul) + bn_bias) + skip)

bit for bit ``BatchNorm.forward``, ``+ skip`` and ``torch.relu``, written
over ``y``: the same kernel, counted as ``launch.cnn_epilogue_residual``.
A CUDA tensor goes to the kernel, a CPU one to the plain PyTorch twin
(``epilogue_twin``).
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.ops import cuda_lib


def epilogue_twin(y: torch.Tensor, conv_bias: torch.Tensor | None, mean: torch.Tensor,
                  mul: torch.Tensor, bn_bias: torch.Tensor, hwc: bool = False,
                  skip: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch of ``cnn_epilogue_kernel``: the eager chain's ops in
    its order, on a new tensor; with ``hwc`` in a (B, H, W, C) buffer,
    returned as its (B, C, H, W) view."""
    if conv_bias is not None:
        y = y + conv_bias[:, None, None]
    out = (y - mean[:, None, None]) * mul[:, None, None] + bn_bias[:, None, None]
    out = torch.relu(out if skip is None else out + skip)
    return out.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2) if hwc else out


def _check(y: torch.Tensor, vectors: dict, skip: torch.Tensor | None = None) -> None:
    """Raise unless ``y`` is a contiguous, 16-byte aligned float32 (B, C, H,
    W) tensor with C a divisor of 256 and C H W a multiple of 4, each vector
    a contiguous float32 (C,) tensor on its device, and ``skip``, where
    given, a contiguous, 16-byte aligned float32 tensor of its shape on its
    device."""
    if y.dim() != 4:
        raise ValueError(f"y must be (B, C, H, W), got shape {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be torch.float32, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous (the conv's NCHW output)")
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned")
    B, C, H, W = y.shape
    if C < 1 or 256 % C:
        raise ValueError(f"y's channels must divide 256, got {C}")
    if C * H * W % 4:
        raise ValueError(f"y's boards must be a multiple of 4 floats, got {C} x {H} x {W}")
    for name, v in vectors.items():
        if v.shape != (C,):
            raise ValueError(f"{name} must have shape ({C},), got {tuple(v.shape)}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.device != y.device:
            raise ValueError(f"{name} lies on {v.device}, y on {y.device}")
    if skip is None:
        return
    if skip.shape != y.shape:
        raise ValueError(f"skip must have y's shape {tuple(y.shape)}, got {tuple(skip.shape)}")
    if skip.dtype != torch.float32:
        raise ValueError(f"skip must be torch.float32, got {skip.dtype}")
    if skip.device != y.device:
        raise ValueError(f"skip lies on {skip.device}, y on {y.device}")
    if not skip.is_contiguous():
        raise ValueError("skip must be contiguous")
    if skip.data_ptr() % 16:
        raise ValueError("skip must be 16-byte aligned")


def _launch(kernel: str, y, conv_bias, mean, mul, bn_bias, skip, hwc: bool) -> torch.Tensor:
    B, C, H, W = y.shape
    out = torch.empty((B, H, W, C), dtype=y.dtype, device=y.device) if hwc else y
    if out.numel() == 0:
        return out.permute(0, 3, 1, 2) if hwc else out
    cuda_lib.launch(kernel, "hex_cnn_epilogue", y.data_ptr(), cuda_lib.ptr(conv_bias),
                    mean.data_ptr(), mul.data_ptr(), bn_bias.data_ptr(), cuda_lib.ptr(skip),
                    out.data_ptr(), B, C, H * W, int(hwc))
    return out.permute(0, 3, 1, 2) if hwc else out


def epilogue(y: torch.Tensor, conv_bias: torch.Tensor | None, mean: torch.Tensor,
             mul: torch.Tensor, bn_bias: torch.Tensor, hwc: bool = False) -> torch.Tensor:
    """``relu(((y + conv_bias) - mean) * mul + bn_bias)`` of a conv's raw
    output ``y`` (B, C, H, W) over its channels (``conv_bias`` None: no
    bias), as the module docstring says: the kernel for a CUDA tensor (in
    place without ``hwc``), the twin for a CPU one."""
    if hwc and conv_bias is None:
        raise ValueError("the (H, W, C) launch takes a conv bias")
    vectors = {"conv_bias": conv_bias, "mean": mean, "mul": mul, "bn_bias": bn_bias}
    _check(y, {k: v for k, v in vectors.items() if v is not None})
    if not y.is_cuda:
        return epilogue_twin(y, conv_bias, mean, mul, bn_bias, hwc)
    return _launch("cnn_epilogue", y, conv_bias, mean, mul, bn_bias, None, hwc)


def residual(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bn_bias: torch.Tensor,
             skip: torch.Tensor) -> torch.Tensor:
    """``relu((((y - mean) * mul) + bn_bias) + skip)`` of a residual block's
    second conv's raw output ``y`` and the block's input ``skip``, as the
    module docstring says: the kernel for a CUDA tensor, in place (counted
    as ``launch.cnn_epilogue_residual``), the twin for a CPU one."""
    _check(y, {"mean": mean, "mul": mul, "bn_bias": bn_bias}, skip)
    if not y.is_cuda:
        return epilogue_twin(y, None, mean, mul, bn_bias, skip=skip)
    return _launch("cnn_epilogue_residual", y, None, mean, mul, bn_bias, skip, False)
