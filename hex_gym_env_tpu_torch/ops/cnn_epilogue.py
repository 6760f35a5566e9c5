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

``preact(y, skip, mean, mul, bn_bias, board_bias=None)`` is the
pre-activation tower's layer (``models/nbt.py``: the residual stream is
never normalized, each conv's input is BatchNorm and ReLU of it).  It
returns ``(s, a)``,

    s = y + skip
    a = relu((((s + board_bias) - mean) * mul) + bn_bias)

``s`` the stream kept for the next skip (with ``skip`` None, ``y`` itself),
``a`` the next conv's input, a new contiguous tensor; ``board_bias``, where
given, is (B, C), one value a board and channel (the pooled block's bias),
taken only without a skip.  ``y`` may be a channel slice of a wider NCHW
tensor (its boards contiguous, 16-byte aligned and a multiple of 4 floats
apart; the pooled conv's output split in two); ``skip`` contiguous, of
``y``'s shape.  Any C with C H W a multiple of 4.  Bit for bit the eager
chain's add, ``BatchNorm.forward`` and ``torch.relu``: the same kernel,
counted as ``launch.cnn_epilogue_preact``, with ``s`` written over ``y``.

A CUDA tensor goes to the kernel, a CPU one to the plain PyTorch twin
(``epilogue_twin``, ``preact_twin``).
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
    _check_vectors(y, C, vectors)
    if skip is not None:
        _check_skip(y, skip)


def _check_vectors(y: torch.Tensor, C: int, vectors: dict) -> None:
    """Raise unless each vector is a contiguous float32 (C,) tensor on
    ``y``'s device."""
    for name, v in vectors.items():
        if v.shape != (C,):
            raise ValueError(f"{name} must have shape ({C},), got {tuple(v.shape)}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.device != y.device:
            raise ValueError(f"{name} lies on {v.device}, y on {y.device}")


def _check_skip(y: torch.Tensor, skip: torch.Tensor) -> None:
    """Raise unless ``skip`` is a contiguous, 16-byte aligned float32
    tensor of ``y``'s shape on its device."""
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


def preact_twin(y: torch.Tensor, skip: torch.Tensor | None, mean: torch.Tensor,
                mul: torch.Tensor, bn_bias: torch.Tensor,
                board_bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch of the pre-activation launch: the eager chain's ops in
    its order, ``(s, a)`` on new tensors (``s`` is ``y`` without a skip)."""
    s = y if skip is None else y + skip
    t = s if board_bias is None else s + board_bias[:, :, None, None]
    a = torch.relu((t - mean[:, None, None]) * mul[:, None, None] + bn_bias[:, None, None])
    return s, a


def _check_preact(y: torch.Tensor, skip, vectors: dict, board_bias) -> None:
    """Raise unless ``y`` is a float32 (B, C, H, W) tensor whose boards are
    each contiguous, 16-byte aligned and a multiple of 4 floats apart, with
    C H W a multiple of 4; ``skip``, where given, a contiguous, 16-byte
    aligned float32 tensor of its shape on its device; each vector a
    contiguous float32 (C,) tensor on its device; and ``board_bias``, where
    given (only without a skip), a contiguous float32 (B, C) tensor on its
    device."""
    if y.dim() != 4:
        raise ValueError(f"y must be (B, C, H, W), got shape {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be torch.float32, got {y.dtype}")
    B, C, H, W = y.shape
    if C < 1 or C * H * W % 4:
        raise ValueError(f"y's boards must be a multiple of 4 floats, got {C} x {H} x {W}")
    if y.stride()[1:] != (H * W, W, 1) or (B > 1 and (y.stride(0) < C * H * W
                                                      or y.stride(0) % 4)):
        raise ValueError("y's boards must each be contiguous, a multiple of 4 floats apart")
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned")
    if skip is not None:
        _check_skip(y, skip)
    _check_vectors(y, C, vectors)
    if board_bias is None:
        return
    if skip is not None:
        raise ValueError("a board bias is taken only without a skip")
    if board_bias.shape != (B, C):
        raise ValueError(f"board_bias must have shape ({B}, {C}), got {tuple(board_bias.shape)}")
    if board_bias.dtype != torch.float32:
        raise ValueError(f"board_bias must be torch.float32, got {board_bias.dtype}")
    if not board_bias.is_contiguous():
        raise ValueError("board_bias must be contiguous")
    if board_bias.device != y.device:
        raise ValueError(f"board_bias lies on {board_bias.device}, y on {y.device}")


def preact(y: torch.Tensor, skip: torch.Tensor | None, mean: torch.Tensor, mul: torch.Tensor,
           bn_bias: torch.Tensor, board_bias: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, a)``: ``s = y + skip`` (``y`` without a skip) and ``a =
    relu((((s + board_bias) - mean) * mul) + bn_bias)``, as the module
    docstring says: the kernel for a CUDA tensor (``s`` written over ``y``,
    counted as ``launch.cnn_epilogue_preact``), the twin for a CPU one."""
    _check_preact(y, skip, {"mean": mean, "mul": mul, "bn_bias": bn_bias}, board_bias)
    if not y.is_cuda:
        return preact_twin(y, skip, mean, mul, bn_bias, board_bias)
    B, C, H, W = y.shape
    a = torch.empty((B, C, H, W), dtype=y.dtype, device=y.device)
    if a.numel():
        cuda_lib.launch("cnn_epilogue_preact", "hex_cnn_preact", y.data_ptr(), cuda_lib.ptr(skip),
                        mean.data_ptr(), mul.data_ptr(), bn_bias.data_ptr(),
                        cuda_lib.ptr(board_bias), a.data_ptr(), B, C, H * W,
                        y.stride(0) if B > 1 else C * H * W)
    return y, a
