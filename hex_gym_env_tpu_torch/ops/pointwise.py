"""The KataGo tower's 1x1 convs as a float32 FFMA product on NCHW boards.

It replaces no TPU kernel: the JAX package has no such tower.  On the card
cuDNN ran the tower's 36 trunk 1x1 convs (18 of 384 -> 192, 18 of 192 ->
384) at 400 11x11 boards with an implicit GEMM at ~37% of the float32 peak,
a quarter of the KataGo forward's device time.  Here:

- ``takes(weight)``, the rule: a 1x1 conv weight (K, C, 1, 1) with C and K
  each a multiple of ``CHANNELS``, 64, float32 on a CUDA device.
  ``models/nbt.NbtPolicy.bind`` gives each 1x1 conv of its trunk that the
  rule takes an image (``image_of``: the weight's transpose W^T (C, K), kept
  with the weight, at its version, it was built from, in a
  ``winograd.FilterImage``); the heads' 1x1 convs (48, 96 and 1 outputs)
  fail the rule.
- ``conv(x, wt)``: the 1x1 conv (no bias) of boards x (B, C, n, n) by the
  weight whose image is wt (C, K), y (B, K, n, n) float32: for a CUDA
  tensor one C entry, ``csrc/pointwise_kernels.cu`` ``hex_pointwise_conv``
  (counter ``launch.pointwise_conv``; its note there gives the bound and
  the design); for a CPU tensor the plain PyTorch twin, ``conv_twin``, the
  same direct sum over the input channels.  It raises on a tensor the
  kernel does not take.

Each output is the direct float32 sum of its C products (no TF32, no
transform), as cuDNN's conv is: ~2e-7 of the output's RMS against float64,
against the Winograd conv's ~1.6e-6.  The image is the weight's own numbers
in another order, so a forward through it is the forward through the weight.
"""

from __future__ import annotations

import torch

from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.ops.winograd import FilterImage

CHANNELS = 64  # C and K multiples of the kernel's narrowest tile (kChannels)


def takes(weight: torch.Tensor) -> bool:
    """The rule: a 1x1 conv weight (K, C, 1, 1) with C and K each a multiple
    of ``CHANNELS``, float32 on a CUDA device."""
    return (weight.dim() == 4 and weight.shape[2:] == (1, 1)
            and weight.shape[0] % CHANNELS == 0 and weight.shape[1] % CHANNELS == 0
            and weight.shape[0] > 0 and weight.shape[1] > 0
            and weight.is_cuda and weight.dtype == torch.float32)


def image_of(weight: torch.Tensor) -> FilterImage:
    """A 1x1 conv weight (K, C, 1, 1) and its image, W^T (C, K), contiguous:
    the rows the kernel's tile loads are W^T's rows."""
    K, C = weight.shape[:2]
    wt = weight.detach().reshape(K, C).t().contiguous()
    return FilterImage(weight, weight._version, wt)


def conv_twin(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch of the kernel: each board's (K, C) x (C, n^2) product,
    in ``x``'s dtype, y (B, K, n, n)."""
    B, C, n, _ = x.shape
    return torch.matmul(wt.t(), x.reshape(B, C, n * n)).reshape(B, wt.shape[1], n, n)


def _check(x: torch.Tensor, wt: torch.Tensor) -> None:
    """Raise unless ``x`` is a contiguous, 16-byte aligned float32 (B, C, n,
    n) tensor with C a multiple of ``CHANNELS``, and ``wt`` a contiguous,
    16-byte aligned float32 (C, K) image on its device, K a multiple of
    ``CHANNELS``."""
    if x.dim() != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (B, C, n, n), got shape {tuple(x.shape)}")
    C = x.shape[1]
    if C < CHANNELS or C % CHANNELS:
        raise ValueError(f"x's channels must be a multiple of {CHANNELS}, got {C}")
    if wt.dim() != 2 or wt.shape[0] != C or wt.shape[1] < CHANNELS or wt.shape[1] % CHANNELS:
        raise ValueError(f"wt must have shape ({C}, K), K a multiple of {CHANNELS}, "
                         f"got {tuple(wt.shape)}")
    for name, t in (("x", x), ("wt", wt)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if wt.device != x.device:
        raise ValueError(f"wt lies on {wt.device}, x on {x.device}")


def conv(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The 1x1 conv (no bias) of boards ``x`` by the image ``wt``, as the
    module docstring says: the kernel for a CUDA tensor, the twin for a CPU
    one."""
    _check(x, wt)
    if not x.is_cuda:
        return conv_twin(x, wt)
    B, C, n, _ = x.shape
    K = wt.shape[1]
    y = torch.empty((B, K, n, n), dtype=x.dtype, device=x.device)
    if B:
        cuda_lib.launch("pointwise_conv", "hex_pointwise_conv", x.data_ptr(), wt.data_ptr(),
                        y.data_ptr(), B, C, K, n * n)
    return y
