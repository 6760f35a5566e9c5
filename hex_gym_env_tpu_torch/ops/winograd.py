"""The residual towers' 3x3 convs as a float32 Winograd F(4x4, 3x3) conv.

It replaces no TPU kernel: the JAX package has no residual tower.  On the
card cuDNN ran the AZ-ResNet tower's 256 -> 256 3x3 convs at 400 11x11
boards with an FFT algorithm (the board padded to 16x16, the bound filters
flipped and transformed again on every call), 91% of the AZ-ResNet
forward.  Here:

- ``filter_image(weight)``: a conv's weight (K, C, 3, 3) transformed once,
  ``U = G g G^T`` for each (output, input) channel pair, computed in float64
  and rounded once to float32, laid out as the product's B operand, (36, C,
  K), point ``xi = 6 a + b`` first.  ``models/resnet.ResNetPolicy.bind`` and
  ``models/nbt.NbtPolicy.bind`` build one for each conv the rule takes
  (``takes``: a 3x3 conv with C_in and C_out each a multiple of
  ``CHANNELS``, 64, not necessarily equal, on a board of at most
  ``MAX_BOARD``, its weight float32 on a CUDA device) and keep it with the
  weight it was built from (``FilterImage``).
- ``conv(x, u)``: the conv of boards x (B, C, n, n) by an image (36, C, K),
  with pad 1, y (B, K, n, n) float32: for a CUDA tensor one C entry,
  ``csrc/winograd_kernels.cu`` ``hex_winograd_conv`` (the input transform,
  36 batched float32 FFMA products, the output transform; counter
  ``launch.winograd_conv``; its note there gives the bound and the design),
  its scratch V (C, 36, Ppad) and M (Ppad, 36, K) from ``torch.empty``; for
  a CPU tensor the plain PyTorch twin, ``conv_twin``, the same Winograd
  arithmetic.  It raises on a tensor the kernel does not take.

Widths that are a multiple of 64 and not of 128 (the KataGo tower's 192)
take a second template instance of the product, 64 columns a CTA tile
(128 threads, the 128-column instance's warp and thread tiles, half the
warps across), not the 128-column tile with a ragged edge nor a 128 and a
64 in two launches: every output channel then sits in a full tile, and the
128-column instance, which the 256 -> 256 convs run, keeps its tiling.
Each output's sum runs over the input channels in the same order in both
instances, so their arithmetic is the same.

The tiles cover the board with ceil(n/4)^2 tiles of 4x4 outputs; each
tile's 6x6 input patch reads zeros outside the board (the conv's pad 1),
and the output transform drops the ragged row and column.  The points are
{0, 1, -1, 1/2, -2, inf} (``AT``, ``G``, ``BT``, exact fractions, the
fractions kept in G): exact in real arithmetic, and in float32 about ten
times the direct sum's rounding (relative RMS ~1.6e-6 of the output at C =
256, against ~1.7e-7), the least of the point sets tried.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hex_gym_env_tpu_torch.ops import cuda_lib

_h = Fraction(1, 2)
# y = A^T [(G g G^T) * (B^T d B)] A, each for one axis of a tile
AT = ((1, 1, 1, 1, 1, 0),
      (0, 1, -1, _h, -2, 0),
      (0, 1, 1, _h ** 2, 4, 0),
      (0, 1, -1, _h ** 3, -8, 1))
G = ((1, 0, 0),
     (Fraction(1, 3), Fraction(1, 3), Fraction(1, 3)),
     (Fraction(-1, 3), Fraction(1, 3), Fraction(-1, 3)),
     (Fraction(-16, 15), Fraction(-8, 15), Fraction(-4, 15)),
     (Fraction(1, 15), Fraction(-2, 15), Fraction(4, 15)),
     (0, 0, 1))
BT = ((1, -3 * _h, -2, 3 * _h, 1, 0),
      (0, -1, _h, 5 * _h, 1, 0),
      (0, 1, -5 * _h, _h, 1, 0),
      (0, -2, -1, 2, 1, 0),
      (0, _h, -1, -_h, 1, 0),
      (0, 1, -3 * _h, -2, 3 * _h, 1))

POINTS = 36  # 6 x 6 transformed points a tile
TILE = 4  # a tile's outputs a side
MAX_BOARD = 19  # kMaxBoard
CHANNELS = 64  # C and K multiples of the product's narrow tile width (kChannels)
ROWS = 128  # the product's rows (tiles) padded to its tile height (kBM)


def matrix(rows, dtype: torch.dtype = torch.float64, device=None) -> torch.Tensor:
    """One of ``AT``, ``G``, ``BT`` as a tensor."""
    return torch.tensor([[float(v) for v in row] for row in rows], dtype=dtype, device=device)


def tiles(n: int) -> int:
    """Tiles a side of an n x n board."""
    return (n + TILE - 1) // TILE


def padded_rows(B: int, n: int) -> int:
    """Ppad: the product's rows, B boards' tiles rounded up to ``ROWS``."""
    return -(-B * tiles(n) ** 2 // ROWS) * ROWS


def takes(weight: torch.Tensor, board: int) -> bool:
    """The rule: a 3x3 conv weight (K, C, 3, 3) with C and K each a
    multiple of ``CHANNELS``, float32 on a CUDA device, for boards of side
    ``board`` at most ``MAX_BOARD``."""
    return (weight.dim() == 4 and weight.shape[2:] == (3, 3)
            and weight.shape[0] % CHANNELS == 0 and weight.shape[1] % CHANNELS == 0
            and weight.shape[0] > 0 and weight.shape[1] > 0
            and 1 <= board <= MAX_BOARD and weight.is_cuda and weight.dtype == torch.float32)


def filter_image(weight: torch.Tensor) -> torch.Tensor:
    """U (36, C, K) float32 of a conv weight (K, C, 3, 3): ``G g G^T`` of
    each channel pair, computed in float64 on the weight's device as one
    product by ``G (x) G`` (point 6 a + b, tap 3 i + j) and rounded once."""
    K, C = weight.shape[:2]
    g = matrix(G, device=weight.device)
    u = weight.to(torch.float64).reshape(K * C, 9) @ torch.kron(g, g).T  # (K C, 36)
    return u.T.reshape(POINTS, K, C).transpose(1, 2).to(torch.float32).contiguous()


class FilterImage(NamedTuple):
    """A conv's filter image ``u`` and the weight, at its version, that it
    was built from."""

    weight: torch.Tensor
    version: int
    u: torch.Tensor

    @classmethod
    def of(cls, weight: torch.Tensor) -> "FilterImage":
        return cls(weight, weight._version, filter_image(weight.detach()))

    def current(self, weight: torch.Tensor) -> bool:
        """``weight`` is still the tensor, at the version, the image was
        built from (a write through ``.data`` escapes the version counter,
        as it escapes autograd)."""
        return weight is self.weight and weight._version == self.version


def conv_twin(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch of the three kernels: the same Winograd arithmetic, in
    ``x``'s dtype, y (B, K, n, n)."""
    B, C, n, _ = x.shape
    K, tn = u.shape[2], tiles(n)
    bt, at = matrix(BT, x.dtype, x.device), matrix(AT, x.dtype, x.device)
    pad = TILE * tn + 1 - n  # the patches cover rows -1 .. 4 tn
    d = F.pad(x, (1, pad, 1, pad)).unfold(2, 6, TILE).unfold(3, 6, TILE)  # (B, C, ty, tx, 6, 6)
    v = torch.einsum("ar,bcyxrs,es->aebyxc", bt, d, bt).reshape(POINTS, B * tn * tn, C)
    m = torch.bmm(v, u).reshape(6, 6, B, tn, tn, K)
    y = torch.einsum("ia,aebyxk,je->bkyixj", at, m, at).reshape(B, K, TILE * tn, TILE * tn)
    return y[:, :, :n, :n].contiguous()


def _check(x: torch.Tensor, u: torch.Tensor) -> None:
    """Raise unless ``x`` is a contiguous, 16-byte aligned float32 (B, C, n,
    n) tensor with C a multiple of ``CHANNELS`` and n at most ``MAX_BOARD``,
    and ``u`` a contiguous, 16-byte aligned float32 (36, C, K) image on its
    device, K a multiple of ``CHANNELS``."""
    if x.dim() != 4 or x.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (B, C, n, n), got shape {tuple(x.shape)}")
    B, C, n, _ = x.shape
    if C < CHANNELS or C % CHANNELS:
        raise ValueError(f"x's channels must be a multiple of {CHANNELS}, got {C}")
    if not 1 <= n <= MAX_BOARD:
        raise ValueError(f"x's boards must be 1 to {MAX_BOARD} a side, got {n}")
    if u.dim() != 3 or u.shape[:2] != (POINTS, C) or u.shape[2] < CHANNELS or u.shape[2] % CHANNELS:
        raise ValueError(f"u must have shape ({POINTS}, {C}, K), K a multiple of {CHANNELS}, "
                         f"got {tuple(u.shape)}")
    for name, t in (("x", x), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if u.device != x.device:
        raise ValueError(f"u lies on {u.device}, x on {x.device}")


def conv(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv (pad 1, no bias) of boards ``x`` by the filter image
    ``u``, as the module docstring says: the kernels for a CUDA tensor, the
    twin for a CPU one."""
    _check(x, u)
    if not x.is_cuda:
        return conv_twin(x, u)
    B, C, n, _ = x.shape
    K = u.shape[2]
    rows = padded_rows(B, n)
    v = torch.empty((C, POINTS, rows), dtype=x.dtype, device=x.device)
    m = torch.empty((rows, POINTS, K), dtype=x.dtype, device=x.device)
    y = torch.empty((B, K, n, n), dtype=x.dtype, device=x.device)
    if B:
        cuda_lib.launch("winograd_conv", "hex_winograd_conv", x.data_ptr(), u.data_ptr(),
                        v.data_ptr(), m.data_ptr(), y.data_ptr(), B, C, K, n)
    return y
