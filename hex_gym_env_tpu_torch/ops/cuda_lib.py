"""Build, load and launch the package's hand-written CUDA kernels.

The kernels live in ``csrc/hex_kernels.cu`` (with the shared device code in
``csrc/hex_common.cuh``) behind a plain C interface.  On first use the
source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``_build/`` beside this package (listed in ``.gitignore``),
keyed by a hash of the sources, and loaded with ``ctypes``.  Every pointer
and the stream are passed as ``c_void_p``; every C entry returns the
``cudaGetLastError()`` of its launch, and a non-zero code raises here.

No fast-math: ``tanhf``, ``logf`` and ``expf`` must be the full-precision
library versions, or the kernels drift from their PyTorch twins.

``launches`` counts the launches of each kernel, one per call that reached
the device; ``reset_launches`` zeroes it.  Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("hex_kernels.cu", "hex_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

KERNELS = ("k1_step", "k2_agent", "k3_bank", "k4_rollout")
launches: dict[str, int] = {name: 0 for name in KERNELS}

P = ctypes.c_void_p
I = ctypes.c_int
U64 = ctypes.c_uint64
F32 = ctypes.c_float

# argument types of each C entry, in order (see csrc/hex_kernels.cu)
_ARGTYPES = {
    "hex_step": [P] * 9 + [P] * 8 + [I, I, I, P],
    "hex_agent": [P, I, I, I, I, I, P, P, P, U64, U64, P, P, P, P, I, P],
    "hex_bank": [P, I, I, I, I, I, P, P, P, P, U64, U64, P, P, I, P],
    "hex_rollout": (
        [P, P, P, I, I, I, I, I, I]  # weights + dims
        + [P] * 9  # state in
        + [P, P, P, P, U64, U64]  # bits + philox
        + [P, P, P]  # obs / ints / flts
        + [P] * 9  # state out
        + [I, I, I, I, F32, I, I, P]
    ),
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if the cached library is stale) and return its
    path.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    register/shared-memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libhexkernels_{_source_hash()}.so"
    if out.exists() and not verbose:
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "hex_kernels.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, types in _ARGTYPES.items():
                fn = getattr(handle, name)
                fn.argtypes = types
                fn.restype = I
            handle.hex_error_string.argtypes = [I]
            handle.hex_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry ``entry`` on the current stream, raise on a launch
    error, and count one launch of ``kernel``."""
    handle = lib()
    code = getattr(handle, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(
            f"{entry} launch failed: {handle.hex_error_string(code).decode()}"
        )
    launches[kernel] += 1


def ptr(t: torch.Tensor | None):
    """A tensor's device address for ``c_void_p`` (None for a null pointer)."""
    return None if t is None else t.data_ptr()


def philox_seed(generator: torch.Generator | None, kernel: str) -> tuple[int, int]:
    """Seed and offset of one launch's Philox streams: a fresh 63-bit seed
    from ``generator`` and an offset that advances 2**32 draws per launch of
    ``kernel``, so no two launches share a stream."""
    if generator is None:
        raise ValueError("a torch.Generator is needed to seed the kernel's Philox streams")
    seed = int(
        torch.randint(0, 2**63 - 1, (1,), generator=generator, device=generator.device).item()
    )
    return seed, launches[kernel] << 32


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` and ``shape``;
    return it contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.contiguous()
