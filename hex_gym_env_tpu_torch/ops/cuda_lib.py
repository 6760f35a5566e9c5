"""Build, load and launch the package's hand-written CUDA kernels.

The kernels live in ``csrc/hex_kernels.cu`` (the rollout's K1-K4 and the
random-legal rollout K7) and
``csrc/learner_kernels.cu`` (the learner's K5-K6), with the shared device
code in ``csrc/hex_common.cuh``, behind a plain C interface.  On first use
each ``.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``), all at once
in parallel, and linked into one shared library under ``_build/`` beside
this package (listed in ``.gitignore``), keyed by a hash of the sources, and
loaded with ``ctypes``.  Every pointer and the stream are passed as
``c_void_p``; every C entry returns the ``cudaGetLastError()`` of its launch
(K6's is a cooperative launch, ``cudaLaunchCooperativeKernel``, whose own
error code comes back the same way), and a non-zero code raises here.

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
UNITS = ("hex_kernels.cu", "learner_kernels.cu")  # compiled one nvcc each
SOURCES = UNITS + ("hex_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

KERNELS = (
    "k1_step", "k2_agent", "k3_bank", "k4_rollout", "k5_gae", "k6_ppo", "k7_random_rollout",
)
launches: dict[str, int] = {name: 0 for name in KERNELS}

P = ctypes.c_void_p
I = ctypes.c_int
U64 = ctypes.c_uint64
F32 = ctypes.c_float

# argument types of each C entry, in order (see csrc/*.cu)
_ARGTYPES = {
    "hex_step": [P] * 9 + [P, P] + [I, I, I, P],  # state in, action, active; ints, bytes
    "hex_agent": [P, I, I, I, I, I, P, P, P, U64, P, P, P, P, I, P],
    "hex_bank": [P, I, I, I, I, I, P, P, P, P, U64, P, P, I, P],
    "hex_rollout": (
        [P, P, P, P, I, I, I, I, I, I]  # weights, image scratch, dims
        + [P] * 9  # state in
        + [P, P, P, P, U64]  # bits + philox seed
        + [P, P, P]  # obs / ints / flts
        + [P] * 9  # state out
        + [I, I, I, I, F32, I, I]  # B, n, L, T, best_prob, per_episode_seat, eval_mode
        + [I, I, I, P, P]  # games per CTA, agent / members in smem, timers, stream
    ),
    "hex_random_rollout": (
        [P] * 5 + [U64]  # state in, bits, philox seed
        + [P, P]  # out: ints, bytes
        + [I, I, I, I, P]  # B, n, L, T, stream
    ),
    "hex_gae": [P] * 6 + [I, I, F32, F32, P],
    "hex_ppo": (
        [P] * 15  # obs, flt, idx, order, bias, p, m, v, stats + 6 scratch
        + [I] * 7  # F, H, A, n_layers, relu, mb, G
        + [F32] * 8  # lr, clip, clip_lo, clip_hi, ent_scale, vf_scale, max_norm, eps
        + [I, I, I, I, P, P]  # grid, R, smem, resident, timers, stream
    ),
    "hex_ppo_plan": [I, I, I, I, I, P],  # launches nothing: no stream
    "hex_rollout_image_floats": [I] * 5,  # a size: no stream
    "hex_rollout_plan": [I] * 7 + [P],  # launches nothing: no stream
    "hex_env_plan": [I, I, I, P],  # launches nothing: no stream
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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if the cached library is stale) and return its
    path.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's
    register/shared-memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    key = _source_hash()
    out = BUILD_DIR / f"libhexkernels_{key}.so"
    if out.exists() and not verbose:
        return out
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(u).stem}_{tag}.o" for u in UNITS]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    compiles = [
        subprocess.Popen(
            [nvcc, *ptxas, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / unit)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for unit, obj in zip(UNITS, objs)
    ]
    errors = []
    for unit, proc in zip(UNITS, compiles):
        err = proc.communicate()[1]
        if verbose:
            print(err, end="")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {unit} ({proc.returncode}):\n{err}")
    if errors:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)], capture_output=True, text=True
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
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


def ppo_plan(F: int, H: int, A: int, n_layers: int, mb: int) -> tuple[int, int, int, int, int]:
    """K6's launch shape on the current device: ``(grid, rows per chunk,
    shared-memory bytes, resident, padded parameter floats)``; grid is at
    most the CTAs that fit on the card at once, as a cooperative launch
    needs; ``resident`` says whether the whole padded parameter image sits
    in shared memory (else one tower-layer at a time is staged).  Raises on
    an error code."""
    handle = lib()
    plan = (ctypes.c_int * 5)()
    code = handle.hex_ppo_plan(F, H, A, n_layers, mb, ctypes.addressof(plan))
    if code != 0:
        raise RuntimeError(f"hex_ppo_plan failed: {handle.hex_error_string(code).decode()}")
    return tuple(plan)


def rollout_plan(F: int, H: int, A: int, n_layers: int, n: int, L: int, B: int):
    """K4's launch shape on the current device: ``(games per CTA, agent in
    shared memory, bank members in shared memory, shared-memory bytes)``.
    Raises on an error code."""
    handle = lib()
    plan = (ctypes.c_int * 4)()
    code = handle.hex_rollout_plan(F, H, A, n_layers, n, L, B, ctypes.addressof(plan))
    if code != 0:
        raise RuntimeError(f"hex_rollout_plan failed: {handle.hex_error_string(code).decode()}")
    return tuple(plan)


def env_plan(kernel: str, B: int, L: int) -> tuple[int, int, int]:
    """K1's (``"k1_step"``) or K7's (``"k7_random_rollout"``) launch shape
    on the current device for B games of L lanes: ``(games per CTA, CTAs
    resident per SM, registers per thread)``.  Raises on an error code."""
    handle = lib()
    plan = (ctypes.c_int * 3)()
    code = handle.hex_env_plan(("k1_step", "k7_random_rollout").index(kernel), B, L,
                               ctypes.addressof(plan))
    if code != 0:
        raise RuntimeError(f"hex_env_plan failed: {handle.hex_error_string(code).decode()}")
    return tuple(plan)


def rollout_image_floats(F: int, H: int, A: int, n_layers: int, P1: int) -> int:
    """Floats of K4's scratch for the transposed, padded towers of the agent
    and the P1 bank members that its launch builds."""
    return int(lib().hex_rollout_image_floats(F, H, A, n_layers, P1))


def ptr(t: torch.Tensor | None):
    """A tensor's device address for ``c_void_p`` (None for a null pointer)."""
    return None if t is None else t.data_ptr()


def philox_seed(generator: torch.Generator | None) -> int:
    """A fresh 63-bit seed for one launch's Philox streams, drawn from
    ``generator``: launches never share a stream (each thread takes its own
    subsequence of its launch's seed), and the streams are a function of the
    generator's state alone, so a run restored from a checkpoint draws what
    the uninterrupted run drew."""
    if generator is None:
        raise ValueError("a torch.Generator is needed to seed the kernel's Philox streams")
    return int(
        torch.randint(0, 2**63 - 1, (1,), generator=generator, device=generator.device).item()
    )


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` and ``shape``;
    return it contiguous (itself when it already is)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on a CUDA device")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    return t if t.is_contiguous() else t.contiguous()
