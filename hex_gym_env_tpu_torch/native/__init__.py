"""Native scalar Hex engine: ctypes loader + build-on-demand.

The counterpart of the JAX package's ``native/__init__.py``, over its own
copy of ``hexcore.c``.  The system C compiler (``$CC``, else ``cc`` or
``gcc``) builds it on first use into
``hex_gym_env_tpu_torch/_build/``, keyed by a hash of the source and the
flags, so a changed source builds anew; the library is written under a
temporary name and moved into place, so processes that build at once never
load a half-written file.  See ``native/engine.py`` for the Python-facing
wrapper.  The engine is host code: it runs no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hexcore.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CFLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the build for the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhexcore_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``hexcore.c`` unless the build for this source exists; return
    the library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc") or "cc"
    proc = subprocess.run([cc, *CFLAGS, "-o", tmp, _SRC], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cc} failed on {_SRC} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())

        lib.hex_new.argtypes = [ctypes.c_int]
        lib.hex_new.restype = ctypes.c_void_p
        lib.hex_free.argtypes = [ctypes.c_void_p]
        lib.hex_free.restype = None
        lib.hex_reset.argtypes = [ctypes.c_void_p]
        lib.hex_reset.restype = None
        lib.hex_step.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
        ]
        lib.hex_step.restype = ctypes.c_int
        for name, elem in (("hex_observe", ctypes.c_int8), ("hex_legal", ctypes.c_uint8),
                           ("hex_world_board", ctypes.c_int8), ("hex_set_board", ctypes.c_int8)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(elem)]
            fn.restype = None
        for name in ["hex_to_move", "hex_done", "hex_winner", "hex_empty"]:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.hex_random_playouts.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int)
        ]
        lib.hex_random_playouts.restype = ctypes.c_long

        _lib = lib
        return lib
