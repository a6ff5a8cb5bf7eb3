"""Native (C++) host-side augmentation kernel, loaded with ctypes.

The port's own copy of cspn_monodepth_tpu/native/: the fused affine
resample behind data/transforms.py, in C++ (`augment.cpp`), called through
ctypes, which releases the interpreter lock so the input pipeline's worker
threads scale across host cores. The JAX package made it the default
executor of its augmentation because numpy staging (~8 img/s per core, by
its own docstring) bounded its input pipeline at NYU size; a raw KITTI
frame (375x1242) is ~6x an NYU frame at the same crop work per pixel.

Built with g++ at first use into the package's `_build/` directory, keyed
by a hash of the source. Where no compiler is found or the build fails,
`lib()` returns None and data/transforms.py runs its numpy executor, as
the JAX package does; CSPN_NATIVE=0 in the environment chooses the numpy
executor too. `executor()` names the one that runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libaugment_{digest}.so"


def _build(so: Path) -> bool:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        return False
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-fno-math-errno",
           str(SOURCE), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent builds race safely
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32 = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    L, F = ctypes.c_long, ctypes.c_float
    lib.affine_bilinear_f32.argtypes = [f32, L, L, L, f32, f32, L, L,
                                        f32, F, F]
    lib.affine_bilinear_f32.restype = None
    lib.affine_bilinear_u8.argtypes = [u8, L, L, L, f32, f32, L, L,
                                       f32, F, F]
    lib.affine_bilinear_u8.restype = None
    lib.affine_nearest_f32.argtypes = [f32, L, L, f32, f32, L, L, F]
    lib.affine_nearest_f32.restype = None
    return lib


def lib() -> ctypes.CDLL | None:
    """The loaded native library, building it if needed; None where it
    cannot be built (no compiler) or is disabled (CSPN_NATIVE=0). A caller
    that arrives while another thread builds or loads it waits for that
    attempt: `_tried` is set only once `_lib` holds its result, so no
    worker thread takes the numpy executor (whose rgb differs in the last
    bits) for a record while the library is on its way."""
    global _lib, _tried
    if os.environ.get("CSPN_NATIVE", "1") == "0":
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        so = library_path()
        if so.exists() or _build(so):
            try:
                _lib = _bind(ctypes.CDLL(str(so)))
            except OSError:
                _lib = None
        _tried = True
    return _lib


def executor() -> str:
    """"native" where the C++ kernel runs the augmentation, else "numpy"."""
    return "numpy" if lib() is None else "native"
