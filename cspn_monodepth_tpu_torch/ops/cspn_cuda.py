"""Wrapper of the hand-written Hopper CSPN forward kernel (csrc/cspn_fwd.cu).

The kernel is compiled at first use with `nvcc` for sm_90a into a shared
library with a plain C interface, keyed by a hash of its source, under
`_build/` in this package, and bound with ctypes. Nothing is built or
loaded when this module is imported.

`cspn_fwd` is the kernel's wrapper: on CUDA tensors it launches the kernel
(or raises); on CPU tensors it runs the kernel's plain version,
`cspn_propagate_ref_nchw`. `cspn_fwd.launches` counts the calls that
launched the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    NORM_TYPES,
    cspn_propagate_ref_nchw,
)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cspn_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The plain PyTorch version of the kernel: the CPU path and the reference
# the kernel is held to on the card.
cspn_fwd_plain = cspn_propagate_ref_nchw

_lib = None
build_log = ""


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under PyTorch's CUDA_HOME."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CSPN kernel cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcspn_fwd_{digest[:16]}.so"


def build() -> Path:
    """Compile csrc/cspn_fwd.cu unless a library of this source exists;
    returns its path. The compiler's output (registers, spills) is kept in
    `build_log`."""
    global build_log
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)   # atomic against a concurrent build
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.cspn_fwd.argtypes = [p, i64, p, i64, p, i64, p, p,
                                 i32, i32, i32, i32, i32, p]
        lib.cspn_fwd.restype = i32
        lib.cspn_fwd_error_string.argtypes = [i32]
        lib.cspn_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_planes(name: str, t: torch.Tensor, shape: tuple, device):
    """The kernel reads each (H, W) plane contiguously and takes any batch
    stride; planes of the guidance must be H*W apart."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    h, w = shape[-2:]
    inner = (h * w, w, 1) if len(shape) == 4 else (w, 1)
    if t.stride()[1:] != inner:
        raise ValueError(f"{name} planes must be contiguous, strides "
                         f"{t.stride()}")


def cspn_fwd(guidance: torch.Tensor, blur: torch.Tensor,
             sparse: torch.Tensor | None, *, num_iters: int,
             norm_type: str) -> torch.Tensor:
    """CSPN forward: guidance (B, 8, H, W), blur and sparse (B, H, W), all
    float32 with contiguous planes and any batch stride -> (B, H, W).

    A CUDA tensor goes to the kernel; a CPU tensor to the plain version.
    """
    if guidance.device.type == "cpu":
        return cspn_fwd_plain(guidance, blur, sparse, num_iters=num_iters,
                              norm_type=norm_type)
    if guidance.device.type != "cuda":
        raise ValueError(f"no CSPN kernel for device {guidance.device}")
    if norm_type not in NORM_TYPES:
        raise ValueError(f"unknown norm_type: {norm_type!r}")
    if num_iters < 0:
        raise ValueError(f"num_iters must be >= 0, got {num_iters}")
    b, _, h, w = guidance.shape
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid (1..65535)")
    dev = guidance.device
    _check_planes("guidance", guidance, (b, 8, h, w), dev)
    _check_planes("blur", blur, (b, h, w), dev)
    if sparse is not None:
        _check_planes("sparse", sparse, (b, h, w), dev)

    lib = _load()
    out = torch.empty((b, h, w), device=dev, dtype=torch.float32)
    scratch = torch.empty_like(out)     # ping-pong partner between rounds
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cspn_fwd(
            guidance.data_ptr(), guidance.stride(0),
            blur.data_ptr(), blur.stride(0),
            None if sparse is None else sparse.data_ptr(),
            0 if sparse is None else sparse.stride(0),
            out.data_ptr(), scratch.data_ptr(),
            b, h, w, num_iters, NORM_TYPES.index(norm_type), stream)
    if err != 0:
        raise RuntimeError("cspn_fwd launch failed: "
                           + lib.cspn_fwd_error_string(err).decode())
    cspn_fwd.launches += 1
    return out


cspn_fwd.launches = 0
