"""Wrappers of the hand-written Hopper CSPN kernels (csrc/*.cu).

Each source under csrc/ is compiled at first use with `nvcc` for sm_90a
into a shared library with a plain C interface, keyed by a hash of its
source, under `_build/` in this package, and bound with ctypes; the
sources compile in parallel, one `nvcc` each. Nothing is built or loaded
when this module is imported.

The wrappers, one per kernel, each with a `.launches` count of the calls
that launched its kernel. The whole-plane route, on raw guidance:
  cspn_fwd        K1, the forward (csrc/cspn_fwd.cu);
  cspn_fwd_stash  K2, the forward that also stashes every d^t (same file);
  cspn_bwd        K3, the adjoint over that stash (csrc/cspn_bwd.cu).
The H-tiled route, on raw guidance as JAX's `_cspn_pallas_tiled`: the same
three functions, so each launches the C entry of its whole-plane
counterpart with the geometry `fwd_plan` gives for the shape:
  cspn_tiled_fwd        K4 (C entry cspn_fwd);
  cspn_tiled_fwd_stash  K5 (C entry cspn_fwd_stash);
  cspn_tiled_bwd        K6 (C entry cspn_bwd).
The spatial path's slab kernels, on prenormalized gates9 and d^0 as given
(or anchored on load), on one rank's halo'd slab of H/S + 2k rows for the
r <= k iterations of one round (parallel/halo.py):
  cspn_prenorm_fwd        K7, the forward (csrc/cspn_fwd.cu);
  cspn_prenorm_fwd_stash  K8, K7 that also stashes every d^t (same file);
  cspn_prenorm_bwd        K9, the adjoint over that stash (csrc/cspn_bwd.cu).
The normalization, the slab route's (csrc/cspn_bwd.cu):
  cspn_gates9      raw guidance to gates9, also K3's and K6's stage 0;
  cspn_gates9_bwd  its adjoint, the chain rule of K3's sums stage.
The adjoints are composed of stage kernels (csrc/cspn_bwd.cu); stage 0 is
cspn_gates9, and the other two have wrappers of their own, for checking and
timing them alone:
  cspn_bwd_sweep   stage 1, the lam recursion with its adjoint stash;
  cspn_bwd_sums    stage 2, the gate sums (K3's with the chain rule).
On CUDA tensors a wrapper launches its kernel (or raises); on CPU tensors
it runs the kernel's plain version from ops/cspn_ref.py.

The forward kernels' launch plan (`fwd_plan`) is the tile geometry, one
of FWD_GEOMETRIES, picked by shape. A forward wrapper takes it as the
keyword argument `geometry` for a sweep; every geometry gives the same
output bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    NORM_TYPES,
    adjoint_sweep_plain,
    cspn_bwd_plain,
    cspn_bwd_sums_plain,
    cspn_fwd_stash_plain,
    cspn_prenorm_bwd_plain,
    cspn_prenorm_fwd_plain,
    cspn_prenorm_fwd_stash_plain,
    cspn_propagate_ref_nchw,
    cspn_tiled_bwd_plain,
    cspn_tiled_fwd_plain,
    cspn_tiled_fwd_stash_plain,
    prenorm_gates9,
    prenorm_gates9_bwd_plain,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The plain PyTorch versions of the kernels: the CPU path and the
# references the kernels are held to on the card.
cspn_fwd_plain = cspn_propagate_ref_nchw

# The tile geometries of csrc/cspn_fwd.cu's round kernel, by index:
# (TILE, HALO, RUN, MINB). A block owns a TILE x TILE interior of a slab
# with HALO more pixels on each side and runs HALO iterations a round; each
# of its threads owns RUN rows of one slab column; MINB is the blocks per
# SM its registers are capped for. The build hands the table to the source
# (geometry_header), which instantiates its round kernel for each.
FWD_GEOMETRIES = ((32, 4, 5, 2), (32, 8, 3, 1), (48, 8, 4, 1),
                  (40, 12, 4, 1))

_libs: dict = {}
build_log: dict[str, str] = {}     # source name -> nvcc's output


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under PyTorch's CUDA_HOME."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CSPN kernels cannot be built")


def sources() -> dict[str, Path]:
    """Every kernel source under csrc/, by name (file stem)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def geometry_header() -> str:
    """FWD_GEOMETRIES as the X-macro csrc/cspn_fwd.cu instantiates its round
    kernel from: CSPN_FWD_GEOMETRIES(G) is G(TILE, HALO, RUN, MINB) for
    each geometry, in the table's order."""
    return "#define CSPN_FWD_GEOMETRIES(G) " + " ".join(
        "G({}, {}, {}, {})".format(*g) for g in FWD_GEOMETRIES) + "\n"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        sources()[name].read_bytes() + geometry_header().encode()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source under csrc/ that has no library of its current
    source yet, all at once (one nvcc each); returns the library paths by
    name. The compiler's output (registers, spills) is kept in
    `build_log`."""
    paths = {name: library_path(name) for name in sources()}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    header = BUILD_DIR / "cspn_fwd_geometries.h"
    fd, tmp = tempfile.mkstemp(suffix=".h", dir=BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(geometry_header())
    os.replace(tmp, header)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-include", str(header), "-o", tmp,
               str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        build_log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} ({proc.returncode}):\n{build_log[name]}")
        else:
            os.replace(tmp, todo[name])   # atomic against a concurrent build
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


def _load(name: str):
    if not _libs:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        signatures = {
            "cspn_fwd": {
                "cspn_fwd": [p, i64, p, i64, p, i64, p, p, p,
                             i32, i32, i32, i32, i32, i32, p],
                "cspn_fwd_stash": [p, i64, p, i64, p, i64, p, p, p, p,
                                   i32, i32, i32, i32, i32, i32, p],
                "cspn_prenorm_fwd": [p, i64, p, i64, p, i64, p, p,
                                     i32, i32, i32, i32, i32, i32, p],
                "cspn_prenorm_fwd_stash": [p, i64, p, i64, p, i64, p, p, p,
                                           i32, i32, i32, i32, i32, i32, p]},
            "cspn_bwd": {
                "cspn_bwd": [p, i64, p, i64, p, i64, p, p, p, p, p, p, p,
                             i32, i32, i32, i32, i32, p],
                "cspn_prenorm_bwd": [p, i64, p, i64, p, i64, p, p, p, p, p,
                                     p, i32, i32, i32, i32, i32, p],
                "cspn_gates9": [p, i64, p, i32, i32, i32, i32, p],
                "cspn_gates9_bwd": [p, i64, p, i64, p, i32, i32, i32, i32,
                                    p],
                "cspn_bwd_sweep": [p, i64, p, i64, p, i64, p, p, p,
                                   i32, i32, i32, i32, p],
                "cspn_bwd_sums": [p, i64, p, i64, p, p, p, p, p,
                                  i32, i32, i32, i32, i32, p]},
        }
        for lib_name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures[lib_name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = i32
            err_string = getattr(lib, f"{lib_name}_error_string")
            err_string.argtypes = [i32]
            err_string.restype = ctypes.c_char_p
            _libs[lib_name] = lib
    return _libs[name]


def _raise_on(err: int, lib_name: str, what: str):
    if err != 0:
        msg = getattr(_load(lib_name), f"{lib_name}_error_string")(err)
        raise RuntimeError(f"{what} launch failed: {msg.decode()}")


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


def _check_call(guidance: torch.Tensor, num_iters: int,
                norm_type: str | None) -> bool:
    """True for a CPU tensor (the plain version runs); checks what every
    kernel needs of a CUDA one and raises on anything else. norm_type is
    None for the prenormalized kernels (K7-K9)."""
    if guidance.device.type == "cpu":
        return True
    if guidance.device.type != "cuda":
        raise ValueError(f"no CSPN kernel for device {guidance.device}")
    if norm_type is not None and norm_type not in NORM_TYPES:
        raise ValueError(f"unknown norm_type: {norm_type!r}")
    if num_iters < 0:
        raise ValueError(f"num_iters must be >= 0, got {num_iters}")
    if not 0 < guidance.shape[0] <= 65535:
        raise ValueError(f"batch {guidance.shape[0]} outside the kernel's "
                         f"grid (1..65535)")
    return False


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _bstride(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.stride(0)


def rounds(geometry: int, num_iters: int) -> int:
    """The rounds (launches) of a forward call: ceil(T / HALO), one for
    T = 0."""
    return max(1, math.ceil(num_iters / FWD_GEOMETRIES[geometry][1]))


def pick_geometry(b: int, h: int, w: int, num_iters: int) -> int:
    """The tile geometry for a (B, H, W) call of num_iters iterations: the
    fastest for its class in chip_smoke.py's sweep on an H100 (PERF.md
    section 6). One round of at most 4 iterations (the spatial path's slabs):
    32x32 tiles with a 4-pixel halo. More, by pixels per call: up to
    ~200k (one NYU image) 32x32 with an 8-pixel halo; up to ~3M (one
    KITTI image, an NYU batch of 32) 48x48 with an 8-pixel halo; beyond
    (a KITTI batch of 8) 40x40 with a 12-pixel halo, in two rounds. A
    stash call (K2, K5, K8) takes the same: the stash entries' own sweep
    found the same points fastest on the H100."""
    if num_iters <= 4:
        return 0
    px = b * h * w
    if px < 200_000:
        return 1
    return 2 if px < 3_000_000 else 3


# The largest slab of any geometry: the kernel's 32-bit pixel index must
# reach (H + 2 SLAB) x (W + 2 SLAB).
_MAX_SLAB = max(t + 2 * halo for t, halo, _, _ in FWD_GEOMETRIES)


def fwd_plan(b: int, h: int, w: int, num_iters: int, *,
             geometry: int | None = None) -> int:
    """The tile geometry of a forward call on a (B, H, W) batch: by shape
    unless given. Raises on a shape or geometry the kernel cannot
    serve."""
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid (1..65535)")
    if h < 1 or w < 1:
        raise ValueError(f"empty {h}x{w} plane")
    if (h + 2 * _MAX_SLAB) * (w + 2 * _MAX_SLAB) >= 2 ** 31:
        raise ValueError(f"a {h}x{w} plane is beyond the forward kernels' "
                         f"32-bit pixel index")
    if geometry is None:
        geometry = pick_geometry(b, h, w, num_iters)
    if not 0 <= geometry < len(FWD_GEOMETRIES):
        raise ValueError(f"no tile geometry {geometry}")
    return geometry


@functools.lru_cache(maxsize=1024)
def _launch_plan(b, h, w, num_iters, geometry):
    """fwd_plan and whether the call runs more than one round, cached: a
    single image's call is bound by the host."""
    geometry = fwd_plan(b, h, w, num_iters, geometry=geometry)
    return geometry, rounds(geometry, num_iters) > 1


def _forward(entry, guidance, blur, sparse, num_iters, norm_type, stash,
             geometry=None, anchor_d0=False):
    """Launch the forward C entry `entry` of csrc/cspn_fwd.cu: cspn_fwd or
    cspn_fwd_stash on raw guidance (B, 8, H, W) with norm_type, the
    cspn_prenorm entries on gates9 (B, 9, H, W) with norm_type None and
    d^0 anchored on load with anchor_d0; the stash entries write into
    `stash`. Returns the output."""
    b, _, h, w = guidance.shape
    dev = guidance.device
    _check_planes("guidance" if norm_type else "gates9", guidance,
                  (b, 8 if norm_type else 9, h, w), dev)
    _check_planes("blur", blur, (b, h, w), dev)
    if sparse is not None:
        _check_planes("sparse", sparse, (b, h, w), dev)
    lib = _load("cspn_fwd")
    geometry, more = _launch_plan(b, h, w, num_iters, geometry)
    out = torch.empty((b, h, w), device=dev, dtype=torch.float32)
    # One scratch buffer, freed on return: d's ping-pong partner between
    # rounds and, on raw guidance, the gates9 (B, 9, H, W) that the first
    # round writes for the later ones.
    scratch = gates9 = None
    if more:
        work = torch.empty(b * h * w * (10 if norm_type else 1), device=dev,
                           dtype=torch.float32)
        scratch = work.data_ptr()
        gates9 = scratch + 4 * b * h * w
    args = (guidance.data_ptr(), guidance.stride(0),
            blur.data_ptr(), blur.stride(0), _ptr(sparse), _bstride(sparse),
            out.data_ptr(), scratch)
    if norm_type:
        args += (gates9,)
    if stash is not None:
        args += (stash.data_ptr(),)
    size = (b, h, w, num_iters)
    size += (NORM_TYPES.index(norm_type),) if norm_type else (int(anchor_d0),)
    size += (geometry,)
    with torch.cuda.device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = getattr(lib, entry)(*args, *size, stream)
    _raise_on(err, "cspn_fwd", entry)
    return out


def _stash_like(blur: torch.Tensor, num_iters: int) -> torch.Tensor:
    b, h, w = blur.shape
    return torch.empty((b, num_iters, h, w), device=blur.device,
                       dtype=torch.float32)


def cspn_fwd(guidance: torch.Tensor, blur: torch.Tensor,
             sparse: torch.Tensor | None, *, num_iters: int,
             norm_type: str,
             geometry: int | None = None) -> torch.Tensor:
    """CSPN forward (K1): guidance (B, 8, H, W), blur and sparse (B, H, W),
    all float32 with contiguous planes and any batch stride -> (B, H, W).

    A CUDA tensor goes to the kernel; a CPU tensor to the plain version.
    `geometry` overrides fwd_plan's choice (a sweep).
    """
    if _check_call(guidance, num_iters, norm_type):
        return cspn_fwd_plain(guidance, blur, sparse, num_iters=num_iters,
                              norm_type=norm_type)
    out = _forward("cspn_fwd", guidance, blur, sparse, num_iters, norm_type,
                   None, geometry)
    cspn_fwd.launches += 1
    return out


def cspn_fwd_stash(guidance: torch.Tensor, blur: torch.Tensor,
                   sparse: torch.Tensor | None, *, num_iters: int,
                   norm_type: str, geometry: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward (K2): as cspn_fwd, and also returns the stash
    (B, T, H, W) of every d^t, the plane iteration t starts from. Its
    output equals cspn_fwd's."""
    if _check_call(guidance, num_iters, norm_type):
        return cspn_fwd_stash_plain(guidance, blur, sparse,
                                    num_iters=num_iters, norm_type=norm_type)
    stash = _stash_like(blur, num_iters)
    out = _forward("cspn_fwd_stash", guidance, blur, sparse, num_iters,
                   norm_type, stash, geometry)
    cspn_fwd_stash.launches += 1
    return out, stash


def cspn_bwd(guidance: torch.Tensor, sparse: torch.Tensor | None,
             stash: torch.Tensor, grad_out: torch.Tensor, *, num_iters: int,
             norm_type: str
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint (K3): guidance (B, 8, H, W), sparse (B, H, W) or None,
    the stash of cspn_fwd_stash and the output's cotangent grad_out
    (B, H, W) -> (d_guidance (B, 8, H, W), d_blur, d_sparse (B, H, W));
    d_sparse is zero without a sparse map. Inputs are float32 with
    contiguous planes; the stash is contiguous."""
    if _check_call(guidance, num_iters, norm_type):
        return cspn_bwd_plain(guidance, sparse, stash, grad_out,
                              num_iters=num_iters, norm_type=norm_type)
    out = _raw_adjoint(guidance, sparse, stash, grad_out, num_iters,
                       norm_type)
    cspn_bwd.launches += 1
    return out


def _raw_adjoint(guidance, sparse, stash, grad_out, num_iters, norm_type):
    """Launch the C entry cspn_bwd of csrc/cspn_bwd.cu (K3, K6); returns
    (d_guidance, d_blur, d_sparse)."""
    b, _, h, w = guidance.shape
    dev = guidance.device
    _check_adjoint(dev, b, h, w, num_iters, planes=(
        ("guidance", guidance, 8), ("grad_out", grad_out, 0),
        ("sparse", sparse, 0)), stashes=(("stash", stash),))
    d_guid = _empty((b, 8, h, w), dev)
    d_blur, d_sparse = _empty((b, h, w), dev), _empty((b, h, w), dev)
    # Scratch: stage 0's gates9, stage 1's adjoint stash and the plane lam
    # ping-pongs with between rounds; freed on return.
    gates9 = _empty((b, 9, h, w), dev)
    lam_stash, lam_scratch = _stash_like(d_blur, num_iters), torch.empty_like(
        d_blur)
    _launch("cspn_bwd", dev, guidance.data_ptr(), guidance.stride(0),
            _ptr(sparse), _bstride(sparse), grad_out.data_ptr(),
            grad_out.stride(0), stash.data_ptr(), d_guid.data_ptr(),
            d_blur.data_ptr(), d_sparse.data_ptr(), gates9.data_ptr(),
            lam_stash.data_ptr(), lam_scratch.data_ptr(), b, h, w, num_iters,
            NORM_TYPES.index(norm_type))
    return d_guid, d_blur, d_sparse


def cspn_tiled_fwd(guidance: torch.Tensor, blur: torch.Tensor,
                   sparse: torch.Tensor | None, *, num_iters: int,
                   norm_type: str,
                   geometry: int | None = None) -> torch.Tensor:
    """The H-tiled route's forward (K4, JAX's `_cspn_pallas_tiled` without
    a gradient): cspn_fwd's contract and function, raw guidance normalized
    and d^0 anchored in the kernel, so it launches cspn_fwd's C entry.

    A CUDA tensor goes to the kernel; a CPU tensor to the plain version.
    """
    if _check_call(guidance, num_iters, norm_type):
        return cspn_tiled_fwd_plain(guidance, blur, sparse,
                                    num_iters=num_iters, norm_type=norm_type)
    out = _forward("cspn_fwd", guidance, blur, sparse, num_iters, norm_type,
                   None, geometry)
    cspn_tiled_fwd.launches += 1
    return out


def cspn_tiled_fwd_stash(guidance: torch.Tensor, blur: torch.Tensor,
                         sparse: torch.Tensor | None, *, num_iters: int,
                         norm_type: str, geometry: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The H-tiled route's training forward (K5): cspn_fwd_stash's
    contract and function (its C entry); its output equals
    cspn_tiled_fwd's."""
    if _check_call(guidance, num_iters, norm_type):
        return cspn_tiled_fwd_stash_plain(guidance, blur, sparse,
                                          num_iters=num_iters,
                                          norm_type=norm_type)
    stash = _stash_like(blur, num_iters)
    out = _forward("cspn_fwd_stash", guidance, blur, sparse, num_iters,
                   norm_type, stash, geometry)
    cspn_tiled_fwd_stash.launches += 1
    return out, stash


def cspn_tiled_bwd(guidance: torch.Tensor, sparse: torch.Tensor | None,
                   stash: torch.Tensor, grad_out: torch.Tensor, *,
                   num_iters: int, norm_type: str
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The H-tiled route's adjoint (K6, JAX's `_cspn_tiled_adjoint_bwd_impl`):
    cspn_bwd's contract and function (its C entry) on the stash of
    cspn_tiled_fwd_stash -> (d_guidance (B, 8, H, W), d_blur = (1 - m)
    lam^0, d_sparse = sum_t m lam^{t+1} + m lam^0), the normalization's
    chain rule and the anchor's gradients included."""
    if _check_call(guidance, num_iters, norm_type):
        return cspn_tiled_bwd_plain(guidance, sparse, stash, grad_out,
                                    num_iters=num_iters, norm_type=norm_type)
    out = _raw_adjoint(guidance, sparse, stash, grad_out, num_iters,
                       norm_type)
    cspn_tiled_bwd.launches += 1
    return out


def _prenorm_adjoint(gates9, sparse, stash, grad_out, num_iters, anchor_d0):
    """Launch the C entry cspn_prenorm_bwd of csrc/cspn_bwd.cu (K9);
    returns (d_gates9, lam0, d_sparse)."""
    b, _, h, w = gates9.shape
    dev = gates9.device
    _check_adjoint(dev, b, h, w, num_iters, planes=(
        ("gates9", gates9, 9), ("grad_out", grad_out, 0),
        ("sparse", sparse, 0)), stashes=(("stash", stash),))
    d_gates9 = _empty((b, 9, h, w), dev)
    lam0, d_sparse = _empty((b, h, w), dev), _empty((b, h, w), dev)
    # Scratch: stage 1's adjoint stash and the plane lam ping-pongs with
    # between rounds; freed on return.
    lam_stash, lam_scratch = _stash_like(lam0, num_iters), torch.empty_like(
        lam0)
    _launch("cspn_prenorm_bwd", dev, gates9.data_ptr(), gates9.stride(0),
            _ptr(sparse), _bstride(sparse), grad_out.data_ptr(),
            grad_out.stride(0), stash.data_ptr(), d_gates9.data_ptr(),
            lam0.data_ptr(), d_sparse.data_ptr(), lam_stash.data_ptr(),
            lam_scratch.data_ptr(), b, h, w, num_iters, int(anchor_d0))
    return d_gates9, lam0, d_sparse


def _empty(shape: tuple, dev) -> torch.Tensor:
    return torch.empty(shape, device=dev, dtype=torch.float32)


def _check_adjoint(dev, b, h, w, num_iters, planes=(), stashes=()):
    """What the adjoint's kernels take: each (name, tensor or None,
    channels) of `planes` (B, channels, H, W) with contiguous planes, or
    (B, H, W) for channels 0; each (name, tensor) of `stashes` contiguous
    (B, T, H, W); a plane whose pixels a 32-bit index reaches."""
    if h * w >= 2 ** 31:
        raise ValueError(f"a {h}x{w} plane is beyond the adjoint kernels' "
                         f"32-bit pixel index")
    for name, t, channels in planes:
        if t is not None:
            _check_planes(name, t, (b, channels, h, w) if channels
                          else (b, h, w), dev)
    for name, t in stashes:
        _check_planes(name, t, (b, num_iters, h, w), dev)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, dev, *args) -> None:
    """Call the C entry `entry` of csrc/cspn_bwd.cu with `args` on dev's
    current stream; raises if a launch failed."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_load("cspn_bwd"), entry)(*args, stream)
    _raise_on(err, "cspn_bwd", entry)


def cspn_gates9(guidance: torch.Tensor, *, norm_type: str) -> torch.Tensor:
    """The normalization (K3's and K6's stage 0, the slab route's): the raw
    guidance (B, 8, H, W), contiguous planes and any batch stride ->
    gates9 (B, 9, H, W) = [1 - sum_k gate_k, gate_1..8], prenorm_gates9's
    function."""
    if _check_call(guidance, 0, norm_type):
        return prenorm_gates9(guidance, norm_type)
    b, _, h, w = guidance.shape
    dev = guidance.device
    _check_adjoint(dev, b, h, w, 0, planes=(("guidance", guidance, 8),))
    gates9 = _empty((b, 9, h, w), dev)
    _launch("cspn_gates9", dev, guidance.data_ptr(), guidance.stride(0),
            gates9.data_ptr(), b, h, w, NORM_TYPES.index(norm_type))
    cspn_gates9.launches += 1
    return gates9


def cspn_gates9_bwd(guidance: torch.Tensor, d_gates9: torch.Tensor, *,
                    norm_type: str) -> torch.Tensor:
    """The normalization's adjoint: the raw guidance (B, 8, H, W) and the
    cotangent d_gates9 (B, 9, H, W) of cspn_gates9's output, contiguous
    planes and any batch stride -> d_guidance (B, 8, H, W), by the chain
    rule K3's sums stage applies (sign(0) = 0 under 8sum_abs). Its plain
    version is torch autograd of prenorm_gates9."""
    if _check_call(guidance, 0, norm_type):
        return prenorm_gates9_bwd_plain(guidance, d_gates9, norm_type)
    b, _, h, w = guidance.shape
    dev = guidance.device
    _check_adjoint(dev, b, h, w, 0, planes=(("guidance", guidance, 8),
                                            ("d_gates9", d_gates9, 9)))
    d_guid = _empty((b, 8, h, w), dev)
    _launch("cspn_gates9_bwd", dev, guidance.data_ptr(), guidance.stride(0),
            d_gates9.data_ptr(), d_gates9.stride(0), d_guid.data_ptr(), b, h,
            w, NORM_TYPES.index(norm_type))
    cspn_gates9_bwd.launches += 1
    return d_guid


def cspn_bwd_sweep(gates9: torch.Tensor, sparse: torch.Tensor | None,
                   grad_out: torch.Tensor, *, num_iters: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of K3, K6 and K9, the lam recursion on the transposed
    stencil: gates9 (B, 9, H, W), sparse (B, H, W) or None and the
    cotangent grad_out (B, H, W) -> (the adjoint stash (B, T, H, W),
    stash[:, t] = lam^{t+1}, and lam^0 (B, H, W), both unmasked);
    ops/cspn_ref.py:adjoint_sweep_plain."""
    if _check_call(gates9, num_iters, None):
        return adjoint_sweep_plain(gates9, sparse, grad_out,
                                   num_iters=num_iters)
    b, _, h, w = gates9.shape
    dev = gates9.device
    _check_adjoint(dev, b, h, w, num_iters, planes=(
        ("gates9", gates9, 9), ("grad_out", grad_out, 0),
        ("sparse", sparse, 0)))
    lam0 = _empty((b, h, w), dev)
    lam_stash, lam_scratch = _stash_like(lam0, num_iters), torch.empty_like(
        lam0)
    _launch("cspn_bwd_sweep", dev, gates9.data_ptr(), gates9.stride(0),
            _ptr(sparse), _bstride(sparse), grad_out.data_ptr(),
            grad_out.stride(0), lam_stash.data_ptr(), lam0.data_ptr(),
            lam_scratch.data_ptr(), b, h, w, num_iters)
    cspn_bwd_sweep.launches += 1
    return lam_stash, lam0


def cspn_bwd_sums(sparse: torch.Tensor | None, stash: torch.Tensor,
                  lam_stash: torch.Tensor, *, num_iters: int,
                  guidance: torch.Tensor | None = None,
                  lam0: torch.Tensor | None = None,
                  norm_type: str | None = None) -> tuple[torch.Tensor, ...]:
    """Stage 2, the gate sums over the forward's stash and stage 1's
    adjoint stash (both contiguous (B, T, H, W)). Without guidance (K9):
    (d_gates9 (B, 9, H, W) = [G_0, G_1..8], d_sparse = sum_t m
    lam^{t+1}). With the raw guidance (B, 8, H, W), lam^0 and norm_type
    (K3, K6): (d_guidance, d_blur, d_sparse), the chain rule included;
    ops/cspn_ref.py:cspn_bwd_sums_plain."""
    if not (guidance is None) == (lam0 is None) == (norm_type is None):
        raise ValueError("guidance, lam0 and norm_type go together")
    kw = dict(num_iters=num_iters, guidance=guidance, lam0=lam0,
              norm_type=norm_type)
    if _check_call(stash, num_iters, norm_type):
        return cspn_bwd_sums_plain(sparse, stash, lam_stash, **kw)
    b, _, h, w = stash.shape
    dev = stash.device
    _check_adjoint(dev, b, h, w, num_iters, planes=(
        ("sparse", sparse, 0), ("guidance", guidance, 8), ("lam0", lam0, 0)),
        stashes=(("stash", stash), ("lam_stash", lam_stash)))
    d_guid = _empty((b, 9 if guidance is None else 8, h, w), dev)
    d_sparse = _empty((b, h, w), dev)
    d_blur = None if lam0 is None else _empty((b, h, w), dev).copy_(lam0)
    _launch("cspn_bwd_sums", dev, _ptr(guidance), _bstride(guidance),
            _ptr(sparse), _bstride(sparse), stash.data_ptr(),
            lam_stash.data_ptr(), d_guid.data_ptr(), _ptr(d_blur),
            d_sparse.data_ptr(), b, h, w, num_iters,
            0 if norm_type is None else NORM_TYPES.index(norm_type))
    cspn_bwd_sums.launches += 1
    if guidance is None:
        return d_guid, d_sparse
    return d_guid, d_blur, d_sparse


def cspn_prenorm_fwd(gates9: torch.Tensor, d0: torch.Tensor,
                     sparse: torch.Tensor | None, *, num_iters: int,
                     anchor_d0: bool = False,
                     geometry: int | None = None) -> torch.Tensor:
    """The spatial path's slab forward (K7): prenormalized gates9
    (B, 9, Hs, W) [centre, 8 gates], d0 (B, Hs, W) taken as given, or
    anchored on load with anchor_d0 (the slab route's first round), sparse
    (B, Hs, W) or None, all float32 with contiguous planes and any batch
    stride, on one rank's halo'd slab for the r = num_iters <= k iterations
    of one round -> (B, Hs, W); the anchor follows every iteration.

    A CUDA tensor goes to the kernel; a CPU tensor to the plain version.
    """
    if _check_call(gates9, num_iters, None):
        return cspn_prenorm_fwd_plain(gates9, d0, sparse, num_iters=num_iters,
                                      anchor_d0=anchor_d0)
    out = _forward("cspn_prenorm_fwd", gates9, d0, sparse, num_iters, None,
                   None, geometry, anchor_d0)
    cspn_prenorm_fwd.launches += 1
    return out


def cspn_prenorm_fwd_stash(gates9: torch.Tensor, d0: torch.Tensor,
                           sparse: torch.Tensor | None, *, num_iters: int,
                           anchor_d0: bool = False,
                           geometry: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The slab's training forward (K8): as cspn_prenorm_fwd, and also
    returns the stash (B, r, Hs, W) of every d^t. Its output equals
    cspn_prenorm_fwd's."""
    if _check_call(gates9, num_iters, None):
        return cspn_prenorm_fwd_stash_plain(gates9, d0, sparse,
                                            num_iters=num_iters,
                                            anchor_d0=anchor_d0)
    stash = _stash_like(d0, num_iters)
    out = _forward("cspn_prenorm_fwd_stash", gates9, d0, sparse, num_iters,
                   None, stash, geometry, anchor_d0)
    cspn_prenorm_fwd_stash.launches += 1
    return out, stash


def cspn_prenorm_bwd(gates9: torch.Tensor, sparse: torch.Tensor | None,
                     stash: torch.Tensor, grad_out: torch.Tensor, *,
                     num_iters: int, anchor_d0: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slab's adjoint (K9) on the stash of cspn_prenorm_fwd_stash:
    (d_gates9 (B, 9, Hs, W) = [G_0, G_1..8], lam0 = dL/dd^0 unmasked,
    d_sparse = sum_t m lam^{t+1}, zero without a sparse map). With
    anchor_d0 (d0 anchored on load), lam0 = (1 - m) dL/dd^0 and d_sparse
    also takes m dL/dd^0 (ops/cspn_ref.py:cspn_prenorm_bwd_plain)."""
    if _check_call(gates9, num_iters, None):
        return cspn_prenorm_bwd_plain(gates9, sparse, stash, grad_out,
                                      num_iters=num_iters,
                                      anchor_d0=anchor_d0)
    out = _prenorm_adjoint(gates9, sparse, stash, grad_out, num_iters,
                           anchor_d0)
    cspn_prenorm_bwd.launches += 1
    return out


WRAPPERS = (cspn_fwd, cspn_fwd_stash, cspn_bwd, cspn_tiled_fwd,
            cspn_tiled_fwd_stash, cspn_tiled_bwd, cspn_prenorm_fwd,
            cspn_prenorm_fwd_stash, cspn_prenorm_bwd, cspn_gates9,
            cspn_gates9_bwd)
# The adjoint's further stages alone; the adjoints launch them from C, not
# these.
STAGE_WRAPPERS = (cspn_bwd_sweep, cspn_bwd_sums)
for _wrapper in WRAPPERS + STAGE_WRAPPERS:
    _wrapper.launches = 0
