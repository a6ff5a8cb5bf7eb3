"""The forward kernels' launch plan (ops/cspn_cuda.py:fwd_plan), on the CPU.

csrc/cspn_fwd.cu runs a forward call as rounds of recompute-in-halo tiles,
each round one launch over the whole batch; the wrapper picks the tile
geometry by shape, a stash call (K2, K5, K8) as the plain call of its
shape. These tests hold the pure-Python plan to what the kernel needs:
each geometry has a halo of at least the spatial path's 4 rows and a
block that fits an H100's threads, shared memory and registers, the
library is rebuilt when the geometry table changes, and a shape or
geometry the kernel cannot serve raises. The kernels themselves
run only on the card (tests/test_torch_cuda.py); on CPU tensors the
wrappers take the plain version whatever geometry they are given.
"""

import math

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.ops.cspn_ref import anchor, prenorm_gates9

SHAPES = [(1, 228, 304), (9, 228, 304), (32, 228, 304), (1, 352, 1216),
          (3, 352, 1216), (8, 352, 1216), (4, 96, 1216), (16, 122, 304),
          (65535, 8, 8), (2, 2000, 3000)]

# What an H100 block may hold (threads, static shared memory) and what one
# SM holds (threads, registers, shared memory).
MAX_THREADS, MAX_STATIC_SMEM = 1024, 48 * 1024
SM_THREADS, SM_REGISTERS, SM_SMEM = 2048, 65536, 228 * 1024


def geometry_resources(geometry: int) -> dict:
    """What one block of a geometry holds: threads, static shared memory
    (bytes; two (SLAB + 2)^2 planes of d, in every variant: a stash
    variant's threads store from their registers), the registers a thread may use
    under its MINB cap (allocated in units of 8) and the registers its
    pixels' state takes at least (9 gates, an anchor and d for each of RUN
    pixels)."""
    tile, halo, run, minb = cspn_cuda.FWD_GEOMETRIES[geometry]
    slab = tile + 2 * halo
    threads = slab * (slab // run)
    return dict(slab=slab, threads=threads, smem=2 * (slab + 2) ** 2 * 4,
                register_cap=min(255, SM_REGISTERS // (threads * minb)
                                 // 8 * 8),
                state_registers=11 * run)


@pytest.mark.parametrize("b,h,w", SHAPES)
@pytest.mark.parametrize("t", [0, 4, 24])
def test_the_default_plan_is_the_geometry_by_shape(b, h, w, t):
    geometry = cspn_cuda.fwd_plan(b, h, w, t)
    assert geometry == cspn_cuda.pick_geometry(b, h, w, t)
    assert 0 <= geometry < len(cspn_cuda.FWD_GEOMETRIES)


@pytest.mark.parametrize("geometry", range(len(cspn_cuda.FWD_GEOMETRIES)))
def test_each_geometry_fits_a_block(geometry):
    tile, halo, run, minb = cspn_cuda.FWD_GEOMETRIES[geometry]
    res = geometry_resources(geometry)
    assert halo >= 4          # K7/K8's rounds of r <= 4 are one launch
    assert res["slab"] == tile + 2 * halo and res["slab"] % run == 0
    assert run <= 32          # a run's interior mask is one 32-bit word
    assert res["threads"] <= MAX_THREADS and res["threads"] % 32 == 0
    assert minb * res["threads"] <= SM_THREADS
    assert res["smem"] <= MAX_STATIC_SMEM
    assert minb * res["smem"] <= SM_SMEM
    assert res["state_registers"] < res["register_cap"] <= 255


@pytest.mark.parametrize("b,h,w", SHAPES)
@pytest.mark.parametrize("t", [1, 4, 24])
def test_the_chosen_geometry_serves_the_shape(b, h, w, t):
    geometry = cspn_cuda.pick_geometry(b, h, w, t)
    _, halo, _, _ = cspn_cuda.FWD_GEOMETRIES[geometry]
    assert halo >= 4
    # The spatial path's rounds of r <= 4 iterations are one launch.
    assert t > 4 or cspn_cuda.rounds(geometry, t) == 1
    # A geometry the caller gives is kept.
    assert cspn_cuda.fwd_plan(b, h, w, t, geometry=0) == 0


@pytest.mark.parametrize("b,h,w,kw", [
    (0, 228, 304, {}), (65536, 228, 304, {}), (-1, 8, 8, {}),
    (1, 0, 304, {}), (1, 228, 0, {}), (1, 47000, 47000, {}),
    (4, 228, 304, {"geometry": -1}),
    (4, 228, 304, {"geometry": len(cspn_cuda.FWD_GEOMETRIES)})])
def test_the_plan_raises_on_what_the_kernel_cannot_serve(b, h, w, kw):
    with pytest.raises(ValueError):
        cspn_cuda.fwd_plan(b, h, w, 24, **kw)


def test_the_geometry_table_is_built_into_the_library(monkeypatch):
    """The source instantiates its round kernel from the table, so the
    library's digest covers it: another table is another library."""
    header = cspn_cuda.geometry_header()
    assert header.startswith("#define CSPN_FWD_GEOMETRIES(G) ")
    assert header.count("G(") == len(cspn_cuda.FWD_GEOMETRIES)
    for tile, halo, run, minb in cspn_cuda.FWD_GEOMETRIES:
        assert f"G({tile}, {halo}, {run}, {minb})" in header
    before = cspn_cuda.library_path("cspn_fwd")
    monkeypatch.setattr(cspn_cuda, "FWD_GEOMETRIES",
                        cspn_cuda.FWD_GEOMETRIES[:-1])
    assert cspn_cuda.library_path("cspn_fwd") != before


@pytest.mark.parametrize("geometry", range(len(cspn_cuda.FWD_GEOMETRIES)))
def test_rounds_are_ceil_t_over_halo(geometry):
    halo = cspn_cuda.FWD_GEOMETRIES[geometry][1]
    assert cspn_cuda.rounds(geometry, 0) == 1
    assert cspn_cuda.rounds(geometry, 1) == 1
    assert cspn_cuda.rounds(geometry, halo) == 1
    assert cspn_cuda.rounds(geometry, halo + 1) == 2
    assert cspn_cuda.rounds(geometry, 24) == math.ceil(24 / halo)


def test_cpu_tensors_take_the_plain_version_under_any_geometry():
    rng = np.random.default_rng(0)
    guid = torch.from_numpy(rng.standard_normal((3, 8, 13, 17)).astype(
        np.float32))
    blur = torch.from_numpy(rng.uniform(0.5, 9.5, (3, 13, 17)).astype(
        np.float32))
    sp = torch.where(torch.from_numpy(rng.random((3, 13, 17)) < 0.1),
                     blur + 0.25, torch.zeros_like(blur))
    kw = dict(num_iters=9, norm_type="8sum_clamp")
    want = cspn_cuda.cspn_fwd_plain(guid, blur, sp, **kw)
    before = cspn_cuda.cspn_fwd.launches
    got = cspn_cuda.cspn_fwd(guid, blur, sp, **kw, geometry=1)
    assert torch.equal(got, want) and cspn_cuda.cspn_fwd.launches == before
    assert torch.equal(
        cspn_cuda.cspn_tiled_fwd(guid, blur, sp, **kw, geometry=2),
        cspn_cuda.cspn_tiled_fwd_plain(guid, blur, sp, **kw))
    g9, d0 = prenorm_gates9(guid, "8sum_clamp"), anchor(blur, sp)
    assert torch.equal(
        cspn_cuda.cspn_prenorm_fwd(g9, d0, sp, num_iters=9, geometry=2),
        cspn_cuda.cspn_prenorm_fwd_plain(g9, d0, sp, num_iters=9))


def pr6_geometry(b: int, h: int, w: int, num_iters: int) -> int:
    """K1's, K4's and K7's geometry by shape as the H100 sweep set it
    (PERF.md section 6)."""
    if num_iters <= 4:
        return 0
    px = b * h * w
    return 1 if px < 200_000 else 2 if px < 3_000_000 else 3


@pytest.mark.parametrize("b,h,w", SHAPES)
@pytest.mark.parametrize("t", [0, 4, 24])
def test_k1_and_k4_keep_their_plan(b, h, w, t):
    assert cspn_cuda.fwd_plan(b, h, w, t) == pr6_geometry(b, h, w, t)


@pytest.mark.parametrize("b,h,w", SHAPES + [(2, 57, 75), (2, 13, 17),
                                            (2, 13, 16)])
@pytest.mark.parametrize("t", [1, 4, 24])
def test_the_stash_plan_serves_the_shape(b, h, w, t):
    """A stash call's launch plan: the geometry by shape, its rounds, and
    whether more than one round runs (the wrapper's scratch)."""
    geometry, more = cspn_cuda._launch_plan(b, h, w, t, None)
    assert geometry == cspn_cuda.pick_geometry(b, h, w, t)
    assert 0 <= geometry < len(cspn_cuda.FWD_GEOMETRIES)
    # The spatial path's rounds of r <= 4 iterations are one launch.
    assert t > 4 or cspn_cuda.rounds(geometry, t) == 1
    assert more == (cspn_cuda.rounds(geometry, t) > 1)


def test_cpu_stash_calls_take_the_plain_version_under_any_geometry():
    rng = np.random.default_rng(1)
    guid = torch.from_numpy(rng.standard_normal((2, 8, 13, 16)).astype(
        np.float32))
    blur = torch.from_numpy(rng.uniform(0.5, 9.5, (2, 13, 16)).astype(
        np.float32))
    sp = torch.where(torch.from_numpy(rng.random((2, 13, 16)) < 0.1),
                     blur + 0.25, torch.zeros_like(blur))
    kw = dict(num_iters=6, norm_type="8sum")
    want = cspn_cuda.cspn_fwd_stash_plain(guid, blur, sp, **kw)
    g9, d0 = prenorm_gates9(guid, "8sum"), anchor(blur, sp)
    want9 = cspn_cuda.cspn_prenorm_fwd_stash_plain(g9, d0, sp, num_iters=6)
    stashes = (cspn_cuda.cspn_fwd_stash, cspn_cuda.cspn_tiled_fwd_stash,
               cspn_cuda.cspn_prenorm_fwd_stash)
    before = [fn.launches for fn in stashes]
    for geometry in range(len(cspn_cuda.FWD_GEOMETRIES)):
        for got, ref in ((cspn_cuda.cspn_fwd_stash(guid, blur, sp, **kw,
                                                   geometry=geometry), want),
                         (cspn_cuda.cspn_tiled_fwd_stash(
                             guid, blur, sp, **kw, geometry=geometry), want),
                         (cspn_cuda.cspn_prenorm_fwd_stash(
                             g9, d0, sp, num_iters=6, geometry=geometry),
                          want9)):
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [fn.launches for fn in stashes] == before
