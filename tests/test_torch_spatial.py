"""The port's spatially sharded CSPN (parallel/halo.py) on gloo ranks of the
CPU against the JAX package's `cspn_propagate_spatial` on the same mesh of
forced host devices, and against the port's whole-image op.

Each mesh's scenarios run inside one spawn of data * spatial ranks
(parallel/launch.py: file rendezvous under tmp_path, a deadline after which
every rank is killed). The ranks import this module without JAX: JAX is
imported only by the fixtures that compute the references, in the pytest
process. Inputs are made with numpy from a seed.
* Forward, T = 10, halo_k in {1, 3, 4}, sparse on and off: each rank takes
  its block of the data group's images and of the rows, as JAX's shard_map
  does; the assembled result against JAX's on the same mesh (its scan slab
  body, impl="jnp": tests/test_torch_prenorm.py holds the slab kernels'
  contract against JAX's interpreted ones) and against the port's
  whole-image `cspn_propagate`, at tests/test_sharding.py's tolerance for
  the JAX slab kernels (2e-4 relative and absolute).
* H = 30 rows on spatial 4 (not a multiple): whole images per rank
  through `scatter_rows`/`gather_rows`, which pad and crop.
* The gradients of guidance, blur and sparse for a random cotangent
  against `jax.vjp` of JAX's op, at tests/test_sharding.py's gradient
  tolerance for its slab kernels (rtol 5e-4, atol 1e-4), the atol scaled
  to the gradient's magnitude as tests/test_cspn_pallas.py:_assert_close
  scales it: the port's hand adjoint sums in another order than JAX's
  autodiff of the scan (one of 49152 guidance gradients, 0.18, lands
  2.4e-4 away on the 2x4 mesh).
* The number of halo exchanges: ceil(T / k) for the depth, one for the
  gates, one for the sparse map (tests/test_sharding.py's amortization
  count).
* `init_distributed` joins the group that torchrun's environment names.
"""

import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch.configs import MeshConfig
from cspn_monodepth_tpu_torch.ops import cspn_propagate
from cspn_monodepth_tpu_torch.parallel import (
    cspn_propagate_spatial,
    exchange_halo,
    gather_rows,
    make_mesh,
    scatter_rows,
    spawn_ranks,
)

MESHES = [(2, 4), (4, 2), (1, 2)]
T = 10
NORM = "8sum_clamp"
B, H, W = 8, 32, 24
H_ODD = 30
FWD_TOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-4
# (halo_k, sparse map)
FWD_CASES = [(k, s) for k in (1, 3, 4) for s in (True, False)]
GRAD_K = 3
DEADLINE_S = 240
JAX_IMPL = "jnp"


def problem(h, seed=0):
    """Guidance N(0, 1) channels-last (B, h, W, 8), blur U(0.1, 10), ~10%
    anchors, cotangent N(0, 1)."""
    rng = np.random.default_rng(seed)
    guid = rng.standard_normal((B, h, W, 8)).astype(np.float32)
    blur = rng.uniform(0.1, 10.0, (B, h, W)).astype(np.float32)
    sp = np.where(rng.random((B, h, W)) < 0.1,
                  rng.uniform(0.1, 10.0, (B, h, W)), 0.0).astype(np.float32)
    cot = rng.standard_normal((B, h, W)).astype(np.float32)
    return guid, blur, sp, cot


def _block(x, mesh):
    """This rank's block of a (B, H, ...) array: its data index's images
    and its spatial index's rows, as shard_map's P("data", "spatial")."""
    b, h = x.shape[0] // mesh.data, x.shape[1] // mesh.spatial
    return x[mesh.d * b:(mesh.d + 1) * b, mesh.s * h:(mesh.s + 1) * h]


def _run_ranks(rank, data, spatial):
    """Every scenario on one mesh; returns this rank's results."""
    mesh = make_mesh(MeshConfig(data=data, spatial=spatial), device="cpu")
    guid, blur, sp, cot = problem(H)
    out = {"rank": rank, "d": mesh.d, "s": mesh.s}
    for k, with_sparse in FWD_CASES:
        exchange_halo.calls = 0
        with torch.no_grad():
            got = cspn_propagate_spatial(
                torch.from_numpy(_block(guid, mesh)).permute(0, 3, 1, 2),
                torch.from_numpy(_block(blur, mesh)),
                torch.from_numpy(_block(sp, mesh)) if with_sparse else None,
                mesh=mesh, num_iters=T, norm_type=NORM, halo_k=k)
        out[("fwd", k, with_sparse)] = got.numpy()
        out[("exchanges", k, with_sparse)] = exchange_halo.calls

    # Gradients of all three inputs of this rank's block.
    inputs = [torch.from_numpy(_block(x, mesh)).requires_grad_()
              for x in (guid, blur, sp)]
    got = cspn_propagate_spatial(inputs[0].permute(0, 3, 1, 2), *inputs[1:],
                                 mesh=mesh, num_iters=T, norm_type=NORM,
                                 halo_k=GRAD_K)
    (got * torch.from_numpy(_block(cot, mesh))).sum().backward()
    out["grads"] = [x.grad.numpy() for x in inputs]

    # Whole images per rank through the reshard, H not a multiple of S.
    guid, blur, sp, _ = problem(H_ODD, seed=1)
    b = B // mesh.size
    mine = slice(rank * b, (rank + 1) * b)
    planes = torch.from_numpy(np.concatenate(
        [blur[mine, None], guid[mine].transpose(0, 3, 1, 2), sp[mine, None]],
        axis=1))
    shards = scatter_rows(planes, mesh)
    refined = cspn_propagate_spatial(
        shards[:, 1:9], shards[:, 0], shards[:, 9], mesh=mesh, num_iters=T,
        norm_type=NORM, halo_k=4)
    out["odd"] = gather_rows(refined[:, None], mesh, H_ODD)[:, 0].numpy()
    out["odd_shard_rows"] = shards.shape[2]
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, tmp_path_factory):
    data, spatial = request.param
    init = tmp_path_factory.mktemp("spatial") / "rendezvous"
    results = spawn_ranks(_run_ranks, data * spatial, data, spatial,
                          timeout=DEADLINE_S, init_file=str(init))
    return dict(data=data, spatial=spatial, results=results)


def _assemble(ranks, key):
    """The (B, H, W) array from every rank's block."""
    rows = {}
    for r in ranks["results"]:
        rows.setdefault(r["d"], {})[r["s"]] = r[key]
    return np.concatenate([np.concatenate([rows[d][s] for s in sorted(
        rows[d])], axis=1) for d in sorted(rows)], axis=0)


def _jax_spatial(ranks, *args, **kw):
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.configs import MeshConfig as JaxMeshConfig
    from cspn_monodepth_tpu.parallel import (
        cspn_propagate_spatial as jax_spatial,
        make_mesh as jax_make_mesh,
    )

    mesh = jax_make_mesh(JaxMeshConfig(data=ranks["data"],
                                       spatial=ranks["spatial"]))
    fn = jax.jit(functools.partial(jax_spatial, mesh=mesh, num_iters=T,
                                   norm_type=NORM, impl=JAX_IMPL, **kw))
    return fn(*[None if a is None else jnp.asarray(a) for a in args]), mesh


def _port_whole(guid, blur, sp):
    return cspn_propagate(torch.from_numpy(guid), torch.from_numpy(blur),
                          None if sp is None else torch.from_numpy(sp),
                          num_iters=T, norm_type=NORM, impl="torch").numpy()


@pytest.mark.parametrize("k,with_sparse", FWD_CASES)
def test_spatial_forward_matches_jax_and_whole_image(ranks, k, with_sparse):
    guid, blur, sp, _ = problem(H)
    sp = sp if with_sparse else None
    got = _assemble(ranks, ("fwd", k, with_sparse))
    want, _ = _jax_spatial(ranks, guid, blur, sp, halo_k=k)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(got, _port_whole(guid, blur, sp),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("k,with_sparse", FWD_CASES)
def test_halo_exchange_count_matches_amortization_math(ranks, k,
                                                       with_sparse):
    want = math.ceil(T / k) + 1 + int(with_sparse)
    assert all(r[("exchanges", k, with_sparse)] == want
               for r in ranks["results"])


def test_spatial_gradients_match_jax_vjp(ranks):
    import jax
    import jax.numpy as jnp

    guid, blur, sp, cot = problem(H)
    _, mesh = _jax_spatial(ranks, guid, blur, sp, halo_k=GRAD_K)

    from cspn_monodepth_tpu.parallel import (
        cspn_propagate_spatial as jax_spatial,
    )

    def fn(g, d, s):
        return jax_spatial(g, d, s, mesh=mesh, num_iters=T, norm_type=NORM,
                           halo_k=GRAD_K, impl=JAX_IMPL)

    _, vjp = jax.vjp(jax.jit(fn), jnp.asarray(guid), jnp.asarray(blur),
                     jnp.asarray(sp))
    want = vjp(jnp.asarray(cot))
    for i, name in enumerate(("guidance", "blur", "sparse")):
        rows = {}
        for r in ranks["results"]:
            rows.setdefault(r["d"], {})[r["s"]] = r["grads"][i]
        got = np.concatenate([np.concatenate(
            [rows[d][s] for s in sorted(rows[d])], axis=1)
            for d in sorted(rows)], axis=0)
        want_i = np.asarray(want[i])
        scale = max(1.0, float(np.abs(want_i).max()))
        np.testing.assert_allclose(got, want_i, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


INIT_DISTRIBUTED = """
import torch, torch.distributed as dist
from cspn_monodepth_tpu_torch.configs import MeshConfig
from cspn_monodepth_tpu_torch.parallel import init_distributed, make_mesh
device = init_distributed(device="cpu")
mesh = make_mesh(MeshConfig(data=1, spatial=1), device=device)
x = torch.ones(3)
dist.all_reduce(x, group=mesh.world_group)
print(device, dist.get_backend(), dist.get_world_size(), mesh.rank, x.sum())
dist.destroy_process_group()
"""


def test_init_distributed_joins_the_group_torchrun_describes():
    """torchrun's environment in a fresh process without a card, asked for
    the CPU: gloo, the world and rank it names (MASTER_PORT=0: the store
    picks a free port)."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="0",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", INIT_DISTRIBUTED], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True, cwd=Path(__file__).parents[1])
    assert out.stdout.split() == ["cpu", "gloo", "1", "0", "tensor(3.)"]


def test_init_distributed_without_a_card_raises():
    """No CPU fallback: asked for the default "cuda" where no card is
    visible, init_distributed raises before it joins any group."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="0",
               CUDA_VISIBLE_DEVICES="")
    code = ("from cspn_monodepth_tpu_torch.parallel import init_distributed\n"
            "init_distributed()\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=Path(__file__).parents[1])
    assert out.returncode != 0
    assert "RuntimeError: init_distributed: no CUDA device" in out.stderr


def test_non_divisible_height_pads_and_crops(ranks):
    guid, blur, sp, _ = problem(H_ODD, seed=1)
    got = np.concatenate([r["odd"] for r in ranks["results"]])
    assert got.shape == (B, H_ODD, W)
    assert all(r["odd_shard_rows"] == math.ceil(H_ODD / ranks["spatial"])
               for r in ranks["results"])
    want, _ = _jax_spatial(ranks, guid, blur, sp, halo_k=4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(got, _port_whole(guid, blur, sp),
                               rtol=FWD_TOL, atol=FWD_TOL)
