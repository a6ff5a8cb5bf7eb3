"""The ("data", "spatial") mesh on torch.distributed (counterpart of
cspn_monodepth_tpu/parallel/mesh.py).

The JAX package lays a 2-D device mesh out and lets GSPMD shard every array
on it: the batch over "data", and for large images the H axis of the feature
and depth maps over "spatial". PyTorch has no such partitioner, so the port
computes the same function with this layout on `data * spatial` ranks:

* the network is data-parallel over all ranks: rank r holds images
  [r b, (r + 1) b) of the global batch, b = B / (data * spatial), with
  BatchNorm statistics, the loss, the gradients and the metric sums reduced
  over the world group (models/resnet.py, train/);
* only the CSPN runs on H slabs over "spatial" (parallel/halo.py): inside
  each spatial group an all_to_all turns "b whole images per rank" into "the
  data group's S b images, H / S rows each", as JAX's
  `cspn_propagate_spatial` shards them, and a second one brings the refined
  depth back.

Ranks are numbered data-major: rank = d * spatial + s, as
`np.reshape(devices, (data, spatial))` orders the JAX mesh. Multi-host
bootstrap is `init_distributed()` under torchrun, the counterpart of
`jax.distributed.initialize()`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

# A rank that died leaves the others waiting in a collective; this makes
# them fail instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a data x spatial mesh and its process groups."""

    data: int
    spatial: int
    rank: int                   # d * spatial + s
    world_group: object         # all data * spatial ranks
    data_group: object          # the ranks of this rank's spatial index s
    spatial_group: object       # the ranks of this rank's data index d
    device: torch.device

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def d(self) -> int:
        return self.rank // self.spatial

    @property
    def s(self) -> int:
        return self.rank % self.spatial


def make_mesh(cfg, device: str | torch.device = "cuda") -> Mesh:
    """The mesh of cfg (a configs.MeshConfig) over the initialized process
    group, one rank per position; refuses, as the JAX package's make_mesh
    asserts, when the world does not have data * spatial ranks. Every rank
    creates every group, in the same order."""
    data, spatial = cfg.data, cfg.spatial
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * spatial:
        raise ValueError(f"mesh {data}x{spatial} needs {data * spatial} "
                         f"ranks, have {world}")
    rank = dist.get_rank()
    spatial_groups = [dist.new_group([d * spatial + s for s in range(spatial)])
                      for d in range(data)]
    data_groups = [dist.new_group([d * spatial + s for d in range(data)])
                   for s in range(spatial)]
    return Mesh(data=data, spatial=spatial, rank=rank,
                world_group=dist.group.WORLD,
                data_group=data_groups[rank % spatial],
                spatial_group=spatial_groups[rank // spatial],
                device=torch.device(device))


def init_distributed(device: str = "cuda",
                     backend: str | None = None) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment) and return
    this rank's device: for "cuda", cuda:LOCAL_RANK over NCCL, and a
    RuntimeError where there is no card; for "cpu", the CPU over gloo.
    `backend` overrides the choice (gloo lets several ranks share one
    card)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' to run the ranks on the CPU")
        rank_device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                              0)))
        torch.cuda.set_device(rank_device)
    elif device == "cpu":
        rank_device = torch.device("cpu")
    else:
        raise ValueError(f"init_distributed: unknown device {device!r}")
    dist.init_process_group(
        backend or ("nccl" if device == "cuda" else "gloo"),
        init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT)
    return rank_device
