"""The ("data", "spatial") mesh on torch.distributed (counterpart of
cspn_monodepth_tpu/parallel/mesh.py).

The JAX package lays a 2-D device mesh out and lets GSPMD shard every array
on it: the batch over "data", and for large images the H axis of the feature
and depth maps over "spatial". PyTorch has no such partitioner; the port
computes the same function on `data * spatial` ranks in one of two layouts
(`choose_layout`), with BatchNorm statistics, the loss, the gradients and
the metric sums reduced over the ranks (models/resnet.py, train/):

* "rows", JAX's layout: the global batch splits over "data" only, and rank
  (d, s) computes, of the data group's images [d b, (d + 1) b), b = B /
  data, only its rows of every feature map, the depth and the CSPN
  (parallel/rows.py: ceil(H_l / S) rows a rank at each level, halos
  exchanged in the spatial group);
* "images": the network is data-parallel over all ranks, rank r holding
  whole images [r b, (r + 1) b), b = B / (data * spatial), and only the
  CSPN runs on H slabs over "spatial" (parallel/halo.py): an all_to_all
  turns "b whole images per rank" into "the data group's S b images,
  H / S rows each", and a second one brings the refined depth back.

"auto" takes "images" where the batch splits over every rank (fewer
exchanges: two all_to_alls and the CSPN's halos a forward) and "rows"
where it splits over "data" only.

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


LAYOUTS = ("auto", "images", "rows")


def choose_layout(mesh: Mesh | None, batch_size: int | None,
                  layout: str = "auto") -> str:
    """The layout ("images" or "rows") of a model on `mesh` for the global
    `batch_size`: "auto" is "images" where the batch splits over data *
    spatial ranks (or is not given, or there is no mesh) and "rows" where
    it splits over mesh.data only. Refuses a batch that does not split over
    mesh.data, "images" for one that does not split over every rank, and
    "rows" without a spatial axis > 1.

    The criterion is per-rank memory and exchanges a step, measured on one
    card time-shared by every rank (PERF.md): where both layouts apply,
    images held less memory and made fewer exchanges. How the two compare
    in step time across several cards is not measured yet, and may change
    this choice."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: one of {LAYOUTS}")
    if layout == "rows" and (mesh is None or mesh.spatial == 1):
        raise ValueError("the rows layout needs a spatial axis > 1")
    if mesh is None or batch_size is None:
        return "rows" if layout == "rows" else "images"
    if batch_size % mesh.data:
        raise ValueError(f"batch {batch_size} does not split over the "
                         f"{mesh.data}x{mesh.spatial} mesh's {mesh.data} "
                         "data groups")
    if layout == "auto":
        layout = "images" if batch_size % mesh.size == 0 else "rows"
    if layout == "images" and batch_size % mesh.size:
        raise ValueError(f"batch {batch_size} does not split over the "
                         f"{mesh.data}x{mesh.spatial} mesh's {mesh.size} "
                         "ranks: the images layout needs a multiple")
    return layout


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
