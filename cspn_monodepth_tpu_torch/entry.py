"""Entry points: the flagship forward and a multi-rank dry run (the
counterpart of the root __graft_entry__.py).

    fn, args = entry()                  # on "cuda"; entry(device="cpu")
    depth = fn(*args)                   # (1, 228, 304, 1)
    dryrun_multichip(8)                 # one train step per mesh layout

`dryrun_multichip` starts one process per rank (parallel/launch.py
`spawn_ranks`). With a card per rank they run over NCCL, rank r on
cuda:r; with fewer cards than ranks they share cuda:0 over gloo (NCCL
refuses two ranks on one device); with device="cpu" they run on the CPU
over gloo.
"""

from __future__ import annotations

import numpy as np
import torch

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.parallel.launch import spawn_ranks
from cspn_monodepth_tpu_torch.train.loop import Trainer

RANK_TIMEOUT_S = 600


def entry(device: str = "cuda"):
    """(fn, args): the forward of the flagship model, NYU 228x304 depth
    completion (rgbd, 24-iteration CSPN, eval mode, seeded weights), and a
    zero (1, 228, 304, 4) input on `device`. fn runs without a gradient,
    so the CSPN takes its inference kernel (K1); fn.model is the module."""
    model = CSPNDepthNet(modality="rgbd", num_iters=24).to(device).eval()
    x = torch.zeros((1, 228, 304, 4), device=device)

    @torch.no_grad()
    def fn(x):
        return model(x)

    fn.model = model
    return fn, (x,)


def layouts(n_devices: int) -> list[tuple[int, int]]:
    """The (data, spatial) meshes a dry run over n_devices takes: the
    data-major one (the host8_dp class) and, where n is a multiple of 4,
    the spatial-major one (the kitti_1216 mesh)."""
    if n_devices >= 4 and n_devices % 4 == 0:
        return [(n_devices // 2, 2), (2, n_devices // 2)]
    if n_devices % 2 == 0:
        return [(n_devices // 2, 2)]
    return [(n_devices, 1)]


def _dryrun_rank(rank: int, data: int, spatial: int, device: str,
                 nccl: bool) -> dict:
    """One rank's train step of the dry run on its share of the global
    batch, on cuda:rank under NCCL, on cuda:0 where the ranks share a
    card, or on the CPU; its loss, layout and the CSPN kernels'
    launches."""
    if device != "cpu":
        device = f"cuda:{rank if nccl else 0}"
        torch.cuda.set_device(device)
    # synthetic_tiny at the root dry run's shapes.
    cfg = get_config("synthetic_tiny").override(**{
        "mesh.data": data,
        "mesh.spatial": spatial,
        "train.batch_size": 2 * data,
        "data.height": 32 * spatial,   # H divides the spatial axis
        "data.width": 128,
        "model.num_iters": 4,
    })
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    h, w, b = cfg.data.height, cfg.data.width, cfg.train.batch_size
    batch = {
        "rgb": np.random.default_rng(0).random((b, h, w, 3), np.float32),
        "depth": np.random.default_rng(1).uniform(
            0.5, 9.5, (b, h, w)).astype(np.float32),
    }
    index, count = trainer._share()
    share = b // count
    mine = {k: v[index * share:(index + 1) * share] for k, v in batch.items()}
    cspn_cuda.reset_launch_counts()
    state, loss, _ = trainer.train_step(state, mine)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: rank {rank} loss {loss}")
    return dict(loss=loss, layout=trainer.layout,
                launches=cspn_cuda.launch_counts())


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[dict]:
    """One full train step on every mesh layout of `layouts(n_devices)`,
    each on n_devices ranks at tiny shapes: the batch over "data", H over
    "spatial" (the "images" layout where the batch splits over every rank,
    else "rows"). Prints one line per mesh; returns rank 0's loss, layout
    and kernel launches for each."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")
    nccl = device != "cpu" and torch.cuda.device_count() >= n_devices
    out = []
    for data, spatial in layouts(n_devices):
        results = spawn_ranks(
            _dryrun_rank, n_devices, data, spatial, device, nccl,
            backend="nccl" if nccl else "gloo", timeout=RANK_TIMEOUT_S)
        first = results[0]
        print(f"dryrun_multichip ok: mesh=({data},{spatial}) "
              f"layout={first['layout']} loss={first['loss']:.4f}",
              flush=True)
        out.append(dict(mesh=(data, spatial), **first))
    return out

