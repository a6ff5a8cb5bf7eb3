"""Headline benchmark of the port: images/s for train + CSPN-refined
inference (the counterpart of the root bench.py).

    python -m cspn_monodepth_tpu_torch.bench       # on the card

Environment, as the root bench.py reads it: BENCH_BATCH (32), BENCH_ITERS
(10, the chain length N), BENCH_CONFIG (nyu_completion_500; kitti_1216
gives the KITTI cell) and BENCH_PARITY (0 skips the parity block).

Prints ONE JSON line with the root bench's keys:
  {"metric": ..., "value": N, "unit": "images/s/chip", "vs_baseline": N,
   "train_images_per_sec": ..., "infer_images_per_sec": ..., "batch": ...,
   "chain_len": N, "dispatch_overhead_ms": ..., "backend": "cuda",
   "device": "<name>, <power limit>", "parity": {...}}

Method: utils/profiling.py `marginal_chain`, two chains of N and 5N serial
steps each closed by one scalar read back to the host, the step being
(t_5N - t_N) / 4N; `dispatch_overhead_ms` is the chain's fixed cost that
the difference cancels. PyTorch runs eagerly, so the host's launches of
every step are inside what is timed, as a training loop pays them.
* The train chain runs `Trainer.train_step` with a fresh step tag per step
  (the root bench's `fold_in(r, i)`), and chains each step's loss plus
  every metric-sum leaf times 1e-12 (`consume_sums`): the read-back
  depends on each leaf, as the root bench makes XLA keep them. A train
  step updates the weights in place, so the model and optimizer are put
  back to their initial state before every chain (and once at the end),
  outside the clock, as each JAX chain restarts from the same state.
* The eval chain runs `Trainer.eval_step` with `valid_image` ones and
  chains mean(pred) * 1e-9 plus the metric-sum leaves.
* The inputs are seeded random float32 tensors made on the device before
  timing (the root bench's), which `_to_device`/`_unpack` pass through
  without a copy: no transfer is timed.
* The mesh is clamped to 1x1: one process is one rank, as the root bench
  clamps the mesh to the chips it sees.
* combined = 1 / (1/train + 1/infer).

The parity block (`ops/parity.py`, at the root bench's shapes: the 3 x 3
kernels at NYU's 228x304 or KITTI's 352x1216, and the slab kernels on a
96x304 or 104x1216 slab) runs on the card before timing; it is null on
the CPU and with BENCH_PARITY=0.

vs_baseline: combined over the combined img/s of tools/torch_baseline.py
(the reference architecture with its per-iteration CSPN loop) measured on
a card of the same name at the same batch, read from bench_baseline.json
beside this file; null where there is none (the root BENCH_BASELINE.json
is a CPU's).
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path

import numpy as np
import torch

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.train.loop import Trainer
from cspn_monodepth_tpu_torch.train.metrics import FIELDS, MetricSums
from cspn_monodepth_tpu_torch.utils import profiling

BASELINE = Path(__file__).resolve().parent / "bench_baseline.json"


def consume_sums(sums: MetricSums) -> torch.Tensor:
    """Every metric-sum leaf folded into one scalar, 1e-12 of their sum:
    numerically irrelevant, but the chained value depends on each."""
    return sum(getattr(sums, f).sum() for f in FIELDS) * 1e-12


def train_body(trainer: Trainer, state, batch: dict, i: int) -> torch.Tensor:
    """One step of the train chain: train_step on tag i, its loss plus the
    consumed metric sums."""
    state, loss, sums = trainer.train_step(state, batch, i)
    return loss + consume_sums(sums)


def eval_body(trainer: Trainer, state, batch: dict, acc: torch.Tensor,
              i: int) -> torch.Tensor:
    """One step of the eval chain: eval_step on batch index i folded into
    the accumulator with its consumed metric sums."""
    sums, pred = trainer.eval_step(state, batch, i)
    return acc + pred.mean() * 1e-9 + consume_sums(sums)


class Snapshot:
    """The model's and optimizer's state and the step count, copied once;
    `restore()` puts them back in place."""

    def __init__(self, state):
        self.state = state
        self.model = copy.deepcopy(state.model.state_dict())
        self.optimizer = copy.deepcopy(state.optimizer.state_dict())
        self.step = state.step

    def restore(self):
        self.state.model.load_state_dict(self.model)
        self.state.optimizer.load_state_dict(self.optimizer)
        self.state.step = self.step


def synthetic_batch(batch: int, h: int, w: int, device) -> dict:
    """The root bench's inputs: rgb U[0, 1) and depth U[0.5, 9.5) from
    default_rng(0), float32, on the device."""
    rng = np.random.default_rng(0)
    rgb = rng.random((batch, h, w, 3), dtype="float32")
    depth = rng.uniform(0.5, 9.5, (batch, h, w)).astype("float32")
    return {"rgb": torch.from_numpy(rgb).to(device),
            "depth": torch.from_numpy(depth).to(device)}


def parity_block(config_name: str) -> dict:
    """ops/parity.py's checks at the root bench's shapes, keyed to the
    config: they raise where a kernel disagrees."""
    from cspn_monodepth_tpu_torch.ops.parity import (
        cspn_parity_check,
        prenorm_parity_check,
    )

    parity = {}
    if "kitti" in config_name:
        parity["tiled_352x1216"] = cspn_parity_check(
            norms=("8sum_clamp",), batch=2, h=352, w=1216)
        # KITTI 4-way-spatial slab: 352/4 interior + 2*8 halo rows.
        parity["prenorm_104x1216"] = prenorm_parity_check(
            batch=2, h=104, w=1216, num_iters=8)
    else:
        parity["whole_plane_228x304"] = cspn_parity_check(
            norms=("8sum_clamp", "8sum_abs"), batch=2)
        parity["prenorm_96x304"] = prenorm_parity_check(
            batch=2, h=96, w=304, num_iters=8)
    return parity


def baseline_ips(device_line: str, batch: int) -> float | None:
    """The combined img/s of the torch baseline measured on a card of the
    same name as `device_line`'s at the same batch, or None."""
    if not BASELINE.exists():
        return None
    base = json.loads(BASELINE.read_text())
    name = device_line.split(",")[0].strip()
    if (base.get("device", "").split(",")[0].strip() != name
            or base.get("batch") != batch):
        return None
    return base.get("combined_ips") or None


def main(device: str = "cuda") -> dict:
    """Run the bench on `device` ("cpu" for the tests: the plain CSPN, no
    parity, no baseline) and print its JSON line; returns it."""
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    n_chain = int(os.environ.get("BENCH_ITERS", "10"))
    config_name = os.environ.get("BENCH_CONFIG", "nyu_completion_500")
    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; nothing was run")

    parity = None
    if os.environ.get("BENCH_PARITY", "1") != "0" and on_card:
        parity = parity_block(config_name)

    cfg = get_config(config_name).override(**{
        "data.dataset": "synthetic",     # the bench feeds random tensors
        "train.batch_size": batch,
        "train.steps_per_epoch": 1,
        # One process is one rank: the mesh clamped to the one device.
        "mesh.data": 1,
        "mesh.spatial": 1,
    })
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    snapshot = Snapshot(state)
    h, w = cfg.data.height, cfg.data.width
    dev_batch = synthetic_batch(batch, h, w, trainer.device)

    last = []

    def train_step(carry, _):
        value, i = carry
        value = train_body(trainer, state, dev_batch, i)
        last[:] = [value]
        return value, i + 1

    zero = torch.zeros((), device=trainer.device)
    t_train, dispatch_s = profiling.marginal_chain(
        train_step, (zero, 0), n=n_chain, reset=snapshot.restore)
    # The last chain's final value, as the root bench asserts its loss.
    if not bool(torch.isfinite(last[0])):
        raise AssertionError(f"non-finite train loss {float(last[0])}")
    train_ips = batch / t_train

    eval_batch = {**dev_batch,
                  "valid_image": torch.ones(batch, device=trainer.device)}

    def eval_step(carry, _):
        acc, i = carry
        return eval_body(trainer, state, eval_batch, acc, i), i + 1

    t_infer, _ = profiling.marginal_chain(
        eval_step, (zero, 0), n=n_chain, reset=snapshot.restore)
    snapshot.restore()
    infer_ips = batch / t_infer
    combined = 1.0 / (1.0 / train_ips + 1.0 / infer_ips)

    device_line = profiling.card() if on_card else "cpu"
    base = (baseline_ips(device_line, batch)
            if on_card and "nyu" in config_name else None)
    vs_baseline = combined / base if base else None
    label = ("NYU 304x228" if "nyu" in config_name else
             f"{config_name} {w}x{h}")
    line = {
        "metric": (f"train+infer images/s/chip, {label} rgbd, "
                   "ResNet50-UNet + 24-iter CSPN"),
        "value": round(combined, 2),
        "unit": "images/s/chip",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        "train_images_per_sec": round(train_ips, 2),
        "infer_images_per_sec": round(infer_ips, 2),
        "batch": batch,
        "chain_len": n_chain,
        "dispatch_overhead_ms": round(dispatch_s * 1e3, 1),
        "backend": "cuda" if on_card else "cpu",
        "device": device_line,
        "parity": parity,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
