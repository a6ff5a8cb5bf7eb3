"""Throughput of the host's input pipeline and the data-versus-step split of
a short real training loop (the counterpart of the root
tools/bench_pipeline.py).

It first writes a packed-NYU dataset of procedural records
(tools/prepare_nyu.py's layout: raw 480x640 uint8 rgb and uint16 depth
memmaps), whose read and augmentation cost per record is the real
dataset's. Then:
  reader_ms_1thread          - memmap slice + uint16 -> f32 depth, a record
  read_augment_ms_1thread    - + the native augmentation (train transform)
  pipeline_ips               - make_train_iterator (read + augment + pack)
                               by worker-thread count
  pipeline_put_ips           - + the pinned copy to the card of every batch
                               (device_prefetch), at the most workers
  train_loop_*               - Trainer.train_epoch over --train-steps
                               steps, after a warm-up epoch: mean data ms
                               (waiting for a batch) and step ms per step,
                               img/s

    python -m cspn_monodepth_tpu_torch.tools.bench_pipeline [--records 512]
        [--batch 32] [--steps 16] [--workers 1,2,4,8] [--train-steps 8]
        [--skip-train] [--root DIR] [--config nyu_completion_500]
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.data.datasets import PackedNYUDataset
from cspn_monodepth_tpu_torch.data.pipeline import (
    DEVICE_AHEAD,
    device_prefetch,
    make_train_iterator,
)
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.train.loop import Trainer


def ensure_synth_packed(root: str, n: int, h: int = 480, w: int = 640):
    """Write a packed-NYU-format dataset of n procedural records under root
    (tools/prepare_nyu.py's memmap layout), unless one of at least n is
    there; the val split shares the train memmaps."""
    idx_path = os.path.join(root, "train_index.json")
    if os.path.isfile(idx_path):
        with open(idx_path) as f:
            if json.load(f)["n"] >= n:
                return
    os.makedirs(root, exist_ok=True)
    rgb_mm = np.lib.format.open_memmap(
        os.path.join(root, "train_rgb.u8.npy"), mode="w+",
        dtype=np.uint8, shape=(n, h, w, 3))
    dep_mm = np.lib.format.open_memmap(
        os.path.join(root, "train_depth.u16.npy"), mode="w+",
        dtype=np.uint16, shape=(n, h, w))
    rng = np.random.default_rng(0)
    base_rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    base_dep = (rng.uniform(0.5, 9.5, (h, w)) * 256).astype(np.uint16)
    for i in range(n):
        rgb_mm[i] = np.roll(base_rgb, i * 7, axis=1)
        dep_mm[i] = np.roll(base_dep, i * 7, axis=1)
    rgb_mm.flush()
    dep_mm.flush()
    del rgb_mm, dep_mm
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}_index.json"), "w") as f:
            json.dump({"n": n, "height": h, "width": w,
                       "depth_scale": 256.0, "files": []}, f)
    for kind in ("rgb.u8", "depth.u16"):
        dst = os.path.join(root, f"val_{kind}.npy")
        if not os.path.exists(dst):
            os.symlink(os.path.join(root, f"train_{kind}.npy"), dst)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "nyu_packed_bench"))
    ap.add_argument("--records", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--workers", default="1,2,4,8",
                    help="comma-separated worker-thread counts")
    ap.add_argument("--train-steps", type=int, default=8)
    ap.add_argument("--skip-train", action="store_true",
                    help="the host's stages only")
    ap.add_argument("--config", default="nyu_completion_500")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    workers = [int(v) for v in args.workers.split(",")]

    ensure_synth_packed(args.root, args.records)
    cfg = get_config(args.config).override(**{
        "data.dataset": "nyudepthv2", "data.root": args.root,
        "train.batch_size": args.batch, "data.num_workers": max(workers),
        "mesh.data": 1, "mesh.spatial": 1})
    ds = PackedNYUDataset(cfg.data, "train", seed=0)
    res = {"records": args.records, "batch": args.batch, "workers": workers,
           "host_cores": os.cpu_count(), "config": args.config,
           "device": line}

    def record_ms(fn, n=64):
        fn(0)                      # warm: page-in, the native build
        t0 = time.perf_counter()
        for i in range(n):
            fn(i % len(ds))
        return 1e3 * (time.perf_counter() - t0) / n

    res["reader_ms_1thread"] = record_ms(
        lambda i: (np.ascontiguousarray(ds.rgb[i]),
                   ds.depth[i].astype(np.float32) / 256.0))
    res["read_augment_ms_1thread"] = record_ms(lambda i: ds.get(i, epoch=0))

    def pipeline_ips(num_workers, consume=iter, ahead=0):
        """img/s of --steps batches after two warm-up batches; a consumer
        that reads `ahead` batches ahead gets as many more, so that the
        timed window produces --steps of them."""
        it = make_train_iterator(
            ds, global_batch=args.batch, epoch=0, seed=0,
            num_workers=num_workers, steps=args.steps + 2 + ahead)
        try:
            batches = iter(consume(it))
            next(batches)
            next(batches)          # warm: the workers, the pages
            t0 = time.perf_counter()
            for _ in batches:
                pass
            return args.steps * args.batch / (time.perf_counter() - t0)
        finally:
            it.close()

    res["pipeline_ips"] = {str(k): pipeline_ips(k) for k in workers}
    if not args.skip_train:
        res["pipeline_put_ips"] = pipeline_ips(
            max(workers), lambda it: device_prefetch(it, args.device),
            DEVICE_AHEAD)
        trainer = Trainer(cfg.override(**{
            "train.steps_per_epoch": args.train_steps,
            "train.log_every": 10 ** 9}), device=args.device)
        state = trainer.init_state()
        state, _ = trainer.train_epoch(state, 0, log=lambda *a: None)
        t0 = time.perf_counter()
        state, metrics = trainer.train_epoch(state, 1, log=lambda *a: None)
        wall = time.perf_counter() - t0    # closed by the losses' read
        if not np.isfinite(metrics["loss"]):
            raise AssertionError(f"train loss {metrics['loss']}")
        res["train_loop_steps"] = args.train_steps
        res["train_loop_data_ms_mean"] = 1e3 * metrics["data_time"]
        res["train_loop_step_ms_mean"] = 1e3 * metrics["step_time"]
        res["train_loop_wall_ips"] = args.train_steps * args.batch / wall
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
