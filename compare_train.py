"""Time the NYU (batch 32) and KITTI (batch 8) train steps of one checkout
on one GPU, as chip_smoke.py's train phases do: 3 warm-up steps, 10 timed
steps on a fixed batch, the peak memory over them, and one step under
torch.profiler (device busy ms, the CSPN kernels' ms).

    python3 compare_train.py ROOT LABEL

ROOT is a checkout of the repository; its own chip_smoke.py and package are
imported. To compare two commits on one card, run both on that card, in
turns: parent, change, change, parent. Prints one line "AB {json}".
"""
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

out = {"label": sys.argv[2]}
for name, cfg, b in (
        ("nyu", cs.train_config(), cs.TRAIN_BATCH),
        ("kitti", cs.kitti_config(**{"data.dataset": "synthetic"}),
         cs.KITTI_BATCH)):
    variables = cs.randomized_variables(cfg)
    trainer = cs.Trainer(cfg)
    state = trainer.init_state(variables)
    batch = cs.fixed_batch(trainer, b)
    for _ in range(3):
        state, loss, _ = trainer.train_step(state, batch)
    float(loss)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batch)
        float(loss)
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batch)
        float(loss)
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy = sum(v for _, v in dev)
    out[name] = dict(
        ms_p50=float(np.median(ms)), ms=ms, peak_gb=peak, wall_ms=wall,
        busy_ms=busy,
        cspn_ms=sum(v for k, v in dev if "cspn" in k or "adjoint" in k))
    del trainer, state, batch, variables
    torch.cuda.empty_cache()
print("AB " + json.dumps(out), flush=True)
