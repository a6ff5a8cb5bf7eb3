"""Time serving of one checkout on one GPU, as chip_smoke.py's serving
phases do: DepthPredictor.predict on nyu_completion_500 (K1) and
kitti_1216 on one device (K4) with seeded random weights, SERVE_REQUESTS
closed-loop requests after a warm-up (host clock, each ending in the copy
back), median and p75; predict_batch at each config's batch (32, 8),
BATCH_CALLS calls the same way; and the no-gradient CSPN call alone at B=1
(cspn_propagate on the heads' shapes, host clock, each ending in a
synchronize), the host time that the operator's dispatch adds to.

    python3 compare_serving.py ROOT LABEL

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

import chip_smoke as cs  # noqa: E402

SERVE_REQUESTS = 200
BATCH_CALLS = 20
CSPN_CALLS = 400


def quantiles(ms: list) -> dict:
    return dict(ms_p50=float(np.median(ms)),
                ms_p75=float(np.percentile(ms, 75)))


out = {"label": sys.argv[2]}
for name, cfg, depth_range, batch in (
        ("nyu", cs.get_config("nyu_completion_500"), (0.5, 9.5),
         cs.TRAIN_BATCH),
        ("kitti", cs.kitti_config(), (1.0, cs.KITTI_MAX_DEPTH),
         cs.KITTI_BATCH)):
    h, w = cfg.data.height, cfg.data.width
    predictor = cs.DepthPredictor.from_variables(
        cfg, cs.randomized_variables(cfg))
    rgb, sparse = cs.requests(np.random.default_rng(cs.SEED), batch, h, w,
                              depth_range=depth_range)
    for i in range(5):
        predictor.predict(rgb[i], sparse[i])
    cs.reset_counts()
    ms = []
    for i in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        predictor.predict(rgb[i % 8], sparse[i % 8])
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = {k: v for k, v in cs.counts().items() if v}
    for _ in range(3):
        predictor.predict_batch(rgb, sparse)
    batch_ms = []
    for _ in range(BATCH_CALLS):
        t0 = time.perf_counter()
        predictor.predict_batch(rgb, sparse)
        batch_ms.append(1e3 * (time.perf_counter() - t0))

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    guid, blur, sp = cs.cspn_problem(gen, 1, h, w, strided=True)
    kw = dict(num_iters=cfg.model.num_iters, norm_type=cfg.model.norm_type,
              guidance_layout="NCHW")
    with torch.inference_mode():
        for _ in range(10):
            cs.cspn_propagate(guid, blur, sp, **kw)
        cspn_ms = []
        for _ in range(CSPN_CALLS):
            t0 = time.perf_counter()
            cs.cspn_propagate(guid, blur, sp, **kw)
            torch.cuda.synchronize()
            cspn_ms.append(1e3 * (time.perf_counter() - t0))
    out[name] = dict(predict=quantiles(ms), requests=SERVE_REQUESTS,
                     launches=launches, predict_batch=quantiles(batch_ms),
                     batch=batch, batch_calls=BATCH_CALLS,
                     cspn_b1=quantiles(cspn_ms), cspn_calls=CSPN_CALLS)
    del predictor
    torch.cuda.empty_cache()
print("AB " + json.dumps(out), flush=True)
