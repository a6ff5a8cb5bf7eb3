"""What the serving drivers share (traffic/serve_single.py, serve_batch.py):
a closed loop of one client with no think time, each request numpy in and
numpy out through the program's `DepthPredictor`.

Traffic parameters: `batch` (frames a request), `pool` (seeded requests,
cycled in order), `sparse_samples`, `depth_range`, `keep_share` (the share
of the window's answers kept for the comparison, drawn from the seed),
`traced` (requests under the profiler).

Set-up builds the predictor, loads the seeded weights and serves every
request of the pool once (the one shape the traffic uses). In the window
each request is timed on the host from the call to the returned array:
`serve_ms_p50` and `serve_ms_p95` over every request of the window, and
`serve_img_per_s`, the frames returned over the window, from the first
call to the end of the last. A cell reports those BENCHMARK.json names
for it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.compare import answer_gap
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps
from benchmark.weights import make_weights

KEEP_STREAM = 3


class ServeDriver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device: str):
        from cspn_monodepth_tpu_torch.models import CSPNDepthNet
        from cspn_monodepth_tpu_torch.serving import DepthPredictor

        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = device
        self.marks = [("imported", time.perf_counter())]
        cfg = harness.port_config(conf, traffic, seed)
        d = conf["data"]
        self.predictor = DepthPredictor(CSPNDepthNet.from_config(cfg.model),
                                        d["height"], d["width"], device)
        self.marks.append(("built", time.perf_counter()))
        spec = ref_model.Spec.from_config(conf)
        harness.load_weights(self.predictor.model,
                             make_weights(ref_model.shapes(spec), seed,
                                          device))
        self.rgb, self.sparse = inputs.serve_pool(traffic, d["height"],
                                                  d["width"], seed, device)
        self.marks.append(("weights and inputs", time.perf_counter()))
        self.kept: list = []
        self.call(0)
        self.marks.append(("first request", time.perf_counter()))
        for i in range(1, traffic["pool"]):
            self.call(i)
        self.marks.append(("warm", time.perf_counter()))

    def call(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def window(self, seconds: float) -> dict:
        rng = np.random.default_rng([self.seed % 2 ** 64, KEEP_STREAM])
        pool, share = self.traffic["pool"], self.traffic["keep_share"]
        latency = []
        t0 = end = time.perf_counter()
        while end - t0 < seconds:
            i = len(latency) % pool
            start = time.perf_counter()
            out = self.call(i)
            end = time.perf_counter()
            latency.append(end - start)
            if rng.random() < share:
                self.kept.append((i, out))
        ms = 1e3 * np.asarray(latency)
        images = len(latency) * self.traffic["batch"]
        elapsed = end - t0
        return {"serve_ms_p50": float(np.percentile(ms, 50)),
                "serve_ms_p95": float(np.percentile(ms, 95)),
                "serve_img_per_s": images / elapsed, "images": images,
                "seconds": elapsed, "attempted": len(latency),
                "failed": sum(not np.all(np.isfinite(o))
                              for _, o in self.kept)}

    def traced(self, record: dict) -> None:
        n = self.traffic["traced"]
        for k in range(n):
            with torch.profiler.record_function(f"bm.{self.NAME}"):
                self.call(k % self.traffic["pool"])
        record["calls"] = n

    def release(self) -> None:
        self.predictor = None

    def readings(self) -> dict:
        """The number compared: the program's sampled answers against the
        reference's at the stated precision."""
        needed = sorted({i for i, _ in self.kept})
        ref = reference(self.conf, self.traffic, self.seed, self.device,
                        needed, ref_model.STATED)
        return {"answer_gap": answer_gap(self.kept, ref)}


def reference(conf: dict, traffic: dict, seed: int, device: str,
              needed: list, precision) -> np.ndarray:
    """The reference's answers, from the seed alone, to the pool's requests
    `needed` (the others zero), (P, B, H, W)."""
    d = conf["data"]
    spec = ref_model.Spec.from_config(conf)
    weights = make_weights(ref_model.shapes(spec), seed, device)
    rgb, sparse = inputs.serve_pool(traffic, d["height"], d["width"], seed,
                                    device)
    b = traffic["batch"]
    ref = np.zeros((traffic["pool"], b, d["height"], d["width"]), np.float32)
    for i in needed:
        ref[i] = ref_steps.serve(weights, rgb[i], sparse[i], conf, precision,
                                 block=b)
    return ref


def control(conf: dict, traffic: dict, seed: int, device: str,
            fault: str = "precision") -> dict:
    """The number compared with the reference at a lower precision (a key
    of `ref_model.LOWER`) put in the program's place, on every request of
    the pool."""
    needed = list(range(traffic["pool"]))
    ref = reference(conf, traffic, seed, device, needed, ref_model.STATED)
    low = reference(conf, traffic, seed, device, needed,
                    ref_model.LOWER[fault])
    return {"answer_gap": answer_gap([(i, low[i]) for i in needed], ref)}
