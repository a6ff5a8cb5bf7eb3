"""Back-to-back `Trainer.train_step` calls, the program's training entry.

Traffic parameters: `batch`, `pool` (seeded device batches, cycled),
`depth_range`, `valid_share`, `warmup` (steps after the first three) and
`traced` (steps under the profiler).

Set-up builds one Trainer and its state, loads the seeded weights, and
drives it through its first three steps on three different batches of
the pool; their losses, the first step's gradient norms (from the
optimizer's momentum after one step) and the parameters' change over the
three are kept for the comparison with the reference. The window then
continues the same state: `train_img_per_s` is the images of every step
enqueued over the time from a synchronize before the first to a
synchronize after the last.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness, inputs
from benchmark.compare import train_readings
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps
from benchmark.weights import make_weights

FIRST_STEPS = 3


class Driver:
    def __init__(self, conf: dict, traffic: dict, seed: int, device: str):
        from cspn_monodepth_tpu_torch.train.loop import Trainer

        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = device
        self.marks = [("imported", time.perf_counter())]
        cfg = harness.port_config(conf, traffic, seed)
        self.trainer = Trainer(cfg, device=device)
        self.state = self.trainer.init_state()
        self.marks.append(("built", time.perf_counter()))
        spec = ref_model.Spec.from_config(conf)
        harness.load_weights(self.state.model,
                             make_weights(ref_model.shapes(spec), seed,
                                          device))
        d = conf["data"]
        self.rgb, self.depth = inputs.train_pool(traffic, d["height"],
                                                 d["width"], seed, device)
        self._sync()
        self.marks.append(("weights and inputs", time.perf_counter()))
        self.first = self._first_steps()
        self.marks.append(("first steps", time.perf_counter()))
        for _ in range(traffic["warmup"]):
            self._step()
        self._sync()
        self.marks.append(("warm", time.perf_counter()))

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _batch(self, i: int) -> dict:
        k = i % self.traffic["pool"]
        return {"rgb": self.rgb[k], "depth": self.depth[k]}

    def _step(self):
        _, loss, _ = self.trainer.train_step(self.state, self._batch(self.i))
        self.i += 1
        return loss

    def _first_steps(self) -> dict:
        """The first steps' readings, as the program's state holds them."""
        model, opt = self.state.model, self.state.optimizer
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        wd = self.conf["train"]["weight_decay"]
        losses, first_grad = [], None
        self.i = 0
        for step in range(FIRST_STEPS):
            losses.append(self._step())
            if step == 0:
                # SGD's momentum after one step is the clipped gradient
                # plus the weight decay; a parameter it did not touch has
                # none.
                first_grad = ref_steps.leaf_norms(
                    {k: opt.state.get(p, {}).get("momentum_buffer",
                                                 wd * start[k]) - wd * start[k]
                     for k, p in params.items()})
        change = ref_steps.leaf_norms(
            {k: p.detach() - start[k] for k, p in params.items()})
        return {"losses": [float(x) for x in losses],
                "first_grad": first_grad, "change": change}

    def window(self, seconds: float) -> dict:
        losses = []
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            losses.append(self._step())
        self._sync()
        elapsed = time.perf_counter() - t0
        steps = len(losses)
        images = steps * self.traffic["batch"]
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"train_img_per_s": images / elapsed, "images": images,
                "seconds": elapsed, "attempted": steps, "failed": failed}

    def traced(self, record: dict) -> None:
        for _ in range(self.traffic["traced"]):
            with torch.profiler.record_function("bm.train_step"):
                self._step()
        record["calls"] = self.traffic["traced"]

    def release(self) -> None:
        self.state = self.trainer = self.rgb = self.depth = None

    def readings(self) -> dict:
        """The numbers compared: the program's first steps against the
        reference's at the stated precision (kept in `self.ref`)."""
        self.ref = reference(self.conf, self.traffic, self.seed,
                             self.device, ref_model.STATED)
        return train_readings(self.first, self.ref)


def reference(conf: dict, traffic: dict, seed: int, device: str, precision,
              images: int | None = None) -> dict:
    """The reference's first steps from the seed alone: the same weights
    and batches as the program's set-up (the first `images` of each batch
    where given)."""
    d = conf["data"]
    spec = ref_model.Spec.from_config(conf)
    weights = make_weights(ref_model.shapes(spec), seed, device)
    rgb, depth = inputs.train_pool(traffic, d["height"], d["width"], seed,
                                   device)
    batches = [(rgb[i, :images].clone(), depth[i, :images].clone())
               for i in range(FIRST_STEPS)]
    del rgb, depth
    out = ref_steps.train_steps(weights, batches, conf, harness.train_seed(seed),
                                precision)
    if not all(math.isfinite(x) for x in out["losses"]):
        out["losses"] = [math.inf] * len(out["losses"])
    return out


def control(conf: dict, traffic: dict, seed: int, device: str,
            fault: str = "precision") -> dict:
    """The numbers compared with the reference put in the program's place:
    at a lower precision (a key of `ref_model.LOWER`), or with half of
    each batch left out and the mean taken over the rest ("half_batch")."""
    ref = reference(conf, traffic, seed, device, ref_model.STATED)
    if fault == "half_batch":
        other = reference(conf, traffic, seed, device, ref_model.STATED,
                          images=traffic["batch"] // 2)
    else:
        other = reference(conf, traffic, seed, device,
                          ref_model.LOWER[fault])
    return train_readings(other, ref)
