"""Back-to-back `Trainer.train_step` calls of CSPN++'s context-aware CSPN
(benchmark/reference/cspnpp.py): traffic/train.py's traffic, whose set-up
here loads the CSPN++ network's seeded weights and whose readings compare
with the CSPN++ reference. The traffic's parameters are train.py's.

Set-up also holds the program's stencil sizes, checkpoints and `arch` to
the configuration file, beside what `harness.port_config` holds.
"""

from __future__ import annotations

import math
import time

from benchmark import harness, inputs
from benchmark.compare import train_readings
from benchmark.reference import cspnpp
from benchmark.reference import model as ref_model
from benchmark.traffic import train
from benchmark.weights import make_weights


def check_model(cfg, conf: dict) -> None:
    """Raise where the program's CA-CSPN differs from the file's."""
    m = conf["model"]
    stated = {"model.cspn_kernel_sizes": tuple(m["kernel_sizes"]),
              "model.cspn_checkpoints": tuple(m["checkpoints"]),
              "model.arch": m["arch"]}
    differ = {k: (getattr(cfg.model, k[6:]), v) for k, v in stated.items()
              if getattr(cfg.model, k[6:]) != v}
    if differ:
        raise ValueError(f"the program's config differs from "
                         f"{conf['name']}.json (program, file): {differ}")


class Driver(train.Driver):
    def __init__(self, conf: dict, traffic: dict, seed: int, device: str):
        from cspn_monodepth_tpu_torch.train.loop import Trainer

        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = device
        self.marks = [("imported", time.perf_counter())]
        cfg = harness.port_config(conf, traffic, seed)
        check_model(cfg, conf)
        self.trainer = Trainer(cfg, device=device)
        self.state = self.trainer.init_state()
        self.marks.append(("built", time.perf_counter()))
        harness.load_weights(self.state.model, make_weights(
            cspnpp.shapes(cspnpp.Spec.from_config(conf)), seed, device))
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

    def readings(self) -> dict:
        """The program's first steps against the CSPN++ reference's at the
        stated precision (kept in `self.ref`)."""
        self.ref = reference(self.conf, self.traffic, self.seed,
                             self.device, ref_model.STATED)
        return train_readings(self.first, self.ref)


def reference(conf: dict, traffic: dict, seed: int, device: str, precision,
              images: int | None = None) -> dict:
    """The CSPN++ reference's first steps from the seed alone, on the
    program's weights and batches (the first `images` of each batch where
    given)."""
    d = conf["data"]
    weights = make_weights(cspnpp.shapes(cspnpp.Spec.from_config(conf)),
                           seed, device)
    rgb, depth = inputs.train_pool(traffic, d["height"], d["width"], seed,
                                   device)
    batches = [(rgb[i, :images].clone(), depth[i, :images].clone())
               for i in range(train.FIRST_STEPS)]
    del rgb, depth
    out = cspnpp.train_steps(weights, batches, conf,
                             harness.train_seed(seed), precision)
    if not all(math.isfinite(x) for x in out["losses"]):
        out["losses"] = [math.inf] * len(out["losses"])
    return out


def control(conf: dict, traffic: dict, seed: int, device: str,
            fault: str = "precision") -> dict:
    """The numbers compared with the CSPN++ reference in the program's
    place: at a lower precision (a key of `ref_model.LOWER`: "precision"
    lowers the head, the propagation and the mix to bf16 and the network
    to fp8), or with half of each batch left out ("half_batch")."""
    ref = reference(conf, traffic, seed, device, ref_model.STATED)
    if fault == "half_batch":
        other = reference(conf, traffic, seed, device, ref_model.STATED,
                          images=traffic["batch"] // 2)
    else:
        other = reference(conf, traffic, seed, device,
                          ref_model.LOWER[fault])
    return train_readings(other, ref)
