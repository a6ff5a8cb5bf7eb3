"""The work of one image at a configuration's shapes, counted on the plain
reference (benchmark/reference/) on the meta device: no data, no device.

* `flops_per_image`: "forward", the FLOPs `torch.utils.flop_counter`
  counts in a forward pass (convolutions; the CSPN's elementwise
  iterations count none), and "train", forward + backward (the weight
  gradients of every convolution, and the input gradients of all but the
  first, whose input needs none);
* `cspn_bytes_per_image`: the CSPN op's contract in float32, each
  operand once a call: "forward" reads the guidance's 8 planes, blur and
  sparse and writes the output (11 planes); "backward" reads grad_out,
  the guidance, blur and sparse and writes d_guidance and d_blur (20).

The numbers are written into the configuration file once (`python3
benchmark/count.py <config>` prints them); a test holds the file to them,
so the yardstick does not move with the program.

    python3 benchmark/count.py nyu_completion_500
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.reference.model import Spec, forward, shapes  # noqa: E402

CSPN_PLANES = {"forward": 8 + 1 + 1 + 1, "backward": 1 + 8 + 1 + 1 + 8 + 1}


def counts(conf: dict) -> dict:
    spec = Spec.from_config(conf)
    h, w = conf["data"]["height"], conf["data"]["width"]
    meta = torch.device("meta")
    params = {k: torch.empty(s, device=meta).requires_grad_(
        not k.endswith(("running_mean", "running_var")))
        for k, s in shapes(spec).items()}
    x = torch.empty((1, h, w, spec.in_channels), device=meta)
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            forward(params, x, spec, train=True)
    with FlopCounterMode(display=False) as train:
        forward(params, x, spec, train=True).sum().backward()
    return {"flops_per_image": {"forward": fwd.get_total_flops(),
                                "train": train.get_total_flops()},
            "cspn_bytes_per_image": {k: 4 * n * h * w
                                     for k, n in CSPN_PLANES.items()}}


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    for name in sys.argv[1:]:
        conf = json.loads((here / "configs" / f"{name}.json").read_text())
        print(name, json.dumps(counts(conf)))
