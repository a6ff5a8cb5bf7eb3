"""The readings that the limits of `correct` are set from: the program's on
a dozen seeds and more, and the control's (the reference at the precision
below the configuration's, put in the program's place) on three and more,
at the cell's own size, in one process. The benchmark's own runs do not
run it.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control 1,2,3 [--faults precision,network,half_batch] \
        [--seconds 2]

Each program seed's set-up is a run's; serving cells then serve
`--seconds` of the cell's load to have answers to compare. A control seed
needs no program: its reference at a lower precision ("precision", one
step below the configuration's everywhere; "network", the encoder and
decoder alone) or, for training, with half of each batch left out
("half_batch"), is compared with its reference at the stated one. Prints
one JSON line a seed ("side", "seed", the numbers; for a training
program seed also "worst", the leaves that set the leaf numbers) and one
with the largest program reading and the smallest of each control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import compare, harness  # noqa: E402


def program(cell: str, seeds: list, seconds: float, device: str,
            where: Path = harness.HERE) -> list:
    """The program's readings, a full set-up a seed (and for serving
    `seconds` of the cell's load)."""
    work = harness.workload(cell, where)
    conf = harness.config(work["config"], where)
    out = []
    for seed in seeds:
        driver = harness.traffic_module(work["driver"], where).Driver(
            conf, work["traffic"], seed, device)
        if "sparse_samples" in work["traffic"]:
            driver.window(seconds)
        driver.release()
        _free(device)
        numbers = driver.readings()
        if hasattr(driver, "ref"):
            numbers["worst"] = compare.worst_leaves(driver.first, driver.ref)
        out.append(_line(cell, "program", seed, numbers))
        del driver
        _free(device)
    return out


def control(cell: str, seeds: list, fault: str, device: str,
            where: Path = harness.HERE) -> list:
    """The readings with the reference at the precision below the
    configuration's ("precision") or with a planted fault in the
    program's place."""
    work = harness.workload(cell, where)
    conf = harness.config(work["config"], where)
    module = harness.traffic_module(work["driver"], where)
    return [_line(cell, fault, seed,
                  module.control(conf, work["traffic"], seed, device, fault))
            for seed in seeds]


def _free(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _line(cell: str, side: str, seed: int, numbers: dict) -> dict:
    line = {"cell": cell, "side": side, "seed": seed, **numbers}
    print(json.dumps(line), flush=True)
    return line


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="precision",
                   help="comma-separated: precision, network, half_batch")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    prog = program(a.workload, ints(a.seeds), a.seconds, a.device)
    others = {f: control(a.workload, ints(a.control), f, a.device)
              for f in a.faults.split(",") if f}
    numbers = [k for k in (prog or next(iter(others.values())))[0]
               if k not in ("cell", "side", "seed", "worst")]
    summary = {k: {"program_max": max((r[k] for r in prog), default=None),
                   **{f"{f}_min": min(r[k] for r in rows)
                      for f, rows in others.items() if rows}}
               for k in numbers}
    print(json.dumps({"cell": a.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
