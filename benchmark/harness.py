"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

Everything is found by name under benchmark/: the cell in
`workloads/<cell>.json` names its configuration (`configs/<config>.json`),
its traffic driver (`traffic/<driver>.py`) and the traffic's parameters;
`BENCHMARK.json` lists which end-to-end and per-layer metrics the cell
reports, and each per-layer metric is read by `metrics/<metric>.py`.

A traffic driver is a class `Driver(conf, traffic, seed, device)` whose
construction is the set-up (the program built, the seeded weights loaded,
the inputs made, the first steps or requests made and their readings
kept, every shape warmed up), with methods:

* `window(seconds) -> dict`: the measured window; returns the end-to-end
  values by metric name and "images", "seconds", "attempted", "failed";
* `traced(record)`: a fixed count of further steps or requests under the
  profiler, each inside a `record_function` span named "bm.<call>"; it
  sets record["calls"];
* `release()`: drops the program's state;
* `readings() -> dict`: the numbers compared (compare.py), the program's
  against the reference's at the stated precision.

A driver's module also has `control(conf, traffic, seed, device, fault)`,
the same numbers with the reference at a lower precision
(`reference/model.py:LOWER`) or with a fault put in the program's place,
which calibrate.py reads and the benchmark's runs do not.

The limits of the numbers compared are the workload file's "limits".
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import tracing

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "cspn_monodepth_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str, where: Path = HERE) -> dict:
    return read_json(where / "workloads" / f"{name}.json")


def config(name: str, where: Path = HERE) -> dict:
    return read_json(where / "configs" / f"{name}.json")


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def traffic_module(name: str, where: Path = HERE):
    """traffic/<name>.py: its `Driver` and `control`."""
    return _load(where / "traffic" / f"{name}.py", "benchmark_traffic_")


def metric_reader(name: str, where: Path = HERE):
    """`read(record) -> float | None` of metrics/<name>.py."""
    return _load(where / "metrics" / f"{name}.py", "benchmark_metric_").read


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that `cell`
    reports: those that list it under "workloads", or list none."""
    def mine(m):
        return cell in m.get("workloads", [cell])
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, flax's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ------------------------------------------------------------- program

def train_seed(seed: int) -> int:
    """The seed of the program's sparse draws for the run's --seed."""
    return seed % 2 ** 32


def port_config(conf: dict, traffic: dict, seed: int):
    """The program's Config: its named config with the configuration
    file's and the traffic's overrides, held to the configuration file."""
    from cspn_monodepth_tpu_torch.configs import get_config

    overrides = dict(conf["port"]["overrides"])
    overrides.update(traffic.get("port_overrides", {}))
    overrides["train.seed"] = train_seed(seed)
    cfg = get_config(conf["port"]["config"]).override(**overrides)
    m, d, t = conf["model"], conf["data"], conf["train"]
    stated = {
        "model.modality": m["modality"], "model.num_iters": m["num_iters"],
        "model.norm_type": m["norm_type"], "model.dtype":
        m["precision"]["network"],
        "model.encoder_block": m["encoder_block"],
        "model.decoder_block": m["decoder_block"],
        "data.height": d["height"], "data.width": d["width"],
        "data.num_samples": d["num_samples"],
        "data.max_depth": d["max_depth"], "data.sampler": "uniform",
        "train.optimizer": t["optimizer"], "train.lr": t["lr"],
        "train.momentum": t["momentum"],
        "train.weight_decay": t["weight_decay"],
        "train.clip_norm": t["clip_norm"], "train.loss": t["loss"],
        "train.encoder_lr_mult": 1.0,
        "mesh.data": conf["mesh"]["data"],
        "mesh.spatial": conf["mesh"]["spatial"]}
    differ = {k: (getattr(getattr(cfg, k.split(".")[0]), k.split(".")[1]), v)
              for k, v in stated.items()
              if getattr(getattr(cfg, k.split(".")[0]), k.split(".")[1]) != v}
    if differ:
        raise ValueError(f"the program's config differs from "
                         f"{conf['name']}.json (program, file): {differ}")
    return cfg


def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Copy the seeded tensors into the program's model by name; the two
    must hold exactly the same float tensors."""
    own = {k: v for k, v in model.state_dict().items()
           if v.is_floating_point()}
    if set(own) != set(weights) or any(
            own[k].shape != weights[k].shape for k in own):
        missing = sorted(set(weights) ^ set(own))[:8]
        raise ValueError(f"the program's tensors differ from the "
                         f"configuration's: {missing}")
    with torch.no_grad():
        names = list(own)
        torch._foreach_copy_([own[k] for k in names],
                             [weights[k] for k in names])


# ------------------------------------------------------------- tracing

def profiled(fn, device: str) -> dict:
    """Run fn() under torch.profiler and return the plain record of the
    stretch (tracing.py)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    record: dict = {}
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("bm.stretch"):
            fn(record)
            if device == "cuda":
                torch.cuda.synchronize()
    kernels, spans, ops, stretch = [], [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # The device timeline's copies of the harness's spans are not
            # device work.
            if not (e.name.startswith("bm.") or e.is_user_annotation):
                kernels.append([e.name, start, end])
        elif e.name == "bm.stretch":
            stretch = [start, end]
        elif e.name.startswith("bm."):
            spans.append([e.name, start, end])
        elif e.cpu_parent is not None and e.cpu_parent.name.startswith(
                "bm.") and e.cpu_parent.name != "bm.stretch":
            ops.append([e.name, start, end])
    record.update(kernels=kernels, spans=spans, ops=ops, stretch=stretch)
    return record


# ------------------------------------------------------------- the run

def run(cell: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, where: Path = HERE, bench: dict | None = None
        ) -> tuple[dict, list[str]]:
    """One run of `cell`; returns the result line's object and the lines
    of the numbers compared (number and limit each)."""
    bench = spec() if bench is None else bench
    work = workload(cell, where)
    conf = config(work["config"], where)
    end_to_end, per_layer = cell_metrics(bench, cell)

    driver = traffic_module(work["driver"], where).Driver(
        conf, work["traffic"], seed, device)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print("bm: set-up s from process start: " + ", ".join(
        f"{name} {t - t_start:.2f}" for name, t in driver.marks),
        file=sys.stderr)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    values = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = {"calls": values["attempted"], "images": values["images"],
              "seconds": values["seconds"],
              "img_per_s": values["images"] / values["seconds"],
              "peak_bytes": peak}
    values["setup_s"] = setup_s

    result: dict = {"correct": False, "attempted": values["attempted"],
                    "failed": values["failed"], "metrics": {}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        record = profiled(driver.traced, device)
        record.update(window=window, device_name=device_info["kind"],
                      batch=work["traffic"]["batch"], counts=conf["counts"])
        for m in per_layer:
            value = metric_reader(m["name"], where)(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if record["kernels"]:
            lo, hi = record["stretch"]
            device_info.update(busy_s=tracing.busy_us(record) / 1e6,
                               window_s=(hi - lo) / 1e6)
            result["breakdown"] = {
                "device_ops": tracing.device_ops(record),
                "idle_gaps": tracing.idle_gaps(record)}
        classes = {k: round(v, 3) for k, v in
                   sorted(tracing.by_class(record).items())}
        print(f"bm: traced {record.get('calls')} calls, device ms by "
              f"class {classes}", file=sys.stderr)
    else:
        for m in end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["device"] = device_info

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.readings()
    limits = work["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    result["correct"] = all(v <= limits[k] for k, v in readings.items())
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines
