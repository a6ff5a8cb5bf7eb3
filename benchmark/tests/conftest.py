"""Fixtures of the benchmark's CPU tests: a checkout-like directory with the
tiny configuration (the program's synthetic_tiny architecture), one tiny
cell per real cell, the real traffic drivers and metric readers, and the
spec that lists the tiny cells where BENCHMARK.json lists the real ones.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

# tiny cell -> the real cell it copies, its driver and its traffic
TINY = {
    "tiny-train": ("nyu500-train-b32", "train", {
        "batch": 2, "pool": 4, "warmup": 1, "traced": 2,
        "port_overrides": {"train.batch_size": 2}}),
    "tiny-serve-b1": ("kitti1216-serve-b8", "serve_single", {
        "batch": 1, "pool": 4, "sparse_samples": 50, "keep_share": 0.5,
        "traced": 3}),
    "tiny-serve-b2": ("kitti1216-serve-b8", "serve_batch", {
        "batch": 2, "pool": 3, "sparse_samples": 50, "keep_share": 0.5,
        "traced": 2}),
}


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def make_root(path: Path) -> Path:
    """A directory laid out as benchmark/ with the tiny cells."""
    (path / "configs").mkdir(parents=True)
    (path / "workloads").mkdir()
    shutil.copytree(BENCH / "metrics", path / "metrics")
    shutil.copytree(BENCH / "traffic", path / "traffic")
    shutil.copy(HERE / "data" / "tiny.json", path / "configs" / "tiny.json")
    for name, (real, driver, traffic) in TINY.items():
        work = json.loads((BENCH / "workloads" / f"{real}.json").read_text())
        work.update(name=name, config="tiny", driver=driver)
        work["traffic"].update(traffic)
        (path / "workloads" / f"{name}.json").write_text(json.dumps(work))
    return path


def tiny_spec() -> dict:
    """BENCHMARK.json with each tiny cell beside its real one."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in spec["end_to_end"] + spec["per_layer"]:
        for name, (real, _, _) in TINY.items():
            if real in entry.get("workloads", []):
                entry["workloads"].append(name)
    for name, (real, _, _) in TINY.items():
        cell = copy.deepcopy(next(w for w in spec["workloads"]
                                  if w["name"] == real))
        cell.update(name=name, config="tiny")
        spec["workloads"].append(cell)
    return spec


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))
