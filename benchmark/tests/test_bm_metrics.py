"""Each per-layer metric's reader on a canned trace record, and the frozen
FLOP and byte counts of each configuration against its shapes."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, tracing
from benchmark.count import counts
from benchmark.tests.conftest import BENCH, ROOT

CARD = "NVIDIA H100 80GB HBM3"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16"
BN = "void at::native::batch_norm_transform_input_kernel<c10::BFloat16>"
K2 = "void cspn_fwd_round<Geometry<48, 8, 4, 1>, 0, true>"
K3 = "void adjoint_sweep_round"
SGD = "void at::native::multi_tensor_apply_kernel<foreach>"


def canned() -> dict:
    """Two steps of 10 ms of device work each on a 25 ms stretch: conv 6
    ms, BatchNorm 2 ms, CSPN 1 + 0.5 ms, optimizer 0.5 ms a step."""
    kernels = []
    for step, t in enumerate((0.0, 12_000.0)):
        t += 1_000.0
        for name, dur in ((CONV, 4000), (BN, 2000), (K2, 1000), (K3, 500),
                          (SGD, 500), (CONV, 2000)):
            kernels.append([name, t, t + dur])
            t += dur
    return {
        "kernels": kernels,
        "spans": [["bm.train_step", 0.0, 11_000.0],
                  ["bm.train_step", 11_500.0, 23_000.0]],
        "ops": [["aten::conv2d", 0.0, 900.0]],
        "stretch": [0.0, 25_000.0], "calls": 2,
        "window": {"calls": 100, "images": 3200, "seconds": 1.25,
                   "img_per_s": 2560.0, "peak_bytes": 9.5e9},
        "device_name": CARD, "batch": 32,
        "counts": {"flops_per_image": {"forward": 1e11, "train": 3e11},
                   "cspn_bytes_per_image": {"forward": 1e6, "backward": 2e6}},
    }


def expected() -> dict:
    window_img_s = 2560.0
    return {
        "model_device_ms.train": 8.0,
        # 32 images x 3 MB at 3.35 TB/s over 1.5 ms a step
        "cspn_roofline.train": 100 * (32 * 3e6 / 3.35e12) / 1.5e-3,
        "mfu.train": 100 * 3e11 * window_img_s / 989e12,
        "mfu.serve_b8": 100 * 1e11 * window_img_s / 989e12,
        # 10 ms busy a call x 100 calls over 1.25 s
        "idle_share.train": 100 * (1 - 0.010 * 100 / 1.25),
        "idle_share.serve_b8": 100 * (1 - 0.010 * 100 / 1.25),
        "peak_mem_gb.train": 9.5,
    }


def test_every_per_layer_metric_has_a_reader_with_a_case():
    names = {m["name"] for m in harness.spec()["per_layer"]}
    assert names == set(expected())
    assert names == {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}


@pytest.mark.parametrize("name", sorted(expected()))
def test_reader_on_a_canned_trace(name):
    value = harness.metric_reader(name)(canned())
    assert value == pytest.approx(expected()[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(
    set(expected()) - {"peak_mem_gb.train"}))
def test_reader_finds_nothing_without_device_events(name):
    record = canned()
    record["kernels"] = []
    record["device_name"] = "cpu"
    assert harness.metric_reader(name)(record) is None


def test_breakdown_of_the_canned_trace():
    record = canned()
    assert tracing.busy_us(record) == 2 * 10_000.0
    ops = dict(tracing.device_ops(record))
    assert ops[f"conv/{CONV}"] == pytest.approx(2 * 6e-3)
    assert ops[f"cspn/{K2}"] == pytest.approx(2 * 1e-3)
    gaps = tracing.idle_gaps(record)
    # 1 ms before the first step's kernels, 2 ms between, 2 ms after
    assert gaps[0] == ["outside/host", pytest.approx(2e-3)]
    assert sorted(g[1] for g in gaps) == pytest.approx([1e-3, 2e-3, 2e-3])
    assert ["bm.train_step/aten::conv2d", pytest.approx(1e-3)] in gaps


@pytest.mark.parametrize("name", ["nyu_completion_500", "kitti_1216"])
def test_frozen_counts_match_the_shapes(name):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert conf["counts"] == counts(conf)
    h, w = conf["data"]["height"], conf["data"]["width"]
    per_image = conf["counts"]["cspn_bytes_per_image"]
    assert per_image == {"forward": 4 * 11 * h * w,
                         "backward": 4 * 20 * h * w}


def test_benchmark_entries_name_their_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in spec["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["source"] == conf["source"]
        assert data["reduced"] == conf["reduced"]
    for cell in spec["workloads"]:
        work = harness.workload(cell["name"])
        assert (work["config"], work["driver"]) == (
            cell["config"], cell["traffic"])
        assert (BENCH / "traffic" / f"{work['driver']}.py").exists()
