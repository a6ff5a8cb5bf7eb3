"""The CSPN++ cell's files: its frozen counts, its five per-layer readers
on a canned record, and a tiny CA-CSPN cell run by the harness on the CPU
from the new files alone."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.reference import cspnpp
from benchmark.tests.conftest import BENCH, HERE, make_root, tiny_spec
from benchmark.tests.test_bm_metrics import canned

CELL = "kitti1216-cspnpp-train-b8"
FWD = "void (anonymous namespace)::cspn_kxk_step<7, 2>(float const*)"
PREP = "void (anonymous namespace)::cspn_kxk_prep<5>(float const*)"
ADJ = "void (anonymous namespace)::cspn_kxk_adjoint_step<7, 2>(float*)"
SUMS = "void (anonymous namespace)::cspn_kxk_adjoint_sums<5>(float*)"
NEW = ("cspnpp_share.train_pp", "cspn_kxk_fwd_roofline.train_pp",
       "cspn_kxk_bwd_roofline.train_pp", "cspnpp_fwd_device_ms.train_pp",
       "cspn_kxk_calls.train_pp")


def test_frozen_counts_match_the_shapes():
    conf = json.loads((BENCH / "configs" / "kitti_1216_cspnpp.json")
                      .read_text())
    assert conf["counts"] == cspnpp.counts(conf)
    h, w = conf["data"]["height"], conf["data"]["width"]
    assert conf["counts"]["cspn_kxk_bytes_per_image"] == {
        "forward": 4 * h * w * (30 + 54), "backward": 4 * h * w * (55 + 103)}
    # The whole op, the 3x3 branch's 14 and 23 planes with them.
    assert conf["counts"]["cspn_bytes_per_image"] == {
        "forward": 4 * h * w * (14 + 30 + 54),
        "backward": 4 * h * w * (23 + 55 + 103)}
    assert cspnpp.Spec.from_config(conf).head_channels == conf["model"][
        "head_channels"] == 96


def test_new_metrics_list_the_new_cell_alone():
    spec = harness.spec()
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
    _, per_layer = harness.cell_metrics(spec, CELL)
    assert set(NEW) <= {m["name"] for m in per_layer}


def kxk_record() -> dict:
    """canned()'s two steps with the k x k kernels in each: forward 1 ms
    (0.8 + 0.2), adjoint 2 ms (1.5 + 0.5), beside its K3 0.5 ms."""
    record = canned()
    kernels = []
    for t in (30_000.0, 40_000.0):
        for name, dur in ((FWD, 800), (PREP, 200), (ADJ, 1500),
                          (SUMS, 500)):
            kernels.append([name, t, t + dur])
            t += dur
    record["kernels"] += kernels
    record["stretch"] = [0.0, 50_000.0]
    record.update(batch=8, counts={
        "flops_per_image": {"forward": 1e11, "train": 3e11},
        "cspn_kxk_bytes_per_image": {"forward": 1e8, "backward": 2e8}})
    return record


def expected() -> dict:
    # Busy 10 + 3 ms a step, of which CSPN 1.5 (canned's K2, K3) + 3.
    return {"cspnpp_share.train_pp": 100 * 2 * 4.5 / (2 * 13.0),
            "cspn_kxk_fwd_roofline.train_pp":
                100 * (8 * 1e8 / 3.35e12) / 1e-3,
            "cspn_kxk_bwd_roofline.train_pp":
                100 * (8 * 2e8 / 3.35e12) / 2e-3}


@pytest.mark.parametrize("name", sorted(expected()))
def test_trace_readers_on_a_canned_record(name):
    value = harness.metric_reader(name)(kxk_record())
    assert value == pytest.approx(expected()[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(expected()))
def test_trace_readers_find_nothing_without_device_events(name):
    record = kxk_record()
    record["kernels"] = []
    assert harness.metric_reader(name)(record) is None


def test_rooflines_find_nothing_without_kxk_kernels():
    record = kxk_record()
    record["kernels"] = [k for k in record["kernels"]
                         if "cspn_kxk_" not in k[0]]
    for name in ("cspn_kxk_fwd_roofline.train_pp",
                 "cspn_kxk_bwd_roofline.train_pp"):
        assert harness.metric_reader(name)(record) is None


@pytest.mark.parametrize("got,want", [
    ({"spans": [{"name": "cspnpp.forward", "device_ms": 6.0},
                {"name": "cspnpp.forward", "device_ms": 8.0}],
      "counters": {"cspn.kxk_calls": 16}}, (7.0, 8.0)),
    ({"spans": [{"name": "cspnpp.forward", "device_ms": None}],
      "counters": {}}, (None, None)),
    (None, (None, None)),
])
def test_program_readers(monkeypatch, got, want):
    from benchmark import spans

    monkeypatch.setattr(spans, "collection", lambda: got)
    record = {"calls": 2}
    assert (harness.metric_reader("cspnpp_fwd_device_ms.train_pp")(record),
            harness.metric_reader("cspn_kxk_calls.train_pp")(record)) == want


# The shared train cells' program readers on this cell's spans: the
# branches' 12 cspn.forward and 12 cspn.backward spans a step (3 sizes x 4
# segments) nest under cspnpp.forward, itself under train.forward.
SHARED = {"train_loop_device_ms.train": 1.0 + 2.0 + 3.0 + 4.0,
          "model_fwd_bwd_device_ms.train": 100.0 + 200.0 - 12 * (0.5 + 1.5),
          "cspn_op_roofline.train":
              100 * (8 * (1e8 + 2e8) / 3.35e12) / (12 * 2.0 * 1e-3)}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_program_readers_read_the_cell(monkeypatch, name):
    from benchmark import spans

    listed = {m["name"]: m.get("workloads", [])
              for m in harness.spec()["per_layer"]}
    assert CELL in listed[name]
    got = {"spans": [{"name": n, "device_ms": ms} for n, ms in (
        ("train.input", 1.0), ("train.loss", 2.0), ("train.optimizer", 3.0),
        ("train.metrics", 4.0), ("train.forward", 100.0),
        ("cspnpp.forward", 30.0), ("train.backward", 200.0))]
        + [{"name": "cspn.forward", "device_ms": 0.5}] * 12
        + [{"name": "cspn.backward", "device_ms": 1.5}] * 12,
        "counters": {}}
    monkeypatch.setattr(spans, "collection", lambda: got)
    record = kxk_record()
    record.update(calls=1, counts={
        **record["counts"],
        "cspn_bytes_per_image": {"forward": 1e8, "backward": 2e8}})
    value = harness.metric_reader(name)(record)
    assert value == pytest.approx(SHARED[name], rel=1e-9)


def tiny_cspnpp(root):
    """A tiny CA-CSPN configuration and cell beside the tiny ones: the
    program's synthetic_tiny widths with basic blocks, stencils (3, 5, 7)
    and checkpoints (2, 4) of T = 4, at 32x48, batch 2."""
    conf = json.loads((HERE / "data" / "tiny.json").read_text())
    conf["name"] = "tiny_cspnpp"
    conf["model"].update(encoder_block="basic", kernel_sizes=[3, 5, 7],
                         checkpoints=[2, 4], head_channels=90)
    conf["data"].update(height=32, width=48)
    conf["port"]["overrides"].update({
        "model.encoder_block": "basic", "model.cspn_kernel_sizes": [3, 5, 7],
        "model.cspn_checkpoints": [2, 4], "data.height": 32,
        "data.width": 48})
    conf["counts"] = cspnpp.counts(conf)
    (root / "configs" / "tiny_cspnpp.json").write_text(json.dumps(conf))
    work = harness.workload(CELL)
    work.update(name="tiny-cspnpp", config="tiny_cspnpp")
    work["traffic"].update(batch=2, pool=4, warmup=1, traced=2,
                           port_overrides={"train.batch_size": 2})
    # The cell's change_gap limit is calibrated at its own shape. At 32x48
    # and batch 2 the bf16 encoder's BatchNorm leaves change by ~4e-5 in
    # three steps and read change gaps up to 0.12 on the CPU, where the
    # float32 model matches the reference (tests/test_torch_cspnpp.py).
    work["limits"]["change_gap"] = 0.25
    (root / "workloads" / "tiny-cspnpp.json").write_text(json.dumps(work))
    spec = tiny_spec()
    for entry in spec["end_to_end"] + spec["per_layer"]:
        if CELL in entry.get("workloads", []):
            entry["workloads"].append("tiny-cspnpp")
    spec["workloads"].append({"name": "tiny-cspnpp", "config": "tiny_cspnpp",
                              "traffic": "train_cspnpp", "chips": 1})
    return spec


def test_harness_runs_a_tiny_cspnpp_cell(tmp_path):
    root = make_root(tmp_path / "bench")
    spec = tiny_cspnpp(root)
    for trace in (0, 1):
        result, lines = harness.run("tiny-cspnpp", 2 ** 31 + 77, 0.5,
                                    bool(trace), "cpu", 0.0, where=root,
                                    bench=spec)
        assert result["correct"] is True, lines
        assert result["failed"] == 0
        if trace:
            # Off the card only the program's counter reads.
            assert result["metrics"] == {"cspn_kxk_calls.train_pp": {
                "value": 4.0, "unit": "calls"}}
        else:
            assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}


def test_set_up_holds_the_program_to_the_file(tmp_path):
    root = make_root(tmp_path / "bench")
    tiny_cspnpp(root)
    conf = json.loads((root / "configs" / "tiny_cspnpp.json").read_text())
    conf["port"]["overrides"]["model.cspn_checkpoints"] = [1, 4]
    work = harness.workload("tiny-cspnpp", root)
    traffic = harness.traffic_module("train_cspnpp", root)
    with pytest.raises(ValueError, match="cspn_checkpoints"):
        traffic.Driver(conf, work["traffic"], 1, "cpu")
