"""The head conv's readers (head_device_ms.train, head_conv_calls.train)
on canned collections of the program's spans and counters: a program with
the head's spans, one whose spans lack device times, one whose head runs
on cuDNN (no such spans or counter, as the parent of the head's kernels
reads), and one without `collected`; and the tiny train cell through the
harness on the CPU, where the counter reads one call a step and the spans
have no device times."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_bm_run import run_main

READERS = ("head_device_ms.train", "head_conv_calls.train")


def spans(device: bool) -> list:
    """Two train steps (calls 3 and 4) of the head's spans, forward 1.5
    and backward 2.25 device ms a step."""
    return [{"name": n, "parent": p, "call": call, "host_ms": 0.1,
             "device_ms": ms if device else None}
            for call in (3, 4)
            for n, p, ms in (("head.forward", "train.forward", 1.5),
                             ("head.backward", "train.backward", 2.25))]


@pytest.mark.parametrize("got,want", [
    ({"spans": spans(True), "counters": {"head.conv_calls": 2}},
     (3.75, 1.0)),
    ({"spans": spans(False), "counters": {"head.conv_calls": 2}},
     (None, 1.0)),
    ({"spans": [s for s in spans(True) if s["name"] == "head.forward"],
      "counters": {"head.conv_calls": 2}}, (None, 1.0)),
    ({"spans": [{"name": "train.forward", "parent": None, "call": 3,
                 "host_ms": 1.0, "device_ms": 9.0}],
      "counters": {"bn.train_calls": 138}}, (None, None)),
    (None, (None, None)),
], ids=["device", "host_only", "no_backward", "cudnn_head", "no_program"])
def test_head_readers(monkeypatch, got, want):
    from benchmark import spans as program_spans

    monkeypatch.setattr(program_spans, "collection", lambda: got)
    record = {"calls": 2}
    assert tuple(harness.metric_reader(n)(record) for n in READERS) == want


def test_the_entries_name_the_two_train_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = spec[name]
        assert m["layer"] == "Model, models/ (encoder, decoder, heads)"
        assert m["moves"] == "train_img_per_s"
        assert m["workloads"] == ["nyu500-train-b32", "kitti1216-train-b8"]


def test_the_tiny_train_cell_reads_one_head_call_a_step(monkeypatch, capsys,
                                                        tiny_root):
    """A traced run of the tiny train cell on the CPU: one head conv call a
    step; no device times, so no head_device_ms."""
    rc, result, _ = run_main(monkeypatch, capsys, tiny_root, "tiny-train",
                             trace=1)
    assert rc == 0 and result["correct"] is True
    assert result["metrics"]["head_conv_calls.train"]["value"] == 1
    assert "head_device_ms.train" not in result["metrics"]
