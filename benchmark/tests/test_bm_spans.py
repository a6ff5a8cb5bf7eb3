"""Each reader of the program's spans and counters (benchmark/spans.py) on
a canned collection, without device times, and against a program that
keeps no spans."""

from __future__ import annotations

import pytest

from benchmark import harness

DEVICE = ("train_loop_device_ms.train", "model_fwd_bwd_device_ms.train",
          "cspn_op_roofline.train", "cspn_op_roofline.serve_b8")


def collection(device: bool = True) -> dict:
    """Two calls of every span the readers read: (name, host ms, device ms)
    a call; device_ms None where `device` is False."""
    per_call = [("train.input", 3.0, 2.0), ("train.forward", 40.0, 50.0),
                ("cspn.forward", 0.5, 0.75), ("train.loss", 1.0, 0.5),
                ("train.backward", 30.0, 60.0), ("cspn.backward", 0.25, 1.25),
                ("train.optimizer", 4.0, 2.5), ("train.metrics", 2.0, 1.0),
                ("serve.prep", 80.0, 0.25), ("serve.h2d", 12.0, 8.0)]
    spans = [{"name": n, "parent": None, "call": call, "host_ms": host,
              "device_ms": dev if device else None}
             for call in (7, 8) for n, host, dev in per_call]
    return {"spans": spans, "counters": {"serve.h2d_bytes": 2 * 54_788_096}}


def canned() -> dict:
    """The traced record around the collection: two calls of batch 32 on
    the card, 1 + 2 MB of CSPN contract an image."""
    return {"calls": 2, "batch": 32, "device_name": "NVIDIA H100 80GB HBM3",
            "counts": {"cspn_bytes_per_image": {"forward": 1e6,
                                                "backward": 2e6}}}


def expected() -> dict:
    return {
        "train_loop_device_ms.train": 2.0 + 0.5 + 2.5 + 1.0,
        "model_fwd_bwd_device_ms.train": 50.0 + 60.0 - 0.75 - 1.25,
        # 32 images x 3 MB at 3.35 TB/s over 2 ms a step
        "cspn_op_roofline.train": 100 * (32 * 3e6 / 3.35e12) / 2e-3,
        # 32 images x 1 MB over 0.75 ms a call
        "cspn_op_roofline.serve_b8": 100 * (32 * 1e6 / 3.35e12) / 0.75e-3,
        "serve_prep_ms.serve_b8": 80.0,
        "serve_h2d_ms.serve_b8": 12.0,
        "serve_h2d_mb.serve_b8": 54.788096,
    }


@pytest.fixture
def program(monkeypatch):
    """Hands the readers `collected()` from the given collection (None: a
    program without `collected`)."""
    from cspn_monodepth_tpu_torch.utils import profiling

    def give(got):
        if got is None:
            monkeypatch.delattr(profiling, "collected", raising=False)
        else:
            monkeypatch.setattr(profiling, "collected", lambda: got,
                                raising=False)

    return give


def test_every_per_layer_metric_has_a_case_here_or_on_a_canned_trace():
    from benchmark.tests.test_bm_metrics import expected as trace_expected

    names = {m["name"] for m in harness.spec()["per_layer"]}
    assert not set(expected()) & set(trace_expected())
    assert names == set(expected()) | set(trace_expected())


@pytest.mark.parametrize("name", sorted(expected()))
def test_reader_on_a_canned_collection(name, program):
    program(collection())
    value = harness.metric_reader(name)(canned())
    assert value == pytest.approx(expected()[name], rel=1e-9)


@pytest.mark.parametrize("name", DEVICE)
def test_device_reader_finds_nothing_without_device_times(name, program):
    program(collection(device=False))
    assert harness.metric_reader(name)(canned()) is None


@pytest.mark.parametrize("name", sorted(expected()))
def test_reader_finds_nothing_in_a_program_without_spans(name, program):
    program(None)
    assert harness.metric_reader(name)(canned()) is None
