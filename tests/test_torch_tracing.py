"""The port's spans and counters (utils/profiling.py: span, count,
next_call, collected) in `Trainer.train_step`, `DepthPredictor.predict_batch`,
the head conv and the CSPN op, on the CPU at synthetic_tiny's size (64x96,
T=4).

Off: without a profiler the entries collect nothing and `span` is one
shared null context. On, under `torch.profiler`: each phase's span once a
call, nested as the code nests them, each also a `record_function` event of
the same trace; device_ms None (no card); a second stretch starts afresh.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cspn_monodepth_tpu_torch import CSPNDepthNet, DepthPredictor, get_config
from cspn_monodepth_tpu_torch.train import Trainer
from cspn_monodepth_tpu_torch.utils import profiling

H, W, B = 64, 96, 2
SERVE = ("serve.prep", "serve.h2d", "serve.forward", "serve.d2h")
TRAIN = ("train.input", "train.forward", "train.loss", "train.backward",
         "train.optimizer", "train.metrics")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny(**over):
    cfg = get_config("synthetic_tiny").override(
        **{"model.dtype": "float32", **over})
    assert (cfg.data.height, cfg.data.width) == (H, W)
    return cfg


def requests(seed=0):
    """uint8 rgb (B, H, W, 3) and sparse depth (B, H, W) with 40 anchors."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    sparse = np.zeros((B, H, W), np.float32)
    idx = rng.choice(H * W, 40, replace=False)
    sparse.reshape(B, -1)[:, idx] = rng.uniform(0.5, 9.5, (B, 40))
    return rgb, sparse


def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.random((B, H, W, 3), np.float32),
            "depth": rng.uniform(0.5, 9.5, (B, H, W)).astype(np.float32)}


# Each entry and what it runs: serving per modality, a train step per
# CSPN impl (CSPNFunction, whose kernel wrappers run their plain versions
# on the CPU; the plain loop under autograd).
ENTRIES = ["serve-rgbd", "serve-rgb", "train-auto", "train-torch"]


def make(entry):
    kind, variant = entry.split("-", 1)
    if kind == "serve":
        cfg = tiny(**{"model.modality": variant})
        torch.manual_seed(3)
        return DepthPredictor(CSPNDepthNet.from_config(cfg.model), H, W,
                              "cpu")
    trainer = Trainer(tiny(**{"model.cspn_impl": variant}), device="cpu")
    return trainer, trainer.init_state()


@pytest.fixture(scope="module")
def built():
    """entry -> its predictor or (trainer, state), built once."""
    made = {}

    def get(entry):
        if entry not in made:
            made[entry] = make(entry)
        return made[entry]

    return get


def call(built, entry):
    """One predict_batch or train_step of `entry`."""
    if entry.startswith("serve"):
        rgb, sparse = requests()
        return built(entry).predict_batch(rgb, sparse)
    trainer, state = built(entry)
    return trainer.train_step(state, train_batch())


def profiled(fn):
    """fn() under the CPU profiler: (its collection, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.collected(), prof


def by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_span_is_one_shared_null_context_without_a_profiler():
    off = profiling.span("serve.prep")
    assert off is profiling.span("train.forward")
    with off as inside:
        assert inside is None


@pytest.mark.parametrize("entry", ENTRIES)
def test_nothing_is_collected_without_a_profiler(entry, built):
    before = profiling.collected()
    calls = profiling._SPANS.call
    call(built, entry)
    assert profiling.collected() == before
    assert profiling._SPANS.call == calls


@pytest.mark.parametrize("entry", ["serve-rgbd", "serve-rgb"])
def test_predict_batch_spans(entry, built, monkeypatch):
    predictor = built(entry)
    rgb, sparse = requests()
    uploads = []
    real = torch.from_numpy

    def spy(a):
        uploads.append(a.nbytes)
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    got, _ = profiled(lambda: predictor.predict_batch(rgb, sparse))
    monkeypatch.undo()
    spans = by_name(got["spans"])
    assert sorted(spans) == sorted(SERVE + ("head.forward", "cspn.forward"))
    assert all(len(v) == 1 for v in spans.values())
    assert [spans[n][0]["parent"] for n in SERVE] == [None] * 4
    assert spans["head.forward"][0]["parent"] == "serve.forward"
    assert spans["cspn.forward"][0]["parent"] == "serve.forward"
    assert len({s["call"] for s in got["spans"]}) == 1
    assert all(s["device_ms"] is None and s["host_ms"] > 0
               for s in got["spans"])
    # The request's arrays go up as they are, each where the modality
    # reads it; the model's input is built on the device.
    want = [rgb.nbytes] + ([sparse.nbytes]
                           if predictor.model.modality == "rgbd" else [])
    assert uploads == want
    assert got["counters"] == {"serve.h2d_bytes": sum(want),
                               "head.conv_calls": 1}


@pytest.mark.parametrize("entry", ["train-auto", "train-torch"])
def test_train_step_spans(entry, built):
    """CSPNFunction's backward is the hand-written adjoint, spanned
    `cspn.backward`; the plain loop's is torch autograd's, unspanned. The
    head conv's forward and backward are spanned under either."""
    got, _ = profiled(lambda: call(built, entry))
    spans = by_name(got["spans"])
    adjoint = ("cspn.backward",) if entry == "train-auto" else ()
    head = ("head.forward", "head.backward")
    assert sorted(spans) == sorted(TRAIN + ("cspn.forward",) + head
                                   + adjoint)
    assert all(len(v) == 1 for v in spans.values())
    assert [spans[n][0]["parent"] for n in TRAIN] == [None] * len(TRAIN)
    assert spans["cspn.forward"][0]["parent"] == "train.forward"
    assert spans["head.forward"][0]["parent"] == "train.forward"
    # On the CPU autograd runs the backward on the calling thread.
    for name in adjoint + head[1:]:
        assert spans[name][0]["parent"] == "train.backward"
    calls = {s["call"] for s in got["spans"]}
    assert len(calls) == 1
    assert all(s["device_ms"] is None and s["host_ms"] > 0
               for s in got["spans"])
    assert got["counters"] == {"head.conv_calls": 1}


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_span_is_a_profiler_event_nested_as_collected(entry, built):
    got, prof = profiled(lambda: call(built, entry))
    names = {s["name"] for s in got["spans"]}
    events = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in events) == sorted(
        s["name"] for s in got["spans"])

    def enclosing_span(e):
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return None if p is None else p.name

    assert sorted((e.name, enclosing_span(e)) for e in events) == sorted(
        (s["name"], s["parent"]) for s in got["spans"])


@pytest.mark.parametrize("entry", ["serve-rgbd", "serve-rgb"])
def test_a_second_stretch_starts_a_fresh_collection(entry, built):
    first, _ = profiled(lambda: call(built, "train-auto"))
    second, _ = profiled(lambda: call(built, entry))
    assert {s["name"] for s in second["spans"]} == set(SERVE + (
        "head.forward", "cspn.forward"))
    assert second["spans"][0]["call"] == first["spans"][0]["call"] + 1
    assert second["counters"].keys() == {"serve.h2d_bytes",
                                         "head.conv_calls"}
    assert second["counters"]["head.conv_calls"] == 1


def test_counters_and_calls_only_while_a_profiler_records():
    profiling.collected()
    call = profiling._SPANS.call
    profiling.count("c", 5)
    profiling.next_call()
    assert profiling._SPANS.call == call
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.next_call()
        profiling.count("c", 5)
        profiling.count("c", 2.5)
        with profiling.span("s"):
            pass
    got = profiling.collected()
    assert got["counters"] == {"c": 7.5}
    assert [(s["name"], s["parent"], s["call"]) for s in got["spans"]] == [
        ("s", None, call + 1)]
