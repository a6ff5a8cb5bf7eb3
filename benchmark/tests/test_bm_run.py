"""Whole runs of the tiny cells through run.py's main on the CPU: the look
for a card is skipped, the rest of a run is the benchmark's own, with the
program's plain (CPU) path underneath."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import benchmark.run as run_mod
from benchmark import harness
from benchmark.tests.conftest import ROOT, TINY, tiny_spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_main(monkeypatch, capsys, root, cell, seed=2 ** 31 + 12345,
             trace=0, seconds=0.5):
    """run.py's main on `cell` of `root` on the CPU: (rc, last stdout
    line's object or None, stderr lines)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "spec", tiny_spec)
    monkeypatch.setattr(run_mod, "power_limit", lambda: "")
    real = harness.run

    def on_the_cpu(cell, seed, seconds, trace, device, t_start, bench=None):
        return real(cell, seed, seconds, trace, "cpu", t_start, where=root,
                    bench=bench)

    monkeypatch.setattr(harness, "run", on_the_cpu)
    rc = run_mod.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)])
    out, err = capsys.readouterr()
    lines = [x for x in out.splitlines() if x.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err.splitlines()


CELLS = list(TINY)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_each_driver_runs_end_to_end(monkeypatch, capsys, tiny_root, cell,
                                     trace):
    rc, result, err = run_main(monkeypatch, capsys, tiny_root, cell,
                               trace=trace)
    assert rc == 0
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    end_to_end, per_layer = harness.cell_metrics(tiny_spec(), cell)
    if trace:
        # Without a card only the host's readings exist.
        assert set(result["metrics"]) <= {m["name"] for m in per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in end_to_end}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    checks = result["checks"]
    assert err[-len(checks):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}"
        for k, c in checks.items()]
    assert all(c["value"] <= c["limit"] for c in checks.values())


def _unchanged_step(monkeypatch):
    from cspn_monodepth_tpu_torch.train.train_state import TrainState

    def apply_gradients(self, schedule, clip_norm=0.0, group=None):
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch):
    from cspn_monodepth_tpu_torch.train.loop import Trainer

    real = Trainer.train_step

    def train_step(self, state, batch, tag=0):
        half = {k: v[:len(v) // 2] for k, v in batch.items()}
        return real(self, state, half, tag)

    monkeypatch.setattr(Trainer, "train_step", train_step)


def _altered_answer(monkeypatch):
    from cspn_monodepth_tpu_torch.serving import DepthPredictor

    real = DepthPredictor.predict_batch

    def predict_batch(self, rgb, sparse_depth=None):
        out = real(self, rgb, sparse_depth)
        out[..., 0, 0] += 0.05
        return out

    monkeypatch.setattr(DepthPredictor, "predict_batch", predict_batch)


FAULTS = [("tiny-train", _unchanged_step), ("tiny-train", _half_batch),
          ("tiny-serve-b1", _altered_answer),
          ("tiny-serve-b2", _altered_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, tiny_root,
                                            cell, fault):
    fault(monkeypatch)
    rc, result, err = run_main(monkeypatch, capsys, tiny_root, cell)
    assert rc == 0
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_jax_loaded_fails_the_run(monkeypatch, capsys, tiny_root):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result, err = run_main(monkeypatch, capsys, tiny_root,
                               "tiny-serve-b1")
    assert rc != 0 and result is None
    assert "jax" in err[-1]


def test_the_jax_package_is_told_from_the_port_by_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cspn_monodepth_tpu.ops",
                        types.ModuleType("cspn_monodepth_tpu.ops"))
    assert harness.forbidden_modules() == ["cspn_monodepth_tpu"]


def test_no_result_without_the_program(monkeypatch, capsys, tiny_root):
    monkeypatch.setitem(sys.modules, "cspn_monodepth_tpu_torch", None)
    with pytest.raises(ImportError):
        run_main(monkeypatch, capsys, tiny_root, "tiny-serve-b1")
    assert capsys.readouterr().out == ""


def test_no_result_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kitti1216-serve-b8",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr


def test_the_seed_takes_values_past_32_bits():
    for seed in (0, 2 ** 31 + 7, 2 ** 40 + 3):
        assert 0 <= harness.train_seed(seed) < 2 ** 32
    from benchmark.weights import generator
    x = torch.rand(3, generator=generator(2 ** 40 + 3, 1, "cpu"))
    y = torch.rand(3, generator=generator(2 ** 40 + 3, 1, "cpu"))
    assert np.array_equal(x.numpy(), y.numpy())
