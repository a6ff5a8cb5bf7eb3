"""The reference's independence, the seeded weights, and the control (the
reference one precision step below the configuration, in the program's
place) failing the cells' limits at a size a test run holds."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.reference import model as ref_model
from benchmark.tests.conftest import BENCH, HERE, ROOT
from benchmark.weights import make_weights

TOPS = ("import sys; print(sorted({m.split('.')[0] "
        "for m in list(sys.modules)}))")


def loaded_tops(code: str) -> list[str]:
    """Top-level names of the modules loaded after `code` in a fresh
    interpreter at the checkout's root."""
    out = subprocess.run([sys.executable, "-c", f"{code}\n{TOPS}"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return eval(out.strip().splitlines()[-1])


def test_the_harness_loads_no_jax():
    code = ("import runpy; from pathlib import Path\n"
            "from benchmark import harness, calibrate, count, serve\n"
            "import benchmark.run\n"
            "for p in sorted(Path('benchmark/traffic').glob('*.py')):\n"
            "    harness.traffic_module(p.stem)\n"
            "for p in sorted(Path('benchmark/metrics').glob('*.py')):\n"
            "    harness.metric_reader(p.name[:-3])\n"
            "import cspn_monodepth_tpu_torch.train.loop\n")
    tops = loaded_tops(code)
    assert "cspn_monodepth_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "cspn_monodepth_tpu"} & set(tops)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded_tops("import benchmark.reference.model, "
                       "benchmark.reference.steps, benchmark.weights, "
                       "benchmark.inputs, benchmark.compare")
    assert not {"cspn_monodepth_tpu_torch", "cspn_monodepth_tpu", "jax",
                "jaxlib", "flax"} & set(tops)


def tiny() -> dict:
    return json.loads((HERE / "data" / "tiny.json").read_text())


def test_weights_make_a_live_head_and_batchnorm():
    spec = ref_model.Spec.from_config(tiny())
    w = make_weights(ref_model.shapes(spec), 2 ** 33 + 1, "cpu")
    again = make_weights(ref_model.shapes(spec), 2 ** 33 + 1, "cpu")
    other = make_weights(ref_model.shapes(spec), 2 ** 33 + 2, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(w["head.weight"], other["head.weight"])
    assert w["head.weight"].abs().min() > 0 and w["head.bias"].min() > 0.5
    for leaf in ("weight", "bias", "running_mean"):
        t = w[f"encoder.bn1.{leaf}"]
        assert t.std() > 0.05
    assert w["encoder.bn1.running_var"].min() >= 1.0


def test_the_cspn_is_not_the_identity_under_the_seeded_weights():
    """The refined depth differs from the blurred plane the head gives, in
    the reference and in the program."""
    from cspn_monodepth_tpu_torch.models import CSPNDepthNet

    conf = tiny()
    spec = ref_model.Spec.from_config(conf)
    w = make_weights(ref_model.shapes(spec), 7, "cpu")
    x = torch.rand(2, 64, 96, 4)
    x[..., 3] = torch.where(torch.rand(2, 64, 96) < 0.01, 5.0, 0.0)
    model = CSPNDepthNet.from_config(
        harness.port_config(conf, {}, 7).model).eval()
    harness.load_weights(model, w)
    heads = {}
    model.head.register_forward_hook(lambda m, i, o: heads.update(out=o))
    with torch.no_grad():
        refined = model(x)[..., 0]
        ref = ref_model.forward(w, x, spec, train=False)
    blur = heads["out"][:, 0]
    free = x[..., 3] == 0
    assert (refined - blur)[free].abs().mean() > 1e-2 * blur.abs().mean()
    assert torch.allclose(refined, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell,real,fault", [
    ("tiny-train", "nyu500-train-b32", "precision"),
    ("tiny-serve-b1", "kitti1216-serve-b8", "precision"),
    ("tiny-serve-b2", "kitti1216-serve-b8", "precision"),
    ("tiny-serve-b2", "kitti1216-serve-b8", "network")])
def test_the_control_fails_the_limits(tiny_root, cell, real, fault):
    work = harness.workload(cell, tiny_root)
    limits = harness.workload(real)["limits"]
    module = harness.traffic_module(work["driver"], tiny_root)
    for seed in (11, 12, 13):
        readings = module.control(tiny(), work["traffic"], seed, "cpu",
                                  fault)
        assert any(readings[k] > limits[k] for k in limits), readings


def test_calibrate_reads_the_program_and_the_control(tiny_root, capsys):
    from benchmark import calibrate

    prog = calibrate.program("tiny-train", [3, 4], 0.5, "cpu", tiny_root)
    ctrl = calibrate.control("tiny-train", [5], "half_batch", "cpu",
                             tiny_root)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == prog + ctrl
    assert [x["side"] for x in lines] == ["program", "program", "half_batch"]
    limits = harness.workload("nyu500-train-b32", BENCH)["limits"]
    for row in prog:
        assert all(row[k] <= limits[k] for k in limits)
        worst = row["worst"]["change"][0]
        assert worst[1] == pytest.approx(row["change_gap"], rel=1e-12)
    assert any(ctrl[0][k] > limits[k] for k in limits)
