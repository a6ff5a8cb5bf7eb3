"""The port's measurement tools (cspn_monodepth_tpu_torch/tools/) on the CPU.

Each tool's `main` runs at its smallest size with `--device cpu` and
prints one JSON object with its keys, naming the device ("cpu"); its
numbers are the CPU's. `profile_step`'s classes sum to its busy time; the
port's `torch_baseline` model is the root tools/torch_baseline.py model
(the same state dict gives the same output bit for bit) and writes no
file on the CPU. The tools run on the card in chip_smoke.py's bench
phase.
"""

import contextlib
import importlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from cspn_monodepth_tpu_torch.tools import torch_baseline

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--config", "synthetic_tiny"]

CASES = {
    "profile_step": (
        TINY + ["--batch", "2", "--steps", "1", "--top", "5"], {},
        {"wall_ms_per_step", "busy_ms_per_step", "idle_share",
         "by_class_ms_per_step", "by_class_share", "top_ms_per_step"}),
    "profile_step-eval": (
        TINY + ["--batch", "2", "--steps", "1", "--eval"], {},
        {"step", "busy_ms_per_step", "by_class_ms_per_step"}),
    "profile_components": (
        TINY + ["--batch", "1", "--hw", "32x48", "--iters", "1",
                "--num-iters", "4", "--train"], {},
        {"encoder_fwd_ms", "decoder_fwd_ms", "cspn4_fwd_ms", "full_fwd_ms",
         "encoder_fwdbwd_ms", "decoder_fwdbwd_ms", "cspn4_fwdbwd_ms",
         "full_fwdbwd_ms"}),
    "profile_step_parts": (
        TINY + ["--batch", "1", "--hw", "32x48", "--iters", "1"], {},
        {"sampler_ms", "heads_ms", "loss_ms", "metrics_ms", "clip_opt_ms"}),
    "profile_decoder": (
        TINY + ["--batch", "1", "--hw", "32x48", "--iters", "1", "--train"],
        {}, {"up1", "up2", "up3", "up4", "up5", "peak_bf16_tflops"}),
    "bench_pipeline": (
        TINY + ["--records", "8", "--batch", "2", "--steps", "2",
                "--workers", "1,2", "--train-steps", "2"], {},
        {"reader_ms_1thread", "read_augment_ms_1thread", "pipeline_ips",
         "pipeline_put_ips", "train_loop_data_ms_mean",
         "train_loop_step_ms_mean", "train_loop_wall_ips"}),
    "bench_cspn_vjp": (
        ["--device", "cpu", "--batch", "1", "--hw", "24x32", "--num-iters",
         "4", "--iters", "1"], {},
        {"kernels_fwd_plus_full_bwd_ms", "plain_fwd_plus_full_bwd_ms",
         "shape"}),
    "bench_cspn_vjp-kitti": (
        ["--device", "cpu", "--batch", "1", "--hw", "24x32", "--num-iters",
         "4", "--iters", "1", "--kitti"], {},
        {"kernels_fwd_plus_full_bwd_ms", "plain_fwd_plus_full_bwd_ms",
         "shape"}),
    "probe_bn_eval": (
        TINY, {"BENCH_BATCH": "1", "BENCH_ITERS": "1"},
        {"bn_eval_cost_ms", "fold_headroom_pct", "eval_step_ms",
         "batchnorm_modules"}),
    "torch_baseline": (
        ["--device", "cpu", "--hw", "32x48"],
        {"BENCH_BATCH": "1", "BENCH_ITERS": "1"},
        {"combined_ips", "train_images_per_sec", "infer_images_per_sec",
         "torch"}),
    "bench_bw": (
        ["--device", "cpu", "--batch", "1", "--mm", "64", "--iters", "1"],
        {}, {"copy64_gbps", "copy128_gbps", "copy2d_gbps", "mm_tflops",
             "mm_stream_gbps", "mm_stream_tflops"}),
    "parity_check": (
        ["--device", "cpu", "--batch", "1", "--hw", "24x32", "--kitti"], {},
        {"8sum_clamp", "8sum", "8sum_abs", "prenorm_96x304", "tiled_24x32",
         "prenorm_104x1216"}),
}


def run_tool(name: str, argv: list[str], env: dict, tmp_path,
             monkeypatch) -> tuple[dict, list[str]]:
    """tools.<name>.main(argv) with `env` set: its result and the JSON
    objects it printed."""
    torch.set_num_threads(2)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if name == "bench_pipeline":
        argv = argv + ["--root", str(tmp_path / "nyu")]
    if name == "torch_baseline":
        monkeypatch.setattr(torch_baseline, "OUT", tmp_path / "base.json")
    module = importlib.import_module(
        f"cspn_monodepth_tpu_torch.tools.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = module.main(argv)
    return res, [json.loads(ln) for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_runs_on_the_cpu_and_prints_its_keys(case, tmp_path,
                                                 monkeypatch):
    argv, env, keys = CASES[case]
    name = case.split("-")[0]
    res, printed = run_tool(name, argv, env, tmp_path, monkeypatch)
    assert printed and printed[-1] == res
    assert keys <= set(res), keys - set(res)
    assert res["device"] == "cpu"
    if name == "torch_baseline":
        assert not (tmp_path / "base.json").exists()   # the card's only


def test_profile_step_classes_sum_to_busy(tmp_path, monkeypatch):
    res, _ = run_tool("profile_step", CASES["profile_step"][0], {},
                      tmp_path, monkeypatch)
    by_class = res["by_class_ms_per_step"]
    assert {"conv", "batchnorm", "elementwise"} <= set(by_class)
    assert sum(by_class.values()) == pytest.approx(res["busy_ms_per_step"],
                                                   rel=1e-9)
    assert sum(res["by_class_share"].values()) == pytest.approx(1.0)
    assert 0 < res["busy_ms_per_step"] <= res["wall_ms_per_step"]


def test_torch_baseline_model_is_the_roots():
    spec = importlib.util.spec_from_file_location(
        "root_torch_baseline", ROOT / "tools" / "torch_baseline.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    torch.manual_seed(0)
    want_model = root.TorchCSPNNet(4, 24).eval()
    got_model = torch_baseline.TorchCSPNNet(4, 24).eval()
    got_model.load_state_dict(want_model.state_dict())
    x = torch.rand(1, 4, 32, 48)
    x[:, 3] *= torch.rand(1, 32, 48) < 0.05
    with torch.no_grad():
        want, got = want_model(x), got_model(x)
    assert torch.isfinite(want).all() and want.abs().max() > 0
    assert torch.equal(got, want)
