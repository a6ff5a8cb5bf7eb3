#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cspn_monodepth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:
  1. toolchain: GPU name and power limit, torch, CUDA, nvcc, triton;
  2. build: compile every kernel of the serving path from csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the serving path's shapes and at edge cases; kernel, plain and
     bound times;
  4. serving: DepthPredictor at the full width of nyu_completion_500
     (ResNet-50 UNet, rgbd, 228x304, T=24) with seeded random weights,
     single-image requests and batches of 32; the kernel launch counts of
     that run; a profile of one batch (device time by kernel, idle share);
     the same model with the plain CSPN loop; a small model on the card
     against the same model on the CPU.
Then a line with the kernel table and, last, the device line.
It exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cspn_monodepth_tpu_torch import DepthPredictor, get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet, jax_variables
from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.ops.cspn_ref import NORM_TYPES

# H100 SXM published peaks (NVIDIA data sheet, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Max-relative error, max|a - b| / max|b|. The kernel contracts to FMA and
# sums in its own order; the JAX kernels sit near 2e-6 against their scan.
KERNEL_TOL = 1e-5
# The whole path, kernel vs plain CSPN on identical heads: T=24 iterations
# of an expansive stencil amplify rounding.
PATH_TOL = 1e-4
# Small f32 model on the card vs the CPU, TF32 off: convolution sums in
# another order, then T=4 CSPN iterations.
DEVICE_TOL = 1e-3

NYU_H, NYU_W = 228, 304
SEED = 0
# Timed requests: p75 of 40 single-image requests has 10 samples above it.
SINGLE_REQUESTS = 40
BATCH_REQUESTS = 12


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cspn_problem(gen, b, h, w, *, sparse=True, strided=False):
    """Random raw guidance N(0, 1), blur U(0.5, 9.5) and ~1% anchors. With
    `strided`, guidance and blur are channel slices of one (B, 9, H, W)
    tensor, as the model's head hands them to the kernel."""
    heads = torch.randn((b, 9, h, w), generator=gen, device="cuda")
    heads[:, 0] = 0.5 + 9.0 * torch.rand((b, h, w), generator=gen,
                                         device="cuda")
    guid, blur = heads[:, 1:], heads[:, 0]
    if not strided:
        guid, blur = guid.contiguous(), blur.contiguous()
    sp = None
    if sparse:
        keep = torch.rand((b, h, w), generator=gen, device="cuda") < 0.01
        sp = torch.where(keep, blur + 0.25, torch.zeros_like(blur))
    return guid, blur, sp


def cspn_bound_ms(b, h, w, num_iters, sparse: bool):
    """Least time for the function on this card: read the 8 guidance
    planes, blur and sparse once, write the result once; 19 flop/px per
    iteration plus 32 for the normalization."""
    px = b * h * w
    nbytes = 4 * px * (8 + 1 + int(sparse) + 1)
    ops = px * (19 * num_iters + 32)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_toolchain() -> str:
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = gpu.splitlines()[0]
    print(gpu, flush=True)
    nvcc = subprocess.run([cspn_cuda.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("toolchain", gpu=gpu, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.stdout.strip().splitlines()[-1],
         triton=importlib.util.find_spec("triton") is not None,
         python=sys.version.split()[0])
    return gpu


def phase_build():
    t0 = time.perf_counter()
    path = cspn_cuda.build()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cspn_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="cspn_fwd", seconds=seconds, library=path.name,
         ptxas=ptxas)


def phase_kernels(gpu: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [dict(b=2, h=NYU_H, w=NYU_W, t=t, norm=n, sparse=s)
             for t in (1, 24) for n in NORM_TYPES for s in (True, False)]
    cases += [dict(b=1, h=57, w=76, t=24, norm=n, sparse=True)
              for n in NORM_TYPES]
    cases += [dict(b=1, h=57, w=76, t=5, norm="8sum", sparse=False),
              dict(b=2, h=NYU_H, w=NYU_W, t=24, norm="8sum_clamp",
                   sparse=True, strided=True),
              dict(b=32, h=NYU_H, w=NYU_W, t=24, norm="8sum_clamp",
                   sparse=True)]
    for c in cases:
        guid, blur, sp = cspn_problem(gen, c["b"], c["h"], c["w"],
                                      sparse=c["sparse"],
                                      strided=c.get("strided", False))
        kw = dict(num_iters=c["t"], norm_type=c["norm"])
        got = cspn_cuda.cspn_fwd(guid, blur, sp, **kw)
        want = cspn_cuda.cspn_fwd_plain(guid, blur, sp, **kw)
        torch.cuda.synchronize()
        err = max_rel(got, want)
        anchors_exact = True
        if sp is not None:
            m = sp > 0
            anchors_exact = bool(torch.equal(got[m], sp[m]))
        emit("kernel_case", kernel="cspn_fwd", **c, max_rel=err,
             max_abs=float((got - want).abs().max()),
             max_abs_value=float(want.abs().max()),
             anchors_exact=anchors_exact, tol=KERNEL_TOL)
        if not (err <= KERNEL_TOL and anchors_exact):
            raise AssertionError(f"cspn_fwd disagrees with its plain "
                                 f"version: {c} max_rel={err}")

    timing = {}
    for b in (1, 32):
        guid, blur, sp = cspn_problem(gen, b, NYU_H, NYU_W)
        kw = dict(num_iters=24, norm_type="8sum_clamp")
        ms = time_ms(lambda: cspn_cuda.cspn_fwd(guid, blur, sp, **kw), 50)
        plain_ms = time_ms(
            lambda: cspn_cuda.cspn_fwd_plain(guid, blur, sp, **kw), 5)
        # Device time of the kernels alone, without the host's launch gaps.
        device_ms = device_profile(
            lambda: cspn_cuda.cspn_fwd(guid, blur, sp, **kw))["busy_ms"]
        bound_ms, bound_by = cspn_bound_ms(b, NYU_H, NYU_W, 24, True)
        timing[b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        emit("kernel_time", kernel="cspn_fwd", b=b, h=NYU_H, w=NYU_W, t=24,
             norm="8sum_clamp", ms=ms, device_ms=device_ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None, gpu=gpu)
    return timing[32]


def randomized_variables(cfg) -> dict:
    """Seeded random weights of the configured model in the JAX package's
    tree layout: lecun-normal convs, non-trivial BN statistics and NON-ZERO
    heads (zero heads make CSPN the identity and the kernel trivial)."""
    gen = torch.Generator().manual_seed(SEED)
    model = CSPNDepthNet.from_config(cfg.model, generator=gen)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(uniform(c, 0.8, 1.2))
                m.bias.copy_(uniform(c, -0.1, 0.1))
                m.running_mean.copy_(uniform(c, -0.3, 0.3))
                m.running_var.copy_(uniform(c, 0.5, 1.5))
        model.head.weight.copy_(
            0.05 * torch.randn(model.head.weight.shape, generator=gen))
        model.head.bias.copy_(torch.cat(
            [torch.full((1,), 0.5), 0.1 * torch.randn(8, generator=gen)]))
    return jax_variables(model)


def requests(rng, b, h, w, n_sparse=500):
    rgb = rng.random((b, h, w, 3), dtype=np.float32)
    sparse = np.zeros((b, h * w), np.float32)
    for i in range(b):
        idx = rng.choice(h * w, n_sparse, replace=False)
        sparse[i, idx] = rng.uniform(0.5, 9.5, n_sparse)
    return rgb, sparse.reshape(b, h, w)


def check_depth(out, sparse, shape):
    if out.shape != shape:
        raise AssertionError(f"output shape {out.shape}, expected {shape}")
    if not np.isfinite(out).all():
        raise AssertionError("non-finite depth in the output")
    m = sparse > 0
    if not np.array_equal(out[m], sparse[m]):
        raise AssertionError("sparse anchors are not exact in the output")


def device_profile(fn) -> dict:
    """One call of fn under torch.profiler: the device time of each kernel
    and their sum against the host wall time of the call. Device times are
    None where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Device-side events only (kernels, copies, memsets): a host operator's
    # row would count the kernels it launched a second time.
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    if not kernels:
        return dict(wall_ms=wall_ms, busy_ms=None, idle_share=None,
                    by_class=None, top=[])
    by_class: dict[str, float] = {}
    for k, ms in kernels:
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + ms
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, by_class=by_class,
                top=[[k[:80], ms] for k, ms in kernels[:12]])


def kernel_class(name: str) -> str:
    """Coarse class of a device event by its name."""
    if "cspn_fwd" in name:
        return "cspn"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout"
    if "batch_norm" in name or "bn_fw" in name:
        return "batchnorm"
    if any(s in name for s in ("xmma", "gemm", "conv", "cudnn", "cutlass")):
        return "conv"
    return "elementwise"


def host_ms(fn, runs: int = 6) -> float:
    """Median host-clock time of fn() followed by a synchronize."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_serving(gpu: str) -> tuple[int, float]:
    cfg = get_config("nyu_completion_500")
    t0 = time.perf_counter()
    variables = randomized_variables(cfg)
    predictor = DepthPredictor.from_variables(cfg, variables)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    batch = 32
    rgb, sparse = requests(rng, batch, NYU_H, NYU_W)
    # Warm-up at both request shapes (cuDNN chooses algorithms per shape).
    predictor.predict(rgb[0], sparse[0])
    predictor.predict_batch(rgb, sparse)
    torch.cuda.synchronize()

    # The main path: single-image requests, then batches of 32.
    cspn_cuda.cspn_fwd.launches = 0
    single_ms = []
    for i in range(SINGLE_REQUESTS):
        t0 = time.perf_counter()
        depth = predictor.predict(rgb[i % batch], sparse[i % batch])
        single_ms.append(1e3 * (time.perf_counter() - t0))
        check_depth(depth, sparse[i % batch], (NYU_H, NYU_W))
    batch_ms = []
    for _ in range(BATCH_REQUESTS):
        t0 = time.perf_counter()
        out = predictor.predict_batch(rgb, sparse)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        check_depth(out, sparse, (batch, NYU_H, NYU_W))
    launches = cspn_cuda.cspn_fwd.launches
    if launches == 0:
        raise AssertionError("the serving path never launched cspn_fwd")
    emit("serving", config=cfg.name, arch=cfg.model.arch,
         modality=cfg.model.modality, num_iters=cfg.model.num_iters,
         norm=cfg.model.norm_type, dtype=cfg.model.dtype, h=NYU_H, w=NYU_W,
         setup_s=setup_s, requests=len(single_ms),
         ms_per_request_p50=float(np.median(single_ms)),
         ms_per_request_p75=float(np.percentile(single_ms, 75)),
         batch=batch, batches=len(batch_ms),
         batch_ms_p50=float(np.median(batch_ms)),
         batch_ms_max=max(batch_ms),
         img_per_s=batch / (float(np.median(batch_ms)) / 1e3),
         cspn_fwd_launches=launches,
         max_abs_depth=float(np.abs(out).max()), gpu=gpu)
    # Layers of one batch: the host-to-device copy of the model's input and
    # the model's forward on an input already on the card; the rest of a
    # predict_batch call is the host's preparation and the copy back.
    x = np.concatenate([rgb, sparse[..., None]], axis=-1)
    x_dev = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        model_ms = host_ms(lambda: predictor.model(x_dev))
    emit("serving_profile", batch=batch, gpu=gpu,
         h2d_ms=host_ms(lambda: torch.from_numpy(x).cuda()),
         model_ms=model_ms,
         **device_profile(lambda: predictor.predict_batch(rgb, sparse)))

    # The kernel against its plain version on the heads the path computed.
    captured = []
    hook = predictor.model.head.register_forward_hook(
        lambda module, args, out: captured.append(out))
    predictor.predict_batch(rgb, sparse)
    hook.remove()
    heads = captured[0]
    sp = torch.from_numpy(sparse).cuda()
    kw = dict(num_iters=cfg.model.num_iters, norm_type=cfg.model.norm_type)
    got = cspn_cuda.cspn_fwd(heads[:, 1:], heads[:, 0], sp, **kw)
    want = cspn_cuda.cspn_fwd_plain(heads[:, 1:], heads[:, 0], sp, **kw)
    heads_err = max_rel(got, want)
    heads_abs = float((got - want).abs().max())
    if not heads_err <= KERNEL_TOL:
        raise AssertionError(f"cspn_fwd vs plain on the path's heads: "
                             f"max_rel {heads_err} > {KERNEL_TOL}")

    # The whole path against the same model with the plain CSPN loop. The
    # same convolution algorithms in both, so that they differ only in
    # their CSPN.
    torch.backends.cudnn.deterministic = True
    out = predictor.predict_batch(rgb, sparse)
    plain = DepthPredictor.from_variables(
        cfg.override(**{"model.cspn_impl": "torch"}), variables)
    want = plain.predict_batch(rgb, sparse)
    torch.backends.cudnn.deterministic = False
    path_err = float(np.abs(out - want).max() / np.abs(want).max())

    # Batch time with the kernel and with the plain CSPN loop, in turns
    # (kernel, plain, plain, kernel) so that drift hits both alike.
    turns = {"kernel": [], "plain": []}
    for _ in range(3):
        for name in ("kernel", "plain", "plain", "kernel"):
            p = predictor if name == "kernel" else plain
            t0 = time.perf_counter()
            p.predict_batch(rgb, sparse)
            turns[name].append(1e3 * (time.perf_counter() - t0))
    emit("serving_vs_plain_cspn", batch=batch, heads_kernel_max_rel=heads_err,
         heads_kernel_max_abs=heads_abs, heads_tol=KERNEL_TOL,
         path_max_rel=path_err, path_tol=PATH_TOL,
         batch_ms_p50_kernel=float(np.median(turns["kernel"])),
         batch_ms_p50_plain=float(np.median(turns["plain"])),
         batches_each=len(turns["kernel"]), gpu=gpu)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"serving path with the kernel vs the plain "
                             f"CSPN: max_rel {path_err} > {PATH_TOL}")
    del predictor, plain, heads, captured

    # A small f32 model on the card against the same weights on the CPU.
    torch.backends.cudnn.allow_tf32 = False
    small = get_config("synthetic_tiny").override(**{
        "model.dtype": "float32", "model.norm_type": "8sum_clamp"})
    small_vars = randomized_variables(small)
    h, w = small.data.height, small.data.width
    rgb_s, sparse_s = requests(rng, 2, h, w, n_sparse=50)
    got = DepthPredictor.from_variables(small, small_vars).predict_batch(
        rgb_s, sparse_s)
    ref = DepthPredictor.from_variables(small, small_vars, device="cpu"
                                        ).predict_batch(rgb_s, sparse_s)
    dev_err = float(np.abs(got - ref).max() / np.abs(ref).max())
    check_depth(got, sparse_s, (2, h, w))
    emit("device_vs_cpu", config=small.name, h=h, w=w, max_rel=dev_err,
         tol=DEVICE_TOL)
    if not dev_err <= DEVICE_TOL:
        raise AssertionError(f"small model on the card vs the CPU: "
                             f"max_rel {dev_err} > {DEVICE_TOL}")
    return launches, heads_abs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    gpu = phase_toolchain()
    phase_build()
    k1 = phase_kernels(gpu)
    launches, max_abs_err = phase_serving(gpu)
    print(json.dumps({"kernels": [{
        "name": "cspn_fwd", "route": "cuda",
        "source": "cspn_monodepth_tpu_torch/csrc/cspn_fwd.cu",
        "replaces": "cspn_monodepth_tpu/ops/cspn_pallas.py:94",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
