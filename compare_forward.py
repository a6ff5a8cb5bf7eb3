"""Time the forward kernels of one checkout on one GPU: K1, K2, K4, K5, K7
and K8 (ops/cspn_cuda.py) at the shapes chip_smoke.py times them, T=24
(one round of 4 on the slabs), 8sum_clamp, each through its wrapper with
the wrapper's own plan: CUDA-event ms over CALLS calls after a warm-up,
and torch.profiler's device ms of one call. The inputs are seeded random
planes made on the card, the same for every checkout.

    python3 compare_forward.py ROOT LABEL

ROOT is a checkout of the repository; its own package is imported and
builds its kernels into its own _build/. To compare two commits on one
card, run both on that card, in turns: parent, change, change, parent.
Prints one line "AB {json}". K4 and K5 take raw guidance (the wrappers'
contract since the H-tiled route took JAX's); a checkout from before that
has other K4/K5 wrappers and cannot be timed by this script.
"""
import json
import os
import sys

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cspn_monodepth_tpu_torch.ops import cspn_cuda  # noqa: E402
from cspn_monodepth_tpu_torch.ops.cspn_ref import (  # noqa: E402
    anchor,
    prenorm_gates9,
)

CALLS = 50
NYU = (32, 228, 304)
KITTI = (8, 352, 1216)
SLABS = {"kitti_2x4": (4, 96, 1216), "nyu_16x2": (16, 122, 304)}


def problem(gen, b, h, w):
    """Raw guidance N(0, 1), blur U(0.5, 9.5), ~1% anchors at blur + 0.25."""
    guid = torch.randn((b, 8, h, w), generator=gen, device="cuda")
    blur = 0.5 + 9.0 * torch.rand((b, h, w), generator=gen, device="cuda")
    keep = torch.rand((b, h, w), generator=gen, device="cuda") < 0.01
    return guid, blur, torch.where(keep, blur + 0.25, torch.zeros_like(blur))


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def device_ms(fn) -> float:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


gen = torch.Generator(device="cuda").manual_seed(0)
calls = {}
guid, blur, sp = problem(gen, *NYU)
raw = dict(num_iters=24, norm_type="8sum_clamp")
calls["k1_nyu32"] = lambda: cspn_cuda.cspn_fwd(guid, blur, sp, **raw)
calls["k1_nyu1"] = lambda: cspn_cuda.cspn_fwd(guid[:1], blur[:1], sp[:1],
                                              **raw)
calls["k2_nyu32"] = lambda: cspn_cuda.cspn_fwd_stash(guid, blur, sp, **raw)
kg, kb, ks = problem(gen, *KITTI)
calls["k4_kitti8"] = lambda: cspn_cuda.cspn_tiled_fwd(kg, kb, ks, **raw)
calls["k4_kitti1"] = lambda: cspn_cuda.cspn_tiled_fwd(kg[:1], kb[:1], ks[:1],
                                                      **raw)
calls["k5_kitti8"] = lambda: cspn_cuda.cspn_tiled_fwd_stash(kg, kb, ks,
                                                            **raw)
for name, shape in SLABS.items():
    sg, sb, ss = problem(gen, *shape)
    s9, s0 = prenorm_gates9(sg, "8sum_clamp"), anchor(sb, ss)
    calls[f"k7_{name}"] = (lambda s9=s9, s0=s0, ss=ss:
                           cspn_cuda.cspn_prenorm_fwd(s9, s0, ss,
                                                      num_iters=4))
    calls[f"k8_{name}"] = (lambda s9=s9, s0=s0, ss=ss:
                           cspn_cuda.cspn_prenorm_fwd_stash(s9, s0, ss,
                                                            num_iters=4))

out = {"label": sys.argv[2], "gpu": torch.cuda.get_device_name(0)}
for name, fn in calls.items():
    out[name] = dict(ms=time_ms(fn), device_ms=device_ms(fn))
print("AB " + json.dumps(out), flush=True)
