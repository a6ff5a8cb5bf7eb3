#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cspn_monodepth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:
  1. toolchain: GPU name and power limit, torch, CUDA, nvcc, triton;
  2. build: compile every kernel from csrc/ (one nvcc per source, all at
     once), with ptxas's registers and spills of every entry;
  3. kernels: each kernel (K1 forward, K2 stash forward, K3 adjoint)
     against its plain PyTorch version on the card, at the main paths'
     shapes and at edge cases; the autograd Function's gradients against
     torch autograd of the plain loop; kernel, plain and bound times; K3's
     stage kernels (gates9, sweep, sums) against their plain stages, each
     timed beside its own bound, and two K3 runs bit for bit;
  4. serving: DepthPredictor at the full width of nyu_completion_500
     (ResNet-50 UNet, rgbd, 228x304, T=24) with seeded random weights,
     single-image requests and batches of 32; the kernel launch counts of
     that run; a profile of one batch (device time by kernel, idle share);
     the same model with the plain CSPN loop; a small model on the card
     against the same model on the CPU;
  5. train: Trainer.train_step of the same configuration on synthetic data
     at batch 32 (timed steps, the K2/K3 launch counts of that run, peak
     memory, a profile of one step, the loss falling on a fixed batch),
     Trainer.evaluate (K1), one step with the kernels against one with the
     plain CSPN loop, and a small f32 model's train step on the card
     against the CPU;
  6. kitti_kernels: the H-tiled route's kernels (K4 forward, K5 stash
     forward, K6 adjoint, on the raw inputs as JAX's `_cspn_pallas_tiled`
     takes them, through K1-K3's C entries) against their plain versions
     at KITTI's 352x1216 and at edge cases, K5 = K4 and K4 = the gates9
     contract on cspn_gates9's planes bit for bit, TiledCSPNFunction's
     gradients against torch autograd of the plain loop, the tiled route
     against K1 on the same raw guidance; K4-K6, K1 and the plain versions
     timed at batch 8, K4 also at batch 1; K6's stage kernels (gates9,
     sweep, sums) against their plain stages and timed, two K6 runs bit
     for bit; what the normalization costs on the route against the plain
     ops it replaced (`prenorm_time`), and the two ways to serve without a
     gradient (`serving_route`);
  7. kitti_serving: DepthPredictor at the full width of kitti_1216 (one
     device) with seeded random weights, single requests and batches of 8,
     the K4/K1 launch counts of that run, a profile of one batch, the path
     against the plain CSPN loop;
  8. kitti_train: Trainer.train_step of kitti_1216 at batch 8 on synthetic
     records (timed steps, K5/K6 launch counts, peak memory, a profile, the
     loss falling), one step against the plain CSPN loop, then train_epoch
     and evaluate (K4) through KITTIDataset on raw 375x1242 npz frames the
     script writes, with the augmentation executor that ran;
  9. spatial_kernels: the spatial path's slab kernels (K7 forward, K8
     stash forward, K9 adjoint) against their plain versions on the
     deployed slabs (kitti_1216 on 2x4: 4 x 96x1216; multihost on 16x2:
     16 x 122x304), a remainder round, B=1 and a first and a last shard,
     and d^0 anchored on load (the slab route's first round); timed beside
     their plain versions and bounds; K9's stage kernels against their
     plain stages and timed; the normalization's kernel pair cspn_gates9 /
     cspn_gates9_bwd against its plain versions at KITTI and slab shapes
     and at zero guidance, and timed (`gates9_case`);
     then the forward round's launch plan: K1 and K4 at B=1 and at the
     batch shape and K7 on both slabs over every tile geometry, and K2
     and K5 at the batch shape over every geometry (`geometry` lines,
     every output bit for bit the same, K2 = K1 and K5 = K4, every stash
     bit for bit the first point's; `geometry_best` with the plan's own
     choice), and the six forward entries timed at every shape this
     script times them, with K1 and K4's round split at T = 0, 4 and 24
     and what each stash entry adds to its plain entry (`forward_time`,
     `round_split`, `stash_split` lines). The stash entries' checks in
     phases 3, 6 and 9 add shapes whose W is not a multiple of 4 or is
     narrower than a tile (57x75, 13x17, 13x16; a 20x75 slab);
 10. spatial: ranks on the one card, each a process on cuda:0 over gloo
     (NCCL refuses two ranks on one device): cspn_propagate_spatial on a
     1x4 spatial group against the whole-image tiled route (K4-K6), then
     the kitti_1216 Trainer at its own 2x4 mesh on 8 ranks at full width,
     three runs in one spawn (MESH_RUNS): the images layout at batch 8,
     and every feature map sharded over H (the rows layout) at batch 2,
     which "auto" picks, and at batch 8; each an f32 step against the 1x1
     Trainer's at the same batch, timed bf16 steps and an eval step with
     the slab route's launch counts (K7/K8/K9, cspn_gates9,
     cspn_gates9_bwd) and the exchanges and bytes of that run,
     peak memory per rank, the ranks' parameters bit for bit
     (`spatial_train`, and a `spatial_rows` line per run). Times of this
     phase are one card time-shared by 8 processes, not a multi-GPU
     figure. `phase_spatial(gpu, gap_probe=True)` also takes the f32
     step's gap apart (`mesh_gap`: cuDNN off on both sides, the 1x1
     BatchNorm on the mesh's sums);
 11. fit: nyu_completion_500 as configured (ResNet-50, batch 8) on packed
     NYU shards that the script writes (raw 480x640, tools/prepare_nyu.py's
     format): a kill after a checkpoint and a resume inside the epoch
     (restored state bit for bit, the resumed losses against two
     uninterrupted runs, cuDNN deterministic; save and restore ms and the
     checkpoint's size), Trainer.fit over two epochs with its K2/K3 launches
     per train step and K1 per eval batch, its step, data and eval times;
     the CLI as a subprocess (train, resume at the next epoch, --evaluate)
     and DepthPredictor.from_checkpoint against the restored Trainer;
 12. breadth: the JAX package's other model and data options. `mixed`:
     host8_dp's share of one rank (mesh.data 8 -> 1, batch 64 -> 8) on NYU
     shards and KITTI frames the script writes, NYU and KITTI batches in
     turn, a warm-up epoch, then one counted epoch (step ms by shape, data
     ms, peak memory, K2/K3 per NYU step, K5/K6 per KITTI step, K1 per
     eval batch, nothing else) and a kill and resume inside the epoch;
     `ref_recipe`: nyu_completion_500_ref at full width with a
     torchvision-layout .pth written from seeded weights (the loaded
     encoder against the file, conv1's 4th channel the RGB mean, train
     steps through K2/K3, one step against the plain CSPN loop); `arch`:
     resnet18 and resnet34 with upproj and resnet50 with upconv at
     228x304 (serving at batch 32 against the plain CSPN path with its K1
     launches, train steps with their K2/K3 launches, one step against
     the plain loop); `stereo`: stereo_sparse_sample's scores and
     selection on the card against the CPU, timed at NYU B=32 and KITTI
     B=8, and a train step with data.sampler=stereo;
 13. tools (run after phase 9, before the serving counts and the KITTI
     epoch): `export`: DepthPredictor.export_program of nyu_completion_500
     at B=1 and 32 and kitti_1216 at B=1 and 8, each program loaded in one
     fresh process that imports torch and ops/library.py by name and builds
     no model, its output against predict_batch, its K1 (NYU) or K4 (KITTI)
     launches, one a call and nothing else, its host ms per call beside the
     eager model's, and a program on the gates9 operator contract of K4
     before it took raw guidance (it loads and runs K7's entry); `parity`: ops/parity.py's checks of K1-K9 as the JAX
     bench runs its parity gate; `profiling`: a trace of a serving batch,
     StepTimer, marginal_chain of K1 and kernel_roofline; `debug`:
     checkify_step on a train step, clean and with a NaN in rgb, and a step
     under enable_debug().
The kernel checks (3, 6, 9) run first. Every path's launch counts also
count the plain normalization's and anchor's calls on a CUDA tensor
("prenorm_gates9", "anchor"), which must stay 0. Then a line with the
kernel table and, last, the device line.
It exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from cspn_monodepth_tpu_torch import DepthPredictor, get_config, native
from cspn_monodepth_tpu_torch.configs import MeshConfig
from cspn_monodepth_tpu_torch.data import (
    DEPTH_SCALE,
    make_train_iterator,
    pack_batch,
)
from cspn_monodepth_tpu_torch.models import CSPNDepthNet, jax_variables
from cspn_monodepth_tpu_torch.models import resnet
from cspn_monodepth_tpu_torch.models.resnet import ARCHS
from cspn_monodepth_tpu_torch.models.torch_weights import encoder_key
from cspn_monodepth_tpu_torch.ops import cspn_cuda, cspn_propagate, parity
from cspn_monodepth_tpu_torch.ops.cspn_ref import (
    NORM_TYPES,
    adjoint_sweep_plain,
    anchor,
    cspn_bwd_sums_plain,
    prenorm_gates9,
    prenorm_gates9_bwd_plain,
)
from cspn_monodepth_tpu_torch.ops.sparse import (
    keep_top,
    stereo_scores,
    stereo_sparse_sample,
    uniform_sparse_sample,
)
from cspn_monodepth_tpu_torch.parallel import (
    comm,
    cspn_propagate_spatial,
    exchange_halo,
    make_mesh,
    spawn_ranks,
)
from cspn_monodepth_tpu_torch.train import Trainer
from cspn_monodepth_tpu_torch.train.checkpoint import CheckpointManager
from cspn_monodepth_tpu_torch.utils import debug, profiling

# H100 SXM published peaks (NVIDIA data sheet, full 700 W power limit); the
# memory rate is utils/profiling.py's, which kernel_roofline divides by.
HBM_BYTES_PER_S = profiling.HBM_BYTES_PER_S["H100 80GB HBM3"]
F32_FLOPS = 67e12

# Max-relative error, max|a - b| / max|b|. The kernel contracts to FMA and
# sums in its own order; the JAX kernels sit near 2e-6 against their scan.
KERNEL_TOL = 1e-5
# The whole path, kernel vs plain CSPN on identical heads: T=24 iterations
# of an expansive stencil amplify rounding.
PATH_TOL = 1e-4
# Gradients through the kernels (K2 forward, K3 adjoint) against torch
# autograd of the plain loop: the reverse-mode sums of two programs.
GRAD_TOL = 1e-4
# A train step with the kernels vs the plain CSPN loop, identical weights,
# batch and sparse map, cuDNN deterministic: the loss (a mean over the
# batch) differs only by the CSPN's rounding.
STEP_LOSS_TOL = 1e-5
# Small f32 model on the card vs the CPU, TF32 off: convolution sums in
# another order, then T=4 CSPN iterations.
DEVICE_TOL = 1e-3
# The same model's gradients with cuDNN's own f32 weight-gradient
# algorithms (TF32 off): on the H100 the one it picks for the 5x5 decoder
# convolutions lands 4.7e-3 from the CPU's gradient, where the card's own
# CUDA convolutions land within 1e-3; held to 1e-2.
CUDNN_WGRAD_TOL = 1e-2

NYU_H, NYU_W = 228, 304
SEED = 0
TRAIN_BATCH = 32
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
# Timed requests: p75 of 40 single-image requests has 10 samples above it.
SINGLE_REQUESTS = 40
BATCH_REQUESTS = 12
KITTI_H, KITTI_W = 352, 1216
KITTI_RAW = (375, 1242)         # a raw frame, bottom-cropped to 352x1216
KITTI_BATCH = 8
KITTI_MAX_DEPTH = 85.0
KITTI_FRAMES = {"train": 48, "val": 8}
# The spatial path: halo_k rows on each side of a shard; the deployed slabs
# (kitti_1216 on 2x4: 4 images of 352/4 + 2k rows; multihost on 16x2: 256/16
# images of 228/2 + 2k rows).
HALO_K = 4
KITTI_SLAB = (4, KITTI_H // 4 + 2 * HALO_K, KITTI_W)
NYU_SLAB = (16, NYU_H // 2 + 2 * HALO_K, NYU_W)
SPATIAL_STEPS = 3
# The forward round's split: T=0 (the load phase alone), one round, six.
SPLIT_ITERS = (0, 4, 24)
# Ranks on the one card: one process each, all on cuda:0 over gloo.
RANK_DEADLINE_S = 420
# The kitti_1216 2x4 Trainer's f32 step against the 1x1 Trainer's: cuDNN
# picks its algorithms for batch 1 per rank and batch 8 on one device, and
# BatchNorm sums per rank before the all_reduce. On an H100 the loss came
# 1.0e-4 and the head gradients 1.4e-4 apart (PERF.md); held to 5e-4.
MESH_STEP_TOL = 5e-4
# The fit phase: packed NYU shards of raw 480x640 frames.
ROOT = Path(__file__).resolve().parent
NYU_RAW = (480, 640)
NYU_FRAMES = {"train": 96, "val": 32}
FIT_EPOCHS = 2
# Kill and resume: RESUME_STEPS steps an epoch, a checkpoint every
# CKPT_EVERY, the crash right after the first. With cuDNN deterministic the
# same state and batch give the same bits, except in the first epoch a
# process trains (on an H100 its second loss came 7.4e-5 from every later
# run's, which agreed bit for bit): a warm-up epoch runs first, then two
# uninterrupted epochs measure the spread, and the resumed losses are held
# to RESUME_TOL of the first of them, or to the spread where that is
# larger.
RESUME_STEPS = 4
CKPT_EVERY = 2
RESUME_TOL = 1e-6
# Steps on one fixed batch after fit (the first is not counted).
FIXED_STEPS = 7
# The CLI: steps an epoch, and the seconds a run may take.
CLI_STEPS = 3
CLI_TIMEOUT_S = 300
# DepthPredictor.from_checkpoint against the restored Trainer's forward:
# the same weights and kernels.
SERVE_TOL = 1e-5
# Phase 12, breadth. The mixed job: host8_dp's NYU and KITTI batches in
# turn (mix_every 2), an epoch of MIX_STEPS steps, a checkpoint every
# MIX_CKPT and the crash right after the first (the resume starts at a
# KITTI step, both streams inside their epoch).
MIX_STEPS = 8
MIX_CKPT = 3
BREADTH_REDUCED = ["mesh.data 8 -> 1 (one rank's share on one card)",
                   "train.batch_size 64 -> 8 (the rank's share)",
                   "NYU 96 + 32 and KITTI 48 + 8 frames written by the "
                   "script (synthetic, raw sizes)",
                   "train.steps_per_epoch 8"]
REF_STEPS = 3
# The other encoder and decoder options at 228x304.
ARCH_CELLS = (("resnet18", "upproj"), ("resnet34", "upproj"),
              ("resnet50", "upconv"))
ARCH_BATCH = 32
ARCH_STEPS = 5
# stereo_scores on the card vs the CPU: a channel mean and two absolute
# differences of values in [0, 1], a few float32 roundings.
STEREO_SCORE_TOL = 1e-6
# Phase 13, tools. The exported serving program at each served shape, loaded
# in a fresh process; against predict_batch it is held to the JAX package's
# own bar for its StableHLO round trip (tests/test_serving.py).
EXPORT_CELLS = (("nyu_completion_500", 1), ("nyu_completion_500", TRAIN_BATCH),
                ("kitti_1216", 1), ("kitti_1216", KITTI_BATCH))
EXPORT_TOL = 1e-6
# Calls of the loaded program at a batch shape (SINGLE_REQUESTS at B=1).
EXPORT_BATCH_CALLS = 5
# StepTimer: warm-up steps, then the counted ones.
TIMER_WARMUP = 3
TIMER_STEPS = 6
DEBUG_BATCH = 8
# K1's kernel as a trace names it (csrc/cspn_fwd.cu).
K1_KERNEL = "cspn_fwd_round"
# The process that loads the programs: torch and ops/library.py by name, no
# model built, no config read. argv[1] is a JSON list of jobs (program,
# input .npy, output .npy, calls); prints one JSON line per job.
LOADER = r'''
import json, sys, time
import numpy as np
import torch
import cspn_monodepth_tpu_torch.ops.library as library

for path, x_path, out_path, calls in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    program = library.load_program(path, device="cuda")
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.load(x_path)).cuda()
    program(x).cpu()
    for fn in library.cspn_cuda.WRAPPERS:
        fn.launches = 0
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        y = program(x).cpu()
        ms.append(1e3 * (time.perf_counter() - t0))
    np.save(out_path, y.numpy())
    print(json.dumps({"path": path, "load_s": load_s, "ms": ms,
                      "launches": {fn.__name__: fn.launches
                                   for fn in library.cspn_cuda.WRAPPERS},
                      "jax_imported": "jax" in sys.modules}), flush=True)
    del program
'''


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


def bound_ms(planes: int, px: int, ops: float):
    """Least time on this card for work that moves `planes` f32 planes of
    `px` pixels (each input read once, each output written once) and does
    `ops` f32 operations: the larger of the two times, and which it is."""
    t_bytes, t_ops = 4 * px * planes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def cspn_bound_ms(b, h, w, num_iters, sparse: bool):
    """K1: read the 8 guidance planes, blur and sparse once, write the
    result once; 19 flop/px per iteration plus 32 for the normalization."""
    px = b * h * w
    return bound_ms(8 + 1 + int(sparse) + 1, px, px * (19 * num_iters + 32))


def stash_bound_ms(b, h, w, num_iters, sparse: bool):
    """K2: K1's planes plus the T stash planes written once."""
    px = b * h * w
    return bound_ms(8 + 1 + int(sparse) + 1 + num_iters, px,
                    px * (19 * num_iters + 32))


def bwd_bound_ms(b, h, w, num_iters, sparse: bool):
    """K3: read the 8 guidance planes, sparse, the cotangent and the T
    stash planes once, write the 8 guidance gradients, d_blur and d_sparse
    once; ~40 flop/px per iteration (the 9-tap gather and the 9 gate-sum
    updates) plus ~80 for the normalizations and the chain rule."""
    px = b * h * w
    return bound_ms(8 + int(sparse) + 1 + num_iters + 8 + 1 + 1, px,
                    px * (40 * num_iters + 80))


def prenorm_fwd_bound_ms(b, h, w, num_iters, sparse: bool):
    """K7 (the gates9 contract): read the 9 gate planes, d0 and sparse
    once, write the result once; 19 flop/px per iteration (no
    normalization). K4-K6 compute K1-K3's functions, with their bounds."""
    px = b * h * w
    return bound_ms(9 + 1 + int(sparse) + 1, px, px * 19 * num_iters)


def prenorm_stash_bound_ms(b, h, w, num_iters, sparse: bool):
    """K8: K7's planes plus the T stash planes written once."""
    px = b * h * w
    return bound_ms(9 + 1 + int(sparse) + 1 + num_iters, px,
                    px * 19 * num_iters)


def prenorm_bwd_bound_ms(b, h, w, num_iters, sparse: bool):
    """K9: read the 9 gate planes, sparse, the cotangent and the T stash
    planes once, write the 9 gate gradients, lam0 and the sparse sums once;
    ~40 flop/px per iteration, no chain rule."""
    px = b * h * w
    return bound_ms(9 + int(sparse) + 1 + num_iters + 9 + 1 + 1, px,
                    px * 40 * num_iters)


def gates9_bound_ms(b, h, w):
    """cspn_gates9 (K3's and K6's stage 0): read the 8 guidance planes,
    write the 9 gate planes; ~32 flop/px."""
    px = b * h * w
    return bound_ms(8 + 9, px, 32 * px)


def gates9_bwd_bound_ms(b, h, w):
    """cspn_gates9_bwd: read the 8 guidance and 9 gate-gradient planes,
    write the 8 guidance gradients; ~60 flop/px (the chain rule)."""
    px = b * h * w
    return bound_ms(8 + 9 + 8, px, 60 * px)


def sweep_bound_ms(b, h, w, num_iters, sparse: bool):
    """The adjoint's stage 1: read the 9 gate planes, sparse and the
    cotangent, write the T planes of the adjoint stash and lam^0; 17 flop/px
    per iteration."""
    px = b * h * w
    return bound_ms(9 + int(sparse) + 1 + num_iters + 1, px,
                    px * 17 * num_iters)


def sums_bound_ms(b, h, w, num_iters, sparse: bool, raw: bool):
    """The adjoint's stage 2: read the T stash and T adjoint-stash planes
    and sparse; write the 9 gate sums and the sparse sum (K6, K9), or (K3,
    `raw`) also read the 8 guidance planes and lam^0 and write the 8
    guidance gradients, d_blur and d_sparse; 18 flop/px per iteration, ~80
    for the chain rule."""
    px = b * h * w
    planes = 2 * num_iters + int(sparse) + (8 + 1 + 8 + 1 + 1 if raw else 10)
    return bound_ms(planes, px, px * (18 * num_iters + (80 if raw else 0)))


def check_adjoint_stages(c: dict, gates9, sp, stash, cot, guid=None,
                         norm=None):
    """Each stage kernel of the adjoint against its plain stage on the same
    inputs, held alone, for case `c`: K3's stage 0 on the raw guidance
    `guid` (when given); the sweep on gates9 (every adjoint stash plane and
    lam^0); the sums, in K3's form with the chain rule when `guid` is given,
    on the stash and the plain sweep's lam stash. Emits the largest
    max-relative error of each output; raises past KERNEL_TOL."""
    kw = dict(num_iters=c["t"])
    errs = {}
    if guid is not None:
        errs["gates9"] = max_rel(cspn_cuda.cspn_gates9(guid, norm_type=norm),
                                 prenorm_gates9(guid, norm))
    lam_stash, lam0 = cspn_cuda.cspn_bwd_sweep(gates9, sp, cot, **kw)
    want_stash, want_lam0 = adjoint_sweep_plain(gates9, sp, cot, **kw)
    errs["sweep_lam_stash"] = max(
        [max_rel(lam_stash[:, t], want_stash[:, t])
         for t in range(c["t"])], default=0.0)
    errs["sweep_lam0"] = max_rel(lam0, want_lam0)
    del lam_stash, lam0
    raw = {} if guid is None else dict(guidance=guid, lam0=want_lam0,
                                       norm_type=norm)
    got = cspn_cuda.cspn_bwd_sums(sp, stash, want_stash, **kw, **raw)
    want = cspn_bwd_sums_plain(sp, stash, want_stash, **kw, **raw)
    names = ("d_guid", "d_blur", "d_sparse") if raw else ("d_gates9",
                                                          "d_sparse")
    torch.cuda.synchronize()
    for name, g, w in zip(names, got, want):
        errs[f"sums_{name}"] = max_rel_or_zero(g, w)
    emit("adjoint_stage_case", **c, max_rel=errs, tol=KERNEL_TOL)
    if not max(errs.values()) <= KERNEL_TOL:
        raise AssertionError(f"adjoint stages vs their plain stages: {c} "
                             f"{errs}")


def time_adjoint_stages(gpu: str, kernel: str, shape: dict, gates9, sp,
                        stash, cot, guid=None, norm=None):
    """Each stage of `kernel` (K3 or K6 with `guid`, else K9) timed alone on
    the inputs it gets inside the adjoint, beside its plain stage and its
    own bound: one `stage_time` line each."""
    b, h, w, t = shape["b"], shape["h"], shape["w"], shape["t"]
    kw = dict(num_iters=t)
    lam_stash, lam0 = cspn_cuda.cspn_bwd_sweep(gates9, sp, cot, **kw)
    raw = {} if guid is None else dict(guidance=guid, lam0=lam0,
                                       norm_type=norm)
    stages = []
    if guid is not None:
        stages.append(("gates9",
                       lambda: cspn_cuda.cspn_gates9(guid, norm_type=norm),
                       lambda: prenorm_gates9(guid, norm),
                       gates9_bound_ms(b, h, w)))
    stages += [
        ("sweep", lambda: cspn_cuda.cspn_bwd_sweep(gates9, sp, cot, **kw),
         lambda: adjoint_sweep_plain(gates9, sp, cot, **kw),
         sweep_bound_ms(b, h, w, t, sp is not None)),
        ("sums",
         lambda: cspn_cuda.cspn_bwd_sums(sp, stash, lam_stash, **kw, **raw),
         lambda: cspn_bwd_sums_plain(sp, stash, lam_stash, **kw, **raw),
         sums_bound_ms(b, h, w, t, sp is not None, guid is not None))]
    for stage, fn, plain, bound in stages:
        ms = time_ms(fn, 20)
        plain_ms = time_ms(plain, 3, warmup=1)
        emit("stage_time", kernel=kernel, stage=stage, **shape, ms=ms,
             device_ms=device_profile(fn)["busy_ms"], plain_ms=plain_ms,
             bound_ms=bound[0], bound_by=bound[1], gpu=gpu)


def check_deterministic(kernel: str, fn):
    """Two runs of an adjoint on the same inputs, bit for bit (no
    atomics)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    emit("deterministic", kernel=kernel, bitwise_equal=same)
    if not same:
        raise AssertionError(f"two runs of {kernel} differ")


def parse_ptxas(log: str) -> list[dict]:
    """Registers and spill bytes of every entry in nvcc -Xptxas -v output."""
    entries = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entries.append({"entry": ln.split("'")[1]})
        elif entries and "spill stores" in ln:
            nums = [int(x.split()[0]) for x in ln.split(",")]
            entries[-1]["spill_stores"], entries[-1]["spill_loads"] = nums[1:3]
        elif entries and "Used" in ln and "registers" in ln:
            entries[-1]["registers"] = int(ln.split("Used")[1].split()[0])
    return entries


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
    paths = cspn_cuda.build()
    seconds = time.perf_counter() - t0
    for name, path in paths.items():
        # Each kernel's entry line (its mangled name: ILb0E is the raw
        # contract, ILb1E the prenormalized one) before its registers.
        ptxas = [ln.strip() for ln in
                 cspn_cuda.build_log.get(name, "").splitlines()
                 if any(k in ln for k in ("Compiling entry", "registers",
                                          "spill"))]
        emit("build", source=f"csrc/{name}.cu", seconds=seconds,
             library=path.name, ptxas=ptxas,
             entries=parse_ptxas(cspn_cuda.build_log.get(name, "")))


def kernel_cases() -> list[dict]:
    """B=2 228x304, T in {1, 24} x 3 norms x sparse on/off; 57x76; head
    slices; batch 32."""
    cases = [dict(b=2, h=NYU_H, w=NYU_W, t=t, norm=n, sparse=s)
             for t in (1, 24) for n in NORM_TYPES for s in (True, False)]
    cases += [dict(b=1, h=57, w=76, t=24, norm=n, sparse=True)
              for n in NORM_TYPES]
    cases += [dict(b=1, h=57, w=76, t=5, norm="8sum", sparse=False),
              dict(b=2, h=NYU_H, w=NYU_W, t=24, norm="8sum_clamp",
                   sparse=True, strided=True),
              dict(b=32, h=NYU_H, w=NYU_W, t=24, norm="8sum_clamp",
                   sparse=True)]
    return cases


def phase_kernels(gpu: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for c in kernel_cases():
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


def requests(rng, b, h, w, n_sparse=500, depth_range=(0.5, 9.5)):
    rgb = rng.random((b, h, w, 3), dtype=np.float32)
    sparse = np.zeros((b, h * w), np.float32)
    for i in range(b):
        idx = rng.choice(h * w, n_sparse, replace=False)
        sparse[i, idx] = rng.uniform(*depth_range, n_sparse)
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
    if "cspn_" in name or "adjoint_" in name:     # csrc/cspn_*.cu
        return "cspn"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer"
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


def serve(cfg, predictor, rgb, sparse, gpu: str, phase: str) -> dict:
    """The serving main path: warm-up at both request shapes (cuDNN
    chooses algorithms per shape), then, with the launch counts set to 0,
    SINGLE_REQUESTS single-image requests and BATCH_REQUESTS batches, each
    checked; emits `phase` and `phase`_profile (the host-to-device copy of
    the model's input, the model's forward on an input already on the
    card, the rest of a predict_batch call being the host's preparation
    and the copy back; one batch under the profiler). Returns the launch
    counts of the main path and the last batch's output."""
    batch, h, w = sparse.shape
    predictor.predict(rgb[0], sparse[0])
    predictor.predict_batch(rgb, sparse)
    torch.cuda.synchronize()

    reset_counts()
    single_ms = []
    for i in range(SINGLE_REQUESTS):
        t0 = time.perf_counter()
        depth = predictor.predict(rgb[i % batch], sparse[i % batch])
        single_ms.append(1e3 * (time.perf_counter() - t0))
        check_depth(depth, sparse[i % batch], (h, w))
    batch_ms = []
    for _ in range(BATCH_REQUESTS):
        t0 = time.perf_counter()
        out = predictor.predict_batch(rgb, sparse)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        check_depth(out, sparse, (batch, h, w))
    launches = counts()
    emit(phase, config=cfg.name, arch=cfg.model.arch,
         modality=cfg.model.modality, num_iters=cfg.model.num_iters,
         norm=cfg.model.norm_type, dtype=cfg.model.dtype, h=h, w=w,
         requests=len(single_ms),
         ms_per_request_p50=float(np.median(single_ms)),
         ms_per_request_p75=float(np.percentile(single_ms, 75)),
         batch=batch, batches=len(batch_ms),
         batch_ms_p50=float(np.median(batch_ms)),
         batch_ms_max=max(batch_ms),
         img_per_s=batch / (float(np.median(batch_ms)) / 1e3),
         launches=launches, max_abs_depth=float(np.abs(out).max()), gpu=gpu)
    x = np.concatenate([rgb, sparse[..., None]], axis=-1)
    x_dev = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        model_ms = host_ms(lambda: predictor.model(x_dev))
    emit(f"{phase}_profile", batch=batch, gpu=gpu,
         h2d_ms=host_ms(lambda: torch.from_numpy(x).cuda()),
         model_ms=model_ms,
         **device_profile(lambda: predictor.predict_batch(rgb, sparse)))
    return dict(launches=launches, out=out)


def path_heads(predictor, rgb, sparse) -> torch.Tensor:
    """The head output (B, 9, H, W) of one predict_batch call."""
    captured = []
    hook = predictor.model.head.register_forward_hook(
        lambda module, args, out: captured.append(out))
    predictor.predict_batch(rgb, sparse)
    hook.remove()
    return captured[0]


def path_vs_plain(cfg, variables, predictor, rgb, sparse):
    """Max-relative error of the serving path against the same model with
    the plain CSPN loop, and that plain predictor. The same convolution
    algorithms in both, so that they differ only in their CSPN."""
    torch.backends.cudnn.deterministic = True
    out = predictor.predict_batch(rgb, sparse)
    plain = DepthPredictor.from_variables(
        cfg.override(**{"model.cspn_impl": "torch"}), variables)
    want = plain.predict_batch(rgb, sparse)
    torch.backends.cudnn.deterministic = False
    return float(np.abs(out - want).max() / np.abs(want).max()), plain


def phase_serving(gpu: str) -> tuple[int, float]:
    cfg = get_config("nyu_completion_500")
    variables = randomized_variables(cfg)
    predictor = DepthPredictor.from_variables(cfg, variables)
    rng = np.random.default_rng(SEED)
    batch = 32
    rgb, sparse = requests(rng, batch, NYU_H, NYU_W)
    launches = serve(cfg, predictor, rgb, sparse, gpu,
                     "serving")["launches"]["cspn_fwd"]
    if launches == 0:
        raise AssertionError("the serving path never launched cspn_fwd")

    # The kernel against its plain version on the heads the path computed.
    heads = path_heads(predictor, rgb, sparse)
    sp = torch.from_numpy(sparse).cuda()
    kw = dict(num_iters=cfg.model.num_iters, norm_type=cfg.model.norm_type)
    got = cspn_cuda.cspn_fwd(heads[:, 1:], heads[:, 0], sp, **kw)
    want = cspn_cuda.cspn_fwd_plain(heads[:, 1:], heads[:, 0], sp, **kw)
    heads_err = max_rel(got, want)
    heads_abs = float((got - want).abs().max())
    if not heads_err <= KERNEL_TOL:
        raise AssertionError(f"cspn_fwd vs plain on the path's heads: "
                             f"max_rel {heads_err} > {KERNEL_TOL}")

    path_err, plain = path_vs_plain(cfg, variables, predictor, rgb, sparse)

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
    del predictor, plain, heads

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


def max_rel_or_zero(got: torch.Tensor, want: torch.Tensor) -> float:
    """max_rel, or 0 where both are exactly zero (d_sparse without a
    sparse map; zero guidance under 8sum_abs); inf if only `want` is."""
    if float(want.abs().max()) == 0.0:
        return 0.0 if float(got.abs().max()) == 0.0 else float("inf")
    return max_rel(got, want)


def train_kernel_errors(guid, blur, sp, cot, kw) -> dict:
    """K2 and K3 against their plain versions on the same inputs: the
    largest max-relative error of each output (every stash plane on its
    own), their largest absolute errors, and whether K2's output is K1's
    bit for bit."""
    out, stash = cspn_cuda.cspn_fwd_stash(guid, blur, sp, **kw)
    k1 = cspn_cuda.cspn_fwd(guid, blur, sp, **kw)
    grads = cspn_cuda.cspn_bwd(guid, sp, stash, cot, **kw)
    want_out, want_stash = cspn_cuda.cspn_fwd_stash_plain(guid, blur, sp,
                                                          **kw)
    want_grads = cspn_cuda.cspn_bwd_plain(guid, sp, want_stash, cot, **kw)
    torch.cuda.synchronize()
    errs = {"out": max_rel(out, want_out),
            "stash": max([max_rel(stash[:, t], want_stash[:, t])
                          for t in range(stash.shape[1])], default=0.0)}
    for name, got, want in zip(("d_guid", "d_blur", "d_sparse"), grads,
                               want_grads):
        errs[name] = max_rel_or_zero(got, want)
    return dict(max_rel=errs, k2_equals_k1=bool(torch.equal(out, k1)),
                k2_max_abs=max(float((out - want_out).abs().max()),
                               float((stash - want_stash).abs().max())
                               if stash.numel() else 0.0),
                k3_max_abs=max(float((g - w).abs().max())
                               for g, w in zip(grads, want_grads)))


def grad_case(gen, c: dict, impl: str, phase: str):
    """Gradients of every input of cspn_propagate(impl) for a random
    cotangent against torch autograd of the plain loop, guidance and blur
    as slices of one random head tensor; emits `phase`, raises past
    GRAD_TOL."""
    heads = torch.randn((c["b"], 9, c["h"], c["w"]), generator=gen,
                        device="cuda")
    heads[:, 0] = 0.5 + 9.0 * heads[:, 0].abs()
    sp = None
    if c["sparse"]:
        keep = torch.rand(heads[:, 0].shape, generator=gen,
                          device="cuda") < 0.01
        sp = torch.where(keep, heads[:, 0] + 0.25,
                         torch.zeros_like(heads[:, 0]))
    cot = torch.randn(heads[:, 0].shape, generator=gen, device="cuda")
    grads = {}
    for route in (impl, "torch"):
        h = heads.clone().requires_grad_()
        s = None if sp is None else sp.clone().requires_grad_()
        out = cspn_propagate(h[:, 1:], h[:, 0], s, num_iters=c["t"],
                             norm_type=c["norm"], impl=route,
                             guidance_layout="NCHW")
        inputs = [h] + ([s] if s is not None else [])
        grads[route] = torch.autograd.grad((out * cot).sum(), inputs)
    errs = [max_rel(a, b) for a, b in zip(grads[impl], grads["torch"])]
    emit(phase, **c, impl=impl, max_rel=errs, tol=GRAD_TOL)
    if not max(errs) <= GRAD_TOL:
        raise AssertionError(f"{impl} gradients vs torch autograd of the "
                             f"plain loop: {c} {errs}")


def stash_path_cases() -> list[dict]:
    """Stash shapes beside the deployed ones: W % 4 != 0 at T=24, and
    narrower than a tile at T=5 with W % 4 != 0 and == 0."""
    return [dict(b=1, h=57, w=75, t=24, norm="8sum_clamp", sparse=True),
            dict(b=2, h=13, w=17, t=5, norm="8sum", sparse=True),
            dict(b=2, h=13, w=16, t=5, norm="8sum_abs", sparse=True)]


def phase_train_kernels(gpu: str) -> dict:
    """K2 (stash forward) and K3 (adjoint) against their plain versions on
    K1's case matrix plus zero guidance; the autograd Function's gradients
    against torch autograd of the plain loop; K2/K3 times at batch 32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = kernel_cases() + [
        dict(b=2, h=NYU_H, w=NYU_W, t=24, norm=n, sparse=True, zero=True)
        for n in NORM_TYPES] + stash_path_cases()
    for c in cases:
        guid, blur, sp = cspn_problem(gen, c["b"], c["h"], c["w"],
                                      sparse=c["sparse"],
                                      strided=c.get("strided", False))
        if c.get("zero"):
            guid = torch.zeros_like(guid)
        cot = torch.randn(blur.shape, generator=gen, device="cuda")
        r = train_kernel_errors(guid, blur, sp, cot,
                                dict(num_iters=c["t"], norm_type=c["norm"]))
        emit("train_kernel_case", kernels=["cspn_fwd_stash", "cspn_bwd"],
             **c, **r, tol=KERNEL_TOL)
        if not (max(r["max_rel"].values()) <= KERNEL_TOL
                and r["k2_equals_k1"]):
            raise AssertionError(f"K2/K3 disagree with their plain "
                                 f"versions: {c} {r}")

    # Gradients of every input through CSPNFunction (K2 + K3) against
    # torch autograd of the plain loop, guidance and blur as head slices.
    for c in (dict(b=2, h=NYU_H, w=NYU_W, t=24, norm="8sum_clamp",
                   sparse=True),
              dict(b=1, h=57, w=76, t=24, norm="8sum_abs", sparse=False)):
        grad_case(gen, c, "cuda", "function_grad_case")

    b, t, kw = TRAIN_BATCH, 24, dict(num_iters=24, norm_type="8sum_clamp")
    guid, blur, sp = cspn_problem(gen, b, NYU_H, NYU_W, strided=True)
    cot = torch.randn(blur.shape, generator=gen, device="cuda")
    _, stash = cspn_cuda.cspn_fwd_stash(guid, blur, sp, **kw)
    _, plain_stash = cspn_cuda.cspn_fwd_stash_plain(guid, blur, sp, **kw)
    timing = {}
    for name, fn, plain, bound in (
            ("cspn_fwd_stash",
             lambda: cspn_cuda.cspn_fwd_stash(guid, blur, sp, **kw),
             lambda: cspn_cuda.cspn_fwd_stash_plain(guid, blur, sp, **kw),
             stash_bound_ms(b, NYU_H, NYU_W, t, True)),
            ("cspn_bwd",
             lambda: cspn_cuda.cspn_bwd(guid, sp, stash, cot, **kw),
             lambda: cspn_cuda.cspn_bwd_plain(guid, sp, plain_stash, cot,
                                              **kw),
             bwd_bound_ms(b, NYU_H, NYU_W, t, True))):
        ms = time_ms(fn, 30)
        plain_ms = time_ms(plain, 3, warmup=1)
        device_ms = device_profile(fn)["busy_ms"]
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1])
        emit("kernel_time", kernel=name, b=b, h=NYU_H, w=NYU_W, t=t,
             norm="8sum_clamp", ms=ms, device_ms=device_ms,
             plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
             library_ms=None, gpu=gpu)

    # K3's stages at batch 32 and on a small odd case.
    shape = dict(b=b, h=NYU_H, w=NYU_W, t=t, norm="8sum_clamp")
    gates9 = prenorm_gates9(guid, "8sum_clamp")
    check_adjoint_stages(shape, gates9, sp, stash, cot, guid, "8sum_clamp")
    time_adjoint_stages(gpu, "cspn_bwd", shape, gates9, sp, stash, cot, guid,
                        "8sum_clamp")
    check_deterministic("cspn_bwd",
                        lambda: cspn_cuda.cspn_bwd(guid, sp, stash, cot,
                                                   **kw))
    del stash, plain_stash, gates9
    c = dict(b=1, h=57, w=76, t=5, norm="8sum_abs")
    guid, blur, _ = cspn_problem(gen, 1, 57, 76, sparse=False)
    cot = torch.randn(blur.shape, generator=gen, device="cuda")
    _, stash = cspn_cuda.cspn_fwd_stash(guid, blur, None, num_iters=5,
                                        norm_type="8sum_abs")
    check_adjoint_stages(c, prenorm_gates9(guid, "8sum_abs"), None, stash,
                         cot, guid, "8sum_abs")
    return timing


def train_config():
    """nyu_completion_500 at full width on synthetic data, batch 32."""
    return get_config("nyu_completion_500").override(**{
        "data.dataset": "synthetic", "train.batch_size": TRAIN_BATCH})


def fixed_batch(trainer: Trainer, n: int) -> dict:
    """The first n synthetic training records, packed, on the card."""
    recs = [trainer.train_ds.get(i) for i in range(n)]
    packed = pack_batch({k: np.stack([r[k] for r in recs])
                         for k in ("rgb", "depth")})
    return {k: torch.from_numpy(v).cuda() for k, v in packed.items()}


def reset_counts():
    for fn in cspn_cuda.WRAPPERS:
        fn.launches = 0
    prenorm_gates9.cuda_calls = anchor.cuda_calls = 0


def counts() -> dict:
    """Each wrapper's launches, and the calls of the plain normalization
    and anchor on a CUDA tensor ("prenorm_gates9", "anchor"), which no
    route makes: every check of a path's counts holds them at 0."""
    return {**{fn.__name__: fn.launches for fn in cspn_cuda.WRAPPERS},
            "prenorm_gates9": prenorm_gates9.cuda_calls,
            "anchor": anchor.cuda_calls}


def timed_train(cfg, variables, batch_size: int, kernels: tuple,
                gpu: str, phase: str):
    """The train main path: a Trainer of cfg from `variables`, TRAIN_WARMUP
    steps, then, with the launch counts set to 0, TRAIN_STEPS steps on one
    fixed batch of the first batch_size records; each of `kernels` must
    have launched once per step and no other kernel. Emits `phase` (step
    times, peak memory, launches, losses, which must be finite and fall)
    and `phase`_profile (one step under the profiler: device time by
    class, idle share). Returns the trainer, its state, the launches and
    the median step ms."""
    trainer = Trainer(cfg)
    state = trainer.init_state(variables)
    batch = fixed_batch(trainer, batch_size)
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, loss, _ = trainer.train_step(state, batch)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batch)
        losses.append(float(loss))          # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: TRAIN_STEPS if k in kernels else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"the {phase} path's kernel launches "
                             f"{launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{losses}")
    median = float(np.median(step_ms))
    emit(phase, config=cfg.name, arch=cfg.model.arch,
         num_iters=cfg.model.num_iters, norm=cfg.model.norm_type,
         dtype=cfg.model.dtype, batch=batch_size, h=cfg.data.height,
         w=cfg.data.width, steps=len(step_ms), ms_per_step_p50=median,
         ms_per_step_max=max(step_ms), img_per_s=batch_size / median * 1e3,
         peak_mem_gb=peak_gb, launches=launches, losses=losses, gpu=gpu)
    emit(f"{phase}_profile", batch=batch_size, gpu=gpu,
         **device_profile(lambda: trainer.train_step(state, batch)))
    return trainer, state, launches, median


def phase_train(gpu: str) -> dict:
    cfg = train_config()
    variables = randomized_variables(cfg)
    trainer, state, launches, _ = timed_train(
        cfg, variables, TRAIN_BATCH, ("cspn_fwd_stash", "cspn_bwd"), gpu,
        "train")

    # The loop through the data pipeline (pinned, non-blocking copies).
    epoch_state, metrics = trainer.train_epoch(state, 0, log=lambda *a: None)
    emit("train_epoch", steps=trainer.steps_per_epoch,
         loss=metrics["loss"], step_time_s=metrics["step_time"],
         data_time_s=metrics["data_time"], rmse=metrics["rmse"])
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"train_epoch loss {metrics['loss']}")

    # Evaluation: BN on running statistics, K1 forward.
    reset_counts()
    ev = trainer.evaluate(epoch_state, log=lambda *a: None,
                          save_panels=False)
    eval_launches = counts()
    emit("evaluate", n_images=ev["n_images"], rmse=ev["rmse"],
         mae=ev["mae"], delta1=ev["delta1"],
         img_per_s=ev["images_per_sec"], launches=eval_launches)
    if not (eval_launches["cspn_fwd"] > 0 and all(
            np.isfinite(ev[k]) for k in ("rmse", "mae", "rel", "delta1"))):
        raise AssertionError(f"evaluate: {ev} {eval_launches}")
    del state, epoch_state, trainer

    path = phase_train_vs_plain(cfg, variables, gpu)
    phase_train_device_vs_cpu()
    return dict(launches=launches, **path)


def step_vs_plain(cfg, variables, batch_size: int):
    """One train step with the kernels against the same step with the
    plain CSPN loop: identical weights, batch and sparse map, cuDNN
    deterministic. The gradient clip is off here: its factor is the global
    norm of every gradient, bf16 encoder gradients included, which rounds
    differently as soon as the head's gradient differs in its last bits,
    and would scale both head gradients by factors ~1e-4 apart. Returns the
    comparison, the kernel step's heads and its sparse map; raises past the
    tolerances."""
    torch.backends.cudnn.deterministic = True
    results = {}
    captured = []
    sparse = None
    for impl in ("auto", "torch"):
        trainer = Trainer(cfg.override(**{"model.cspn_impl": impl,
                                          "train.clip_norm": 0.0}))
        batch = fixed_batch(trainer, batch_size)
        if sparse is None:
            sparse = trainer._sample_sparse(
                trainer._rng(0, 0), trainer._unpack(batch)["depth"], None)
        trainer._sample_sparse = lambda gen, d, rgb, _s=sparse: _s
        state = trainer.init_state(variables)
        hook = None
        if impl == "auto":
            hook = state.model.head.register_forward_hook(
                lambda module, args, out: captured.append(out.detach()))
        state, loss, _ = trainer.train_step(state, batch)
        if hook is not None:
            hook.remove()
        results[impl] = dict(loss=float(loss), sparse=sparse,
                             weight=state.model.head.weight.grad.clone(),
                             bias=state.model.head.bias.grad.clone())
        del state, trainer
    torch.backends.cudnn.deterministic = False
    k, p = results["auto"], results["torch"]
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    grad_errs = {n: max_rel(k[n], p[n]) for n in ("weight", "bias")}
    grad_err = max(grad_errs.values())
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= GRAD_TOL):
        raise AssertionError(f"train step with the kernels vs the plain "
                             f"CSPN: loss {loss_err}, head grads {grad_err}")
    return (dict(batch=batch_size, loss_kernel=k["loss"],
                 loss_plain=p["loss"], loss_rel=loss_err,
                 loss_tol=STEP_LOSS_TOL, head_grad_max_rel=grad_errs,
                 head_grad_tol=GRAD_TOL), captured[0], k["sparse"])


def phase_train_vs_plain(cfg, variables, gpu: str) -> dict:
    """step_vs_plain on the NYU path, and K2/K3 against their plain
    versions on the step's own heads."""
    line, heads, sparse = step_vs_plain(cfg, variables, TRAIN_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cot = torch.randn(heads[:, 0].shape, generator=gen, device="cuda")
    r = train_kernel_errors(heads[:, 1:], heads[:, 0], sparse, cot,
                            dict(num_iters=cfg.model.num_iters,
                                 norm_type=cfg.model.norm_type))
    emit("train_vs_plain_cspn", **line, heads_kernels=r, gpu=gpu)
    if not (max(r["max_rel"].values()) <= KERNEL_TOL and r["k2_equals_k1"]):
        raise AssertionError(f"K2/K3 vs plain on the path's heads: {r}")
    return dict(k2_max_abs=r["k2_max_abs"], k3_max_abs=r["k3_max_abs"])


def phase_train_device_vs_cpu():
    """One train step of a small f32 model (TF32 off) on the card against
    the same step on the CPU: every parameter's gradient. Random rgb (no
    exact max-pool ties, whose gradient each device may route to another
    element). Held to DEVICE_TOL with cuDNN off (the card's own CUDA
    convolutions, f32 sums in another order). With cuDNN on, its f32
    weight-gradient algorithm for the 5x5 decoder convolutions lands a few
    1e-3 from the CPU (and from f64), so that run is held to
    CUDNN_WGRAD_TOL and reported beside it."""
    torch.backends.cudnn.allow_tf32 = False
    small = get_config("synthetic_tiny").override(**{
        "model.dtype": "float32", "model.norm_type": "8sum_clamp"})
    small_vars = randomized_variables(small)
    b, h, w = small.train.batch_size, small.data.height, small.data.width
    rng = np.random.default_rng(SEED + 3)
    batch = {"rgb": rng.random((b, h, w, 3), dtype=np.float32),
             "depth": rng.uniform(0.5, 9.5, (b, h, w)).astype(np.float32)}
    sparse = np.where(rng.random((b, h, w)) < 0.01, batch["depth"],
                      0.0).astype(np.float32)

    def step_grads(device):
        trainer = Trainer(small, device=device)
        sp = torch.from_numpy(sparse).to(device)
        trainer._sample_sparse = lambda gen, d, rgb, _s=sp: _s
        state = trainer.init_state(small_vars)
        trainer.train_step(state, batch)
        return {n: p.grad.detach().cpu()
                for n, p in state.model.named_parameters()}

    def worst(got, want):
        errs = {n: max_rel_or_zero(got[n], g) for n, g in want.items()}
        name = max(errs, key=errs.get)
        return name, errs[name]

    want = step_grads("cpu")
    with_cudnn = worst(step_grads("cuda"), want)
    torch.backends.cudnn.enabled = False
    try:
        without = worst(step_grads("cuda"), want)
    finally:
        torch.backends.cudnn.enabled = True
    emit("train_device_vs_cpu", config=small.name, h=h, w=w,
         tensors=len(want), max_rel=without[1], worst=without[0],
         tol=DEVICE_TOL, cudnn_max_rel=with_cudnn[1],
         cudnn_worst=with_cudnn[0], cudnn_tol=CUDNN_WGRAD_TOL)
    if not (without[1] <= DEVICE_TOL and with_cudnn[1] <= CUDNN_WGRAD_TOL):
        raise AssertionError(f"small model's train step on the card vs the "
                             f"CPU: {without}, with cuDNN {with_cudnn}")


def tiled_kernel_errors(guid, blur, sp, cot, num_iters: int,
                        norm_type: str) -> dict:
    """K4, K5 and K6 on the raw guidance `guid`, blur and sparse against
    their plain versions: the largest max-relative error of each output
    (every stash plane on its own), their largest absolute errors, anchors
    exact, whether K5's output is K4's bit for bit, and whether K4's is,
    bit for bit, the gates9 contract's on cspn_gates9's planes with d^0
    anchored on load (K7's entry: what K4 computed before it took raw
    guidance)."""
    kw = dict(num_iters=num_iters, norm_type=norm_type)
    k4 = cspn_cuda.cspn_tiled_fwd(guid, blur, sp, **kw)
    out, stash = cspn_cuda.cspn_tiled_fwd_stash(guid, blur, sp, **kw)
    grads = cspn_cuda.cspn_tiled_bwd(guid, sp, stash, cot, **kw)
    on_gates9 = cspn_cuda.cspn_prenorm_fwd(
        cspn_cuda.cspn_gates9(guid, norm_type=norm_type), blur, sp,
        num_iters=num_iters, anchor_d0=True)
    want_out, want_stash = cspn_cuda.cspn_tiled_fwd_stash_plain(
        guid, blur, sp, **kw)
    want_grads = cspn_cuda.cspn_tiled_bwd_plain(guid, sp, want_stash, cot,
                                                **kw)
    torch.cuda.synchronize()
    errs = {"k4_out": max_rel(k4, want_out),
            "k5_stash": max([max_rel(stash[:, t], want_stash[:, t])
                             for t in range(stash.shape[1])], default=0.0)}
    for name, got, want in zip(("d_guid", "d_blur", "d_sparse"), grads,
                               want_grads):
        errs[name] = max_rel_or_zero(got, want)
    anchors_exact = True
    if sp is not None:
        m = sp > 0
        anchors_exact = bool(torch.equal(k4[m], sp[m]))
    return dict(max_rel=errs, k5_equals_k4=bool(torch.equal(out, k4)),
                k4_equals_gates9_contract=bool(torch.equal(k4, on_gates9)),
                anchors_exact=anchors_exact,
                k4_max_abs=float((k4 - want_out).abs().max()),
                k5_max_abs=float((stash - want_stash).abs().max())
                if stash.numel() else 0.0,
                k6_max_abs=max(float((g - w).abs().max())
                               for g, w in zip(grads, want_grads)))


def tiled_ok(r: dict) -> bool:
    return (max(r["max_rel"].values()) <= KERNEL_TOL and r["k5_equals_k4"]
            and r["k4_equals_gates9_contract"] and r["anchors_exact"])


def kitti_kernel_cases() -> list[dict]:
    """B=2 352x1216, T in {1, 24} x 3 norms x sparse on/off; 37x48 and
    13x17 at T=5 (H not a tile multiple, a remainder round); 57x75 and
    13x16 (stash_path_cases); zero guidance x 3 norms; head slices; batch
    8."""
    cases = [dict(b=2, h=KITTI_H, w=KITTI_W, t=t, norm=n, sparse=s)
             for t in (1, 24) for n in NORM_TYPES for s in (True, False)]
    cases += [dict(b=2, h=37, w=48, t=5, norm="8sum", sparse=True),
              dict(b=2, h=13, w=17, t=5, norm="8sum_abs", sparse=False)]
    cases += [c for c in stash_path_cases() if c["w"] != 17]
    cases += [dict(b=1, h=KITTI_H, w=KITTI_W, t=24, norm=n, sparse=True,
                   zero=True) for n in NORM_TYPES]
    cases += [dict(b=2, h=KITTI_H, w=KITTI_W, t=24, norm="8sum_clamp",
                   sparse=s, strided=True) for s in (True, False)]
    cases += [dict(b=KITTI_BATCH, h=KITTI_H, w=KITTI_W, t=24,
                   norm="8sum_clamp", sparse=True)]
    return cases


def phase_kitti_kernels(gpu: str) -> dict:
    """K4, K5 and K6 against their plain versions; TiledCSPNFunction's
    gradients against torch autograd of the plain loop; the tiled route
    against K1 on the same raw guidance; times at batch 8, 352x1216, with
    the normalization's cost on the route (`prenorm_time`)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for c in kitti_kernel_cases():
        guid, blur, sp = cspn_problem(gen, c["b"], c["h"], c["w"],
                                      sparse=c["sparse"],
                                      strided=c.get("strided", False))
        if c.get("zero"):
            guid = torch.zeros_like(guid)
        cot = torch.randn(blur.shape, generator=gen, device="cuda")
        r = tiled_kernel_errors(guid, blur, sp, cot, c["t"], c["norm"])
        emit("kitti_kernel_case", kernels=["cspn_tiled_fwd",
                                           "cspn_tiled_fwd_stash",
                                           "cspn_tiled_bwd"],
             **c, **r, tol=KERNEL_TOL)
        if not tiled_ok(r):
            raise AssertionError(f"K4/K5/K6 disagree with their plain "
                                 f"versions: {c} {r}")

    # Gradients of every input through TiledCSPNFunction (K5 + K6), the
    # normalization and the anchor inside, against torch autograd of the
    # plain loop.
    for c in (dict(b=2, h=KITTI_H, w=KITTI_W, t=24, norm="8sum_clamp",
                   sparse=True),
              dict(b=1, h=37, w=48, t=10, norm="8sum_abs", sparse=False)):
        grad_case(gen, c, "cuda_tiled", "tiled_function_grad_case")

    # The same function by two routes: K4 against K1 on the same raw
    # guidance (one C entry: bit for bit).
    for norm in NORM_TYPES:
        guid, blur, sp = cspn_problem(gen, 2, KITTI_H, KITTI_W)
        kw = dict(num_iters=24, norm_type=norm, guidance_layout="NCHW")
        tiled = cspn_propagate(guid, blur, sp, impl="cuda_tiled", **kw)
        whole = cspn_propagate(guid, blur, sp, impl="cuda", **kw)
        err = max_rel(tiled, whole)
        emit("tiled_vs_whole_plane_route", norm=norm, max_rel=err,
             bitwise_equal=bool(torch.equal(tiled, whole)), tol=KERNEL_TOL)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"tiled route vs K1 ({norm}): {err}")

    b, t = KITTI_BATCH, 24
    guid, blur, sp = cspn_problem(gen, b, KITTI_H, KITTI_W, strided=True)
    cot = torch.randn(blur.shape, generator=gen, device="cuda")
    kw = dict(num_iters=t, norm_type="8sum_clamp")
    _, stash = cspn_cuda.cspn_tiled_fwd_stash(guid, blur, sp, **kw)
    _, plain_stash = cspn_cuda.cspn_tiled_fwd_stash_plain(guid, blur, sp,
                                                          **kw)
    timing = {}
    for name, fn, plain, bound in (
            ("cspn_tiled_fwd",
             lambda: cspn_cuda.cspn_tiled_fwd(guid, blur, sp, **kw),
             lambda: cspn_cuda.cspn_tiled_fwd_plain(guid, blur, sp, **kw),
             cspn_bound_ms(b, KITTI_H, KITTI_W, t, True)),
            ("cspn_tiled_fwd_stash",
             lambda: cspn_cuda.cspn_tiled_fwd_stash(guid, blur, sp, **kw),
             lambda: cspn_cuda.cspn_tiled_fwd_stash_plain(guid, blur, sp,
                                                          **kw),
             stash_bound_ms(b, KITTI_H, KITTI_W, t, True)),
            ("cspn_tiled_bwd",
             lambda: cspn_cuda.cspn_tiled_bwd(guid, sp, stash, cot, **kw),
             lambda: cspn_cuda.cspn_tiled_bwd_plain(guid, sp, plain_stash,
                                                    cot, **kw),
             bwd_bound_ms(b, KITTI_H, KITTI_W, t, True)),
            ("cspn_fwd",
             lambda: cspn_cuda.cspn_fwd(guid, blur, sp, **kw),
             lambda: cspn_cuda.cspn_fwd_plain(guid, blur, sp, **kw),
             cspn_bound_ms(b, KITTI_H, KITTI_W, t, True))):
        ms = time_ms(fn, 20)
        plain_ms = time_ms(plain, 3, warmup=1)
        device_ms = device_profile(fn)["busy_ms"]
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1])
        emit("kernel_time", kernel=name, b=b, h=KITTI_H, w=KITTI_W, t=t,
             norm="8sum_clamp", ms=ms, device_ms=device_ms,
             plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
             library_ms=None, gpu=gpu)

    # K6's stages at batch 8 and on a case with a remainder round.
    shape = dict(b=b, h=KITTI_H, w=KITTI_W, t=t, norm="8sum_clamp")
    gates9 = cspn_cuda.cspn_gates9(guid, norm_type="8sum_clamp")
    check_adjoint_stages(shape, gates9, sp, stash, cot, guid, "8sum_clamp")
    time_adjoint_stages(gpu, "cspn_tiled_bwd", shape, gates9, sp, stash, cot,
                        guid, "8sum_clamp")
    check_deterministic("cspn_tiled_bwd",
                        lambda: cspn_cuda.cspn_tiled_bwd(guid, sp, stash,
                                                         cot, **kw))
    del stash, plain_stash
    g2, b2, s2 = cspn_problem(gen, 2, 37, 48)
    c2 = torch.randn(b2.shape, generator=gen, device="cuda")
    _, st2 = cspn_cuda.cspn_tiled_fwd_stash(g2, b2, s2, num_iters=10,
                                            norm_type="8sum")
    check_adjoint_stages(dict(b=2, h=37, w=48, t=10, norm="8sum"),
                         cspn_cuda.cspn_gates9(g2, norm_type="8sum"), s2,
                         st2, c2, g2, "8sum")

    # K4 on single images, as the serving path's single requests call it.
    g1, d1, s1 = guid[:1], blur[:1], sp[:1]
    fn = lambda: cspn_cuda.cspn_tiled_fwd(g1, d1, s1, **kw)   # noqa: E731
    bound = cspn_bound_ms(1, KITTI_H, KITTI_W, t, True)
    timing["cspn_tiled_fwd_b1"] = dict(
        ms=time_ms(fn, 50), device_ms=device_profile(fn)["busy_ms"],
        plain_ms=time_ms(lambda: cspn_cuda.cspn_tiled_fwd_plain(
            g1, d1, s1, **kw), 5), bound_ms=bound[0], bound_by=bound[1])
    emit("kernel_time", kernel="cspn_tiled_fwd", b=1, h=KITTI_H, w=KITTI_W,
         t=t, norm="8sum_clamp", **timing["cspn_tiled_fwd_b1"],
         library_ms=None, gpu=gpu)
    prenorm_time(gen, guid, blur, sp, cot, gpu)
    serving_route(guid, blur, sp, gpu)
    return timing


def prenorm_time(gen, guid, blur, sp, cot, gpu: str):
    """What the normalization and d^0's anchor cost at KITTI B=8 (T=24,
    8sum_clamp): the plain versions (forward, forward and backward, the
    anchor), as the route ran them before it took raw guidance; the kernel
    pair cspn_gates9 / cspn_gates9_bwd (the slab route's), each beside its
    bound; the route itself, K5 and K5 + K6 on the raw guidance, against
    the same kernels on the gates9 contract (K8's and K9's entries on
    cspn_gates9's planes with d^0 anchored on load: the route's old kernel
    work without the plain normalization), the difference being what the
    normalization and the anchor add inside the kernels."""
    b, t, norm = KITTI_BATCH, 24, "8sum_clamp"
    kw = dict(num_iters=t, norm_type=norm)
    g = guid.detach().clone().requires_grad_()
    d_gates9 = torch.randn((b, 9, KITTI_H, KITTI_W), generator=gen,
                           device="cuda")

    def plain_fwd_bwd():
        torch.autograd.grad(prenorm_gates9(g, norm), g, d_gates9)

    def pair_fwd_bwd():
        cspn_cuda.cspn_gates9(guid, norm_type=norm)
        cspn_cuda.cspn_gates9_bwd(guid, d_gates9, norm_type=norm)

    gates9 = cspn_cuda.cspn_gates9(guid, norm_type=norm)
    _, stash = cspn_cuda.cspn_tiled_fwd_stash(guid, blur, sp, **kw)
    raw_fwd = lambda: cspn_cuda.cspn_tiled_fwd_stash(   # noqa: E731
        guid, blur, sp, **kw)
    raw_bwd = lambda: cspn_cuda.cspn_tiled_bwd(         # noqa: E731
        guid, sp, stash, cot, **kw)
    g9_fwd = lambda: cspn_cuda.cspn_prenorm_fwd_stash(  # noqa: E731
        gates9, blur, sp, num_iters=t, anchor_d0=True)
    g9_bwd = lambda: cspn_cuda.cspn_prenorm_bwd(        # noqa: E731
        gates9, sp, stash, cot, num_iters=t, anchor_d0=True)
    route = dict(fwd_ms=time_ms(raw_fwd, 20), bwd_ms=time_ms(raw_bwd, 20),
                 gates9_fwd_ms=time_ms(g9_fwd, 20),
                 gates9_bwd_ms=time_ms(g9_bwd, 20))
    route.update(
        fwd_bound_ms=stash_bound_ms(b, KITTI_H, KITTI_W, t, True)[0],
        fwd_bwd_bound_ms=stash_bound_ms(b, KITTI_H, KITTI_W, t, True)[0]
        + bwd_bound_ms(b, KITTI_H, KITTI_W, t, True)[0],
        normalization_fwd_ms=route["fwd_ms"] - route["gates9_fwd_ms"],
        normalization_bwd_ms=route["bwd_ms"] - route["gates9_bwd_ms"])
    emit("prenorm_time", b=b, h=KITTI_H, w=KITTI_W, norm=norm,
         plain=dict(fwd_ms=time_ms(lambda: prenorm_gates9(guid, norm), 20),
                    fwd_bwd_ms=time_ms(plain_fwd_bwd, 20),
                    anchor_ms=time_ms(lambda: anchor(blur, sp), 20)),
         kernel_pair=dict(
             fwd_ms=time_ms(lambda: cspn_cuda.cspn_gates9(guid,
                                                          norm_type=norm),
                            20),
             fwd_bound_ms=gates9_bound_ms(b, KITTI_H, KITTI_W)[0],
             fwd_bwd_ms=time_ms(pair_fwd_bwd, 20),
             fwd_bwd_bound_ms=gates9_bound_ms(b, KITTI_H, KITTI_W)[0]
             + gates9_bwd_bound_ms(b, KITTI_H, KITTI_W)[0]),
         route=route, gpu=gpu)


def serving_route(guid, blur, sp, gpu: str):
    """The two ways the H-tiled route can serve without a gradient, timed at
    KITTI B=1 and B=8 (T=24, 8sum_clamp) on the same inputs: K4, the round
    in raw mode (one call: the first round normalizes, anchors and writes
    the gates9 the later rounds read), against cspn_gates9 followed by the
    gates9 contract with d^0 anchored on load (K7's entry: two calls). The
    port serves with the first; a `serving_route` line each, and the two
    outputs bit for bit."""
    norm = "8sum_clamp"
    for b in (1, KITTI_BATCH):
        g, d, s = guid[:b], blur[:b], sp[:b]
        raw = lambda: cspn_cuda.cspn_tiled_fwd(   # noqa: E731
            g, d, s, num_iters=24, norm_type=norm)

        def two_calls():
            return cspn_cuda.cspn_prenorm_fwd(
                cspn_cuda.cspn_gates9(g, norm_type=norm), d, s, num_iters=24,
                anchor_d0=True)

        same = bool(torch.equal(raw(), two_calls()))
        emit("serving_route", b=b, h=KITTI_H, w=KITTI_W, t=24, norm=norm,
             raw_round_ms=time_ms(raw, 50),
             raw_round_device_ms=device_profile(raw)["busy_ms"],
             gates9_then_k7_ms=time_ms(two_calls, 50),
             gates9_then_k7_device_ms=device_profile(two_calls)["busy_ms"],
             bitwise_equal=same, gpu=gpu)
        if not same:
            raise AssertionError(f"serving routes differ at B={b}")


def kitti_config(**overrides):
    """kitti_1216 on one device (the mesh the JAX bench clamps it to)."""
    return get_config("kitti_1216").override(**{
        "mesh.data": 1, "mesh.spatial": 1, **overrides})


def phase_kitti_serving(gpu: str) -> tuple[int, float]:
    cfg = kitti_config()
    variables = randomized_variables(cfg)
    predictor = DepthPredictor.from_variables(cfg, variables)
    rgb, sparse = requests(np.random.default_rng(SEED + 5), KITTI_BATCH,
                           KITTI_H, KITTI_W,
                           depth_range=(1.0, KITTI_MAX_DEPTH))
    launches = serve(cfg, predictor, rgb, sparse, gpu,
                     "kitti_serving")["launches"]
    want_launches = {k: 0 for k in launches}
    want_launches["cspn_tiled_fwd"] = SINGLE_REQUESTS + BATCH_REQUESTS
    if launches != want_launches:
        raise AssertionError(f"the KITTI serving path's launches "
                             f"{launches}: expected K4 on every request and "
                             f"nothing else, no plain normalization or "
                             f"anchor")

    # K4 against its plain version on the heads the path computed.
    heads = path_heads(predictor, rgb, sparse)
    sp = torch.from_numpy(sparse).cuda()
    kw = dict(num_iters=cfg.model.num_iters, norm_type=cfg.model.norm_type)
    got = cspn_cuda.cspn_tiled_fwd(heads[:, 1:], heads[:, 0], sp, **kw)
    want = cspn_cuda.cspn_tiled_fwd_plain(heads[:, 1:], heads[:, 0], sp,
                                          **kw)
    heads_err = max_rel(got, want)
    heads_abs = float((got - want).abs().max())
    if not heads_err <= KERNEL_TOL:
        raise AssertionError(f"cspn_tiled_fwd vs plain on the path's heads:"
                             f" max_rel {heads_err} > {KERNEL_TOL}")

    path_err, _ = path_vs_plain(cfg, variables, predictor, rgb, sparse)
    emit("kitti_serving_vs_plain_cspn", batch=KITTI_BATCH,
         heads_kernel_max_rel=heads_err, heads_kernel_max_abs=heads_abs,
         heads_tol=KERNEL_TOL, path_max_rel=path_err, path_tol=PATH_TOL,
         gpu=gpu)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"KITTI serving path with the kernel vs the "
                             f"plain CSPN: max_rel {path_err} > {PATH_TOL}")
    return launches["cspn_tiled_fwd"], heads_abs


def write_kitti_frames(root: Path, rng) -> None:
    """Raw 375x1242 KITTI-like npz records: uint8 rgb (smooth gradients and
    noise) and lidar-like depth, ~5% of pixels with a return in 1..85 m, 0
    elsewhere."""
    h, w = KITTI_RAW
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    for split, n in KITTI_FRAMES.items():
        (root / split).mkdir(parents=True)
        for i in range(n):
            base = np.stack([yy, xx, 0.5 * (yy + xx)], -1) * 200.0
            rgb = np.clip(base + rng.normal(0.0, 20.0, (h, w, 3)), 0, 255)
            depth = 1.0 + (KITTI_MAX_DEPTH - 1.0) * (1.0 - yy) * rng.uniform(
                0.5, 1.0)
            depth = np.where(rng.random((h, w)) < 0.05, depth, 0.0)
            np.savez(root / split / f"{i:06d}.npz",
                     rgb=rgb.astype(np.uint8), depth=depth.astype(np.float32))


def phase_kitti_train(gpu: str) -> dict:
    cfg = kitti_config(**{"data.dataset": "synthetic"})
    variables = randomized_variables(cfg)
    trainer, state, launches, _ = timed_train(
        cfg, variables, KITTI_BATCH,
        ("cspn_tiled_fwd_stash", "cspn_tiled_bwd"), gpu, "kitti_train")
    del state, trainer

    line, heads, sparse = step_vs_plain(cfg, variables, KITTI_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cot = torch.randn(heads[:, 0].shape, generator=gen, device="cuda")
    r = tiled_kernel_errors(heads[:, 1:], heads[:, 0], sparse, cot,
                            cfg.model.num_iters, cfg.model.norm_type)
    emit("kitti_train_vs_plain_cspn", **line, heads_kernels=r, gpu=gpu)
    if not tiled_ok(r):
        raise AssertionError(f"K4/K5/K6 vs plain on the path's heads: {r}")
    del heads

    epoch = phase_kitti_epoch(variables, gpu)
    return dict(launches=launches, eval_launches=epoch["launches"],
                k5_max_abs=r["k5_max_abs"], k6_max_abs=r["k6_max_abs"])


def phase_kitti_epoch(variables, gpu: str) -> dict:
    """train_epoch and evaluate through KITTIDataset on raw frames that
    this run writes: the records' host time against the step time, the
    input pipeline's own batch interval (the iterator drained with no step
    in between: what it can deliver once started), and the augmentation
    executor that ran."""
    with tempfile.TemporaryDirectory(prefix="kitti_smoke_") as root:
        write_kitti_frames(Path(root), np.random.default_rng(SEED + 7))
        cfg = kitti_config(**{"data.root": root})
        trainer = Trainer(cfg)
        state = trainer.init_state(variables)
        executor = native.executor()    # builds the C++ executor, untimed
        t0 = time.perf_counter()
        recs = [trainer.train_ds.get(i, 0) for i in range(KITTI_BATCH)]
        record_ms = 1e3 * (time.perf_counter() - t0) / KITTI_BATCH
        if recs[0]["rgb"].shape != (KITTI_H, KITTI_W, 3):
            raise AssertionError(f"KITTI record {recs[0]['rgb'].shape}")
        it = make_train_iterator(
            trainer.train_ds, global_batch=KITTI_BATCH, epoch=1,
            seed=cfg.train.seed, num_workers=cfg.data.num_workers,
            steps=trainer.steps_per_epoch)
        arrivals = [time.perf_counter()]
        try:
            for _ in it:
                arrivals.append(time.perf_counter())
        finally:
            it.close()
        batch_s = np.diff(arrivals)
        state, metrics = trainer.train_epoch(state, 0, log=lambda *a: None)
        reset_counts()
        ev = trainer.evaluate(state, log=lambda *a: None,
                              save_panels=False)
        launches = counts()
    emit("kitti_epoch", executor=executor,
         train_frames=KITTI_FRAMES["train"], steps=trainer.steps_per_epoch,
         record_ms_one_thread=record_ms, workers=cfg.data.num_workers,
         pipeline_first_batch_s=float(batch_s[0]),
         pipeline_batch_s_median=float(np.median(batch_s[1:])),
         loss=metrics["loss"], step_time_s=metrics["step_time"],
         data_time_s=metrics["data_time"], n_eval=ev["n_images"],
         rmse=ev["rmse"], mae=ev["mae"], delta1=ev["delta1"],
         eval_img_per_s=ev["images_per_sec"], eval_launches=launches,
         gpu=gpu)
    if not (np.isfinite(metrics["loss"]) and launches["cspn_tiled_fwd"] > 0
            and launches["cspn_fwd"] == 0 and launches["prenorm_gates9"] ==
            launches["anchor"] == 0 and all(
                np.isfinite(ev[k]) for k in ("rmse", "mae", "rel",
                                             "delta1"))):
        raise AssertionError(f"KITTI epoch: {metrics['loss']} {ev} "
                             f"{launches}")
    return dict(launches=launches)


def slab_problem(gen, b, h, w, r, sparse=True, edge=None,
                 anchor_d0=False):
    """A rank's halo'd slab: prenormalized gates of N(0, 1) guidance, an
    anchored d^0 (the blur as it is with anchor_d0, for the kernels to
    anchor on load), ~1% anchors and a cotangent, on the card. edge "first"
    or "last" zeroes the outer HALO_K rows, as the exchange leaves them on
    the first and last shard."""
    guid, blur, sp = cspn_problem(gen, b, h, w, sparse=sparse)
    gates9 = prenorm_gates9(guid, "8sum_clamp")
    d0 = blur if anchor_d0 else anchor(blur, sp)
    if edge is not None:
        rows = slice(0, HALO_K) if edge == "first" else slice(h - HALO_K, h)
        for t in (gates9[:, :, rows], d0[:, rows]) + (
                () if sp is None else (sp[:, rows],)):
            t.zero_()
    cot = torch.randn((b, h, w), generator=gen, device="cuda")
    kw = dict(num_iters=r, anchor_d0=True) if anchor_d0 else dict(
        num_iters=r)
    return gates9, d0, sp, cot, kw


def slab_kernel_errors(gates9, d0, sp, cot, kw) -> dict:
    """K7, K8 and K9 against their plain versions: the largest max-relative
    error of each output (every stash plane on its own), their largest
    absolute errors, and whether K8's output is K7's bit for bit."""
    k7 = cspn_cuda.cspn_prenorm_fwd(gates9, d0, sp, **kw)
    out, stash = cspn_cuda.cspn_prenorm_fwd_stash(gates9, d0, sp, **kw)
    grads = cspn_cuda.cspn_prenorm_bwd(gates9, sp, stash, cot, **kw)
    want_out, want_stash = cspn_cuda.cspn_prenorm_fwd_stash_plain(
        gates9, d0, sp, **kw)
    want_grads = cspn_cuda.cspn_prenorm_bwd_plain(gates9, sp, want_stash, cot,
                                                  **kw)
    torch.cuda.synchronize()
    errs = {"k7_out": max_rel(k7, want_out),
            "k8_stash": max(max_rel_or_zero(stash[:, t], want_stash[:, t])
                            for t in range(stash.shape[1]))}
    for name, got, want in zip(("d_gates9", "lam0", "d_sparse"), grads,
                               want_grads):
        errs[name] = max_rel_or_zero(got, want)
    return dict(max_rel=errs, k8_equals_k7=bool(torch.equal(out, k7)),
                k7_max_abs=float((k7 - want_out).abs().max()),
                k8_max_abs=float((stash - want_stash).abs().max()),
                k9_max_abs=max(float((g - w).abs().max())
                               for g, w in zip(grads, want_grads)))


def phase_spatial_kernels(gpu: str) -> dict:
    """K7, K8 and K9 against their plain versions on the deployed slabs and
    at edge cases; times at both deployed slabs. Returns the KITTI slab's
    times and errors for the kernel table."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cases = [dict(slab=KITTI_SLAB, r=HALO_K), dict(slab=NYU_SLAB, r=HALO_K),
             dict(slab=KITTI_SLAB, r=2), dict(slab=KITTI_SLAB, r=3,
                                              sparse=False),
             dict(slab=(1,) + KITTI_SLAB[1:], r=HALO_K),
             dict(slab=KITTI_SLAB, r=HALO_K, edge="first"),
             dict(slab=KITTI_SLAB, r=HALO_K, edge="last"),
             # W % 4 != 0.
             dict(slab=(2, 20, 75), r=HALO_K),
             # d^0 anchored on load: the slab route's first round.
             dict(slab=KITTI_SLAB, r=HALO_K, anchor_d0=True),
             dict(slab=KITTI_SLAB, r=3, sparse=False, anchor_d0=True),
             dict(slab=KITTI_SLAB, r=HALO_K, edge="first", anchor_d0=True),
             dict(slab=(2, 20, 75), r=2, anchor_d0=True)]
    max_abs = {}
    for c in cases:
        *args, kw = slab_problem(gen, *c["slab"], c["r"],
                                 sparse=c.get("sparse", True),
                                 edge=c.get("edge"),
                                 anchor_d0=c.get("anchor_d0", False))
        r = slab_kernel_errors(*args, kw)
        emit("spatial_kernel_case", kernels=["cspn_prenorm_fwd",
                                             "cspn_prenorm_fwd_stash",
                                             "cspn_prenorm_bwd"],
             **c, **r, tol=KERNEL_TOL)
        if not (max(r["max_rel"].values()) <= KERNEL_TOL
                and r["k8_equals_k7"]):
            raise AssertionError(f"K7/K8/K9 disagree with their plain "
                                 f"versions: {c} {r}")
        if (c["slab"] == KITTI_SLAB and c["r"] == HALO_K
                and "edge" not in c and "anchor_d0" not in c):
            max_abs = r

    timing = {}
    for name, slab in (("kitti_2x4", KITTI_SLAB), ("nyu_16x2", NYU_SLAB)):
        gates9, d0, sp, cot, kw = slab_problem(gen, *slab, HALO_K)
        b, h, w = slab
        _, stash = cspn_cuda.cspn_prenorm_fwd_stash(gates9, d0, sp, **kw)
        _, plain_stash = cspn_cuda.cspn_prenorm_fwd_stash_plain(gates9, d0,
                                                                sp, **kw)
        for kernel, fn, plain, bound in (
                ("cspn_prenorm_fwd",
                 lambda: cspn_cuda.cspn_prenorm_fwd(gates9, d0, sp, **kw),
                 lambda: cspn_cuda.cspn_prenorm_fwd_plain(gates9, d0, sp,
                                                          **kw),
                 prenorm_fwd_bound_ms(b, h, w, HALO_K, True)),
                ("cspn_prenorm_fwd_stash",
                 lambda: cspn_cuda.cspn_prenorm_fwd_stash(gates9, d0, sp,
                                                          **kw),
                 lambda: cspn_cuda.cspn_prenorm_fwd_stash_plain(gates9, d0,
                                                                sp, **kw),
                 prenorm_stash_bound_ms(b, h, w, HALO_K, True)),
                ("cspn_prenorm_bwd",
                 lambda: cspn_cuda.cspn_prenorm_bwd(gates9, sp, stash, cot,
                                                    **kw),
                 lambda: cspn_cuda.cspn_prenorm_bwd_plain(
                     gates9, sp, plain_stash, cot, **kw),
                 prenorm_bwd_bound_ms(b, h, w, HALO_K, True))):
            ms = time_ms(fn, 50)
            plain_ms = time_ms(plain, 10)
            device_ms = device_profile(fn)["busy_ms"]
            emit("kernel_time", kernel=kernel, slab=name, b=b, h=h, w=w,
                 t=HALO_K, norm="8sum_clamp", ms=ms, device_ms=device_ms,
                 plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                 library_ms=None, gpu=gpu)
            if name == "kitti_2x4":
                timing[kernel] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound[0], bound_by=bound[1])
        # K9's stages on the slab.
        shape = dict(slab=name, b=b, h=h, w=w, t=HALO_K, norm="8sum_clamp")
        check_adjoint_stages(shape, gates9, sp, stash, cot)
        time_adjoint_stages(gpu, "cspn_prenorm_bwd", shape, gates9, sp,
                            stash, cot)
    gates9 = gates9_pair(gen, gpu)
    return dict(timing=timing, max_abs=max_abs, gates9=gates9)


def gates9_pair_errors(guid, d_gates9, norm: str) -> dict:
    """cspn_gates9 and cspn_gates9_bwd against their plain versions
    (prenorm_gates9 and torch autograd of it) on the same inputs."""
    got = cspn_cuda.cspn_gates9(guid, norm_type=norm)
    want = prenorm_gates9(guid, norm)
    got_grad = cspn_cuda.cspn_gates9_bwd(guid, d_gates9, norm_type=norm)
    want_grad = prenorm_gates9_bwd_plain(guid, d_gates9, norm)
    torch.cuda.synchronize()
    return dict(max_rel={"gates9": max_rel(got, want),
                         "d_guid": max_rel_or_zero(got_grad, want_grad)},
                gates9_max_abs=float((got - want).abs().max()),
                gates9_bwd_max_abs=float((got_grad - want_grad).abs().max()),
                d_guid_finite=bool(torch.isfinite(got_grad).all()))


def gates9_pair(gen, gpu: str) -> dict:
    """The normalization's kernel pair (the slab route's Gates9Function)
    against its plain versions at KITTI's 352x1216 (B=2 in the three norms,
    B=8, the head's strided guidance slices), on the KITTI 2x4 slab and at
    zero guidance (sign(0) = 0 under 8sum_abs: a zero gradient), then timed
    at KITTI B=8 beside their plain versions and bounds. Returns the
    kernels line's numbers."""
    cases = [dict(b=2, h=KITTI_H, w=KITTI_W, norm=n) for n in NORM_TYPES]
    cases += [dict(b=KITTI_BATCH, h=KITTI_H, w=KITTI_W, norm="8sum_clamp"),
              dict(b=2, h=KITTI_H, w=KITTI_W, norm="8sum", strided=True)]
    cases += [dict(b=KITTI_SLAB[0], h=KITTI_SLAB[1], w=KITTI_SLAB[2],
                   norm=n) for n in NORM_TYPES]
    cases += [dict(b=1, h=KITTI_H, w=KITTI_W, norm=n, zero=True)
              for n in NORM_TYPES]
    cases += [dict(b=KITTI_SLAB[0], h=KITTI_SLAB[1], w=KITTI_SLAB[2],
                   norm="8sum_abs", zero=True)]
    max_abs = {}
    for c in cases:
        guid, _, _ = cspn_problem(gen, c["b"], c["h"], c["w"], sparse=False,
                                  strided=c.get("strided", False))
        if c.get("zero"):
            guid = torch.zeros_like(guid)
        d_gates9 = torch.randn((c["b"], 9, c["h"], c["w"]), generator=gen,
                               device="cuda")
        r = gates9_pair_errors(guid, d_gates9, c["norm"])
        emit("gates9_case", kernels=["cspn_gates9", "cspn_gates9_bwd"], **c,
             **r, tol=KERNEL_TOL)
        if not (max(r["max_rel"].values()) <= KERNEL_TOL
                and r["d_guid_finite"]):
            raise AssertionError(f"cspn_gates9/cspn_gates9_bwd disagree with "
                                 f"their plain versions: {c} {r}")
        if c["b"] == KITTI_BATCH and c["h"] == KITTI_H:
            max_abs = r

    b, norm = KITTI_BATCH, "8sum_clamp"
    guid, _, _ = cspn_problem(gen, b, KITTI_H, KITTI_W, sparse=False,
                              strided=True)
    d_gates9 = torch.randn((b, 9, KITTI_H, KITTI_W), generator=gen,
                           device="cuda")
    timing = {}
    for name, fn, plain, bound in (
            ("cspn_gates9",
             lambda: cspn_cuda.cspn_gates9(guid, norm_type=norm),
             lambda: prenorm_gates9(guid, norm),
             gates9_bound_ms(b, KITTI_H, KITTI_W)),
            ("cspn_gates9_bwd",
             lambda: cspn_cuda.cspn_gates9_bwd(guid, d_gates9,
                                               norm_type=norm),
             lambda: prenorm_gates9_bwd_plain(guid, d_gates9, norm),
             gates9_bwd_bound_ms(b, KITTI_H, KITTI_W))):
        ms = time_ms(fn, 50)
        plain_ms = time_ms(plain, 10)
        device_ms = device_profile(fn)["busy_ms"]
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1])
        emit("kernel_time", kernel=name, b=b, h=KITTI_H, w=KITTI_W,
             norm=norm, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
             bound_ms=bound[0], bound_by=bound[1], library_ms=None, gpu=gpu)
    return dict(timing=timing, max_abs=max_abs)


def forward_calls(gen) -> list:
    """Every forward entry (K1, K2, K4, K5, K7, K8) at each shape this script
    times it, T=24 (one round of HALO_K on the slabs), and K1 and K4 at T=0
    and T=4 besides: (kernel, shape, call) each."""
    calls = []
    for b in (1, TRAIN_BATCH):
        guid, blur, sp = cspn_problem(gen, b, NYU_H, NYU_W)
        for t in SPLIT_ITERS:
            calls.append(("cspn_fwd", dict(b=b, h=NYU_H, w=NYU_W, t=t),
                          lambda g=guid, d=blur, s=sp, t=t: cspn_cuda.cspn_fwd(
                              g, d, s, num_iters=t, norm_type="8sum_clamp")))
    calls.append(("cspn_fwd_stash",
                  dict(b=TRAIN_BATCH, h=NYU_H, w=NYU_W, t=24),
                  lambda g=guid, d=blur, s=sp: cspn_cuda.cspn_fwd_stash(
                      g, d, s, num_iters=24, norm_type="8sum_clamp")))
    del guid, blur, sp
    guid, blur, sp = cspn_problem(gen, KITTI_BATCH, KITTI_H, KITTI_W,
                                  strided=True)
    calls.append(("cspn_fwd", dict(b=KITTI_BATCH, h=KITTI_H, w=KITTI_W, t=24),
                  lambda g=guid, d=blur, s=sp: cspn_cuda.cspn_fwd(
                      g, d, s, num_iters=24, norm_type="8sum_clamp")))
    for b in (1, KITTI_BATCH):
        g, d, s = guid[:b], blur[:b], sp[:b]
        for t in SPLIT_ITERS:
            calls.append(("cspn_tiled_fwd", dict(b=b, h=KITTI_H, w=KITTI_W,
                                                 t=t),
                          lambda g=g, d=d, s=s, t=t: cspn_cuda.cspn_tiled_fwd(
                              g, d, s, num_iters=t, norm_type="8sum_clamp")))
    calls.append(("cspn_tiled_fwd_stash",
                  dict(b=KITTI_BATCH, h=KITTI_H, w=KITTI_W, t=24),
                  lambda: cspn_cuda.cspn_tiled_fwd_stash(
                      guid, blur, sp, num_iters=24, norm_type="8sum_clamp")))
    for name, slab in (("kitti_2x4", KITTI_SLAB), ("nyu_16x2", NYU_SLAB)):
        g, d, s, _, kw = slab_problem(gen, *slab, HALO_K)
        shape = dict(slab=name, b=slab[0], h=slab[1], w=slab[2], t=HALO_K)
        calls.append(("cspn_prenorm_fwd", shape,
                      lambda g=g, d=d, s=s, kw=kw: cspn_cuda.cspn_prenorm_fwd(
                          g, d, s, **kw)))
        calls.append(("cspn_prenorm_fwd_stash", shape,
                      lambda g=g, d=d, s=s, kw=kw:
                      cspn_cuda.cspn_prenorm_fwd_stash(g, d, s, **kw)))
    return calls


# Each stash entry beside the entry it adds the stash to, at the shapes
# forward_calls times both: (stash entry, plain entry, b, h, w, t).
STASH_SPLITS = (
    ("cspn_fwd_stash", "cspn_fwd", TRAIN_BATCH, NYU_H, NYU_W, 24),
    ("cspn_tiled_fwd_stash", "cspn_tiled_fwd", KITTI_BATCH, KITTI_H, KITTI_W,
     24),
    ("cspn_prenorm_fwd_stash", "cspn_prenorm_fwd", *KITTI_SLAB, HALO_K),
    ("cspn_prenorm_fwd_stash", "cspn_prenorm_fwd", *NYU_SLAB, HALO_K))


def forward_times(gpu: str) -> dict:
    """Each of forward_calls timed: CUDA-event ms over 50 calls and
    torch.profiler's device ms of one, a `forward_time` line each; then a
    `round_split` line for K1 and K4 at B=1 and at the batch shape. T=0
    runs one round with no iteration (its time is the load, normalize and
    store phase alone), T=4 one round of 4 iterations, T=24 every round:
    the line models T=24 as rounds x T=0 plus 24 iterations at (T=4 -
    T=0)/4 each. Then a `stash_split` line per stash entry: what the stash
    adds to the plain entry's time, beside the stash's bytes at the card's
    memory rate. Returns the lines' times by (kernel, b, h, t)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    times = {}
    for kernel, shape, fn in forward_calls(gen):
        ms = time_ms(fn, 50)
        device_ms = device_profile(fn)["busy_ms"]
        times[(kernel, shape["b"], shape["h"], shape["t"])] = (ms, device_ms)
        emit("forward_time", kernel=kernel, **shape, ms=ms,
             device_ms=device_ms, gpu=gpu)
    for kernel, (h, w), batches in (
            ("cspn_fwd", (NYU_H, NYU_W), (1, TRAIN_BATCH)),
            ("cspn_tiled_fwd", (KITTI_H, KITTI_W), (1, KITTI_BATCH))):
        for b in batches:
            ms = {t: times[(kernel, b, h, t)][0] for t in SPLIT_ITERS}
            dev = {t: times[(kernel, b, h, t)][1] for t in SPLIT_ITERS}
            rounds = cspn_cuda.rounds(cspn_cuda.pick_geometry(b, h, w, 24),
                                      24)
            per_iter = (ms[4] - ms[0]) / 4
            model = rounds * ms[0] + 24 * per_iter
            emit("round_split", kernel=kernel, b=b, h=h, w=w,
                 ms=ms, device_ms=dev, rounds_at_t24=rounds,
                 load_phase_ms=ms[0], iteration_ms=per_iter,
                 t24_model_ms=model, t24_minus_model_ms=ms[24] - model,
                 gpu=gpu)
    for kernel, plain, b, h, w, t in STASH_SPLITS:
        stash_bytes = 4 * b * t * h * w
        base_ms, base_device_ms = times[(plain, b, h, t)]
        ms, device_ms = times[(kernel, b, h, t)]
        added = (ms - base_ms, device_ms - base_device_ms)
        emit("stash_split", kernel=kernel, minus=plain, b=b, h=h, w=w, t=t,
             plan_geometry=cspn_cuda.fwd_plan(b, h, w, t), ms=ms,
             device_ms=device_ms, plain_ms=base_ms,
             plain_device_ms=base_device_ms, minus_plain_ms=added[0],
             minus_plain_device_ms=added[1], stash_bytes=stash_bytes,
             stash_bytes_ms=1e3 * stash_bytes / HBM_BYTES_PER_S,
             stash_tb_per_s=stash_bytes / added[0] / 1e9
             if added[0] > 0 else None,
             stash_tb_per_s_device=stash_bytes / added[1] / 1e9
             if added[1] > 0 else None, gpu=gpu)
    return times


def geometry_registers(entries: list[dict], geometry: int) -> dict:
    """ptxas's registers and spill bytes (stores + loads) of each variant
    of one geometry's round kernel, by source (0 raw guidance, 1 raw while
    writing gates9, 2 gates9) and stash."""
    tag = "GeometryILi{}ELi{}ELi{}ELi{}EE".format(
        *cspn_cuda.FWD_GEOMETRIES[geometry])
    out = {}
    for e in entries:
        m = re.search(r"cspn_fwd_roundILi(\d)ELb(\d)E", e["entry"])
        if m and tag in e["entry"]:
            out[f"src{m[1]}_stash{m[2]}"] = [
                e.get("registers"),
                e.get("spill_stores", 0) + e.get("spill_loads", 0)]
    return out


def geometry_point(kernel, fn, b, h, w, t, geometry, entries, gpu,
                   **extra) -> dict:
    """Time fn() at one geometry (CUDA-event ms over 30 calls,
    torch.profiler's device ms of one) and describe the point."""
    tile, halo, run, minb = cspn_cuda.FWD_GEOMETRIES[geometry]
    slab = tile + 2 * halo
    point = dict(kernel=kernel, b=b, h=h, w=w, t=t, geometry=geometry,
                 tile=tile, halo=halo, run=run, minb=minb,
                 threads=slab * (slab // run),
                 blocks_per_launch=-(-h // tile) * -(-w // tile) * b,
                 launches=cspn_cuda.rounds(geometry, t), **extra,
                 ms=time_ms(fn, 30), device_ms=device_profile(fn)["busy_ms"])
    emit("geometry", **point, registers=geometry_registers(entries, geometry),
         gpu=gpu)
    return point


def phase_geometry_sweep(gpu: str) -> dict:
    """K1 (NYU 228x304) and K4 (KITTI 352x1216), T=24, 8sum_clamp, at B=1
    and at the batch shape, then K7 on both deployed slabs (T=4), over
    every tile geometry: a `geometry` line per point (CUDA-event ms over
    30 calls, torch.profiler's device ms of one, the geometry's registers
    and spills); every point's output must equal the first point's bit for
    bit. Then K2 and K5 at the batch shape over every geometry: each
    output must equal K1's (K4's) and each stash the first point's, bit
    for bit. A `geometry_best` line per shape with the
    fastest point and the wrappers' own choice."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    entries = parse_ptxas(cspn_cuda.build_log.get("cspn_fwd", ""))
    guid, blur, sp = cspn_problem(gen, TRAIN_BATCH, NYU_H, NYU_W)
    kg, kb, ks = cspn_problem(gen, KITTI_BATCH, KITTI_H, KITTI_W)
    raw = dict(num_iters=24, norm_type="8sum_clamp")

    def k1(b, geometry):
        return cspn_cuda.cspn_fwd(guid[:b], blur[:b], sp[:b], **raw,
                                  geometry=geometry)

    def k2(b, geometry):
        return cspn_cuda.cspn_fwd_stash(guid[:b], blur[:b], sp[:b], **raw,
                                        geometry=geometry)

    def k4(b, geometry):
        return cspn_cuda.cspn_tiled_fwd(kg[:b], kb[:b], ks[:b], **raw,
                                        geometry=geometry)

    def k5(b, geometry):
        return cspn_cuda.cspn_tiled_fwd_stash(kg[:b], kb[:b], ks[:b], **raw,
                                              geometry=geometry)

    slabs = {name: slab_problem(gen, *slab, HALO_K)[:3]
             for name, slab in (("kitti_2x4", KITTI_SLAB),
                                ("nyu_16x2", NYU_SLAB))}

    def k7(name):
        def fn(b, geometry):
            return cspn_cuda.cspn_prenorm_fwd(*slabs[name], num_iters=HALO_K,
                                              geometry=geometry)
        return fn

    best, wants = {}, {}
    for kernel, fn, (h, w), batches, t in (
            ("cspn_fwd", k1, (NYU_H, NYU_W), (1, TRAIN_BATCH), 24),
            ("cspn_tiled_fwd", k4, (KITTI_H, KITTI_W), (1, KITTI_BATCH),
             24),
            ("cspn_prenorm_fwd", k7("kitti_2x4"), KITTI_SLAB[1:],
             (KITTI_SLAB[0],), HALO_K),
            ("cspn_prenorm_fwd", k7("nyu_16x2"), NYU_SLAB[1:],
             (NYU_SLAB[0],), HALO_K)):
        for b in batches:
            want, points = None, []
            for geometry in range(len(cspn_cuda.FWD_GEOMETRIES)):
                out = fn(b, geometry)
                want = out if want is None else want
                if not torch.equal(out, want):
                    raise AssertionError(f"{kernel} at geometry {geometry} "
                                         f"differs from geometry 0")
                points.append(geometry_point(
                    kernel, lambda: fn(b, geometry), b, h, w, t, geometry,
                    entries, gpu, bitwise_equal=True))
            wants[(kernel, b)] = want
            own = points[cspn_cuda.fwd_plan(b, h, w, t)]
            best[(kernel, b)] = own
            emit("geometry_best", kernel=kernel, b=b,
                 fastest=min(points, key=lambda p: p["ms"]), own_plan=own,
                 gpu=gpu)

    for kernel, fn, plain_entry, (h, w), b in (
            ("cspn_fwd_stash", k2, "cspn_fwd", (NYU_H, NYU_W), TRAIN_BATCH),
            ("cspn_tiled_fwd_stash", k5, "cspn_tiled_fwd", (KITTI_H, KITTI_W),
             KITTI_BATCH)):
        want, first, points = wants[(plain_entry, b)], None, []
        for geometry in range(len(cspn_cuda.FWD_GEOMETRIES)):
            out, stash = fn(b, geometry)
            first = stash if first is None else first
            same = (bool(torch.equal(out, want)),
                    bool(torch.equal(stash, first)))
            del out, stash
            if not all(same):
                raise AssertionError(
                    f"{kernel} at geometry {geometry}: output equals "
                    f"{plain_entry}'s {same[0]}, stash equals the first "
                    f"point's {same[1]}")
            points.append(geometry_point(
                kernel, lambda: fn(b, geometry), b, h, w, 24, geometry,
                entries, gpu, equals_plain_entry=True,
                stash_equals_first=True))
        del first
        own = points[cspn_cuda.fwd_plan(b, h, w, 24)]
        best[(kernel, b)] = own
        emit("geometry_best", kernel=kernel, b=b,
             fastest=min(points, key=lambda p: p["ms"]), own_plan=own,
             gpu=gpu)
    return best


def spatial_op_rank(rank: int) -> dict:
    """One rank of a 1x4 spatial group on cuda:0: this rank's rows of 4
    images of 352x1216 through cspn_propagate_spatial, without a gradient
    (cspn_gates9, K7) and with one (cspn_gates9, K8; K9, cspn_gates9_bwd),
    against the whole-image tiled route (K4-K6) on all the rows; returns
    the largest errors of its rows, the largest values of the reference,
    the launch and exchange counts."""
    torch.cuda.set_device(0)
    mesh = make_mesh(MeshConfig(data=1, spatial=4), device="cuda:0")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    guid, blur, sp = cspn_problem(gen, 4, KITTI_H, KITTI_W)
    cot = torch.randn(blur.shape, generator=gen, device="cuda")
    h = KITTI_H // 4
    rows = slice(rank * h, (rank + 1) * h)
    kw = dict(num_iters=24, norm_type="8sum_clamp", halo_k=HALO_K)
    mine = [x[..., rows, :].contiguous() for x in (guid, blur, sp)]

    reset_counts()
    exchange_halo.calls = 0
    with torch.no_grad():
        fwd = cspn_propagate_spatial(*mine, mesh=mesh, **kw)
    inputs = [x.clone().requires_grad_() for x in mine]
    out = cspn_propagate_spatial(*inputs, mesh=mesh, **kw)
    grads = torch.autograd.grad((out * cot[:, rows]).sum(), inputs)
    torch.cuda.synchronize()
    launches, exchanges = counts(), exchange_halo.calls

    whole = [x.clone().requires_grad_() for x in (guid, blur, sp)]
    want = cspn_propagate(whole[0], whole[1], whole[2], num_iters=24,
                          norm_type="8sum_clamp", impl="cuda_tiled",
                          guidance_layout="NCHW")
    want_grads = torch.autograd.grad((want * cot).sum(), whole)
    want = want.detach()
    mine_want = [want[:, rows]] + [g[..., rows, :] for g in want_grads]
    got = [fwd, out.detach()] + list(grads)
    errs = [float((a - b).abs().max()) for a, b in zip(
        got, [mine_want[0]] + mine_want)]
    scale = [float(x.abs().max()) for x in [want, want] + list(want_grads)]
    return dict(errs=errs, scale=scale, launches=launches,
                exchanges=exchanges)


def mesh_config(**overrides):
    """kitti_1216 at its own 2x4 mesh on synthetic records, full width."""
    return get_config("kitti_1216").override(**{"data.dataset": "synthetic",
                                                **overrides})


def param_digest(model) -> str:
    """A digest of every parameter and BN statistic, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def f32_step(cfg, variables, batch, layout: str = "auto", *,
             cudnn: bool = True, bn_sums: bool = False) -> dict:
    """One float32 train step (TF32 off, cuDNN deterministic, no clip) from
    `variables` on `batch` with the Trainer's own sparse samples, in
    `layout` on a mesh: the loss, the head's gradients and the samples'
    sum and count. `cudnn` False runs it with cuDNN off (PyTorch's own
    CUDA convolutions and BatchNorm); `bn_sums` (one process only) takes
    BatchNorm's train statistics from the per-channel sums as a mesh does
    (flax's fast variance) instead of torch's batch_norm kernel."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.enabled = cudnn
    if bn_sums:
        resnet.all_reduce = lambda t, group: t
    try:
        trainer = Trainer(cfg.override(**{"model.dtype": "float32",
                                          "train.clip_norm": 0.0}),
                          device="cuda:0", layout=layout)
        state = trainer.init_state(variables)
        if bn_sums:
            for m in state.model.modules():
                if isinstance(m, resnet.BatchNorm2d):
                    m.group = "one process"
        drawn = trainer._sample_sparse(trainer._rng(0, state.step),
                                       trainer._unpack(batch)["depth"], None)
        state, loss, _ = trainer.train_step(state, batch)
        return dict(loss=float(loss),
                    weight=state.model.head.weight.grad.cpu().numpy(),
                    bias=state.model.head.bias.grad.cpu().numpy(),
                    sparse_sum=float(drawn.double().sum()),
                    sparse_count=int((drawn > 0).sum()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.enabled = True
        resnet.all_reduce = comm.all_reduce


# The 2x4 runs of phase 10, each on the same 8 ranks: (name, global batch,
# layout). "auto" takes images at batch 8 (one image a rank) and rows at
# batch 2 (one image a data group, 88 of its 352 rows a rank).
MESH_RUNS = (("images_b8", KITTI_BATCH, "auto"), ("rows_b2", 2, "auto"),
             ("rows_b8", KITTI_BATCH, "rows"))
# The run whose f32 step is also taken apart (`mesh_gap` line): with cuDNN
# off on both sides, and with the 1x1 BatchNorm on the mesh's sums.
GAP_RUN = "images_b8"


def mesh_run(rank: int, batch_np: dict, batch_size: int, layout: str,
             gap_probe: bool = False) -> dict:
    """One rank of the kitti_1216 2x4 Trainer on cuda:0 at `batch_size`
    (the first images of batch_np) in `layout`: the f32 step against which
    the 1x1 step is held (with `gap_probe` also with cuDNN off), then one
    warm-up and SPATIAL_STEPS timed bf16 steps with the launch and
    exchange counts set to 0 just before and read just after, one eval
    step (K7) the same way, peak memory and a digest of the parameters."""
    cfg = mesh_config(**{"train.batch_size": batch_size})
    variables = randomized_variables(cfg)
    trainer = Trainer(cfg, device="cuda:0", layout=layout)
    index, count = trainer._share()
    b = batch_size // count
    mine = {k: torch.from_numpy(v[index * b:(index + 1) * b]).cuda()
            for k, v in batch_np.items()}
    ref = f32_step(cfg, variables, mine, trainer.layout)
    torch.cuda.empty_cache()
    ref_no_cudnn = None
    if gap_probe:
        # PyTorch's own convolutions unfold their inputs: 8 ranks on one
        # card hold room for them only with nothing else cached.
        ref_no_cudnn = f32_step(cfg, variables, mine, trainer.layout,
                                cudnn=False)
        torch.cuda.empty_cache()

    state = trainer.init_state(variables)
    state, loss, _ = trainer.train_step(state, mine)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    exchange_halo.calls = 0
    comm.reset_counts()
    step_ms, losses = [], [float(loss)]
    for _ in range(SPATIAL_STEPS):
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, mine)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    train_launches, train_exchanges = counts(), exchange_halo.calls
    per_step = {k: v / SPATIAL_STEPS for k, v in comm.COUNTS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    reset_counts()
    eval_batch = dict(mine, valid_image=torch.ones(b, device="cuda:0"))
    t0 = time.perf_counter()
    sums, pred = trainer.eval_step(state, eval_batch, 0)
    rmse = float(sums.rmse / sums.n_images)
    eval_ms = 1e3 * (time.perf_counter() - t0)
    eval_launches = counts()
    return dict(ref=ref, ref_no_cudnn=ref_no_cudnn, losses=losses,
                step_ms=step_ms,
                launches=train_launches, exchanges=train_exchanges,
                comm_per_step=per_step, layout=trainer.layout,
                eval_launches=eval_launches, eval_ms=eval_ms,
                eval_n_images=float(sums.n_images), eval_rmse=rmse,
                pred_finite=bool(torch.isfinite(pred).all()),
                pred_shape=list(pred.shape), peak_gb=peak_gb,
                digest=param_digest(state.model), spatial_index=trainer.mesh.s,
                trainer_mesh=[trainer.mesh.data, trainer.mesh.spatial])


def mesh_rank(rank: int, batch_np: dict, gap_probe: bool = False) -> dict:
    """One rank's MESH_RUNS, in order."""
    torch.cuda.set_device(0)
    out = {}
    for name, batch_size, layout in MESH_RUNS:
        out[name] = mesh_run(rank, batch_np, batch_size, layout,
                             gap_probe=gap_probe and name == GAP_RUN)
        torch.cuda.empty_cache()
    return out


def step_gap(got: dict, want: dict) -> dict:
    """One f32 step's loss and head gradients against another's."""
    return dict(
        loss_rel=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        head_grad_max_rel={n: float(np.abs(got[n] - want[n]).max()
                                    / np.abs(want[n]).max())
                           for n in ("weight", "bias")})


def mesh_vs_single(runs: list[dict], single: dict, key: str = "ref"
                   ) -> dict:
    """A mesh run's f32 step (rank 0's loss and head gradients, every
    data group's samples once) against the 1x1 step at the same batch."""
    ref = runs[0][key]
    once = [r[key] for r in runs
            if r["layout"] == "images" or r["spatial_index"] == 0]
    return dict(
        loss_mesh=ref["loss"], loss_1x1=single["loss"],
        **step_gap(ref, single),
        sparse_samples_equal=(
            sum(r["sparse_count"] for r in once) == single["sparse_count"]
            and abs(sum(r["sparse_sum"] for r in once)
                    - single["sparse_sum"]) <= 1e-9 * single["sparse_sum"]),
        tol=MESH_STEP_TOL)


def mesh_run_ok(runs: list[dict], vs: dict, batch_size: int,
                rounds: int) -> bool:
    """Within MESH_STEP_TOL of the 1x1 step; K8 and K9 once a round and
    cspn_gates9 and cspn_gates9_bwd once in each timed step, K7 once a
    round and cspn_gates9 once in the eval step, nothing else (no plain
    normalization or anchor); every rank's parameters bit for bit the same;
    finite outputs."""
    want_train = {k: (SPATIAL_STEPS * rounds
                      if k in ("cspn_prenorm_fwd_stash", "cspn_prenorm_bwd")
                      else 0) for k in runs[0]["launches"]}
    want_train.update(cspn_gates9=SPATIAL_STEPS,
                      cspn_gates9_bwd=SPATIAL_STEPS)
    want_eval = {k: rounds if k == "cspn_prenorm_fwd" else 0
                 for k in runs[0]["eval_launches"]}
    want_eval.update(cspn_gates9=1)
    return (vs["loss_rel"] <= MESH_STEP_TOL
            and max(vs["head_grad_max_rel"].values()) <= MESH_STEP_TOL
            and vs["sparse_samples_equal"]
            and all(r["launches"] == want_train for r in runs)
            and all(r["eval_launches"] == want_eval for r in runs)
            and len({r["digest"] for r in runs}) == 1
            and runs[0]["eval_n_images"] == batch_size
            and all(r["pred_finite"] for r in runs)
            and all(np.isfinite(r["losses"]).all() for r in runs))


def gap_singles(cfg, variables, batch_np: dict) -> dict:
    """The 1x1 f32 step of GAP_RUN's batch with cuDNN off, with BatchNorm
    on the mesh's sums, and with both."""
    gap_cfg = cfg.override(**{"mesh.data": 1, "mesh.spatial": 1,
                              "train.batch_size": KITTI_BATCH})
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    return {"no_cudnn": f32_step(gap_cfg, variables, batch, cudnn=False),
            "bn_sums": f32_step(gap_cfg, variables, batch, bn_sums=True),
            "no_cudnn_bn_sums": f32_step(gap_cfg, variables, batch,
                                         cudnn=False, bn_sums=True)}


def emit_mesh_gap(gap: list[dict], one: dict, singles: dict, vs: dict,
                  config: str, gpu: str):
    """The `mesh_gap` line: GAP_RUN's f32 step on the mesh against the 1x1
    step, with cuDNN off on both sides, with the 1x1 BatchNorm on the
    mesh's sums, and each change alone on one side."""
    emit("mesh_gap", run=GAP_RUN, config=config, batch=KITTI_BATCH,
         mesh_vs_1x1=vs,
         no_cudnn_mesh_vs_1x1=mesh_vs_single(gap, singles["no_cudnn"],
                                             "ref_no_cudnn"),
         no_cudnn_mesh_vs_1x1_bn_sums=mesh_vs_single(
             gap, singles["no_cudnn_bn_sums"], "ref_no_cudnn"),
         mesh_vs_1x1_bn_sums=mesh_vs_single(gap, singles["bn_sums"]),
         one_x_one_cudnn_vs_no_cudnn=step_gap(one, singles["no_cudnn"]),
         one_x_one_bn_vs_bn_sums=step_gap(one, singles["bn_sums"]),
         mesh_cudnn_vs_no_cudnn=step_gap(gap[0]["ref"],
                                         gap[0]["ref_no_cudnn"]),
         gpu=gpu)


@contextlib.contextmanager
def expandable_segments():
    """Processes started inside take the allocator's segments that grow in
    place (their f32 steps with cuDNN off unfold the convolutions' inputs,
    and 8 ranks on one card have room for them only so)."""
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev


def phase_spatial(gpu: str, gap_probe: bool = False) -> dict:
    """(a) the sharded CSPN op on 4 ranks against K4-K6; (b) the kitti_1216
    2x4 Trainer on 8 ranks against the 1x1 Trainer. Every rank is a
    process on cuda:0 over gloo. With `gap_probe`, the f32 step of
    GAP_RUN is also taken apart (`mesh_gap` line, ROADMAP.md section 3):
    `python3 -c "import chip_smoke as c; g = c.phase_toolchain();
    c.phase_build(); c.phase_spatial(g, gap_probe=True)"`."""
    t0 = time.perf_counter()
    op = spawn_ranks(spatial_op_rank, 4, timeout=RANK_DEADLINE_S)
    rounds = -(-24 // HALO_K)
    errs = [max(r["errs"][i] for r in op) / op[0]["scale"][i]
            for i in range(5)]
    emit("spatial_op", ranks=4, mesh=[1, 4], b=4, h=KITTI_H, w=KITTI_W,
         t=24, halo_k=HALO_K, norm="8sum_clamp",
         max_rel={"k7_forward": errs[0], "k8_forward": errs[1],
                  "d_guidance": errs[2], "d_blur": errs[3],
                  "d_sparse": errs[4]},
         fwd_tol=KERNEL_TOL, grad_tol=GRAD_TOL,
         launches=[r["launches"] for r in op],
         exchanges=[r["exchanges"] for r in op],
         seconds=time.perf_counter() - t0, gpu=gpu)
    want = {k: rounds if k.startswith("cspn_prenorm") else 0
            for k in op[0]["launches"]}
    want.update(cspn_gates9=2, cspn_gates9_bwd=1)
    if not (max(errs[:2]) <= KERNEL_TOL and max(errs[2:]) <= GRAD_TOL
            and all(r["launches"] == want for r in op)
            and all(r["exchanges"] == 2 * (rounds + 2) for r in op)):
        raise AssertionError(f"the sharded CSPN op on 4 ranks: {errs} "
                             f"{[r['launches'] for r in op]}")

    # The 1x1 reference steps, freed before the ranks start.
    cfg = mesh_config()
    variables = randomized_variables(cfg)
    batch_np = {k: v.cpu().numpy() for k, v in fixed_batch(
        Trainer(cfg.override(**{"mesh.data": 1, "mesh.spatial": 1}),
                device="cpu"), KITTI_BATCH).items()}
    single = {n: f32_step(cfg.override(**{"mesh.data": 1, "mesh.spatial": 1,
                                          "train.batch_size": bs}),
                          variables, {k: torch.from_numpy(v[:bs]).cuda()
                                      for k, v in batch_np.items()})
              for n, bs, _ in MESH_RUNS if n != "rows_b8"}
    single["rows_b8"] = single["images_b8"]
    singles = gap_singles(cfg, variables, batch_np) if gap_probe else None
    del variables
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with expandable_segments() if gap_probe else contextlib.nullcontext():
        ranks = spawn_ranks(mesh_rank, 8, batch_np, gap_probe,
                            timeout=RANK_DEADLINE_S)
    seconds = time.perf_counter() - t0
    runs = {n: [r[n] for r in ranks] for n, _, _ in MESH_RUNS}
    vs = {n: mesh_vs_single(runs[n], single[n]) for n in runs}
    images = runs["images_b8"]
    r0 = images[0]
    if gap_probe:
        emit_mesh_gap(runs[GAP_RUN], single[GAP_RUN], singles, vs[GAP_RUN],
                      cfg.name, gpu)
    emit("spatial_train", config=cfg.name, mesh=r0["trainer_mesh"], ranks=8,
         arch=cfg.model.arch, dtype=cfg.model.dtype, batch=KITTI_BATCH,
         h=KITTI_H, w=KITTI_W, num_iters=cfg.model.num_iters,
         layout=r0["layout"], f32_step_vs_1x1=vs["images_b8"],
         losses=r0["losses"],
         step_ms_rank0=r0["step_ms"],
         step_ms_median_all=float(np.median(
             [ms for r in images for ms in r["step_ms"]])),
         eval_ms_rank0=r0["eval_ms"],
         eval_n_images=r0["eval_n_images"], eval_rmse=r0["eval_rmse"],
         launches_per_rank=[r["launches"] for r in images],
         eval_launches_per_rank=[r["eval_launches"] for r in images],
         exchanges_per_rank=[r["exchanges"] for r in images],
         peak_gb_per_rank=[r["peak_gb"] for r in images],
         params_identical=len({r["digest"] for r in images}) == 1,
         seconds=seconds,
         timing="one card time-shared by 8 processes, collectives through "
                "the host over gloo: not a multi-GPU figure", gpu=gpu)
    kernels = ("cspn_prenorm_fwd", "cspn_prenorm_fwd_stash",
               "cspn_prenorm_bwd", "cspn_gates9", "cspn_gates9_bwd",
               "prenorm_gates9", "anchor")
    for name, batch_size, layout in MESH_RUNS:
        rs = runs[name]
        emit("spatial_rows", run=name, layout=rs[0]["layout"],
             asked=layout, config=cfg.name, mesh=rs[0]["trainer_mesh"],
             batch=batch_size, h=KITTI_H, w=KITTI_W,
             pred_shape_rank0=rs[0]["pred_shape"],
             f32_step_vs_1x1=vs[name], losses=rs[0]["losses"],
             comm_exchanges_per_step_per_rank=[r["comm_per_step"]
                                               for r in rs],
             halo_exchanges_per_step=rs[0]["exchanges"] / SPATIAL_STEPS,
             max_memory_allocated_gb_per_rank=[r["peak_gb"] for r in rs],
             step_ms_gloo_on_one_card_rank0=rs[0]["step_ms"],
             step_ms_gloo_on_one_card_median_all=float(np.median(
                 [ms for r in rs for ms in r["step_ms"]])),
             eval_ms_rank0=rs[0]["eval_ms"],
             slab_route_launches_train_per_rank=[
                 {k: r["launches"][k] for k in kernels} for r in rs],
             slab_route_launches_eval_per_rank=[
                 {k: r["eval_launches"][k] for k in kernels} for r in rs],
             params_identical=len({r["digest"] for r in rs}) == 1,
             timing="gloo on one card: 8 processes time-share one H100, "
                    "collectives staged through the host; not a multi-GPU "
                    "figure", gpu=gpu)
    want_layout = {"images_b8": "images", "rows_b2": "rows",
                   "rows_b8": "rows"}
    bad = [n for n, bs, _ in MESH_RUNS
           if not (mesh_run_ok(runs[n], vs[n], bs, rounds)
                   and runs[n][0]["layout"] == want_layout[n])]
    if bad:
        raise AssertionError(f"the kitti_1216 2x4 Trainer on 8 ranks: "
                             f"{bad} failed: {[vs[n] for n in bad]}, "
                             f"launches {[runs[n][0]['launches'] for n in bad]}")
    return dict(train_launches=r0["launches"],
                eval_launches=r0["eval_launches"])


def write_nyu_shards(root: Path, rng) -> None:
    """NYU-like frames packed as tools/prepare_nyu.py packs them (written
    with numpy, no h5py): raw 480x640 uint8 rgb (smooth gradients and
    noise) and uint16 depth (meters * 256, 0.5..9.5 m, ~5% holes)."""
    h, w = NYU_RAW
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    for split, n in NYU_FRAMES.items():
        rgb = np.lib.format.open_memmap(root / f"{split}_rgb.u8.npy", "w+",
                                        np.uint8, (n, h, w, 3))
        dep = np.lib.format.open_memmap(root / f"{split}_depth.u16.npy",
                                        "w+", np.uint16, (n, h, w))
        for i in range(n):
            base = np.stack([yy, xx, 0.5 * (yy + xx)], -1) * 200.0
            rgb[i] = np.clip(base + rng.normal(0.0, 20.0, (h, w, 3)), 0, 255)
            depth = 0.5 + 9.0 * (0.2 + 0.8 * yy) * rng.uniform(0.6, 1.0)
            depth = np.where(rng.random((h, w)) < 0.95, depth, 0.0)
            dep[i] = np.clip(depth * DEPTH_SCALE + 0.5, 0, 65535)
        rgb.flush()
        dep.flush()
        del rgb, dep
        with open(root / f"{split}_index.json", "w") as f:
            json.dump({"n": n, "height": h, "width": w,
                       "depth_scale": DEPTH_SCALE,
                       "files": [f"{split}/{i:05d}.h5" for i in range(n)]},
                      f)


def fit_config(root: str, **overrides):
    """nyu_completion_500 as configured, reading the shards at root."""
    return get_config("nyu_completion_500").override(**{
        "data.root": root, **overrides})


def cli_args(root: str, workdir: str, device: str) -> list[str]:
    """The port's CLI on nyu_completion_500 and the shards at root."""
    return [sys.executable, "-m", "cspn_monodepth_tpu_torch.main",
            "--config", "nyu_completion_500", "--workdir", workdir,
            "--device", device, "--set", f"data.root={root}",
            "--set", f"train.steps_per_epoch={CLI_STEPS}"]


def sync(device: str):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def state_copy(state) -> dict:
    """Copies of what a checkpoint holds: step, model, optimizer state."""
    return {"step": state.step,
            "model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": [
                {k: v.clone() for k, v in state.optimizer.state[p].items()}
                for g in state.optimizer.param_groups for p in g["params"]]}


def states_equal(got: dict, want: dict) -> bool:
    return (got["step"] == want["step"]
            and got["model"].keys() == want["model"].keys()
            and all(torch.equal(got["model"][k], v)
                    for k, v in want["model"].items())
            and len(got["optimizer"]) == len(want["optimizer"])
            and all(g.keys() == w.keys() and len(w) > 0
                    and all(torch.equal(g[k], w[k]) for k in w)
                    for g, w in zip(got["optimizer"], want["optimizer"])))


def max_rel_list(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def quiet(*args):
    pass


def fit_resume(root: str, work: Path, gpu: str, device: str) -> dict:
    """Kill and resume at full width: a warm-up epoch of RESUME_STEPS
    steps and two more uninterrupted (their spread), then one with a
    checkpoint every CKPT_EVERY steps that crashes right after the first,
    a restore into a fresh state and the epoch resumed from the
    checkpoint's epoch_step."""
    cfg = fit_config(root, **{"train.steps_per_epoch": RESUME_STEPS,
                              "train.checkpoint_every": CKPT_EVERY})
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(cfg, device=device, workdir=str(work))
        runs = []
        for _ in range(3):
            state, m = trainer.train_epoch(trainer.init_state(), 0,
                                           log=quiet)
            runs.append(m["step_losses"])
            del state
        warmup, runs = runs[0], runs[1:]
        spread = max_rel_list(runs[1], runs[0])
        ckpt = CheckpointManager(str(work / "ckpt"))
        dead, part = trainer.train_epoch(trainer.init_state(), 0, log=quiet,
                                         ckpt=ckpt, max_steps=CKPT_EVERY)
        saved = state_copy(dead)
        steps_saved = ckpt.steps()
        # The same save into a fresh directory, timed.
        timed = CheckpointManager(str(work / "ckpt_timed"))
        sync(device)
        t0 = time.perf_counter()
        timed.save(dead.step, dead, extra={"epoch": 0,
                                           "epoch_step": CKPT_EVERY})
        save_ms = 1e3 * (time.perf_counter() - t0)
        step_dir = Path(timed.directory) / str(dead.step)
        size_mb = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e6
        shutil.rmtree(timed.directory)
        held = dict(parameters=sum(p.numel() for p in dead.model.parameters()),
                    buffers=sum(b.numel() for b in dead.model.buffers()))
        del dead
        fresh = trainer.init_state()
        sync(device)
        t0 = time.perf_counter()
        restored, extra = ckpt.restore(fresh)
        sync(device)
        restore_ms = 1e3 * (time.perf_counter() - t0)
        identical = states_equal(state_copy(restored), saved)
        del saved
        _, resumed = trainer.train_epoch(restored, 0, log=quiet,
                                         start_step=extra["epoch_step"])
        del restored, fresh, trainer
    finally:
        torch.backends.cudnn.deterministic = False
    tol = max(RESUME_TOL, spread)
    part_err = max_rel_list(part["step_losses"], runs[0])
    resume_err = max_rel_list(resumed["step_losses"], runs[0][CKPT_EVERY:])
    line = dict(config=cfg.name, batch=cfg.train.batch_size,
                steps=RESUME_STEPS, checkpoint_every=CKPT_EVERY,
                checkpoints=steps_saved, extra=extra,
                state_bit_identical=identical, losses=runs[0],
                warmup_max_rel=max_rel_list(warmup, runs[0]),
                rerun_spread=spread, crashed_losses_max_rel=part_err,
                resumed_losses=resumed["step_losses"],
                resumed_max_rel=resume_err, tol=tol,
                tol_rule="cudnn deterministic, after a warm-up epoch; "
                         "max(RESUME_TOL, spread)",
                save_ms=save_ms, restore_ms=restore_ms,
                checkpoint_mb=size_mb, **held, gpu=gpu)
    emit("fit_resume", **line)
    if not (identical and steps_saved == [CKPT_EVERY]
            and extra == {"epoch": 0, "epoch_step": CKPT_EVERY}
            and len(resumed["step_losses"]) == RESUME_STEPS - CKPT_EVERY
            and part_err <= tol and resume_err <= tol
            and np.isfinite(runs[0]).all()):
        raise AssertionError(f"kill and resume: {line}")
    return line


def csv_rows(path: Path) -> list[dict]:
    lines = path.read_text().splitlines()
    keys = lines[0].split(",")
    return [dict(zip(keys, ln.split(","))) for ln in lines[1:]]


def timed_steps(trainer: Trainer, device: str) -> list:
    """Make each of trainer's train steps end in a device sync and record
    its (start, end) on the host clock: the gap before a step is the time
    it waited for its batch."""
    spans = []
    step = trainer.train_step

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = step(*args, **kw)
        sync(device)
        spans.append((t0, time.perf_counter()))
        return out

    trainer.train_step = timed
    return spans


def fit_counted(root: str, work: Path, gpu: str, device: str) -> dict:
    """Trainer.fit over FIT_EPOCHS epochs of the shards, with the launch
    counts set to 0 just before and read just after: K2 and K3 once per
    train step, K1 once per eval batch, nothing else. Each step is timed
    to a device sync (timed_steps): the last epoch's step times and data
    times (the wait before each step but its first, which follows the
    eval and the checkpoint). Then FIXED_STEPS steps on one fixed batch,
    each timed to its sync (after the launch counts were read), and one
    under the profiler."""
    cfg = fit_config(root, **{"train.epochs": FIT_EPOCHS})
    trainer = Trainer(cfg, device=device, workdir=str(work))
    steps = FIT_EPOCHS * trainer.steps_per_epoch
    eval_batches = -(-len(trainer.val_ds) // cfg.train.batch_size)
    spans = timed_steps(trainer, device)
    reset_counts()
    t0 = time.perf_counter()
    state, best = trainer.fit(log=quiet)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = counts()
    fit_spans, final_step = list(spans), state.step
    spe = trainer.steps_per_epoch
    warm = fit_spans[-spe:]
    step_ms = [1e3 * (b - a) for a, b in warm]
    data_ms = [1e3 * (warm[i][0] - warm[i - 1][1]) for i in range(1, spe)]
    want = {k: 0 for k in launches}
    want.update(cspn_fwd_stash=steps, cspn_bwd=steps,
                cspn_fwd=FIT_EPOCHS * eval_batches)
    # The same step on one fixed batch with no input pipeline running (each
    # timed to the sync that timed_steps adds): the step alone, and its
    # device time under the profiler.
    batch = fixed_batch(trainer, cfg.train.batch_size)
    fixed_ms = []
    for _ in range(FIXED_STEPS):
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        fixed_ms.append(1e3 * (time.perf_counter() - t0))
    profile = device_profile(lambda: trainer.train_step(state, batch))
    train, test = csv_rows(work / "train.csv"), csv_rows(work / "test.csv")
    kept = CheckpointManager(str(work)).steps()
    last, last_eval = train[-1], test[-1]
    line = dict(config=cfg.name, arch=cfg.model.arch,
                batch=cfg.train.batch_size, h=cfg.data.height,
                w=cfg.data.width, reader=type(trainer.train_ds).__name__,
                train_frames=len(trainer.train_ds),
                val_frames=len(trainer.val_ds), epochs=FIT_EPOCHS,
                steps_per_epoch=spe, seconds=seconds,
                step_ms_p50=float(np.median(step_ms)),
                step_ms_max=max(step_ms),
                img_per_s=cfg.train.batch_size / np.median(step_ms) * 1e3,
                data_ms_p50=float(np.median(data_ms)),
                data_ms_max=max(data_ms), step_ms=step_ms, data_ms=data_ms,
                fixed_batch_step_ms_p50=float(np.median(fixed_ms[1:])),
                fixed_batch_step_ms=fixed_ms,
                fixed_batch_profile={k: profile[k] for k in (
                    "wall_ms", "busy_ms", "idle_share", "by_class")},
                csv_step_ms_by_epoch=[1e3 * float(r["step_time"])
                                      for r in train],
                csv_data_ms_by_epoch=[1e3 * float(r["data_time"])
                                      for r in train],
                loss_by_epoch=[float(r["loss"]) for r in train],
                eval_img_per_s_by_epoch=[float(r["images_per_sec"])
                                         for r in test],
                rmse=float(last_eval["rmse"]), best_rmse=best,
                checkpoints=kept, final_step=final_step, launches=launches,
                gpu=gpu)
    emit("fit", **line)
    if not (launches == want and len(fit_spans) == steps
            and len(train) == len(test) == FIT_EPOCHS
            and (work / "best.txt").exists() and len(kept) <= 3
            and kept[-1] == steps == final_step
            and np.isfinite(float(last["loss"]))
            and np.isfinite(float(last_eval["rmse"]))):
        raise AssertionError(f"fit: launches {launches}, expected {want}; "
                             f"{line}")
    return line


def run_cli(args: list[str]) -> tuple[str, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[1:])} exited with "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, seconds


def fit_cli(root: str, work: Path, gpu: str, device: str) -> dict:
    """The CLI as a user runs it: two epochs, then three (resuming at the
    third), then --evaluate; then DepthPredictor.from_checkpoint against
    the restored Trainer's forward on the same requests."""
    args = cli_args(root, str(work), device)
    _, first_s = run_cli(args + ["--set", "train.epochs=2"])
    train, test = csv_rows(work / "train.csv"), csv_rows(work / "test.csv")
    first = dict(train_rows=len(train), test_rows=len(test),
                 checkpoints=CheckpointManager(str(work)).steps(),
                 best_txt=(work / "best.txt").exists())
    out, second_s = run_cli(args + ["--set", "train.epochs=3"])
    resumed = f"resumed from step {2 * CLI_STEPS}, epoch 2 step 0" in out
    second = dict(train_rows=len(csv_rows(work / "train.csv")),
                  test_rows=len(csv_rows(work / "test.csv")),
                  checkpoints=CheckpointManager(str(work)).steps(),
                  resumed=resumed)
    best = CheckpointManager(str(work)).best_step()
    out, eval_s = run_cli(args + ["--evaluate"])
    evaluated = (f"evaluating checkpoint step {best}" in out
                 and "eval rmse" in out)

    cfg = fit_config(root)
    predictor = DepthPredictor.from_checkpoint(str(work), cfg, device=device)
    trainer = Trainer(cfg, device=device, workdir=str(work))
    state, _ = CheckpointManager(str(work)).restore(trainer.init_state(),
                                                    step=best)
    rgb, sparse = requests(np.random.default_rng(SEED + 9),
                           cfg.train.batch_size, NYU_H, NYU_W)
    reset_counts()
    got = predictor.predict_batch(rgb, sparse)
    serve_launches = counts()["cspn_fwd"]
    x = torch.cat([torch.from_numpy(rgb), torch.from_numpy(sparse)[..., None]],
                  dim=-1).to(device)
    with torch.no_grad():
        want = state.model.eval()(x)[..., 0].cpu().numpy()
    serve_err = float(np.abs(got - want).max() / np.abs(want).max())
    anchors = sparse > 0
    anchors_exact = bool(np.array_equal(got[anchors], sparse[anchors]))
    del predictor, state, trainer
    line = dict(first=first, second=second, best_step=best,
                evaluated=evaluated, seconds=[first_s, second_s, eval_s],
                from_checkpoint_max_rel=serve_err, tol=SERVE_TOL,
                anchors_exact=anchors_exact,
                from_checkpoint_launches=serve_launches, gpu=gpu)
    emit("fit_cli", **line)
    ok_first = (first["train_rows"] == first["test_rows"] == 2
                and first["best_txt"]
                and first["checkpoints"] == [CLI_STEPS, 2 * CLI_STEPS])
    ok_second = (second["train_rows"] == second["test_rows"] == 3 and resumed
                 and second["checkpoints"] == [CLI_STEPS, 2 * CLI_STEPS,
                                               3 * CLI_STEPS])
    if not (ok_first and ok_second and evaluated and serve_err <= SERVE_TOL
            and anchors_exact and serve_launches == 1
            and np.isfinite(got).all()):
        raise AssertionError(f"the CLI and from_checkpoint: {line}")
    return line


def phase_fit(gpu: str, device: str = "cuda") -> dict:
    """Phase 11 in a temporary directory that it removes: the shards, the
    kill and resume, the counted fit, the CLI and from_checkpoint."""
    with tempfile.TemporaryDirectory(prefix="nyu_fit_") as tmp:
        tmp = Path(tmp)
        shards = tmp / "shards"
        shards.mkdir()
        write_nyu_shards(shards, np.random.default_rng(SEED + 8))
        resume = fit_resume(str(shards), tmp / "resume", gpu, device)
        fit = fit_counted(str(shards), tmp / "fit", gpu, device)
        cli = fit_cli(str(shards), tmp / "cli", gpu, device)
    return dict(resume=resume, fit=fit, cli=cli)


# ---------------------------------------------------------------- phase 12
def host8_config(nyu_root: str, kitti_root: str, **overrides):
    """host8_dp, one rank's share on one card: mesh.data 8 -> 1 and batch
    64 -> 8 (BREADTH_REDUCED), on the shards and frames at the roots."""
    return get_config("host8_dp").override(**{
        "mesh.data": 1, "train.batch_size": 8, "data.root": nyu_root,
        "data.mix_root": kitti_root, "train.steps_per_epoch": MIX_STEPS,
        "train.checkpoint_every": MIX_CKPT, **overrides})


def breadth_mixed(nyu_root: str, kitti_root: str, work: Path,
                  gpu: str) -> dict:
    """host8_dp's mixed job: a warm-up epoch, then, with the launch counts
    set to 0, an epoch of MIX_STEPS steps (NYU 228x304 and KITTI 352x1216
    batches in turn, each step timed to a device sync) and the evaluation
    (NYU val); a second uninterrupted epoch for the spread; a crash right
    after the checkpoint at MIX_CKPT, the restore and the resumed epoch.
    cuDNN deterministic throughout, as fit_resume."""
    cfg = host8_config(nyu_root, kitti_root)
    k = cfg.data.mix_every
    kitti_steps = MIX_STEPS // k
    nyu_steps = MIX_STEPS - kitti_steps
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(cfg, workdir=str(work))
        eval_batches = -(-len(trainer.val_ds) // cfg.train.batch_size)
        _, warm = trainer.train_epoch(trainer.init_state(), 0, log=quiet)
        spans = timed_steps(trainer, "cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, first = trainer.train_epoch(trainer.init_state(), 0,
                                           log=quiet)
        ev = trainer.evaluate(state, log=quiet, save_panels=False)
        sync("cuda")
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        epoch_spans = list(spans)
        del state
        _, second = trainer.train_epoch(trainer.init_state(), 0, log=quiet)
        ckpt = CheckpointManager(str(work / "ckpt"))
        dead, part = trainer.train_epoch(trainer.init_state(), 0, log=quiet,
                                         ckpt=ckpt, max_steps=MIX_CKPT)
        saved = state_copy(dead)
        del dead
        restored, extra = ckpt.restore(trainer.init_state())
        identical = states_equal(state_copy(restored), saved)
        del saved
        _, resumed = trainer.train_epoch(restored, 0, log=quiet,
                                         start_step=extra["epoch_step"])
        del restored, trainer
    finally:
        torch.backends.cudnn.deterministic = False
    kitti = [i % k == k - 1 for i in range(MIX_STEPS)]
    step_ms = [1e3 * (b - a) for a, b in epoch_spans]
    data_ms = [1e3 * (epoch_spans[i][0] - epoch_spans[i - 1][1])
               for i in range(1, MIX_STEPS)]
    losses, spread = first["step_losses"], max_rel_list(
        second["step_losses"], first["step_losses"])
    tol = max(RESUME_TOL, spread)
    resume_err = max_rel_list(resumed["step_losses"], losses[MIX_CKPT:])
    want = {n: 0 for n in launches}
    want.update(cspn_fwd_stash=nyu_steps, cspn_bwd=nyu_steps,
                cspn_tiled_fwd_stash=kitti_steps,
                cspn_tiled_bwd=kitti_steps, cspn_fwd=eval_batches)
    line = dict(
        config=cfg.name, reduced=BREADTH_REDUCED, batch=cfg.train.batch_size,
        mix_every=k, steps=MIX_STEPS, nyu_steps=nyu_steps,
        kitti_steps=kitti_steps, nyu_hw=[cfg.data.height, cfg.data.width],
        kitti_hw=[cfg.data.mix_height, cfg.data.mix_width],
        step_ms_nyu_p50=float(np.median(
            [t for t, m in zip(step_ms, kitti) if not m])),
        step_ms_kitti_p50=float(np.median(
            [t for t, m in zip(step_ms, kitti) if m])),
        step_ms=step_ms, data_ms_p50=float(np.median(data_ms)),
        data_ms_max=max(data_ms), peak_mem_gb=peak_gb, launches=launches,
        eval_batches=eval_batches, eval_rmse=ev["rmse"],
        eval_img_per_s=ev["images_per_sec"], losses=losses,
        warmup_losses=warm["step_losses"], rerun_spread=spread,
        checkpoints=ckpt.steps(), extra=extra, state_bit_identical=identical,
        crashed_losses_max_rel=max_rel_list(part["step_losses"], losses),
        resumed_losses=resumed["step_losses"], resumed_max_rel=resume_err,
        tol=tol, gpu=gpu)
    emit("breadth_mixed", **line)
    if not (launches == want and identical
            and extra == {"epoch": 0, "epoch_step": MIX_CKPT}
            and len(resumed["step_losses"]) == MIX_STEPS - MIX_CKPT
            and resume_err <= tol and np.isfinite(losses).all()
            and np.isfinite(ev["rmse"])):
        raise AssertionError(f"mixed job: launches {launches}, expected "
                             f"{want}; {line}")
    return line


def torchvision_state_dict(arch: str, gen) -> dict:
    """Seeded weights of a torchvision ResNet in its own layout and names
    (`layerL.B.convN`, `downsample.{0,1}`, `num_batches_tracked`, `fc.*`):
    lecun-normal convolutions, non-trivial BN statistics."""
    stages, block = ARCHS[arch]
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn(
            (cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 0.8 + 0.4 * torch.rand(c, generator=gen)
        sd[f"{name}.bias"] = 0.2 * torch.rand(c, generator=gen) - 0.1
        sd[f"{name}.running_mean"] = 0.6 * torch.rand(c, generator=gen) - 0.3
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, n in enumerate(stages, start=1):
        ch = 64 * 2 ** (layer - 1)
        out = ch if block == "basic" else 4 * ch
        for b in range(n):
            p = f"layer{layer}.{b}"
            shapes = ([(ch, cin, 3), (ch, ch, 3)] if block == "basic" else
                      [(ch, cin, 1), (ch, ch, 3), (out, ch, 1)])
            for i, (co, ci, kk) in enumerate(shapes, start=1):
                conv(f"{p}.conv{i}", co, ci, kk)
                bn(f"{p}.bn{i}", co)
            if b == 0 and (layer > 1 or cin != out):
                conv(f"{p}.downsample.0", out, cin, 1)
                bn(f"{p}.downsample.1", out)
            cin = out
    sd["fc.weight"] = torch.randn((1000, cin), generator=gen) / cin ** 0.5
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def breadth_ref_recipe(work: Path, gpu: str) -> dict:
    """nyu_completion_500_ref at full width (ResNet-50, 228x304, batch 8,
    norm 8sum, encoder lr x0.1) with model.pretrained on a torchvision
    .pth saved here from seeded weights: the loaded encoder against the
    file, REF_STEPS steps through K2/K3, one step against the plain CSPN
    loop."""
    pth = work / "resnet50_torchvision.pth"
    sd = torchvision_state_dict("resnet50",
                                torch.Generator().manual_seed(SEED + 12))
    torch.save(sd, pth)
    cfg = get_config("nyu_completion_500_ref").override(**{
        "data.dataset": "synthetic", "model.pretrained": str(pth)})
    trainer = Trainer(cfg, workdir=str(work))
    state = trainer.init_state()
    enc = state.model.encoder.state_dict()
    mismatched = [k for k, v in sd.items() if not k.startswith("fc.")
                  and k != "conv1.weight"
                  and not torch.equal(enc[encoder_key(k)].cpu(), v)]
    w1, file_w1 = enc["conv1.weight"].cpu(), sd["conv1.weight"]
    rgb_exact = torch.equal(w1[:, :3], file_w1)
    mean_exact = torch.equal(w1[:, 3:], file_w1.mean(dim=1, keepdim=True))
    lr_mults = sorted(g["lr_mult"] for g in state.optimizer.param_groups)
    batch = fixed_batch(trainer, cfg.train.batch_size)
    reset_counts()
    losses, step_ms = [], []
    for _ in range(REF_STEPS):
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batch)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = counts()
    del state, trainer
    vs_plain, _, _ = step_vs_plain(cfg, randomized_variables(cfg),
                                   cfg.train.batch_size)
    want = {n: 0 for n in launches}
    want.update(cspn_fwd_stash=REF_STEPS, cspn_bwd=REF_STEPS)
    line = dict(config=cfg.name, arch=cfg.model.arch,
                norm=cfg.model.norm_type, batch=cfg.train.batch_size,
                h=cfg.data.height, w=cfg.data.width,
                encoder_lr_mult=cfg.train.encoder_lr_mult, lr_mults=lr_mults,
                pth_mb=pth.stat().st_size / 1e6, file_tensors=len(sd),
                mismatched=mismatched, conv1_rgb_exact=rgb_exact,
                conv1_4th_is_rgb_mean=mean_exact, losses=losses,
                step_ms=step_ms, launches=launches, vs_plain=vs_plain,
                gpu=gpu)
    emit("breadth_ref_recipe", **line)
    if not (not mismatched and rgb_exact and mean_exact
            and lr_mults == [0.1, 1.0] and launches == want
            and np.isfinite(losses).all()):
        raise AssertionError(f"ref recipe: {line}")
    return line


def breadth_arch(arch: str, block: str, gpu: str) -> dict:
    """One encoder/decoder option at 228x304 (nyu_completion_500 otherwise):
    ARCH_BATCH serving against the plain CSPN path with its K1 launches,
    then ARCH_STEPS train steps on a fixed batch with their K2/K3 launches
    and peak memory, and one step against the plain CSPN loop."""
    cfg = train_config().override(**{
        "model.arch": arch, "model.decoder_block": block,
        "train.batch_size": ARCH_BATCH})
    variables = randomized_variables(cfg)
    predictor = DepthPredictor.from_variables(cfg, variables)
    params = sum(p.numel() for p in predictor.model.parameters())
    rgb, sparse = requests(np.random.default_rng(SEED + 13), ARCH_BATCH,
                           NYU_H, NYU_W)
    predictor.predict_batch(rgb, sparse)
    torch.cuda.synchronize()
    reset_counts()
    batch_ms = []
    for _ in range(ARCH_STEPS):
        t0 = time.perf_counter()
        out = predictor.predict_batch(rgb, sparse)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        check_depth(out, sparse, (ARCH_BATCH, NYU_H, NYU_W))
    serve_launches = counts()
    path_err, plain = path_vs_plain(cfg, variables, predictor, rgb, sparse)
    del plain, predictor

    trainer = Trainer(cfg)
    state = trainer.init_state(variables)
    batch = fixed_batch(trainer, ARCH_BATCH)
    state, loss, _ = trainer.train_step(state, batch)
    losses = [float(loss)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for _ in range(ARCH_STEPS):
        t0 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batch)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    train_launches = counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    del state, trainer
    vs_plain, _, _ = step_vs_plain(cfg, variables, ARCH_BATCH)
    want_serve = {n: 0 for n in serve_launches}
    want_serve["cspn_fwd"] = ARCH_STEPS
    want_train = {n: 0 for n in train_launches}
    want_train.update(cspn_fwd_stash=ARCH_STEPS, cspn_bwd=ARCH_STEPS)
    line = dict(arch=arch, decoder_block=block, params=params,
                batch=ARCH_BATCH, h=NYU_H, w=NYU_W,
                serve_batch_ms_p50=float(np.median(batch_ms)),
                serve_launches=serve_launches, path_max_rel=path_err,
                path_tol=PATH_TOL, step_ms_p50=float(np.median(step_ms)),
                step_ms=step_ms, img_per_s=ARCH_BATCH
                / float(np.median(step_ms)) * 1e3, peak_mem_mb=peak_mb,
                train_launches=train_launches, losses=losses,
                vs_plain=vs_plain, gpu=gpu)
    emit("breadth_arch", **line)
    if not (serve_launches == want_serve and train_launches == want_train
            and path_err <= PATH_TOL and np.isfinite(losses).all()):
        raise AssertionError(f"{arch}/{block}: {line}")
    return line


def breadth_stereo(gpu: str) -> dict:
    """stereo_sparse_sample on the card: its scores against the CPU's, the
    selection of the same scores on the card and on the CPU (the same
    mask), the sampler and the uniform one timed at NYU B=32 and KITTI
    B=8; then one nyu_completion_500 train step with data.sampler=stereo
    through K2/K3."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    shapes = []
    for b, h, w, n in ((TRAIN_BATCH, NYU_H, NYU_W, 500),
                       (KITTI_BATCH, KITTI_H, KITTI_W, 500)):
        rgb = torch.rand((b, h, w, 3), generator=gen, device="cuda")
        depth = 0.5 + 9.0 * torch.rand((b, h, w), generator=gen,
                                       device="cuda")
        depth[torch.rand((b, h, w), generator=gen, device="cuda") < 0.3] = 0
        valid = depth > 0
        scores = stereo_scores(rgb)
        score_err = float((scores.cpu() - stereo_scores(rgb.cpu()))
                          .abs().max())
        scores = scores + 1e-4 * torch.rand((b, h, w), generator=gen,
                                            device="cuda")
        card = keep_top(depth, valid, scores, n)
        cpu = keep_top(depth.cpu(), valid.cpu(), scores.cpu(), n)
        same_mask = torch.equal(card.cpu() > 0, cpu > 0)
        out = stereo_sparse_sample(depth, rgb, n, max_depth=10.0,
                                   generator=gen)
        counts_ok = bool(((out > 0).sum((1, 2)) == n).all())
        stereo_ms = time_ms(lambda: stereo_sparse_sample(
            depth, rgb, n, max_depth=10.0, generator=gen), 20)
        uniform_ms = time_ms(lambda: uniform_sparse_sample(
            depth, n, max_depth=10.0, generator=gen), 20)
        shapes.append(dict(b=b, h=h, w=w, n=n, score_max_abs=score_err,
                           same_mask=same_mask, counts_exact=counts_ok,
                           stereo_ms=stereo_ms, uniform_ms=uniform_ms))
    cfg = train_config().override(**{"data.sampler": "stereo",
                                     "train.batch_size": 8})
    trainer = Trainer(cfg)
    state = trainer.init_state(randomized_variables(cfg))
    batch = fixed_batch(trainer, cfg.train.batch_size)
    unpacked = trainer._unpack(batch)
    kept = trainer._sample_sparse(trainer._rng(0, 0), unpacked["depth"],
                                  unpacked["rgb"])
    reset_counts()
    state, loss, _ = trainer.train_step(state, batch)
    loss = float(loss)
    launches = counts()
    del state, trainer
    want = {n: 0 for n in launches}
    want.update(cspn_fwd_stash=1, cspn_bwd=1)
    per_image = (kept > 0).sum((1, 2)).tolist()
    line = dict(shapes=shapes, score_tol=STEREO_SCORE_TOL,
                train_config=cfg.name, train_batch=cfg.train.batch_size,
                kept_per_image=per_image, train_loss=loss,
                train_launches=launches, gpu=gpu)
    emit("breadth_stereo", **line)
    if not (all(s["same_mask"] and s["counts_exact"]
                and s["score_max_abs"] <= STEREO_SCORE_TOL for s in shapes)
            and launches == want and np.isfinite(loss)
            and per_image == [cfg.data.num_samples] * len(per_image)):
        raise AssertionError(f"stereo sampling: {line}")
    return line


def phase_breadth(gpu: str) -> dict:
    """Phase 12 in a temporary directory that it removes: the mixed
    host8_dp job on NYU shards and KITTI frames written here, the
    paper-exact recipe with a torchvision encoder, the other encoder and
    decoder options, and stereo sampling."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="breadth_") as tmp:
        tmp = Path(tmp)
        (tmp / "nyu").mkdir()
        write_nyu_shards(tmp / "nyu", np.random.default_rng(SEED + 10))
        write_kitti_frames(tmp / "kitti", np.random.default_rng(SEED + 11))
        mixed = breadth_mixed(str(tmp / "nyu"), str(tmp / "kitti"),
                              tmp / "mixed", gpu)
        ref = breadth_ref_recipe(tmp, gpu)
    archs = [breadth_arch(arch, block, gpu) for arch, block in ARCH_CELLS]
    stereo = breadth_stereo(gpu)
    emit("breadth", seconds=time.perf_counter() - t0, gpu=gpu)
    return dict(mixed=mixed, ref=ref, archs=archs, stereo=stereo)


def host_call_ms(fn, calls: int) -> list[float]:
    """Host-clock ms of each of `calls` closed-loop calls of fn()."""
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


class Gates9ContractCSPN(torch.nn.Module):
    """The CSPN step of a kitti_1216 serving program as export_program
    captured it before K4 took raw guidance: the plain normalization and
    anchor as graph ops, then the operator cspn_tiled_fwd on gates9.
    x (B, 10, H, W) = guidance, blur, sparse -> (B, H, W, 1)."""

    def forward(self, x):
        sp = x[:, 9]
        gates9 = prenorm_gates9(x[:, :8], "8sum_clamp")
        d0 = anchor(x[:, 8], sp)
        return torch.ops.cspn_monodepth_tpu_torch.cspn_tiled_fwd(
            gates9, d0, sp, 24)[..., None]


def gates9_contract_job(tmp: Path) -> tuple[list, dict]:
    """A program of Gates9ContractCSPN at KITTI B=1, exported here, and the
    loader's job and cell for it: its output is held to K4's on the same
    raw inputs within KERNEL_TOL (the graph's normalization sums in torch's
    order), and it must launch K7's entry, the gates9 contract's function,
    once a call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    guid, blur, sp = cspn_problem(gen, 1, KITTI_H, KITTI_W)
    x = torch.cat([guid, blur[:, None], sp[:, None]], 1)
    path = tmp / "kitti_1216_gates9_contract_b1.pt2"
    module = Gates9ContractCSPN()
    with torch.no_grad():
        t0 = time.perf_counter()
        torch.export.save(torch.export.export(module, (x,)), str(path))
        export_s = time.perf_counter() - t0
        want = cspn_cuda.cspn_tiled_fwd(guid, blur, sp, num_iters=24,
                                        norm_type="8sum_clamp")
        module(x).cpu()
        eager_ms = host_call_ms(lambda: module(x).cpu(), SINGLE_REQUESTS)
    np.save(tmp / f"{path.stem}_x.npy", x.cpu().numpy())
    job = [str(path), str(tmp / f"{path.stem}_x.npy"),
           str(tmp / f"{path.stem}_y.npy"), SINGLE_REQUESTS]
    cell = dict(config="kitti_1216_gates9_contract", batch=1, h=KITTI_H,
                w=KITTI_W, export_s=export_s, want=want.cpu().numpy(),
                sparse=sp.cpu().numpy(), eager_ms=eager_ms,
                calls=SINGLE_REQUESTS, artifact_mb=path.stat().st_size / 1e6,
                kernel="cspn_prenorm_fwd", tol=KERNEL_TOL)
    return job, cell


def tools_export(tmp: Path, gpu: str) -> dict:
    """export_program of each EXPORT_CELLS shape on the card, every program
    loaded in one fresh process (LOADER), its output against predict_batch
    on the same requests, its CSPN launches (K1 for NYU, K4 for KITTI, one
    a call, nothing else) and its host ms per call beside the eager
    model's (input on the card, output copied back). An `export` line per
    cell; one more for a program with the gates9 operator contract of K4
    before it took raw guidance (gates9_contract_job). Returns the NYU B=32
    predictor, its requests and the loader's launches by cell."""
    jobs, cells = [], []
    nyu = None
    for config in dict.fromkeys(c for c, _ in EXPORT_CELLS):
        kitti = config == "kitti_1216"
        cfg = kitti_config() if kitti else get_config(config)
        predictor = DepthPredictor.from_variables(cfg, randomized_variables(
            cfg))
        h, w = cfg.data.height, cfg.data.width
        depth_range = (1.0, KITTI_MAX_DEPTH) if kitti else (0.5, 9.5)
        for batch in (b for c, b in EXPORT_CELLS if c == config):
            path = tmp / f"{config}_b{batch}.pt2"
            t0 = time.perf_counter()
            predictor.export_program(str(path), batch=batch)
            export_s = time.perf_counter() - t0
            rgb, sparse = requests(np.random.default_rng(SEED + 20 + batch),
                                   batch, h, w, depth_range=depth_range)
            x = np.concatenate([rgb, sparse[..., None]], axis=-1)
            np.save(tmp / f"{path.stem}_x.npy", x)
            want = predictor.predict_batch(rgb, sparse)
            x_dev = torch.from_numpy(x).cuda()
            with torch.inference_mode():
                predictor.model(x_dev).cpu()
                eager_ms = host_call_ms(
                    lambda: predictor.model(x_dev).cpu(),
                    SINGLE_REQUESTS if batch == 1 else EXPORT_BATCH_CALLS)
            calls = SINGLE_REQUESTS if batch == 1 else EXPORT_BATCH_CALLS
            jobs.append([str(path), str(tmp / f"{path.stem}_x.npy"),
                         str(tmp / f"{path.stem}_y.npy"), calls])
            cells.append(dict(config=config, batch=batch, h=h, w=w,
                              export_s=export_s, want=want, sparse=sparse,
                              eager_ms=eager_ms, calls=calls,
                              artifact_mb=path.stat().st_size / 1e6,
                              kernel="cspn_tiled_fwd" if kitti
                              else "cspn_fwd"))
            if config == "nyu_completion_500" and batch == TRAIN_BATCH:
                nyu = (predictor, rgb, sparse)
        del predictor
    job, cell = gates9_contract_job(tmp)
    jobs.append(job)
    cells.append(cell)
    out = subprocess.run([sys.executable, "-c", LOADER, json.dumps(jobs)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(f"the loader failed:\n{out.stderr[-4000:]}")
    loaded = [json.loads(ln) for ln in out.stdout.splitlines()]
    launches = {}
    for c, job, res in zip(cells, jobs, loaded, strict=True):
        got = np.load(job[2])[..., 0]
        check_depth(got, c["sparse"], c["want"].shape)
        err = float(np.abs(got - c["want"]).max() / np.abs(c["want"]).max())
        tol = c.get("tol", EXPORT_TOL)
        want_launches = {n: 0 for n in res["launches"]}
        want_launches[c["kernel"]] = c["calls"]
        line = dict(config=c["config"], batch=c["batch"], h=c["h"], w=c["w"],
                    artifact_mb=c["artifact_mb"], export_s=c["export_s"],
                    load_s=res["load_s"], max_rel=err, tol=tol,
                    calls=c["calls"], launches=res["launches"],
                    jax_imported=res["jax_imported"],
                    program_ms_p50=float(np.median(res["ms"])),
                    program_ms_p75=float(np.percentile(res["ms"], 75)),
                    eager_ms_p50=float(np.median(c["eager_ms"])),
                    eager_ms_p75=float(np.percentile(c["eager_ms"], 75)),
                    gpu=gpu)
        emit("export", **line)
        if not (err <= tol and res["launches"] == want_launches
                and not res["jax_imported"]):
            raise AssertionError(f"exported program: {line}")
        launches[f"{c['config']}_b{c['batch']}"] = res["launches"]
    return dict(nyu=nyu, launches=launches)


# The kernels ops/parity.py holds to the plain loop (JAX's parity gate
# covers the nine Pallas kernels; the normalization's pair is checked in
# phase 9).
PARITY_KERNELS = ("cspn_fwd", "cspn_fwd_stash", "cspn_bwd", "cspn_tiled_fwd",
                  "cspn_tiled_fwd_stash", "cspn_tiled_bwd", "cspn_prenorm_fwd",
                  "cspn_prenorm_fwd_stash", "cspn_prenorm_bwd")


def tools_parity(gpu: str) -> dict:
    """ops/parity.py on the card as the JAX package's bench.py runs its
    parity gate, for both configs: the whole plane at 228x304 (K1; K2/K3)
    and the H-tiled route at 352x1216 (K4; K5/K6), B=2, T=24, then the
    slab kernels (K7; K8/K9) on KITTI and NYU slabs at T=8, and the
    routing asserts. Any error over its tolerance raises."""
    reset_counts()
    t0 = time.perf_counter()
    result = {
        "routing": parity.routing_check(),
        "whole_plane_228x304": parity.cspn_parity_check(
            norms=("8sum_clamp", "8sum_abs"), batch=2, h=NYU_H, w=NYU_W),
        "tiled_352x1216": parity.cspn_parity_check(
            norms=("8sum_clamp",), batch=2, h=KITTI_H, w=KITTI_W,
            impl="cuda_tiled"),
        "prenorm_104x1216": parity.prenorm_parity_check(
            batch=2, h=104, w=KITTI_W, num_iters=8),
        "prenorm_96x304": parity.prenorm_parity_check(
            batch=2, h=96, w=NYU_W, num_iters=8)}
    torch.cuda.synchronize()
    launches = counts()
    emit("parity", **result, fwd_tol=parity.FWD_TOL,
         grad_tol=parity.GRAD_TOL, launches=launches,
         seconds=time.perf_counter() - t0, gpu=gpu)
    if not all(launches[k] for k in PARITY_KERNELS):
        raise AssertionError(f"the parity checks left a kernel unlaunched: "
                             f"{launches}")
    return dict(result, launches=launches)


def tools_profiling(tmp: Path, nyu, gpu: str) -> dict:
    """utils/profiling.py on the card: `trace` of one NYU B=32 serving
    batch (files written, K1's round kernel named in them); StepTimer over
    TIMER_STEPS NYU B=32 train steps after TIMER_WARMUP, beside
    timed_train's median of the same configuration; marginal_chain of K1
    at B=32 beside its CUDA-event time; kernel_roofline(32, 228, 304)
    against the byte term of cspn_bound_ms."""
    predictor, rgb, sparse = nyu
    predictor.predict_batch(rgb, sparse)
    logdir = tmp / "trace"
    with profiling.trace(str(logdir)):
        predictor.predict_batch(rgb, sparse)
        torch.cuda.synchronize()
    files = [p for p in logdir.rglob("*") if p.is_file()]
    k1_named = any(K1_KERNEL in p.read_text(errors="ignore")
                   for p in files)

    cfg = train_config()
    trainer, state, _, train_ms = timed_train(
        cfg, randomized_variables(cfg), TRAIN_BATCH,
        ("cspn_fwd_stash", "cspn_bwd"), gpu, "tools_train")
    batch = fixed_batch(trainer, TRAIN_BATCH)
    timer = profiling.StepTimer(warmup=TIMER_WARMUP)
    for _ in range(TIMER_WARMUP + TIMER_STEPS):
        with timer:
            state, loss, _ = trainer.train_step(state, batch)
    del trainer, state, batch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    guid, blur, sp = cspn_problem(gen, TRAIN_BATCH, NYU_H, NYU_W)
    kw = dict(num_iters=24, norm_type="8sum_clamp")
    k1_ms = time_ms(lambda: cspn_cuda.cspn_fwd(guid, blur, sp, **kw), 50)
    step_s, dispatch_s = profiling.marginal_chain(
        lambda d, p: cspn_cuda.cspn_fwd(p[0], d, p[1], **kw), blur,
        (guid, sp))
    roof = profiling.kernel_roofline(TRAIN_BATCH, NYU_H, NYU_W)
    bound, bound_by = cspn_bound_ms(TRAIN_BATCH, NYU_H, NYU_W, 24, True)
    line = dict(trace_files=len(files),
                trace_mb=sum(p.stat().st_size for p in files) / 1e6,
                trace_names_k1=k1_named,
                step_timer_ms_mean=1e3 * timer.mean(),
                step_timer_steps=len(timer.times),
                step_timer_ms=[1e3 * t for t in timer.times],
                timed_train_ms_p50=train_ms,
                marginal_k1_ms=1e3 * step_s,
                marginal_dispatch_ms=1e3 * dispatch_s, k1_event_ms=k1_ms,
                roofline_ms=1e3 * roof["sol_seconds"], bound_ms=bound,
                bound_by=bound_by, device_kind=torch.cuda.get_device_name(),
                gpu=gpu)
    emit("profiling", **line)
    if not (files and k1_named and len(timer.times) == TIMER_STEPS
            and step_s > 0 and bound_by == "bytes"
            and abs(line["roofline_ms"] - bound) <= 1e-9 * bound):
        raise AssertionError(f"profiling: {line}")
    return line


def tools_debug(gpu: str) -> dict:
    """utils/debug.py on the card: checkify_step on one nyu_completion_500
    train step at batch DEBUG_BATCH (float records on the card), clean,
    then with one NaN in rgb on a fresh state (the step would spread it
    into the weights): it must name an op that touches the input, not a
    convolution further on; then one step under enable_debug() runs
    finite. The global flags are restored."""
    cfg = train_config().override(**{"train.batch_size": DEBUG_BATCH})
    variables = randomized_variables(cfg)
    trainer = Trainer(cfg)
    recs = [trainer.train_ds.get(i) for i in range(DEBUG_BATCH)]
    batch = {k: torch.from_numpy(np.stack([r[k] for r in recs])).cuda()
             for k in ("rgb", "depth")}
    checked = debug.checkify_step(trainer.train_step)
    err, (_, loss, _) = checked(trainer.init_state(variables), batch)
    clean = err.get()
    bad = {k: v.clone() for k, v in batch.items()}
    bad["rgb"][0, NYU_H // 2, NYU_W // 2, 1] = float("nan")
    err, _ = checked(trainer.init_state(variables), bad)
    nan_op = err.get()
    try:
        err.throw()
        raised = False
    except FloatingPointError:
        raised = True
    flags = {f: getattr(torch.backends.cudnn, f)
             for f in ("benchmark", "deterministic", "allow_tf32")}
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        debug.enable_debug()
        _, debug_loss, _ = trainer.train_step(trainer.init_state(variables),
                                              batch)
        debug_loss = float(debug_loss)
    finally:
        torch.autograd.set_detect_anomaly(False)
        for f, v in flags.items():
            setattr(torch.backends.cudnn, f, v)
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    line = dict(batch=DEBUG_BATCH, clean_error=clean, clean_loss=float(loss),
                nan_error=nan_op, raised=raised, debug_loss=debug_loss,
                gpu=gpu)
    emit("debug", **line)
    if not (clean is None and raised and nan_op is not None
            and "conv" not in nan_op and np.isfinite(debug_loss)):
        raise AssertionError(f"debug: {line}")
    return line


def phase_tools(gpu: str) -> dict:
    """Phase 13 in a temporary directory that it removes: the exported
    serving program, the parity checks, the profiling and the debug
    utilities."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tools_") as tmp:
        tmp = Path(tmp)
        export = tools_export(tmp, gpu)
        prof = tools_profiling(tmp, export.pop("nyu"), gpu)
    par = tools_parity(gpu)
    dbg = tools_debug(gpu)
    emit("tools", seconds=time.perf_counter() - t0, gpu=gpu)
    return dict(export=export, parity=par, profiling=prof, debug=dbg)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    gpu = phase_toolchain()
    phase_build()
    k1 = phase_kernels(gpu)
    k23 = phase_train_kernels(gpu)
    k456 = phase_kitti_kernels(gpu)
    # Beside the other kernel checks: torch.profiler has recorded no device
    # time once the KITTI epoch's phase has run.
    k789 = phase_spatial_kernels(gpu)
    phase_geometry_sweep(gpu)
    forward_times(gpu)
    # Before the serving counts and before the KITTI epoch (the profiler).
    phase_tools(gpu)
    reset_counts()
    launches, max_abs_err = phase_serving(gpu)
    train = phase_train(gpu)
    k4_launches, k4_max_abs = phase_kitti_serving(gpu)
    kitti = phase_kitti_train(gpu)
    spatial = phase_spatial(gpu)
    phase_fit(gpu)
    phase_breadth(gpu)

    def row(name, source, line, launches, max_abs, t):
        return {"name": name, "route": "cuda",
                "source": f"cspn_monodepth_tpu_torch/csrc/{source}",
                "replaces": f"cspn_monodepth_tpu/ops/cspn_pallas.py:{line}",
                "launches": launches, "max_abs_err": max_abs,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    print(json.dumps({"kernels": [
        row("cspn_fwd", "cspn_fwd.cu", 94, launches, max_abs_err, k1),
        row("cspn_fwd_stash", "cspn_fwd.cu", 200,
            train["launches"]["cspn_fwd_stash"], train["k2_max_abs"],
            k23["cspn_fwd_stash"]),
        row("cspn_bwd", "cspn_bwd.cu", 245, train["launches"]["cspn_bwd"],
            train["k3_max_abs"], k23["cspn_bwd"]),
        row("cspn_tiled_fwd", "cspn_fwd.cu", 632, k4_launches, k4_max_abs,
            k456["cspn_tiled_fwd"]),
        row("cspn_tiled_fwd_stash", "cspn_fwd.cu", 828,
            kitti["launches"]["cspn_tiled_fwd_stash"], kitti["k5_max_abs"],
            k456["cspn_tiled_fwd_stash"]),
        row("cspn_tiled_bwd", "cspn_bwd.cu", 1008,
            kitti["launches"]["cspn_tiled_bwd"], kitti["k6_max_abs"],
            k456["cspn_tiled_bwd"]),
        row("cspn_prenorm_fwd", "cspn_fwd.cu", 1360,
            spatial["eval_launches"]["cspn_prenorm_fwd"],
            k789["max_abs"]["k7_max_abs"], k789["timing"]["cspn_prenorm_fwd"]),
        row("cspn_prenorm_fwd_stash", "cspn_fwd.cu", 1418,
            spatial["train_launches"]["cspn_prenorm_fwd_stash"],
            k789["max_abs"]["k8_max_abs"],
            k789["timing"]["cspn_prenorm_fwd_stash"]),
        row("cspn_prenorm_bwd", "cspn_bwd.cu", 1496,
            spatial["train_launches"]["cspn_prenorm_bwd"],
            k789["max_abs"]["k9_max_abs"], k789["timing"]["cspn_prenorm_bwd"]),
        # Not pallas_calls: the normalization _prenorm_gates9 and its
        # jax.vjp (the tiled adjoint's chain rule; the slab route's
        # normalization is the same XLA fusion, parallel/halo.py).
        row("cspn_gates9", "cspn_bwd.cu", 720,
            spatial["train_launches"]["cspn_gates9"],
            k789["gates9"]["max_abs"]["gates9_max_abs"],
            k789["gates9"]["timing"]["cspn_gates9"]),
        row("cspn_gates9_bwd", "cspn_bwd.cu", 1195,
            spatial["train_launches"]["cspn_gates9_bwd"],
            k789["gates9"]["max_abs"]["gates9_bwd_max_abs"],
            k789["gates9"]["timing"]["cspn_gates9_bwd"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
