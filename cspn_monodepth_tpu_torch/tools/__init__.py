"""Measurement tools of the port (the counterparts of the root tools/ that
import JAX), each run on the card as

    python -m cspn_monodepth_tpu_torch.tools.<name> [options]

and on the CPU with `--device cpu` (the tests), where its times are the
CPU's, not the card's:

* profile_step: device time of a train (or eval) step by kernel and class;
* profile_components: encoder, decoder, CSPN and the whole model, forward
  and (--train) forward + backward, by the marginal chain;
* profile_step_parts: the sampler, heads, loss, metrics and optimizer;
* profile_decoder: each decoder block beside its bf16 FLOP time;
* bench_pipeline: the packed NYU reader and the input pipeline;
* bench_cspn_vjp: the CSPN forward + backward kernels against autograd of
  the plain loop;
* probe_bn_eval: the eval chain with and without BatchNorm;
* torch_baseline: the reference architecture's PyTorch baseline;
* bench_bw: the card's copy and bf16 matmul rates;
* parity_check: ops/parity.py's sweep of the kernels on the card.

Each prints one JSON object naming the device it ran on.
"""

from __future__ import annotations

import argparse

import torch

from cspn_monodepth_tpu_torch.utils import profiling


def parser(doc: str | None) -> argparse.ArgumentParser:
    """An argument parser with the tools' common `--device` (cuda)."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def device_line(device: str) -> str:
    """What the tool's numbers were measured on: the card's name and power
    limit, or "cpu". Raises SystemExit for "cuda" without a card."""
    if device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    return profiling.card()
