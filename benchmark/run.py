"""The benchmark of the PyTorch/CUDA port, one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the numbers compared with the reference, each beside its
limit, as the last lines of standard error, and one JSON object as the
last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), `device`, with --trace 1 `breakdown`, and last
`checks`. Exits non-zero, printing no result, without the cards, or when
the program is missing, or when JAX, flax or the JAX package was loaded.
"""

import os
import time

T_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START -= _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Caches of any compiler the program may use stay inside the checkout, at
# fixed paths; the program's own nvcc builds go to its _build/ there.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    bench = harness.spec()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"bm: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"bm: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import cspn_monodepth_tpu_torch  # noqa: F401  (fails without the program)

    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", T_START,
                                bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"bm: loaded {found}: the run may not use JAX, flax or the "
              f"JAX package", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["card"] = power_limit()
    result["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them ("" where
    it cannot)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


if __name__ == "__main__":
    sys.exit(main())
