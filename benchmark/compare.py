"""The numbers that decide `correct`, each the program's reading against the
reference's (benchmark/reference/), larger is worse.

Training (the set-up's first three steps, which the window's call drove):
* `loss_gap`: the largest |L - L_ref| / |L_ref| over the steps;
* `grad_gap`: the worst leaf's |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, median
  leaf's ‖g_ref‖), g the first step's clipped gradient as the optimizer
  got it;
* `change_gap`: the same of each parameter's change over the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both leaf numbers.

Serving: `answer_gap`, the largest max |d - d_ref| / max |d_ref| over the
sampled answers (infinite for an answer that is not finite or has the
wrong shape).
"""

from __future__ import annotations

import math
import statistics

import numpy as np

NEGLIGIBLE = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keep: list) -> dict[str, float]:
    floor = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keep}


def _leaf_gap(prog: dict, ref: dict, keep: list) -> float:
    return max(_leaf_gaps(prog, ref, keep).values())


def _kept(ref: dict) -> list:
    g_ref = ref["first_grad"]
    floor = statistics.median(g_ref.values())
    return [k for k, v in g_ref.items() if v >= NEGLIGIBLE * floor]


def train_readings(prog: dict, ref: dict) -> dict[str, float]:
    """prog and ref: {"losses": [...], "first_grad": {leaf: norm},
    "change": {leaf: norm}}."""
    if set(prog["first_grad"]) != set(ref["first_grad"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf,
                "change_gap": math.inf}
    g_ref = ref["first_grad"]
    keep = _kept(ref)
    losses = [abs(a - b) / abs(b) for a, b in
              zip(prog["losses"], ref["losses"], strict=True)]
    return {"loss_gap": _nan_is_inf(max(losses)),
            "grad_gap": _nan_is_inf(_leaf_gap(prog["first_grad"], g_ref,
                                              keep)),
            "change_gap": _nan_is_inf(_leaf_gap(prog["change"],
                                                ref["change"], keep))}


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> dict[str, list]:
    """The `top` leaves of largest gap of each leaf number, [leaf, gap,
    program norm, reference norm], for a look at what sets the number."""
    keep = _kept(ref)
    out = {}
    for key in ("first_grad", "change"):
        gaps = _leaf_gaps(prog[key], ref[key], keep)
        out[key] = [[k, gaps[k], prog[key][k], ref[key][k]] for k in
                    sorted(gaps, key=lambda k: -gaps[k])[:top]]
    return out


def answer_gap(answers: list, ref: np.ndarray) -> float:
    """answers: [(pool index, answer (B, H, W) or (H, W))]; ref (P, B, H,
    W), the reference's answers of the pool."""
    worst = 0.0
    for i, out in answers:
        want = ref[i]
        if np.size(out) != want.size or not np.all(np.isfinite(out)):
            return math.inf
        err = np.abs(np.reshape(out, want.shape) - want)
        scale = np.abs(want).reshape(len(want), -1).max(axis=1)
        worst = max(worst, float(np.max(
            err.reshape(len(want), -1).max(axis=1) / scale)))
    return worst


def _nan_is_inf(x: float) -> float:
    return math.inf if math.isnan(x) else float(x)
