"""Debug mode (the counterpart of cspn_monodepth_tpu/utils/debug.py).

* `enable_debug()`: anomaly detection (a NaN in a backward raises at the
  forward op that made it) and, optionally, the deterministic, full float32
  convolutions and matmuls that make a run replayable bit for bit.
* `checkify_step(fn)`: run a step with every operator's output checked for
  NaN and inf; the first operator that produced one is reported.
* Determinism: every random draw flows from (seed, epoch, step)-derived
  generators (data pipeline, sparse sampling), so a step replays exactly
  from the same config.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def enable_debug(nans: bool = True, disable_opts: bool = False):
    """nans: torch.autograd anomaly detection. disable_opts: cuDNN picks no
    algorithm by benchmark and only deterministic ones, and TF32 is off for
    matmuls and convolutions. Both are process-wide flags."""
    if nans:
        torch.autograd.set_detect_anomaly(True)
    if disable_opts:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class CheckError:
    """The outcome of a checked call: `get()` is the first failure's message
    or None; `throw()` raises FloatingPointError with it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self):
        if self.message is not None:
            raise FloatingPointError(self.message)


# Operators whose output is uninitialized memory: NaN bit patterns there
# are no one's result.
_UNINITIALIZED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "new_empty_strided")


class _NonFinite(TorchDispatchMode):
    """Checks each operator's floating outputs; keeps the first that held a
    NaN or an inf. The checks run with this mode off (inside the handler)."""

    def __init__(self):
        super().__init__()
        self.first: str | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.first is None and func.overloadpacket.__name__ not in \
                _UNINITIALIZED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.numel() and not bool(torch.isfinite(t).all())):
                    kind = "NaN" if bool(torch.isnan(t).any()) else "inf"
                    self.first = f"{kind} in the output of {func}"
                    break
        return out


def checkify_step(fn):
    """Return fn wrapped to give (err, out), err a CheckError that names the
    first aten operator whose floating output held a NaN or an inf.

    Usage:
        checked = checkify_step(trainer.train_step)
        err, out = checked(state, batch); err.throw()

    Every operator's output is read back to the host, which synchronizes on
    each: for debugging only, as JAX's checkify checks are. A division by
    zero in floating point shows up as the inf it makes; JAX's integer
    `div_checks` have no counterpart here.
    """
    @functools.wraps(fn)
    def checked(*args, **kwargs):
        mode = _NonFinite()
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.first), out

    return checked
