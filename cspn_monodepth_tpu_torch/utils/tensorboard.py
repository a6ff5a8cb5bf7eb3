"""TensorBoard scalars and images (the port's own copy of
cspn_monodepth_tpu/utils/tensorboard.py): torch's SummaryWriter where the
`tensorboard` package is installed, else every call does nothing. Only
the writer of rank 0 is enabled.
"""

from __future__ import annotations

import numpy as np


class TBWriter:
    def __init__(self, logdir: str, enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except ImportError:
            self._writer = None

    def scalars(self, prefix: str, values: dict, step: int):
        if self._writer is None:
            return
        for k, v in values.items():
            if isinstance(v, (int, float)) and np.isfinite(v):
                self._writer.add_scalar(f"{prefix}/{k}", v, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        if self._writer is None:
            return
        self._writer.add_image(tag, img_hwc, step, dataformats="HWC")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
