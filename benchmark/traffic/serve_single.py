"""Single-frame requests, `DepthPredictor.predict(rgb (H, W, 3) uint8,
sparse (H, W) float32)`: the program's one-image serving entry."""

from __future__ import annotations

from benchmark.serve import ServeDriver, control  # noqa: F401


class Driver(ServeDriver):
    NAME = "predict"

    def call(self, i: int):
        return self.predictor.predict(self.rgb[i, 0], self.sparse[i, 0])
