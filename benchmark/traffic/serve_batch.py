"""Batched requests, `DepthPredictor.predict_batch(rgb (B, H, W, 3) uint8,
sparse (B, H, W) float32)`: the program's batch serving entry."""

from __future__ import annotations

from benchmark.serve import ServeDriver, control  # noqa: F401


class Driver(ServeDriver):
    NAME = "predict_batch"

    def call(self, i: int):
        return self.predictor.predict_batch(self.rgb[i], self.sparse[i])
