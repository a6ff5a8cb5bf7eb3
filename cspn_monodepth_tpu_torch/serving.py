"""Inference/serving API (PyTorch): single- and multi-image depth prediction.

    predictor = DepthPredictor.from_checkpoint(workdir, cfg)     # on "cuda"
    predictor = DepthPredictor.from_variables(cfg, variables)
    depth = predictor.predict(rgb)                  # (h, w, 3) -> (h, w)
    depth = predictor.predict(rgb, sparse_depth)    # depth completion
    depths = predictor.predict_batch(rgb_batch, sparse_batch)
    predictor.export_program("depth.pt2", batch=1)  # weights baked in
    program = load_program("depth.pt2")             # ops/library.py

Counterpart of cspn_monodepth_tpu/serving.py: inputs up to the configured
(height, width) are zero-padded to it and the output is cropped back;
uint8 rgb is scaled by 1/255; rgbd without sparse depth gets an all-zero
sparse map; BN runs in eval mode on the running statistics. The device is
"cuda" unless the caller asks for another; there is no CPU fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from cspn_monodepth_tpu_torch.configs import Config
from cspn_monodepth_tpu_torch.models.convert import load_jax_variables
from cspn_monodepth_tpu_torch.models.cspn_net import CSPNDepthNet
from cspn_monodepth_tpu_torch.ops.library import load_program
from cspn_monodepth_tpu_torch.train.checkpoint import CheckpointManager
from cspn_monodepth_tpu_torch.train.train_state import (
    TrainState,
    make_optimizer,
)


class DepthPredictor:
    def __init__(self, model: CSPNDepthNet, height: int, width: int,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.height = height
        self.width = width

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, cfg: Config,
                        step: int | None = None, prefer_best: bool = True,
                        device: str | torch.device = "cuda"
                        ) -> "DepthPredictor":
        """The configured model from a Trainer's checkpoint in `ckpt_dir`
        (train/checkpoint.py): `step`, else the best step when
        `prefer_best` and one was saved, else the latest. Raises
        FileNotFoundError when there is no checkpoint."""
        model = CSPNDepthNet.from_config(cfg.model).to(device)
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(cfg.train, model))
        ckpt = CheckpointManager(ckpt_dir)
        if step is None and prefer_best:
            step = ckpt.best_step()
        restored, _ = ckpt.restore(state, step=step)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        return cls(restored.model, cfg.data.height, cfg.data.width, device)

    @classmethod
    def from_variables(cls, cfg: Config, variables,
                       device: str | torch.device = "cuda"
                       ) -> "DepthPredictor":
        """Build the configured model and fill it from the JAX package's
        {"params", "batch_stats"} tree (models/convert.py)."""
        model = load_jax_variables(CSPNDepthNet.from_config(cfg.model),
                                   variables)
        return cls(model, cfg.data.height, cfg.data.width, device)

    @staticmethod
    def _prep_rgb(rgb: np.ndarray) -> np.ndarray:
        rgb = np.asarray(rgb)
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        return rgb.astype(np.float32)

    @torch.inference_mode()
    def predict_batch(self, rgb: np.ndarray,
                      sparse_depth: np.ndarray | None = None) -> np.ndarray:
        """rgb (B, h, w, 3); sparse_depth optional (B, h, w). h <= height,
        w <= width (padded up and cropped back). Returns (B, h, w) meters."""
        rgb = self._prep_rgb(rgb)
        b, h, w, _ = rgb.shape
        if h > self.height or w > self.width:
            raise ValueError(f"input {h}x{w} exceeds configured "
                             f"{self.height}x{self.width}")
        ph, pw = self.height - h, self.width - w
        rgb_p = np.pad(rgb, ((0, 0), (0, ph), (0, pw), (0, 0)))

        modality = self.model.modality
        if modality == "rgb":
            x = rgb_p
        else:
            if sparse_depth is None:
                sparse = np.zeros((b, self.height, self.width), np.float32)
            else:
                sparse = np.pad(np.asarray(sparse_depth, np.float32),
                                ((0, 0), (0, ph), (0, pw)))
            if modality == "d":
                x = sparse[..., None]
            else:
                x = np.concatenate([rgb_p, sparse[..., None]], axis=-1)

        out = self.model(torch.from_numpy(x).to(self.device))
        return out[:, :h, :w, 0].cpu().numpy()

    def predict(self, rgb: np.ndarray,
                sparse_depth: np.ndarray | None = None) -> np.ndarray:
        """Single image (h, w, 3) [+ (h, w) sparse] -> (h, w) depth."""
        sp = None if sparse_depth is None else sparse_depth[None]
        return self.predict_batch(rgb[None], sp)[0]

    # ------------------------------------------------------------ export
    def export_program(self, path, batch: int = 1
                       ) -> torch.export.ExportedProgram:
        """Write the forward pass (weights baked in, BatchNorm in eval mode)
        to `path` as a `torch.export` program, the counterpart of the JAX
        package's `export_stablehlo`. Input: (batch, height, width, C)
        float32 with C fixed by the modality (rgb 3, rgbd 4, d 1); output
        (batch, height, width, 1) depth. Returns the ExportedProgram.

        The forward is traced under torch.no_grad() on the predictor's
        device, so that the CSPN is the one node of the K1 (or K4)
        operator and nothing of the training path. Two differences from
        the JAX artifact, by design:
        * loading needs the operators registered: a process imports
          `cspn_monodepth_tpu_torch.ops.library` and calls its
          `load_program` (the kernels are bound with ctypes, not compiled
          into PyTorch);
        * the program runs on the kind of device it was exported on (the
          bf16 autocast node holds the device type): export on "cuda" for
          the card.
        """
        ch = {"rgb": 3, "rgbd": 4, "d": 1}[self.model.modality]
        example = torch.zeros((batch, self.height, self.width, ch),
                              device=self.device)
        with torch.no_grad():
            program = torch.export.export(self.model, (example,))
        # The artifact holds the program and its weights, not a request.
        program.example_inputs = None
        torch.export.save(program, path)
        return program
