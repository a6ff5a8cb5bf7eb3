"""Training and evaluation steps and epochs (PyTorch counterpart of
cspn_monodepth_tpu/train/loop.py).

    trainer = Trainer(get_config("nyu_completion_500"))      # on "cuda"
    state, best_rmse = trainer.fit()         # epochs, checkpoints, logs
    state = trainer.init_state()             # or init_state(jax_variables)
    state, loss, sums = trainer.train_step(state, batch)
    state, metrics = trainer.train_epoch(state, epoch=0)
    metrics = trainer.evaluate(state)

One train step, as in the JAX package: decode the packed batch on the
device, sample the sparse input on the device, forward in train mode (BN on
batch statistics), masked loss, backward (through the CSPN adjoint kernel
on a CUDA device), clip, weight decay and SGD-momentum (or Adam), metric
sums of the prediction. PyTorch runs eagerly: the step updates the state's
model and optimizer in place and returns the state. The host syncs with
the device only to read the loss every `log_every` steps and to save a
checkpoint.

Random numbers: the sparse samples of a train step come from a
`torch.Generator` on the device seeded by (seed, epoch tag, step); those
of an eval batch by (seed, eval tag, batch index), so evaluation is
deterministic. They are not the JAX package's threefry samples.

On a data x spatial mesh (parallel/mesh.py) each of the data * spatial
ranks runs this Trainer on its share of every global batch (the iterators
hand it out; `train_step` and `eval_step` take it), in the layout that
parallel/mesh.py `choose_layout` picks from the global batch (or that
`layout=` forces):
* "rows", as the JAX package shards: the batch splits over mesh.data,
  every rank of a data group is given the group's whole images, and each
  computes its rows of every feature map; the sparse samples are drawn on
  the whole images, then each rank keeps its rows of the input's depth
  and of the target;
* "images", where the batch splits over every rank: each rank computes
  its own whole images, and only the CSPN runs on H slabs.
BatchNorm, the loss's pixel count and the gradients are reduced over all
ranks, and the metric sums over the ranks that hold distinct images (on
rows, each image is first finished over its spatial group), so a step
computes what one device computes on the global batch, and every rank ends
it with the same parameters. Each rank draws the sparse scores of the
whole batch and keeps its own images', so the samples do not depend on the
mesh or the layout.

`fit` runs the epochs as the JAX package's does, in `workdir` (default
cfg.train.checkpoint_dir): it restores the latest checkpoint
(train/checkpoint.py) and resumes inside an epoch from its `epoch_step`
(the epoch's batches and each step's sparse samples are pure functions of
the seed, the epoch and the step), saves every `checkpoint_every` steps
and at each epoch's end, keeps the best RMSE, and writes train.csv and
test.csv (METRIC_FIELDS), best.txt, TensorBoard scalars and an
rgb|gt|pred panel of the first eval batch. On a mesh rank 0 writes the
files and every rank restores.

Mixed training (cfg.data.mix_dataset, `host8_dp`'s NYU + KITTI): every
mix_every-th step of an epoch takes its batch from a second dataset, at
its own size; the model is fully convolutional and the CSPN kernels
(K2/K3) take any shape, each with the tile geometry of its size.
Both streams are pure functions of (seed, epoch, step), so a resume
inside an epoch replays them. Evaluation stays on the main dataset.

`model.pretrained` grafts a torchvision ResNet file into the encoder at
`init_state` (models/torch_weights.py).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed

from cspn_monodepth_tpu_torch.configs import Config
from cspn_monodepth_tpu_torch.data.datasets import make_dataset
from cspn_monodepth_tpu_torch.data.pipeline import (
    DEPTH_SCALE,
    device_prefetch,
    make_eval_iterator,
    make_train_iterator,
)
from cspn_monodepth_tpu_torch.models import (
    CSPNDepthNet,
    load_jax_variables,
    load_pretrained_encoder,
)
from cspn_monodepth_tpu_torch.models.cspn_net import MODALITIES
from cspn_monodepth_tpu_torch.ops.sparse import (
    stereo_sparse_sample,
    uniform_sparse_sample,
)
from cspn_monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    choose_layout,
    make_mesh,
)
from cspn_monodepth_tpu_torch.parallel.rows import (
    Rows,
    fetch_rows,
    row_range,
)
from cspn_monodepth_tpu_torch.train.checkpoint import CheckpointManager
from cspn_monodepth_tpu_torch.train.loss import get_loss_fn
from cspn_monodepth_tpu_torch.train.metrics import (
    AverageMeter,
    MetricSums,
    finalize_metrics,
    metric_sums_from_batch,
)
from cspn_monodepth_tpu_torch.train.train_state import (
    TrainState,
    make_lr_schedule,
    make_optimizer,
)
from cspn_monodepth_tpu_torch.utils import profiling
from cspn_monodepth_tpu_torch.utils.logging import (
    CSVLogger,
    merge_into_row,
    save_image,
)
from cspn_monodepth_tpu_torch.utils.tensorboard import TBWriter

EVAL_TAG = 9999
METRIC_FIELDS = ["epoch", "loss", "rmse", "mae", "rel", "lg10", "delta1",
                 "delta2", "delta3", "irmse", "imae", "lr", "images_per_sec",
                 "data_time", "step_time"]
PANEL_IMAGES = 4


class Trainer:
    """Train and evaluate cfg's model on `device`, or on `mesh` (a
    parallel.Mesh over the initialized process group; built from cfg.mesh
    when that asks for more than one rank) in `layout` ("auto", "images"
    or "rows"; parallel/mesh.py `choose_layout`); checkpoints and logs go
    to `workdir`."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None, workdir: str | None = None,
                 layout: str = "auto"):
        if mesh is None and cfg.mesh.data * cfg.mesh.spatial > 1:
            mesh = make_mesh(cfg.mesh, device)
        self.layout = choose_layout(mesh, cfg.train.batch_size, layout)
        self.cfg = cfg
        self.mesh = mesh
        self.group = None if mesh is None else mesh.world_group
        self.is_main = mesh is None or mesh.rank == 0
        self.device = torch.device(device) if mesh is None else mesh.device
        self.workdir = workdir or cfg.train.checkpoint_dir
        self.last_panel = None
        self.train_ds = make_dataset(cfg.data, "train", seed=cfg.train.seed)
        self.val_ds = make_dataset(cfg.data, "val", seed=cfg.train.seed)
        # The mix dataset: its own root, size and depth cap, no rotation or
        # scaling, seed + 1, as in the JAX package.
        self.mix_ds = None
        if cfg.data.mix_dataset:
            d = cfg.data
            mix_cfg = dataclasses.replace(
                d, dataset=d.mix_dataset, root=d.mix_root,
                height=d.mix_height, width=d.mix_width,
                max_depth=d.mix_max_depth, rotate_deg=0.0, scale_max=1.0,
                mix_dataset="")
            self.mix_ds = make_dataset(mix_cfg, "train",
                                       seed=cfg.train.seed + 1)
        self.steps_per_epoch = cfg.train.steps_per_epoch or max(
            len(self.train_ds) // cfg.train.batch_size, 1)
        self.lr_schedule = make_lr_schedule(cfg.train, self.steps_per_epoch)
        self.loss_fn = get_loss_fn(cfg.train.loss)

    # ---------------------------------------------------------- state
    def init_state(self, variables=None) -> TrainState:
        """A fresh model from cfg.train.seed, or the JAX package's
        {"params", "batch_stats"} tree `variables`, with the torchvision
        encoder of cfg.model.pretrained grafted in when set, on the
        device, with its optimizer, at step 0."""
        cfg = self.cfg
        if cfg.model.require_pretrained and not cfg.model.pretrained:
            raise ValueError(
                f"config {cfg.name!r} is a paper-exact recipe that is "
                "unstable from scratch: set model.pretrained")
        model = CSPNDepthNet.from_config(
            cfg.model, generator=torch.Generator().manual_seed(cfg.train.seed),
            mesh=self.mesh, layout=self.layout)
        if variables is not None:
            load_jax_variables(model, variables)
        if cfg.model.pretrained:
            load_pretrained_encoder(model.encoder, cfg.model.pretrained,
                                    MODALITIES[cfg.model.modality][0])
        model.to(self.device)
        return TrainState(step=0, model=model,
                          optimizer=make_optimizer(cfg.train, model))

    # ---------------------------------------------------------- model io
    def _rng(self, tag: int, index: int) -> torch.Generator:
        seed = np.random.SeedSequence(
            [self.cfg.train.seed, tag, index]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    @staticmethod
    def _unpack(batch: dict) -> dict:
        """Decode the compact wire format (data/pipeline.py pack_batch) on
        the device: uint8 rgb -> [0, 1] float32, uint16 depth -> meters.
        Float batches pass through unchanged."""
        out = dict(batch)
        if batch["rgb"].dtype == torch.uint8:
            out["rgb"] = batch["rgb"].float() / 255.0
        if batch["depth"].dtype == torch.uint16:
            out["depth"] = batch["depth"].float() / DEPTH_SCALE
        return out

    def _assemble_input(self, rgb, sparse):
        """Stack the modality's input channels, channels-last."""
        modality = self.cfg.model.modality
        if modality == "rgb":
            return rgb
        if modality == "d":
            return sparse[..., None]
        return torch.cat([rgb, sparse[..., None]], dim=-1)

    def _sample_sparse(self, generator, depth, rgb):
        cfg = self.cfg
        if cfg.data.num_samples <= 0:
            return torch.zeros_like(depth)
        cap = cfg.data.max_depth
        if cfg.data.mix_dataset:
            # One cap for both datasets: the looser one is a no-op for the
            # shallower dataset (NYU <= 10 m is unaffected by 85 m).
            cap = max(cap, cfg.data.mix_max_depth)
        rank, ranks = self._share()
        b = depth.shape[0]
        share = dict(max_depth=cap, generator=generator,
                     batch_offset=rank * b, global_batch=ranks * b)
        if cfg.data.sampler == "stereo":
            return stereo_sparse_sample(depth, rgb, cfg.data.num_samples,
                                        **share)
        return uniform_sparse_sample(depth, cfg.data.num_samples, **share)

    def _share(self) -> tuple[int, int]:
        """(index, count) of this rank's share of a global batch: its data
        group's on rows (every rank of the group reads the same images),
        its own on images."""
        if self.mesh is None:
            return 0, 1
        if self.layout == "rows":
            return self.mesh.d, self.mesh.data
        return self.mesh.rank, self.mesh.size

    def _shards(self) -> dict:
        """This rank's share of the iterators' global batches."""
        if self.mesh is None:
            return {}
        index, count = self._share()
        return dict(process_index=index, process_count=count)

    def _mine(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of (B, H, ...) maps on rows; t itself on
        images."""
        if self.layout != "rows":
            return t
        lo, hi = row_range(t.shape[1], self.mesh.spatial, self.mesh.s)
        return t[:, lo:hi]

    def _metric_sums(self, pred, target, **kw) -> MetricSums:
        """The global batch's metric sums, the same on every rank."""
        rows = self.layout == "rows"
        sums = metric_sums_from_batch(
            pred, target, protocol=self.cfg.train.metrics_protocol,
            spatial_group=self.mesh.spatial_group if rows else None, **kw)
        if self.mesh is None:
            return sums
        return sums.all_reduce(self.mesh.data_group if rows else self.group)

    # ---------------------------------------------------------- steps
    def train_step(self, state: TrainState, batch: dict, tag: int = 0):
        """One update of `state` (in place) on `batch` (numpy or tensors,
        packed or float; on a mesh this rank's share of the global batch);
        the sparse input is drawn from (seed, tag, state.step). Returns
        (state, loss, metric sums) of the global batch, on the device.
        Under a profiler: spans train.input, train.forward, train.loss,
        train.backward, train.optimizer, train.metrics
        (utils/profiling.py)."""
        cfg = self.cfg
        profiling.next_call()
        with profiling.span("train.input"):
            batch = self._unpack(self._to_device(batch))
            sparse = self._sample_sparse(self._rng(tag, state.step),
                                         batch["depth"], batch["rgb"])
            x = self._assemble_input(batch["rgb"], sparse)
            target = self._mine(batch["depth"])[..., None]
            model = state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
        with profiling.span("train.forward"):
            pred = model(x)
        with profiling.span("train.loss"):
            loss = self.loss_fn(pred, target, self.group)
        with profiling.span("train.backward"):
            loss.backward()
        with profiling.span("train.optimizer"):
            state.apply_gradients(self.lr_schedule, cfg.train.clip_norm,
                                  self.group)
        with profiling.span("train.metrics"):
            loss = loss.detach()
            with torch.no_grad():
                sums = self._metric_sums(pred, target)
            if self.group is not None:
                torch.distributed.all_reduce(loss, group=self.group)
        return state, loss, sums

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict, batch_idx: int):
        """Metric sums of one eval batch (of the global batch on a mesh)
        and the prediction of this rank's images (on rows: its rows of
        them), BN on its running statistics; the sparse input is a pure
        function of batch_idx."""
        batch = self._unpack(self._to_device(batch))
        sparse = self._sample_sparse(self._rng(EVAL_TAG, batch_idx),
                                     batch["depth"], batch["rgb"])
        x = self._assemble_input(batch["rgb"], sparse)
        pred = state.model.eval()(x)
        sums = self._metric_sums(
            pred, self._mine(batch["depth"])[..., None],
            valid_image=batch.get("valid_image"),
            max_depth=self.cfg.data.eval_max_depth)
        return sums, pred

    # ---------------------------------------------------------- epochs
    def _epoch_batches(self, epoch: int, start_step: int = 0):
        """This epoch's batches on the device from `start_step` on, this
        rank's share of each; with a mix dataset every mix_every-th step's
        batch comes from it, as in the JAX package. Of the first
        start_step steps, start_step // mix_every came from the mix
        stream, so each stream resumes at its own step. Closing the
        generator stops both streams' workers."""
        cfg = self.cfg
        total = self.steps_per_epoch
        k = cfg.data.mix_every if self.mix_ds is not None else 0
        n_mix = total // k if k else 0
        mix_start = start_step // k if k else 0
        streams = [make_train_iterator(
            self.train_ds, global_batch=cfg.train.batch_size, epoch=epoch,
            seed=cfg.train.seed, num_workers=cfg.data.num_workers,
            steps=total - n_mix, start_step=start_step - mix_start,
            **self._shards())]
        if n_mix:
            streams.append(make_train_iterator(
                self.mix_ds, global_batch=cfg.train.batch_size, epoch=epoch,
                seed=cfg.train.seed + 1, num_workers=cfg.data.num_workers,
                steps=n_mix, start_step=mix_start, **self._shards()))
        try:
            main, *mix = [iter(device_prefetch(it, self.device))
                          for it in streams]
            for step in range(start_step, total):
                yield next(mix[0] if n_mix and step % k == k - 1 else main)
        finally:
            for it in streams:
                it.close()

    def train_epoch(self, state: TrainState, epoch: int, log=print,
                    start_step: int = 0, ckpt: CheckpointManager | None = None,
                    ckpt_extra: dict | None = None,
                    max_steps: int | None = None):
        """One epoch of `steps_per_epoch` train steps, from `start_step`
        when resuming inside it; returns the state and the epoch's metrics
        (finalized sums, mean loss, step losses, data and step times,
        learning rate). With `ckpt` and cfg.train.checkpoint_every > 0 the
        state is saved every checkpoint_every steps (not at the epoch's
        last, which the caller saves) with the extras "epoch" and
        "epoch_step". `max_steps` ends the epoch after that many steps:
        the hook that simulates a crash."""
        cfg = self.cfg
        tag = 17 * epoch + 1
        batches = self._epoch_batches(epoch, start_step)
        meter = AverageMeter()
        sums = MetricSums.zeros(cfg.train.metrics_protocol, self.device)
        losses = []
        t_end = time.time()
        try:
            for step, batch in enumerate(batches, start=start_step):
                data_time = time.time() - t_end
                state, loss, s = self.train_step(state, batch, tag)
                if step % cfg.train.log_every == 0:
                    loss_f = float(loss)  # a host sync, every log_every steps
                    step_time = (time.time() - t_end) - data_time
                    ips = cfg.train.batch_size / max(step_time, 1e-9)
                    log(f"epoch {epoch} step {step}/{self.steps_per_epoch} "
                        f"loss {loss_f:.4f} data {data_time*1000:.0f}ms "
                        f"step {step_time*1000:.0f}ms ({ips:.1f} img/s)")
                meter.update(data_time=data_time,
                             step_time=time.time() - t_end - data_time)
                losses.append(loss)
                sums = sums + s
                if (ckpt is not None and cfg.train.checkpoint_every > 0
                        and (step + 1) % cfg.train.checkpoint_every == 0
                        and step + 1 < self.steps_per_epoch):
                    ckpt.save(state.step, state,
                              extra={**(ckpt_extra or {}), "epoch": epoch,
                                     "epoch_step": step + 1})
                if max_steps is not None and step + 1 - start_step >= max_steps:
                    break
                t_end = time.time()
        finally:
            batches.close()

        metrics = finalize_metrics(sums)
        step_losses = torch.stack(losses).cpu() if losses else None
        metrics["loss"] = (float(step_losses.mean()) if losses
                           else float("nan"))
        metrics["step_losses"] = ([float(x) for x in step_losses]
                                  if losses else [])
        metrics.update(meter.average())
        metrics["lr"] = float(self.lr_schedule(state.step))
        return state, metrics

    def evaluate(self, state: TrainState, log=print,
                 epoch: int | None = None, save_panels: bool = True) -> dict:
        """Metrics of the validation set; images_per_sec leaves out the
        first batch (warm-up, and the panel of its first images that rank
        0 saves to workdir when `save_panels`) when there are more."""
        cfg = self.cfg
        it = make_eval_iterator(self.val_ds,
                                global_batch=cfg.train.batch_size,
                                num_workers=cfg.data.num_workers,
                                **self._shards())
        sums = MetricSums.zeros(cfg.train.metrics_protocol, self.device)
        t0 = t_warm = time.time()
        n_warm = 0.0
        try:
            for i, batch in enumerate(device_prefetch(it, self.device)):
                s, pred = self.eval_step(state, batch, i)
                sums = sums + s
                if i == 0:
                    n_warm = float(sums.n_images)
                    if save_panels and self.layout == "rows":
                        # Every rank of the spatial group takes part.
                        rows = Rows(self.mesh, batch["depth"].shape[1])
                        with torch.no_grad():
                            pred = fetch_rows(
                                pred.movedim(-1, 1), rows,
                                [(0, rows.height)] * self.mesh.spatial
                            ).movedim(1, -1)
                    if save_panels and self.is_main:
                        self._save_panel(batch, pred, epoch)
                    t_warm = time.time()
        finally:
            it.close()
        metrics = finalize_metrics(sums)
        steady = metrics["n_images"] - n_warm
        if steady > 0:
            metrics["images_per_sec"] = steady / max(time.time() - t_warm,
                                                     1e-9)
        else:
            metrics["images_per_sec"] = (metrics["n_images"]
                                         / max(time.time() - t0, 1e-9))
        log("eval " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()
                               if isinstance(v, float)))
        return metrics

    def _save_panel(self, batch: dict, pred: torch.Tensor,
                    epoch: int | None):
        """Save the rgb | gt | pred strip of the first PANEL_IMAGES images
        of an eval batch as workdir/comparison_<epoch or latest>.png and
        keep it as `last_panel`. A failure (no PIL, say) is reported and
        never ends the evaluation."""
        try:
            pred_np = pred.detach().float().cpu().numpy()[..., 0]
            rgb = batch["rgb"].cpu().numpy()
            depth = batch["depth"].cpu().numpy()
            if rgb.dtype == np.uint8:           # compact wire format
                rgb = rgb.astype(np.float32) / 255.0
            if depth.dtype == np.uint16:
                depth = depth.astype(np.float32) / DEPTH_SCALE
            rows = [merge_into_row(rgb[i], None, depth[i], pred_np[i])
                    for i in range(min(PANEL_IMAGES, rgb.shape[0]))]
            tag = "latest" if epoch is None else f"epoch{epoch:03d}"
            strip = np.concatenate(rows, axis=0)
            save_image(strip, os.path.join(self.workdir,
                                           f"comparison_{tag}.png"))
            self.last_panel = strip             # for TensorBoard (fit)
        except Exception as e:  # a panel must never end the evaluation
            print(f"panel save failed: {e!r}")

    # ---------------------------------------------------------- fit
    def fit(self, log=print):
        """Train cfg.train.epochs epochs from the latest checkpoint in
        workdir (or a fresh state), evaluating after each; returns the
        final state and the best RMSE."""
        cfg = self.cfg
        ckpt = CheckpointManager(self.workdir, group=self.group)
        state = self.init_state()
        start_epoch, start_step = 0, 0
        best_rmse = float("inf")

        restored, extra = ckpt.restore(state)
        if restored is not None:
            state = restored
            ep = int(extra.get("epoch", -1))
            es = int(extra.get("epoch_step", 0) or 0)
            if 0 < es < self.steps_per_epoch:
                start_epoch, start_step = ep, es
            else:
                start_epoch, start_step = ep + 1, 0
            best_rmse = float(extra.get("best_rmse", float("inf")))
            log(f"resumed from step {state.step}, epoch {start_epoch} "
                f"step {start_step}")

        train_csv = test_csv = None
        if self.is_main:
            train_csv = CSVLogger(os.path.join(self.workdir, "train.csv"),
                                  METRIC_FIELDS)
            test_csv = CSVLogger(os.path.join(self.workdir, "test.csv"),
                                 METRIC_FIELDS)
        tb = TBWriter(os.path.join(self.workdir, "tb"), enabled=self.is_main)

        def row(epoch, metrics):
            return {"epoch": epoch, **{k: f"{v:.6f}"
                                       for k, v in metrics.items()
                                       if isinstance(v, float)}}

        try:
            for epoch in range(start_epoch, cfg.train.epochs):
                state, train_metrics = self.train_epoch(
                    state, epoch, log=log,
                    start_step=start_step if epoch == start_epoch else 0,
                    ckpt=ckpt, ckpt_extra={"best_rmse": best_rmse,
                                           "config": cfg.name})
                if self.is_main:
                    train_csv.append(row(epoch, train_metrics))
                tb.scalars("train", train_metrics, epoch)

                self.last_panel = None
                eval_metrics = self.evaluate(state, log=log, epoch=epoch)
                tb.scalars("eval", eval_metrics, epoch)
                if self.last_panel is not None:
                    tb.image("eval/rgb_sparse_gt_pred", self.last_panel,
                             epoch)
                tb.flush()

                is_best = eval_metrics["rmse"] < best_rmse
                if is_best:
                    best_rmse = eval_metrics["rmse"]
                if self.is_main:
                    test_csv.append(row(epoch, eval_metrics))
                    if is_best:
                        with open(os.path.join(self.workdir, "best.txt"),
                                  "w") as f:
                            f.write(f"epoch {epoch} " + " ".join(
                                f"{k}={v:.6f}"
                                for k, v in eval_metrics.items()
                                if isinstance(v, float)))
                ckpt.save(state.step, state,
                          extra={"epoch": epoch, "best_rmse": best_rmse,
                                 "config": cfg.name},
                          is_best=is_best)
        finally:
            tb.close()
            ckpt.close()
        return state, best_rmse
