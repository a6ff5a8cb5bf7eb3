"""The port's training path (cspn_monodepth_tpu_torch.train, .data,
ops/sparse.py) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.
* Sparse sampling: the same numpy scores through both `_top_k_mask`s
  (the generators differ: threefry against Philox), exact counts, the
  depth cap, uniformity.
* Loss and metric sums: the same arrays through both; float32 sums in
  another order, tolerance rtol 1e-5.
* Optimizer: two steps (so that momentum counts) from the same parameters
  and gradients against the JAX package's optax chain; rtol 1e-6, atol
  1e-6: the same formulas in f32, and Adam's bias corrections and square
  root taken in another order than optax's (~1e-5 of an update of size
  lr = 0.05).
* Train steps: `synthetic_tiny` in float32 from the same weights and
  batch, with the sparse map injected on both sides (a test-local
  monkeypatch of each Trainer instance's `_sample_sparse`); one and two
  steps, then every leaf of `params` and `batch_stats`, BN running
  variance included, within max|a - b| <= 1e-4 max|b|. The losses agree
  to ~1e-6; the leaves to ~1.3e-6 after one step and 2.7e-5 after two
  (the stem's conv1, whose gradient passes a BatchNorm over 3072 values
  per channel: convolutions and BN sums in another order). With torch's
  stock BatchNorm (unbiased running variance) the deepest layers' `var`
  leaves miss by 1.1 % after one step and 2.1 % after two (n = 12 values
  per channel).
  The JAX Trainer runs with `model.packed_stem=False`, its plain stem: the
  packed stem's max pool is a chain of jnp.maximum, whose gradient splits
  exact ties (the clipped synthetic rgb makes some) where a max pool gives
  the whole gradient to one element. Both are subgradients; the port
  computes the plain pool, and on this batch JAX's packed stem's
  gradients differ from its plain stem's by percents.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.data.datasets import make_dataset as jax_make_dataset
from cspn_monodepth_tpu.data.pipeline import (
    make_train_iterator as jax_make_train_iterator,
)
from cspn_monodepth_tpu.ops.sparse import _top_k_mask as jax_top_k_mask
from cspn_monodepth_tpu.train import loss as jax_loss
from cspn_monodepth_tpu.train import metrics as jax_metrics
from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer
from cspn_monodepth_tpu.train.train_state import (
    create_train_state,
    make_optimizer as jax_make_optimizer,
)
from cspn_monodepth_tpu_torch.configs import TrainConfig, get_config
from cspn_monodepth_tpu_torch.data import (
    DEPTH_SCALE,
    make_dataset,
    make_eval_iterator,
    make_train_iterator,
    pack_batch,
)
from cspn_monodepth_tpu_torch.models import jax_variables
from cspn_monodepth_tpu_torch.ops.sparse import (
    _top_k_mask,
    uniform_sparse_sample,
)
from cspn_monodepth_tpu_torch.train import (
    AverageMeter,
    MetricSums,
    Trainer,
    TrainState,
    finalize_metrics,
    make_lr_schedule,
    make_optimizer,
    masked_l1_loss,
    masked_mse_loss,
    metric_sums_from_batch,
)
from test_torch_model import randomize

STATE_TOL = 1e-4
LOSS_TOL = 1e-5
# synthetic_tiny in float32 on both sides, 2 images of 64x96, 2 workers.
TINY = {"model.dtype": "float32", "data.num_workers": 2}


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ sampling
@pytest.mark.parametrize("k", [1, 7, 20, 64])
def test_top_k_mask_matches_jax_on_the_same_scores(k):
    """Ties (including -0.0 against +0.0) and the -1 of invalid pixels
    are kept exactly as the JAX selection keeps them."""
    rng = np.random.default_rng(k)
    scores = rng.random((3, 64)).astype(np.float32)
    scores[0, :10] = 0.5                        # a run of ties
    scores[1, ::3] = -1.0                       # invalid pixels
    scores[2, :8] = 0.0
    scores[2, 8:16] = -0.0                      # -0.0 ties +0.0
    scores[2, 16:] = -1.0
    want = np.asarray(jax_top_k_mask(jnp.asarray(scores), k))
    got = _top_k_mask(torch.from_numpy(scores), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) >= k).all()


def test_uniform_sample_keeps_exact_counts_and_the_cap():
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    dense = rng.uniform(0.5, 12.0, (3, 20, 30)).astype(np.float32)
    dense[1, :, :29] = 0.0          # image 1: 20 valid pixels, fewer than n
    out = uniform_sparse_sample(torch.from_numpy(dense), 50, max_depth=10.0,
                                generator=gen).numpy()
    kept = out > 0
    valid = (dense > 0) & (dense <= 10.0)
    assert kept.sum((1, 2)).tolist() == [50, int(valid[1].sum()), 50]
    assert not (kept & ~valid).any()
    np.testing.assert_array_equal(out[kept], dense[kept])
    out4 = uniform_sparse_sample(torch.from_numpy(dense[..., None]), 10,
                                 generator=gen)
    assert out4.shape == (3, 20, 30, 1)


def test_uniform_sample_is_uniform():
    """Each valid pixel is kept with probability n / n_valid."""
    gen = torch.Generator().manual_seed(3)
    out = uniform_sparse_sample(torch.ones(400, 8, 8), 16, generator=gen)
    freq = (out > 0).float().mean(0)
    assert abs(float(freq.mean()) - 0.25) < 1e-6
    assert float(freq.std()) < 0.06


# ------------------------------------------------------------ loss/metrics
def depth_pair(seed, shape=(3, 16, 20)):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.5, 12.0, shape).astype(np.float32)
    target[rng.random(shape) < 0.3] = 0.0
    target[2] = 0.0                             # an image with no valid gt
    pred = (target + rng.normal(0, 0.7, shape)).astype(np.float32)
    pred[0, 0, :4] = -1.0                       # clamped to 1e-3 m
    return pred, target


@pytest.mark.parametrize("name", ["masked_mse_loss", "masked_l1_loss"])
def test_losses_match_jax(name):
    pred, target = depth_pair(0)
    fn = {"masked_mse_loss": masked_mse_loss,
          "masked_l1_loss": masked_l1_loss}[name]
    got = float(fn(torch.from_numpy(pred), torch.from_numpy(target)))
    want = float(getattr(jax_loss, name)(jnp.asarray(pred),
                                         jnp.asarray(target)))
    assert got == pytest.approx(want, rel=LOSS_TOL)
    zero = torch.zeros(2, 4, 4)
    assert float(fn(zero + 1.0, zero)) == 0.0      # no valid gt: count 1


@pytest.mark.parametrize("protocol", ["image", "pixel"])
@pytest.mark.parametrize("cap,padded", [(0.0, False), (8.0, True)])
def test_metric_sums_match_jax(protocol, cap, padded):
    pred, target = depth_pair(1)
    valid_image = np.array([1.0, 0.0, 1.0], np.float32) if padded else None
    got = metric_sums_from_batch(
        torch.from_numpy(pred), torch.from_numpy(target[..., None]),
        None if valid_image is None else torch.from_numpy(valid_image),
        max_depth=cap, protocol=protocol)
    want = jax_metrics.metric_sums_from_batch(
        jnp.asarray(pred), jnp.asarray(target[..., None]),
        None if valid_image is None else jnp.asarray(valid_image),
        max_depth=cap, protocol=protocol)
    for f in dataclasses.fields(got):
        if f.name == "protocol":
            assert got.protocol == want.protocol == protocol
            continue
        np.testing.assert_allclose(float(getattr(got, f.name)),
                                   float(getattr(want, f.name)), rtol=1e-5)
    total_got = finalize_metrics(got + got)
    total_want = jax_metrics.finalize_metrics(want + want)
    assert total_got.keys() == total_want.keys()
    for k in total_got:
        assert total_got[k] == pytest.approx(total_want[k], rel=1e-5)


def test_metric_sums_refuse_mixed_protocols_and_meter_averages():
    with pytest.raises(ValueError, match="protocol"):
        MetricSums.zeros("image") + MetricSums.zeros("pixel")
    with pytest.raises(ValueError, match="protocol"):
        metric_sums_from_batch(torch.ones(1, 2, 2), torch.ones(1, 2, 2),
                               protocol="tile")
    meter = AverageMeter()
    meter.update(a=1.0, b=2.0)
    meter.update(a=3.0)
    assert meter.average() == {"a": 2.0, "b": 2.0}


# ------------------------------------------------------------ optimizer
class TwoPart(torch.nn.Module):
    """Parameters named encoder.* and head.*, like the model's."""

    def __init__(self, enc, head):
        super().__init__()
        self.encoder = torch.nn.Module()
        self.encoder.w = torch.nn.Parameter(torch.from_numpy(enc.copy()))
        self.head = torch.nn.Module()
        self.head.w = torch.nn.Parameter(torch.from_numpy(head.copy()))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("clip_norm", [0.0, 0.5, 100.0])
@pytest.mark.parametrize("mult", [1.0, 0.1])
def test_two_optimizer_steps_match_optax(optimizer, clip_norm, mult):
    """clip 0.5 is active (gradient norms ~4), 100.0 inactive, 0.0 off."""
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((4, 3)).astype(np.float32)
    head = rng.standard_normal((5,)).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal((5,)).astype(np.float32))
             for _ in range(2)]
    kw = dict(optimizer=optimizer, clip_norm=clip_norm, encoder_lr_mult=mult,
              lr=0.05, lr_decay_every=1, lr_decay_rate=0.5)
    # steps_per_epoch 1 with decay every epoch: the two steps differ in lr.
    tx, _ = jax_make_optimizer(jax_get_config("synthetic_tiny").train
                               .__class__(**kw), 1)
    params = {"encoder": {"w": jnp.asarray(enc)},
              "head": {"w": jnp.asarray(head)}}
    opt_state = tx.init(params)
    for ge, gh in grads:
        updates, opt_state = tx.update(
            {"encoder": {"w": jnp.asarray(ge)}, "head": {"w": jnp.asarray(gh)}},
            opt_state, params)
        params = optax.apply_updates(params, updates)

    cfg = TrainConfig(**kw)
    model = TwoPart(enc, head)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(cfg, model))
    for ge, gh in grads:
        model.encoder.w.grad = torch.from_numpy(ge.copy())
        model.head.w.grad = torch.from_numpy(gh.copy())
        state.apply_gradients(make_lr_schedule(cfg, 1), cfg.clip_norm)
    assert state.step == 2
    for got, want in ((model.encoder.w, params["encoder"]["w"]),
                      (model.head.w, params["head"]["w"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_lr_schedule_is_keyed_to_the_step():
    cfg = TrainConfig(lr=0.01, lr_decay_every=5, lr_decay_rate=0.2)
    schedule = make_lr_schedule(cfg, steps_per_epoch=10)
    assert schedule(0) == schedule(49) == 0.01
    assert schedule(50) == pytest.approx(0.002)
    assert schedule(100) == pytest.approx(0.0004)


# ------------------------------------------------------------ data
def test_synthetic_records_and_wire_format_match_jax():
    cfg = get_config("synthetic_tiny")
    ours = make_dataset(cfg.data, "val", seed=3)
    theirs = jax_make_dataset(jax_get_config("synthetic_tiny").data, "val",
                              seed=3)
    for i in (0, 5):
        a, b = ours.get(i), theirs.get(i)
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
        np.testing.assert_array_equal(a["depth"], b["depth"])
    packed = pack_batch({"rgb": a["rgb"][None], "depth": a["depth"][None]})
    assert packed["rgb"].dtype == np.uint8
    assert packed["depth"].dtype == np.uint16
    np.testing.assert_allclose(packed["depth"][0] / DEPTH_SCALE, a["depth"],
                               atol=0.5 / DEPTH_SCALE)


def test_iterators_are_deterministic_and_pad_the_last_eval_batch():
    cfg = get_config("synthetic_tiny")
    ds = make_dataset(cfg.data, "train")

    def epoch(e):
        it = make_train_iterator(ds, global_batch=4, epoch=e, seed=1,
                                 num_workers=2, steps=3)
        try:
            return [b["depth"] for b in it]
        finally:
            it.close()

    first, again, other = epoch(0), epoch(0), epoch(1)
    assert len(first) == 3
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(first, other))

    val = make_dataset(cfg.data, "val")
    val.length = 5
    it = make_eval_iterator(val, global_batch=4, num_workers=2)
    try:
        batches = list(it)
    finally:
        it.close()
    assert [b["valid_image"].tolist() for b in batches] == [
        [1, 1, 1, 1], [1, 0, 0, 0]]
    assert (batches[1]["depth"][1:] == 0).all()


class _IndexRecords:
    """n records whose pixels hold their own index, so that a batch names
    the records it was built from."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i: int, epoch: int = 0) -> dict[str, np.ndarray]:
        return {"rgb": np.full((1, 1, 3), i, np.uint8),
                "depth": np.full((1, 1), i, np.uint16)}


def _record_indices(make, n, global_batch, epoch, rank, ranks, steps=3):
    it = make(_IndexRecords(n), global_batch=global_batch, epoch=epoch,
              seed=0, num_workers=2, steps=steps, process_index=rank,
              process_count=ranks)
    try:
        return [b["depth"][:, 0, 0].tolist() for b in it]
    finally:
        it.close()


@pytest.mark.parametrize("n,global_batch,ranks", [
    (4, 8, 1), (4, 8, 2), (4, 8, 4), (6, 8, 4), (16, 8, 2)])
def test_train_iterator_ranks_take_jax_records(n, global_batch, ranks):
    """Each rank's record indices, step by step, are JAX's, also with fewer
    records than the global batch (the step's offset is reduced modulo n
    before the rank's is added); n=16 is the control where the two orders
    agree."""
    for epoch in (0, 1):
        for rank in range(ranks):
            assert _record_indices(make_train_iterator, n, global_batch,
                                   epoch, rank, ranks) == _record_indices(
                jax_make_train_iterator, n, global_batch, epoch, rank,
                ranks), (epoch, rank)


def test_unported_datasets_and_samplers_raise():
    # Mixed NYU + KITTI batches (host8_dp) are not ported; the NYU readers
    # are (tests/test_torch_nyu.py).
    cfg = get_config("host8_dp").override(**{"mesh.data": 1})
    with pytest.raises(NotImplementedError):
        Trainer(cfg, device="cpu")
    tiny = get_config("synthetic_tiny").override(**{"data.sampler": "stereo"})
    trainer = Trainer(tiny, device="cpu")
    with pytest.raises(NotImplementedError):
        trainer._sample_sparse(None, torch.ones(1, 4, 4),
                               torch.ones(1, 4, 4, 3))


# ------------------------------------------------------------ train steps
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer on synthetic_tiny (float32, plain stem) from
    randomized weights: the state before and after one and two train
    steps on one batch with an injected sparse map, and the eval sums
    and prediction of that batch after two steps."""
    work = str(tmp_path_factory.mktemp("jax_train"))
    cfg = jax_get_config("synthetic_tiny").override(**{
        **TINY, "model.packed_stem": False, "train.checkpoint_dir": work})
    trainer = JaxTrainer(cfg)
    init = trainer.init_state()
    variables = randomize(jax.device_get(
        {"params": init.params, "batch_stats": init.batch_stats}), 0)
    ds = trainer.train_ds
    recs = [ds.get(i) for i in range(cfg.train.batch_size)]
    batch = {k: np.stack([r[k] for r in recs]) for k in ("rgb", "depth")}
    rng = np.random.default_rng(0)
    sparse = np.where(rng.random(batch["depth"].shape) < 0.01,
                      batch["depth"], 0.0).astype(np.float32)
    trainer._sample_sparse = lambda key, depth, rgb: jnp.asarray(sparse)
    key = jax.random.PRNGKey(0)
    state = create_train_state(variables, trainer.tx)
    states, losses = [], []
    for _ in range(2):
        state, loss, _ = trainer.train_step(state, batch, key)
        states.append(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}))
        losses.append(float(loss))
    eval_batch = dict(batch, valid_image=np.ones(len(recs), np.float32))
    sums, pred = trainer.eval_step(state, eval_batch, key, 0)
    return dict(variables=variables, batch=batch, sparse=sparse,
                states=states, losses=losses, eval_batch=eval_batch,
                eval_sums=jax.device_get(sums), eval_pred=np.asarray(pred))


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's Trainer, the same weights, batch and sparse map."""
    trainer = Trainer(get_config("synthetic_tiny").override(**TINY),
                      device="cpu")
    sparse = torch.from_numpy(jax_run["sparse"])
    trainer._sample_sparse = lambda gen, depth, rgb: sparse
    state = trainer.init_state(jax_run["variables"])
    states, losses = [], []
    for _ in range(2):
        state, loss, _ = trainer.train_step(state, jax_run["batch"])
        states.append(jax_variables(state.model))
        losses.append(float(loss))
    sums, pred = trainer.eval_step(state, jax_run["eval_batch"], 0)
    return dict(states=states, losses=losses, eval_sums=sums,
                eval_pred=pred.numpy(), step=state.step)


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax_leaf_by_leaf(jax_run, port_run, steps):
    assert port_run["losses"][steps - 1] == pytest.approx(
        jax_run["losses"][steps - 1], rel=LOSS_TOL)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax_run["states"][steps - 1]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        port_run["states"][steps - 1]))
    assert got.keys() == want.keys()
    init = dict(jax.tree_util.tree_leaves_with_path(jax_run["variables"]))
    for path, leaf in want.items():
        name = jax.tree_util.keystr(path)
        assert max_rel(got[path], leaf) <= STATE_TOL, name
    # The step moved every BN statistic: the check above is not vacuous.
    stats = [p for p in want if jax.tree_util.keystr(p).startswith(
        "['batch_stats']")]
    assert all(np.abs(want[p] - init[p]).max() > 1e-4 for p in stats)
    assert port_run["step"] == 2


def test_eval_step_matches_jax(jax_run, port_run):
    got, want = port_run["eval_sums"], jax_run["eval_sums"]
    for f in dataclasses.fields(got):
        if f.name != "protocol":
            np.testing.assert_allclose(float(getattr(got, f.name)),
                                       float(getattr(want, f.name)),
                                       rtol=1e-4)
    assert max_rel(port_run["eval_pred"], jax_run["eval_pred"]) <= 1e-4


def test_train_epoch_and_evaluate_run_on_synthetic_data(tmp_path):
    cfg = get_config("synthetic_tiny").override(**{
        **TINY, "train.steps_per_epoch": 2, "train.log_every": 1,
        "train.checkpoint_dir": str(tmp_path)})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    logs = []
    state, metrics = trainer.train_epoch(state, 0, log=logs.append)
    assert state.step == 2 and len(metrics["step_losses"]) == 2
    assert len(logs) == 2 and np.isfinite(metrics["loss"])
    assert metrics["n_images"] == 2 * cfg.train.batch_size
    assert metrics["lr"] == cfg.train.lr
    trainer.val_ds.length = 3
    ev = trainer.evaluate(state, log=logs.append)
    assert ev["n_images"] == 3 and np.isfinite(ev["rmse"])
    assert 0.0 <= ev["delta1"] <= 1.0
