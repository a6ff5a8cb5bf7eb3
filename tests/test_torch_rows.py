"""The rows layout (parallel/rows.py, the model and the Trainer with every
feature map sharded over H on "spatial") on gloo ranks on the CPU.

* The row operations on a 1x4 spatial group against the unsharded op on
  the whole map, forward and every gradient (input, skip, weight), within
  1e-6 max-relative in float32: `conv2d_rows` at k 1/3/5/7 and stride 1/2
  (the 1x1 stride-2 projection among them, whose input rows may lie on
  another rank), the stem's conv from the whole input, `max_pool_rows`,
  and `unpool_cat_rows` under a 5x5 conv cropped to the skip's height, on
  levels of 11, 22 and 57 rows (ceil(H / 4) a rank, the last the
  remainder). A level on which a rank would hold no rows is refused,
  naming the level.
* The Trainer on rows (kitti_1216 cut to synthetic_tiny's arch in float32
  at 128x48, T = 6, tests/test_torch_dist_train.py's setup): one and two
  train steps and an eval step at 2x4 with batch 4 and 2x2 with batch 2,
  where the batch splits over mesh.data only, so that "auto" takes rows;
  against the JAX Trainer on the same mesh of forced host devices (its
  GSPMD shards every feature map over "spatial") and against the port's
  1x1 Trainer, within the tolerances of that file (state 1e-4 of each
  leaf's largest value, loss 1e-5, eval sums 1e-4); every rank's state
  bit for bit rank 0's; each rank's sparse samples those of its data
  group's images on one device; an epoch and an evaluation through the
  iterators (the last eval batch padded, the panel's rows gathered).

Each mesh's ranks run in one spawn (parallel/launch.py); they import this
module without JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from cspn_monodepth_tpu_torch.configs import MeshConfig
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.models.unet import _unpool_cat
from cspn_monodepth_tpu_torch.parallel import Mesh, make_mesh, spawn_ranks
from cspn_monodepth_tpu_torch.parallel.rows import (
    Rows,
    conv2d_rows,
    conv2d_window,
    max_pool_rows,
    row_range,
    unpool_cat_rows,
)
from cspn_monodepth_tpu_torch.train import Trainer
from test_torch_dist_train import (
    DEADLINE_S,
    DELTA_ATOL,
    EVAL_IMAGES,
    LOSS_TOL,
    SUMS_TOL,
    assert_states_close,
    leaves,
    port_config,
    run_steps,
)

OP_TOL = 1e-6
SPATIAL = 4
B, C, W = 2, 3, 9
# (op, height, kernel, stride): the input level's height, the output's
# for the unpool cases; 11, 22 and 57 rows split as (3, 3, 3, 2),
# (6, 6, 6, 4) and (15, 15, 15, 12) on 4 ranks.
OP_CASES = (
    [("conv", h, k, st) for k in (1, 3, 5, 7) for st in (1, 2)
     for h in (11, 22, 57) if (h, st) != (11, 2)]
    + [("stem", 57, 7, 2), ("pool", 22, 3, 2), ("pool", 57, 3, 2),
       ("unpool", 22, 5, 1), ("unpool", 44, 5, 1), ("unpool", 57, 5, 1),
       ("unpool_noskip", 57, 5, 1)])
ROWS_MESHES = {(2, 4): 4, (2, 2): 2}   # mesh -> global batch (rows)


def case_id(case):
    return "{}-h{}-k{}-s{}".format(*case)


def op_inputs(case):
    """The whole-map inputs of a case, from a seed: x (its level), the
    skip (unpool cases: the output's level, x the coarser one of
    ceil(h / 2) rows), the conv and the cotangent of the output."""
    name, h, k, st = case
    rng = np.random.default_rng(OP_CASES.index(case))
    h_in = -(-h // 2) if name.startswith("unpool") else h
    cin = C + (C if name == "unpool" else 0)
    conv = nn.Conv2d(cin, 4, k, st, padding=k // 2, bias=name == "stem")
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                     .astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((B, C, h_in, W))
                         .astype(np.float32))
    skip = torch.from_numpy(rng.standard_normal((B, C, h, W))
                            .astype(np.float32))
    out = whole_op(case, conv, x, skip)
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    return conv, x, skip, cot


def whole_op(case, conv, x, skip):
    name, h = case[:2]
    if name == "pool":
        return F.max_pool2d(x, 3, 2, 1)
    if name.startswith("unpool"):
        cat = _unpool_cat(x, skip if name == "unpool" else None)
        return conv(cat)[:, :, :h, :W]
    return conv(x)


def rows_op(case, conv, x, skip, mesh):
    """The case's op on this rank's rows: returns (out rows, the inputs
    whose gradients are compared)."""
    name, h = case[:2]
    if name == "stem":
        x = x.clone().requires_grad_()
        return conv2d_rows(x, conv, Rows(mesh, h), whole=True), [x]
    if name.startswith("unpool"):
        rows_x, out = Rows(mesh, x.shape[-2]), Rows(mesh, h)
        x = x[..., slice(*rows_x.range), :].clone().requires_grad_()
        if name == "unpool":
            skip = skip[..., slice(*out.range), :].clone().requires_grad_()
        win = unpool_cat_rows(x, rows_x, out, 2,
                              skip if name == "unpool" else None)
        y = conv2d_window(win, conv)[..., :W]
        return y, [x, skip] if name == "unpool" else [x]
    rows = Rows(mesh, h)
    x = x[..., slice(*rows.range), :].clone().requires_grad_()
    if name == "pool":
        return max_pool_rows(x, rows), [x]
    return conv2d_rows(x, conv, rows), [x]


def _rank_ops(rank):
    mesh = make_mesh(MeshConfig(data=1, spatial=SPATIAL), device="cpu")
    out = {}
    for case in OP_CASES:
        conv, x, skip, cot = op_inputs(case)
        y, inputs = rows_op(case, conv, x, skip, mesh)
        lo, hi = row_range(cot.shape[-2], SPATIAL, mesh.s)
        (y * cot[..., lo:hi, :]).sum().backward()
        out[case] = dict(y=y.detach().numpy(),
                         grads=[t.grad.numpy() for t in inputs],
                         weight=(None if conv.weight.grad is None
                                 else conv.weight.grad.numpy()))
    return out


@pytest.fixture(scope="module")
def op_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("rows_ops")
    return spawn_ranks(_rank_ops, SPATIAL, timeout=DEADLINE_S,
                       init_file=str(work / "rendezvous"))


def max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", OP_CASES, ids=case_id)
def test_row_op_matches_the_whole_map(op_ranks, case):
    conv, x, skip, cot = op_inputs(case)
    x.requires_grad_()
    skip.requires_grad_()
    y = whole_op(case, conv, x, skip)
    (y * cot).sum().backward()
    got = [r[case] for r in op_ranks]
    assert max_rel(np.concatenate([g["y"] for g in got], axis=-2),
                   y.detach().numpy()) <= OP_TOL
    if case[0] == "stem":       # every rank's gradient of the whole input
        dx = sum(g["grads"][0] for g in got)
    else:
        dx = np.concatenate([g["grads"][0] for g in got], axis=-2)
    assert max_rel(dx, x.grad.numpy()) <= OP_TOL
    if case[0] == "unpool":
        assert max_rel(np.concatenate([g["grads"][1] for g in got], axis=-2),
                       skip.grad.numpy()) <= OP_TOL
    if case[0] != "pool":
        assert max_rel(sum(g["weight"] for g in got),
                       conv.weight.grad.numpy()) <= OP_TOL


def fake_mesh(data, spatial, rank=0):
    """A mesh position without process groups, for what runs before any
    collective."""
    return Mesh(data=data, spatial=spatial, rank=rank, world_group=None,
                data_group=None, spatial_group=None,
                device=torch.device("cpu"))


@pytest.mark.parametrize("height,refused", [(5, True), (6, True),
                                            (7, False), (11, False)])
def test_a_level_with_a_rank_without_rows_is_refused(height, refused):
    if not refused:
        assert Rows(fake_mesh(1, 4), height).ranges()[-1][1] == height
        return
    with pytest.raises(ValueError, match=f"level /8 of {height} rows"):
        Rows(fake_mesh(1, 4), height, "/8")


def test_the_model_refuses_a_level_without_rows_by_name():
    """64 rows on spatial 4 leave /32 with 2 rows: refused before any
    exchange (the JAX Trainer disagrees with itself there)."""
    model = CSPNDepthNet(arch=None, encoder_stages=(1, 1, 1, 1),
                         encoder_width=16, decoder_channels=(32, 24, 16, 16),
                         decoder_out=16, dtype="float32",
                         spatial_mesh=fake_mesh(2, 4), layout="rows")
    with pytest.raises(ValueError, match="level /32 of 2 rows"):
        model(torch.zeros(1, 64, 48, 4))


@pytest.mark.parametrize("layout,mesh,match", [
    ("rows", None, "needs a spatial axis"),
    ("auto", fake_mesh(2, 4), "unknown layout")])
def test_the_model_takes_only_a_resolved_layout(layout, mesh, match):
    """The Trainer resolves "auto" (parallel/mesh.py choose_layout); the
    model takes "images" or "rows", and rows only with a spatial mesh."""
    with pytest.raises(ValueError, match=match):
        CSPNDepthNet(arch=None, encoder_stages=(1, 1, 1, 1),
                     encoder_width=16, decoder_channels=(32, 24, 16, 16),
                     decoder_out=16, dtype="float32", spatial_mesh=mesh,
                     layout=layout)


# ------------------------------------------------------------ the model
MODEL_HW = (99, 40)     # full resolution 50 + 49 rows on 2 ranks; /4 13 + 12,
                        # /8 7 + 6, /16 4 + 3: uneven shares at every level
MODEL_TOL = 1e-5
# The repo's gradient bar (kernels' gradients, PERF.md section 2): the
# rows' BatchNorm takes flax's E[x^2] - E[x]^2, the whole image's torch's
# two-pass variance, which moves a BN bias gradient by ~1e-5.
GRAD_TOL = 1e-4
TINY_NET = dict(arch=None, encoder_stages=(1, 1, 1, 1), encoder_width=16,
                decoder_channels=(32, 24, 16, 16), decoder_out=16,
                dtype="float32", num_iters=6)


def model_problem():
    """The tiny network's weights (seeded init, a random head so that the
    CSPN is not the identity), a train-mode input of 2 images with sparse
    anchors and the cotangent of the output."""
    rng = np.random.default_rng(11)
    model = CSPNDepthNet(**TINY_NET)
    with torch.no_grad():
        model.head.weight.copy_(torch.from_numpy(
            0.05 * rng.standard_normal(model.head.weight.shape)))
        model.head.bias.copy_(torch.from_numpy(
            np.r_[0.5, 0.1 * rng.standard_normal(8)]))
    h, w = MODEL_HW
    rgb = rng.random((2, h, w, 3))
    sparse = np.where(rng.random((2, h, w, 1)) < 0.05,
                      rng.uniform(0.5, 9.5, (2, h, w, 1)), 0.0)
    x = torch.from_numpy(np.concatenate([rgb, sparse], -1).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, h, w, 1))
                           .astype(np.float32))
    return model.state_dict(), x, cot


def model_step(model, x, cot):
    """Train-mode forward and backward: the output, every parameter's
    gradient and the BN statistics it updated."""
    out = model.train()(x)
    (out * cot).sum().backward()
    return dict(out=out.detach().numpy(),
                grads={n: p.grad.numpy() for n, p in model.named_parameters()},
                buffers={n: b.numpy() for n, b in model.named_buffers()})


def _rank_model(rank):
    mesh = make_mesh(MeshConfig(data=1, spatial=2), device="cpu")
    weights, x, cot = model_problem()
    model = CSPNDepthNet(**TINY_NET, bn_group=mesh.world_group,
                         spatial_mesh=mesh, layout="rows")
    model.load_state_dict(weights)
    lo, hi = row_range(MODEL_HW[0], 2, mesh.s)
    return model_step(model, x, cot[:, lo:hi])


def test_the_model_on_uneven_rows_matches_the_whole_image(tmp_path):
    """The network in train mode on 2 ranks whose shares differ at every
    level (BatchNorm's count all-reduced, the last shard's CSPN rows
    zero-padded), against one model on the whole images: the output and
    the BN statistics within 1e-5 max-relative, every parameter's gradient
    (summed over the ranks) within 1e-4."""
    ranks = spawn_ranks(_rank_model, 2, timeout=DEADLINE_S,
                        init_file=str(tmp_path / "rendezvous"))
    weights, x, cot = model_problem()
    model = CSPNDepthNet(**TINY_NET)
    model.load_state_dict(weights)
    want = model_step(model, x, cot)
    assert max_rel(np.concatenate([r["out"] for r in ranks], axis=1),
                   want["out"]) <= MODEL_TOL
    for name, g in want["grads"].items():
        assert max_rel(sum(r["grads"][name] for r in ranks), g) \
            <= GRAD_TOL, name
    for name, b in want["buffers"].items():
        for r in ranks:
            if name.endswith("num_batches_tracked"):
                assert r["buffers"][name] == b
            else:
                assert max_rel(r["buffers"][name], b) <= MODEL_TOL, name


# ------------------------------------------------------------ the Trainer
def _rank_rows_run(rank, data, spatial, variables, batch, sparse, workdir):
    cfg = port_config(data, spatial, len(sparse)).override(
        **{"train.checkpoint_dir": workdir})
    trainer = Trainer(cfg, device="cpu")
    assert trainer.layout == "rows"
    b = len(sparse) // data
    mine = slice(trainer.mesh.d * b, (trainer.mesh.d + 1) * b)
    local = {k: v[mine] for k, v in batch.items()}
    drawn = trainer._sample_sparse(trainer._rng(0, 0),
                                   torch.from_numpy(local["depth"]), None)
    out = run_steps(trainer, variables, local, sparse[mine],
                    dict(local, valid_image=np.ones(b, np.float32)))
    out["drawn"] = drawn.numpy()

    trainer = Trainer(cfg.override(**{"train.steps_per_epoch": 1}),
                      device="cpu")
    state, metrics = trainer.train_epoch(trainer.init_state(variables), 0,
                                         log=lambda *a: None)
    trainer.val_ds.length = EVAL_IMAGES
    ev = trainer.evaluate(state, log=lambda *a: None)
    out["epoch"] = dict(loss=metrics["loss"], n_images=metrics["n_images"],
                        eval_n_images=ev["n_images"], eval_rmse=ev["rmse"],
                        panel=trainer.last_panel)
    return out


@pytest.fixture(scope="module")
def rows_setup(tmp_path_factory):
    """The JAX Trainer's states on each mesh at its rows batch, the port's
    1x1 Trainer on the same batch, and the port's ranks on rows."""
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.configs import get_config as jax_get_config
    from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer
    from cspn_monodepth_tpu.train.train_state import create_train_state
    from test_torch_dist_train import TINY
    from test_torch_model import randomize

    setup, out = None, {}
    for (data, spatial), batch_size in ROWS_MESHES.items():
        work = tmp_path_factory.mktemp("rows_train")
        cfg = jax_get_config("kitti_1216").override(**{
            **TINY, "model.packed_stem": False, "mesh.data": data,
            "mesh.spatial": spatial, "train.batch_size": batch_size,
            "train.checkpoint_dir": str(work / "jax")})
        trainer = JaxTrainer(cfg)
        if setup is None:
            init = trainer.init_state()
            variables = randomize(jax.device_get(
                {"params": init.params, "batch_stats": init.batch_stats}), 0)
            recs = [trainer.train_ds.get(i) for i in range(max(
                ROWS_MESHES.values()))]
            batch = {k: np.stack([r[k] for r in recs])
                     for k in ("rgb", "depth")}
            rng = np.random.default_rng(0)
            sparse = np.where(rng.random(batch["depth"].shape) < 0.05,
                              batch["depth"], 0.0).astype(np.float32)
            setup = dict(variables=variables, batch=batch, sparse=sparse)
        b = {k: v[:batch_size] for k, v in setup["batch"].items()}
        sp = setup["sparse"][:batch_size]
        trainer._sample_sparse = lambda key, depth, rgb, sp=sp: \
            jnp.asarray(sp)
        state = create_train_state(setup["variables"], trainer.tx)
        states, losses = [], []
        for _ in range(2):
            state, loss, _ = trainer.train_step(state, b,
                                                jax.random.PRNGKey(0))
            states.append(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats}))
            losses.append(float(loss))
        single = Trainer(port_config(1, 1, batch_size), device="cpu")
        drawn = single._sample_sparse(single._rng(0, 0),
                                      torch.from_numpy(b["depth"]), None)
        one = run_steps(single, setup["variables"], b, sp,
                        dict(b, valid_image=np.ones(batch_size, np.float32)))
        one["drawn"] = drawn.numpy()

        ranks = spawn_ranks(
            _rank_rows_run, data * spatial, data, spatial,
            setup["variables"], b, sp, str(work / "workdir"),
            timeout=DEADLINE_S, init_file=str(work / "rendezvous"))
        out[(data, spatial)] = dict(jax=dict(states=states, losses=losses),
                                    single=one, ranks=ranks)
    return out


MESH_IDS = [f"{d}x{s}" for d, s in ROWS_MESHES]


@pytest.mark.parametrize("mesh", list(ROWS_MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("steps", [1, 2])
def test_rows_steps_match_jax_on_the_same_mesh(rows_setup, mesh, steps):
    got = rows_setup[mesh]["ranks"][0]
    want = rows_setup[mesh]["jax"]
    assert got["losses"][steps - 1] == pytest.approx(
        want["losses"][steps - 1], rel=LOSS_TOL)
    assert_states_close(got["states"][steps - 1],
                        {k: dict(v) for k, v in
                         want["states"][steps - 1].items()})


@pytest.mark.parametrize("mesh", list(ROWS_MESHES), ids=MESH_IDS)
@pytest.mark.parametrize("steps", [1, 2])
def test_rows_steps_match_one_device(rows_setup, mesh, steps):
    got = rows_setup[mesh]["ranks"][0]
    want = rows_setup[mesh]["single"]
    assert got["losses"][steps - 1] == pytest.approx(
        want["losses"][steps - 1], rel=LOSS_TOL)
    assert_states_close(got["states"][steps - 1], want["states"][steps - 1])
    assert got["step"] == 2


@pytest.mark.parametrize("mesh", list(ROWS_MESHES), ids=MESH_IDS)
def test_rows_every_rank_holds_rank_zeros_state(rows_setup, mesh):
    ranks = rows_setup[mesh]["ranks"]
    first = [leaves(s) for s in ranks[0]["states"]]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for mine, theirs in zip((leaves(s) for s in r["states"]), first):
            assert all(np.array_equal(mine[p], theirs[p]) for p in theirs)


@pytest.mark.parametrize("mesh", list(ROWS_MESHES), ids=MESH_IDS)
def test_rows_eval_sums_are_the_global_batch(rows_setup, mesh):
    want = rows_setup[mesh]["single"]["sums"]
    assert want["n_images"] == ROWS_MESHES[mesh]
    for r in rows_setup[mesh]["ranks"]:
        for name, w in want.items():
            atol = DELTA_ATOL if name.startswith("delta") else 0.0
            np.testing.assert_allclose(r["sums"][name], w, rtol=SUMS_TOL,
                                       atol=atol, err_msg=name)


@pytest.mark.parametrize("mesh", list(ROWS_MESHES), ids=MESH_IDS)
def test_rows_sparse_samples_are_the_data_groups(rows_setup, mesh):
    data, spatial = mesh
    want = rows_setup[mesh]["single"]["drawn"]
    b = len(want) // data
    assert (want > 0).any()
    for rank, r in enumerate(rows_setup[mesh]["ranks"]):
        d = rank // spatial
        np.testing.assert_array_equal(r["drawn"], want[d * b:(d + 1) * b])


@pytest.mark.parametrize("mesh", list(ROWS_MESHES), ids=MESH_IDS)
def test_rows_epoch_and_evaluate_take_each_groups_share(rows_setup, mesh):
    ranks = rows_setup[mesh]["ranks"]
    first = ranks[0]["epoch"]
    assert first["n_images"] == ROWS_MESHES[mesh]
    assert first["eval_n_images"] == EVAL_IMAGES
    assert np.isfinite(first["loss"]) and np.isfinite(first["eval_rmse"])
    # Rank 0 saved a panel of whole images: rgb | gt | pred, 128 rows each.
    assert first["panel"] is not None and first["panel"].shape[0] == (
        min(4, ROWS_MESHES[mesh] // mesh[0]) * 128)
    for r in ranks[1:]:
        assert {k: r["epoch"][k] for k in ("loss", "n_images",
                                           "eval_n_images", "eval_rmse")} \
            == {k: first[k] for k in ("loss", "n_images", "eval_n_images",
                                      "eval_rmse")}
