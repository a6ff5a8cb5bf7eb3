"""The port's Trainer on a data x spatial mesh of gloo ranks on the CPU
against the JAX Trainer on the same mesh of forced host devices and
against the port's one-device Trainer on the same global batch.

Setup: kitti_1216 cut to synthetic_tiny's arch in float32 at 128x48 (the
H axis splits into 32-row shards on spatial 4), T = 6 CSPN iterations (a
round of 4 and a remainder of 2), synthetic records, the JAX model with its
plain stem, the same randomized weights on every side and an injected
sparse map (each rank its own images' share). The JAX Trainer on a spatial
mesh runs its CSPN through its slab kernels, interpreted. (At 64 rows the
JAX Trainer on spatial 4, whose /32 feature map then has 2 rows for 4
shards, does not agree with itself on one device: ROADMAP.md section 3.)

Each mesh's ranks run in one spawn (parallel/launch.py: file rendezvous
under tmp_path, a deadline after which every rank is killed); they import
this module without JAX, which only the pytest process imports.
* (a) one and two train steps at meshes 2x4 (batch 8) and 2x2 (batch 4):
  rank 0's parameters and BN statistics leaf by leaf within 1e-4 of the
  largest value of the leaf, and the loss within 1e-5, against the JAX
  Trainer on the mesh and against the port's 1x1 Trainer;
* (b) every rank's state equals rank 0's bit for bit;
* (c) one eval_step's all-reduced metric sums equal the 1x1 run's within
  1e-4 (the delta shares within two pixels of an image: one pixel's
  prediction rounds across 1.25^2 on the 2x4 mesh);
* the Trainer's own sparse sampler on each rank draws exactly the 1x1
  sampler's samples of its images;
* train_epoch and evaluate through the iterators, each rank its share:
  the global batch's metrics, equal on every rank;
* at 2x4 (batch 8), the same two steps and eval step with every feature
  map on rows (`layout="rows"`, tests/test_torch_rows.py): within the
  same tolerances of the whole-image layout's on the same batch;
* "auto" takes the whole-image layout where the batch splits over every
  rank, the rows layout where it splits over mesh.data only (batch 12 on
  2x4), and a batch that does not split over mesh.data is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import jax_variables
from cspn_monodepth_tpu_torch.parallel import Mesh, spawn_ranks
from cspn_monodepth_tpu_torch.train import Trainer

STATE_TOL = 1e-4
LOSS_TOL = 1e-5
SUMS_TOL = 1e-4
TINY = {"model.dtype": "float32", "model.arch": "",
        "model.encoder_stages": (1, 1, 1, 1), "model.encoder_width": 16,
        "model.decoder_channels": (32, 24, 16, 16), "model.decoder_out": 16,
        "model.num_iters": 6, "data.dataset": "synthetic",
        "data.height": 128, "data.width": 48, "data.num_workers": 1}
# Two pixels of one image at a delta threshold.
DELTA_ATOL = 2.0 / (TINY["data.height"] * TINY["data.width"])
MESHES = {(2, 4): 8, (2, 2): 4}       # mesh -> global batch
ROWS_VS_IMAGES = (2, 4)
EVAL_IMAGES = 5
DEADLINE_S = 300


def port_config(data, spatial, batch_size):
    return get_config("kitti_1216").override(**{
        **TINY, "mesh.data": data, "mesh.spatial": spatial,
        "train.batch_size": batch_size})


def run_steps(trainer, variables, batch, sparse, eval_batch):
    """Two train steps from `variables` with the sparse map injected, then
    one eval step: the states, losses and eval sums, in numpy."""
    trainer._sample_sparse = lambda gen, depth, rgb: torch.from_numpy(sparse)
    state = trainer.init_state(variables)
    states, losses = [], []
    for _ in range(2):
        state, loss, _ = trainer.train_step(state, batch)
        states.append(jax_variables(state.model))
        losses.append(float(loss))
    sums, _ = trainer.eval_step(state, eval_batch, 0)
    return dict(states=states, losses=losses, step=state.step,
                sums={f.name: float(getattr(sums, f.name))
                      for f in dataclasses.fields(sums)
                      if f.name != "protocol"})


def _rank_run(rank, data, spatial, variables, batch, sparse, workdir):
    cfg = port_config(data, spatial, len(sparse)).override(
        **{"train.checkpoint_dir": workdir})
    trainer = Trainer(cfg, device="cpu")
    b = len(sparse) // trainer.mesh.size
    mine = slice(rank * b, (rank + 1) * b)
    local = {k: v[mine] for k, v in batch.items()}
    drawn = trainer._sample_sparse(trainer._rng(0, 0),
                                   torch.from_numpy(local["depth"]), None)
    out = run_steps(trainer, variables, local, sparse[mine],
                    dict(local, valid_image=np.ones(b, np.float32)))
    out["drawn"] = drawn.numpy()
    assert trainer.layout == "images"
    if (data, spatial) == ROWS_VS_IMAGES:
        # Every feature map on rows: the data group's images on every
        # rank of the group.
        rows = Trainer(cfg, device="cpu", layout="rows")
        n = b * spatial
        group = slice(rows.mesh.d * n, (rows.mesh.d + 1) * n)
        out["rows"] = run_steps(
            rows, variables, {k: v[group] for k, v in batch.items()},
            sparse[group], {**{k: v[group] for k, v in batch.items()},
                            "valid_image": np.ones(n, np.float32)})

    # An epoch of one step and an evaluation of 5 images (the last batch
    # padded) through the iterators, each rank taking its share.
    trainer = Trainer(cfg.override(**{"train.steps_per_epoch": 1}),
                      device="cpu")
    state, metrics = trainer.train_epoch(trainer.init_state(variables), 0,
                                         log=lambda *a: None)
    trainer.val_ds.length = EVAL_IMAGES
    ev = trainer.evaluate(state, log=lambda *a: None)
    out["epoch"] = dict(loss=metrics["loss"], n_images=metrics["n_images"],
                        eval_n_images=ev["n_images"], eval_rmse=ev["rmse"],
                        last_param=[p.detach().numpy().copy()
                                for p in state.model.parameters()][-1])
    return out


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory):
    """The randomized weights, the batch of synthetic records and the
    sparse map, and the JAX Trainer's states on each mesh."""
    import jax
    import jax.numpy as jnp

    from cspn_monodepth_tpu.configs import get_config as jax_get_config
    from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer
    from cspn_monodepth_tpu.train.train_state import create_train_state
    from test_torch_model import randomize

    setup, runs = None, {}
    for (data, spatial), batch_size in MESHES.items():
        work = str(tmp_path_factory.mktemp("jax_dist"))
        cfg = jax_get_config("kitti_1216").override(**{
            **TINY, "model.packed_stem": False, "mesh.data": data,
            "mesh.spatial": spatial, "train.batch_size": batch_size,
            "train.checkpoint_dir": work})
        trainer = JaxTrainer(cfg)
        if setup is None:
            init = trainer.init_state()
            variables = randomize(jax.device_get(
                {"params": init.params, "batch_stats": init.batch_stats}), 0)
            recs = [trainer.train_ds.get(i) for i in range(max(
                MESHES.values()))]
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
        runs[(data, spatial)] = dict(states=states, losses=losses)
    return dict(setup, runs=runs)


@pytest.fixture(scope="module")
def single(jax_setup):
    """The port's 1x1 Trainer on each global batch."""
    out = {}
    for mesh, batch_size in MESHES.items():
        batch = {k: v[:batch_size] for k, v in jax_setup["batch"].items()}
        trainer = Trainer(port_config(1, 1, batch_size), device="cpu")
        drawn = trainer._sample_sparse(
            trainer._rng(0, 0), torch.from_numpy(batch["depth"]), None)
        out[mesh] = run_steps(
            trainer, jax_setup["variables"], batch,
            jax_setup["sparse"][:batch_size],
            dict(batch, valid_image=np.ones(batch_size, np.float32)))
        out[mesh]["drawn"] = drawn.numpy()
    return out


@pytest.fixture(scope="module", params=list(MESHES),
                ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, jax_setup, tmp_path_factory):
    data, spatial = request.param
    batch_size = MESHES[request.param]
    work = tmp_path_factory.mktemp("dist_train")
    results = spawn_ranks(
        _rank_run, data * spatial, data, spatial, jax_setup["variables"],
        {k: v[:batch_size] for k, v in jax_setup["batch"].items()},
        jax_setup["sparse"][:batch_size], str(work / "workdir"),
        timeout=DEADLINE_S, init_file=str(work / "rendezvous"))
    return dict(mesh=request.param, results=results)


def leaves(tree, prefix=""):
    """{path: array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float64)
    return out


def assert_states_close(got, want):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= STATE_TOL * np.abs(w).max(), \
            path


@pytest.mark.parametrize("steps", [1, 2])
def test_mesh_steps_match_jax_on_the_same_mesh(ranks, jax_setup, steps):
    got = ranks["results"][0]
    want = jax_setup["runs"][ranks["mesh"]]
    assert got["losses"][steps - 1] == pytest.approx(
        want["losses"][steps - 1], rel=LOSS_TOL)
    assert_states_close(got["states"][steps - 1],
                        {k: dict(v) for k, v in
                         want["states"][steps - 1].items()})
    assert got["step"] == 2


@pytest.mark.parametrize("steps", [1, 2])
def test_mesh_steps_match_one_device(ranks, single, steps):
    got = ranks["results"][0]
    want = single[ranks["mesh"]]
    assert got["losses"][steps - 1] == pytest.approx(
        want["losses"][steps - 1], rel=LOSS_TOL)
    assert_states_close(got["states"][steps - 1], want["states"][steps - 1])


def test_every_rank_holds_rank_zeros_state(ranks):
    first = [leaves(s) for s in ranks["results"][0]["states"]]
    for r in ranks["results"][1:]:
        assert r["losses"] == ranks["results"][0]["losses"]
        for mine, theirs in zip((leaves(s) for s in r["states"]), first):
            assert all(np.array_equal(mine[p], theirs[p]) for p in theirs)


def test_eval_sums_are_the_global_batch(ranks, single):
    want = single[ranks["mesh"]]["sums"]
    assert want["n_images"] == MESHES[ranks["mesh"]]
    for r in ranks["results"]:
        for name, w in want.items():
            # A delta is a share of an image's pixels under a threshold: a
            # prediction that rounds across it moves the sum by 1/(H W).
            atol = DELTA_ATOL if name.startswith("delta") else 0.0
            np.testing.assert_allclose(r["sums"][name], w, rtol=SUMS_TOL,
                                       atol=atol, err_msg=name)


def test_epoch_and_evaluate_take_each_ranks_share(ranks):
    """train_epoch and evaluate through the iterators: the metrics are the
    global batch's (every image counted once, the padding of the last
    eval batch dropped) and equal on every rank."""
    first = ranks["results"][0]["epoch"]
    assert first["n_images"] == MESHES[ranks["mesh"]]
    assert first["eval_n_images"] == EVAL_IMAGES
    assert np.isfinite(first["loss"]) and np.isfinite(first["eval_rmse"])
    for r in ranks["results"][1:]:
        e = r["epoch"]
        assert {k: e[k] for k in ("loss", "n_images", "eval_n_images",
                                  "eval_rmse")} == {
            k: first[k] for k in ("loss", "n_images", "eval_n_images",
                                  "eval_rmse")}
        assert np.array_equal(e["last_param"], first["last_param"])


def test_sparse_samples_do_not_depend_on_the_mesh(ranks, single):
    drawn = np.concatenate([r["drawn"] for r in ranks["results"]])
    want = single[ranks["mesh"]]["drawn"]
    assert (want > 0).any()
    np.testing.assert_array_equal(drawn, want)


@pytest.mark.parametrize("ranks", [ROWS_VS_IMAGES], indirect=True,
                         ids=["2x4"])
@pytest.mark.parametrize("steps", [1, 2])
def test_rows_layout_matches_the_images_layout(ranks, steps):
    for r in ranks["results"]:
        got, want = r["rows"], r
        assert got["losses"][steps - 1] == pytest.approx(
            want["losses"][steps - 1], rel=LOSS_TOL)
        assert_states_close(got["states"][steps - 1],
                            want["states"][steps - 1])
        for name, w in want["sums"].items():
            atol = DELTA_ATOL if name.startswith("delta") else 0.0
            np.testing.assert_allclose(got["sums"][name], w, rtol=SUMS_TOL,
                                       atol=atol, err_msg=name)


def test_a_batch_that_does_not_split_over_the_ranks_is_refused():
    mesh = Mesh(data=2, spatial=4, rank=0, world_group=None,
                data_group=None, spatial_group=None,
                device=torch.device("cpu"))
    assert Trainer(port_config(2, 4, 8), device="cpu",
                   mesh=mesh).layout == "images"
    assert Trainer(port_config(2, 4, 12), device="cpu",
                   mesh=mesh).layout == "rows"
    with pytest.raises(ValueError, match="batch 7 does not split over"):
        Trainer(port_config(2, 4, 7), device="cpu", mesh=mesh)
