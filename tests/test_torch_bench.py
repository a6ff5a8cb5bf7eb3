"""The port's bench (cspn_monodepth_tpu_torch/bench.py) against the root
bench.py's chains, on the CPU.

* The chain bodies: two steps of the train chain's body (train_step on tag
  i, its loss plus every metric-sum leaf times 1e-12) and the eval chain's
  body from the same weights and batch against the JAX Trainer's
  `train_step_fn` (rng `fold_in(r, i)`) and `eval_step_fn` with the root
  bench's `consume_sums`, on `synthetic_tiny` in float32 (plain stem, as in
  tests/test_torch_train.py) with the sparse map injected on both sides
  (the samplers draw from different generators). The chained values
  within 1e-5 relative, every metric-sum leaf within 1e-5 relative. The
  second step starts from the JAX state after the first, carried across by
  `load_jax_variables`: the delta leaves count pixels under a ratio
  threshold, and the ~1e-6 by which two f32 updates differ
  (tests/test_torch_train.py) moved one pixel of 6144 across 1.25 here
  (delta1 1.6e-4 apart at the port's own second step).
* Every leaf reaches the read-back: a NaN in any one leaf makes the
  consumed value NaN.
* `bench.main()` on the CPU (synthetic_tiny, batch 2, chains of 1 and 5):
  one JSON line with exactly the root bench's keys, parity null, and the
  model back at its initial state bit for bit; the inputs pass
  `_to_device`/`_unpack` without a copy; `vs_baseline` reads only a
  baseline of the same card name and batch.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer
from cspn_monodepth_tpu.train.train_state import create_train_state
from cspn_monodepth_tpu_torch import bench
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import (
    CSPNDepthNet,
    jax_variables,
    load_jax_variables,
)
from cspn_monodepth_tpu_torch.train import Trainer
from cspn_monodepth_tpu_torch.train.metrics import FIELDS, MetricSums

from test_torch_model import randomize

TINY = {"model.dtype": "float32", "data.num_workers": 2}
TOL = 1e-5
# bench.py:214-227, written out.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "train_images_per_sec", "infer_images_per_sec", "batch",
              "chain_len", "dispatch_overhead_ms", "backend", "device",
              "parity"}


def jax_consume_sums(sums):
    """bench.py:127-129."""
    return sum(jnp.sum(x) for x in jax.tree.leaves(sums)) * 1e-12


@pytest.fixture(scope="module")
def problem():
    """Randomized synthetic_tiny weights in the JAX tree layout, the root
    bench's batch at synthetic_tiny's size and a fixed sparse map."""
    torch.set_num_threads(2)
    cfg = get_config("synthetic_tiny").override(**TINY)
    variables = randomize(jax_variables(CSPNDepthNet.from_config(cfg.model)),
                          0)
    b, h, w = cfg.train.batch_size, cfg.data.height, cfg.data.width
    batch = {k: v.numpy() for k, v in
             bench.synthetic_batch(b, h, w, "cpu").items()}
    rng = np.random.default_rng(1)
    sparse = np.where(rng.random((b, h, w)) < 0.01, batch["depth"],
                      0.0).astype(np.float32)
    return dict(variables=variables, batch=batch, sparse=sparse,
                valid=np.ones(b, np.float32))


@pytest.fixture(scope="module")
def jax_chain(problem, tmp_path_factory):
    cfg = jax_get_config("synthetic_tiny").override(**{
        **TINY, "model.packed_stem": False,
        "train.checkpoint_dir": str(tmp_path_factory.mktemp("jax_bench"))})
    trainer = JaxTrainer(cfg)
    sparse = jnp.asarray(problem["sparse"])
    trainer._sample_sparse = lambda key, depth, rgb: sparse
    r = jax.random.PRNGKey(0)

    @jax.jit
    def train(st, b, i):
        st, loss, sums = trainer.train_step_fn(st, b, jax.random.fold_in(r, i))
        return st, loss + jax_consume_sums(sums), sums

    state = create_train_state(problem["variables"], trainer.tx)
    values, sums, states = [], [], []
    for i in range(2):
        state, v, s = train(state, problem["batch"], i)
        values.append(float(v))
        sums.append(jax.device_get(s))
        states.append(jax.tree.map(np.array, jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats})))
    eval_batch = dict(problem["batch"], valid_image=problem["valid"])
    s, pred = jax.jit(trainer.eval_step_fn)(
        create_train_state(problem["variables"], trainer.tx), eval_batch, r,
        0)
    acc = float(0.0 + jnp.mean(pred) * 1e-9 + jax_consume_sums(s))
    return dict(values=values, sums=sums, states=states, eval_value=acc,
                eval_sums=jax.device_get(s))


def port_trainer(problem) -> Trainer:
    trainer = Trainer(get_config("synthetic_tiny").override(**TINY),
                      device="cpu")
    sparse = torch.from_numpy(problem["sparse"])
    trainer._sample_sparse = lambda gen, depth, rgb: sparse
    return trainer


@pytest.fixture(scope="module")
def port_chain(problem, jax_chain):
    trainer = port_trainer(problem)
    state = trainer.init_state(problem["variables"])
    batch = {k: torch.from_numpy(v) for k, v in problem["batch"].items()}
    values, sums = [], []
    real = trainer.train_step

    def keep_sums(*args):
        out = real(*args)
        sums.append(out[2])
        return out

    trainer.train_step = keep_sums
    for i in range(2):
        if i:
            load_jax_variables(state.model, jax_chain["states"][i - 1])
        values.append(float(bench.train_body(trainer, state, batch, i)))
    eval_sums = []
    real_eval = trainer.eval_step

    def keep_eval_sums(*args):
        out = real_eval(*args)
        eval_sums.append(out[0])
        return out

    trainer.eval_step = keep_eval_sums
    fresh = trainer.init_state(problem["variables"])
    eval_batch = dict(batch, valid_image=torch.from_numpy(problem["valid"]))
    acc = bench.eval_body(trainer, fresh, eval_batch, torch.zeros(()), 0)
    return dict(values=values, sums=sums, eval_value=float(acc),
                eval_sums=eval_sums[0])


def assert_leaves_close(got: MetricSums, want):
    for f in FIELDS:
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=TOL,
                                   err_msg=f)


@pytest.mark.parametrize("step", [0, 1])
def test_train_chain_body_matches_jax(jax_chain, port_chain, step):
    assert port_chain["values"][step] == pytest.approx(
        jax_chain["values"][step], rel=TOL)
    assert_leaves_close(port_chain["sums"][step], jax_chain["sums"][step])


def test_eval_chain_body_matches_jax(jax_chain, port_chain):
    assert port_chain["eval_value"] == pytest.approx(
        jax_chain["eval_value"], rel=TOL)
    assert_leaves_close(port_chain["eval_sums"], jax_chain["eval_sums"])


def test_sums_have_the_jax_leaves(jax_chain):
    names = [f.name for f in dataclasses.fields(jax_chain["sums"][0])
             if f.name != "protocol"]
    assert tuple(names) == FIELDS


@pytest.mark.parametrize("leaf", FIELDS)
def test_every_leaf_reaches_the_read_back(leaf):
    sums = MetricSums(**{f: torch.tensor(float(i + 1))
                         for i, f in enumerate(FIELDS)})
    assert torch.isfinite(bench.consume_sums(sums))
    bad = dataclasses.replace(sums, **{leaf: torch.tensor(float("nan"))})
    assert torch.isnan(bench.consume_sums(bad))


@pytest.fixture(scope="module")
def bench_run():
    """bench.main() on the CPU, the state the Trainer built and a copy of
    its initial weights, and the printed lines."""
    import contextlib
    import io

    mp = pytest.MonkeyPatch()
    for k, v in {"BENCH_CONFIG": "synthetic_tiny", "BENCH_BATCH": "2",
                 "BENCH_ITERS": "1"}.items():
        mp.setenv(k, v)
    made = []
    real = Trainer.init_state

    def init_state(self, *args):
        state = real(self, *args)
        made.append((state, {k: v.clone() for k, v in
                             state.model.state_dict().items()}))
        return state

    mp.setattr(Trainer, "init_state", init_state)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            line = bench.main(device="cpu")
    finally:
        mp.undo()
    return dict(line=line, printed=out.getvalue().splitlines(), made=made)


def test_bench_prints_the_root_bench_keys(bench_run):
    assert len(bench_run["printed"]) == 1
    line = json.loads(bench_run["printed"][0])
    assert set(line) == BENCH_KEYS
    assert line == bench_run["line"]
    assert line["parity"] is None and line["vs_baseline"] is None
    assert line["backend"] == "cpu" and line["device"] == "cpu"
    assert line["chain_len"] == 1 and line["batch"] == 2
    for k in ("value", "train_images_per_sec", "infer_images_per_sec"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    assert line["dispatch_overhead_ms"] >= 0


def test_bench_restores_the_weights(bench_run):
    (state, initial), = bench_run["made"]
    now = state.model.state_dict()
    assert now.keys() == initial.keys()
    for k, v in initial.items():
        assert torch.equal(now[k], v), k
    assert state.step == 0
    assert not state.optimizer.state        # no momentum left behind


def test_device_inputs_pass_without_a_copy():
    trainer = Trainer(get_config("synthetic_tiny").override(**TINY),
                      device="cpu")
    batch = bench.synthetic_batch(2, 64, 96, "cpu")
    got = trainer._unpack(trainer._to_device(batch))
    for k in ("rgb", "depth"):
        assert got[k].data_ptr() == batch[k].data_ptr(), k


@pytest.mark.parametrize("device,batch,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 32, 100.0),
    ("NVIDIA H100 80GB HBM3, 500.00 W", 32, 100.0),   # the name decides
    ("NVIDIA H100 80GB HBM3, 700.00 W", 8, None),      # another batch
    ("NVIDIA A100-SXM4-80GB, 400.00 W", 32, None),     # another card
])
def test_vs_baseline_needs_the_same_card_and_batch(device, batch, want,
                                                   tmp_path, monkeypatch):
    path = tmp_path / "bench_baseline.json"
    path.write_text(json.dumps({"combined_ips": 100.0, "batch": 32,
                                "device": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    monkeypatch.setattr(bench, "BASELINE", path)
    assert bench.baseline_ips(device, batch) == want
    monkeypatch.setattr(bench, "BASELINE", tmp_path / "missing.json")
    assert bench.baseline_ips(device, batch) is None
