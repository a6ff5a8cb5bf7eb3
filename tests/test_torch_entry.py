"""The port's entry points (cspn_monodepth_tpu_torch/entry.py) against the
root __graft_entry__.py, on the CPU.

* `entry(device="cpu")`: the flagship model (rgbd, ResNet-50, T=24
  `8sum_clamp`, bf16, eval mode) and a zero (1, 228, 304, 4) input; its
  forward is finite, (1, 228, 304, 1), without a gradient.
* Slow (JAX's ResNet-50 compile on the CPU takes minutes): the port's
  entry forward against the root entry's on the root entry's variables
  (randomized, converted by load_jax_variables), both in float32 (the
  root's model cloned to float32 and its plain CSPN loop; bf16 convolutions
  round differently in XLA and in PyTorch): max-relative <= 1e-4.
* `layouts(n)` is the root dry run's layout rule (__graft_entry__.py:41-46,
  read by running the root function with its Trainer and mesh stubbed) for
  n in 1, 2, 4, 6, 8.
* `dryrun_multichip(2, device="cpu")`: one train step on the (1, 2) mesh,
  two ranks over gloo, a finite loss, a launch count for every wrapper of
  the CSPN registry.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as root_entry
from cspn_monodepth_tpu_torch import entry as port_entry
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import load_jax_variables
from cspn_monodepth_tpu_torch.ops import cspn_cuda

from test_torch_model import make_input, randomize


def test_entry_is_the_flagship_forward():
    torch.set_num_threads(2)
    fn, args = port_entry.entry(device="cpu")
    x, = args
    assert x.shape == (1, 228, 304, 4) and not x.any()
    m = fn.model
    assert (m.modality, m.num_iters, m.norm_type) == ("rgbd", 24,
                                                      "8sum_clamp")
    assert m.dtype == torch.bfloat16 and not m.training
    # ResNet-50's bottleneck stages and nyu_completion_500's decoder.
    cfg = get_config("nyu_completion_500").model
    assert [len(s) for s in m.encoder.stages] == list(cfg.encoder_stages)
    assert type(m.encoder.layer1_block0).__name__ == "Bottleneck"
    assert m.encoder.skip_channels == (64, 256, 512, 1024, 2048)
    assert m.head.in_channels == cfg.decoder_out
    out = fn(*args)
    assert out.shape == (1, 228, 304, 1)
    assert torch.isfinite(out).all() and not out.requires_grad


@pytest.mark.slow
def test_entry_forward_matches_the_root_entry():
    jfn, (variables, _) = root_entry.entry()
    jmodel = dict(zip(jfn.__code__.co_freevars,
                      (c.cell_contents for c in jfn.__closure__)))["model"]
    jmodel = jmodel.clone(dtype=jnp.float32, cspn_impl="jnp")
    variables = randomize(jax.tree.map(np.asarray, variables), 0)
    x = make_input(2, "rgbd", 1, 228, 304, n_sparse=500)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))

    fn, _ = port_entry.entry(device="cpu")
    fn.model.dtype = torch.float32
    load_jax_variables(fn.model, variables)
    got = fn(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def root_layouts(n: int, monkeypatch) -> list[tuple[int, int]]:
    """The meshes the root dry run builds for n devices: its config
    overrides recorded, its Trainer and mesh stubbed out."""
    import cspn_monodepth_tpu.configs as configs
    import cspn_monodepth_tpu.parallel.mesh as mesh
    import cspn_monodepth_tpu.train.loop as loop

    seen = []

    class Config:
        def override(self, **kw):
            seen.append((kw["mesh.data"], kw["mesh.spatial"]))
            ns = types.SimpleNamespace
            return ns(mesh=None, train=ns(batch_size=kw["train.batch_size"]),
                      data=ns(height=kw["data.height"],
                              width=kw["data.width"]))

    class Trainer:
        _rep = None

        def __init__(self, cfg, mesh=None, workdir=None):
            pass

        def init_state(self):
            return types.SimpleNamespace(params=None)

        def train_step(self, state, batch, rng):
            return state, jnp.float32(0.0), None

    monkeypatch.setattr(configs, "get_config", lambda name: Config())
    monkeypatch.setattr(mesh, "make_mesh", lambda cfg, devices: None)
    monkeypatch.setattr(loop, "Trainer", Trainer)
    root_entry.dryrun_multichip(n)
    return seen


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_layout_rule_is_the_root_dry_runs(n, monkeypatch):
    assert port_entry.layouts(n) == root_layouts(n, monkeypatch)


@pytest.fixture(scope="module")
def dryrun():
    return port_entry.dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_on_two_cpu_ranks(dryrun):
    (got,) = dryrun
    assert got["mesh"] == (1, 2) and got["layout"] == "images"
    assert np.isfinite(got["loss"])
    # On the CPU the kernels' wrappers run their plain versions: no launch.
    assert not any(got["launches"].values())


def test_dryrun_reports_every_registered_launch_count(dryrun):
    """The rank step zeroes and reports every CSPN wrapper of the registry,
    the k x k and stage wrappers among them."""
    (got,) = dryrun
    assert got["launches"] == cspn_cuda.launch_counts()
    assert set(got["launches"]) == {fn.__name__ for fn in cspn_cuda.WRAPPERS}
    assert {"cspn_kxk_fwd_stash", "cspn_kxk_bwd"} <= set(got["launches"])
