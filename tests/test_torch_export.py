"""The port's exported serving program (`DepthPredictor.export_program`,
`ops/library.py:load_program`) against its own `predict_batch` and against
the JAX package's `export_stablehlo` artifact, on the same weights.

synthetic_tiny in float32 (64x96, T=4), rgbd, B=2, randomized weights
from one JAX variable tree, on the CPU. Tolerances: the loaded program
against predict_batch 1e-6, the bar of the JAX package's own round trip
(tests/test_serving.py); against JAX rtol 2e-3, atol 2e-4 * max|want|, as
tests/test_torch_serving.py holds the two predictors.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.serving import DepthPredictor as JaxDepthPredictor
from cspn_monodepth_tpu_torch import DepthPredictor, get_config
from cspn_monodepth_tpu_torch.ops import cspn_cuda, library
from cspn_monodepth_tpu_torch.ops.cspn_ref import anchor, prenorm_gates9
from cspn_monodepth_tpu_torch.ops.library import load_program
from tests.test_torch_model import assert_close, jax_model_variables
from tests.test_torch_serving import H, W, model_kw, requests

B = 2
OPS = torch.ops.cspn_monodepth_tpu_torch


def tiny_cfg(getter, **over):
    return getter("synthetic_tiny").override(**{
        "model.dtype": "float32", "model.modality": "rgbd", **over})


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(port predictor, jax predictor, port program path, request x, rgb,
    sparse): one set of randomized weights, the port's program exported
    at batch B."""
    _, variables = jax_model_variables(
        "rgbd", H, W, seed=5, **model_kw(tiny_cfg(jax_get_config)))
    port = DepthPredictor.from_variables(tiny_cfg(get_config), variables,
                                         device="cpu")
    ref = JaxDepthPredictor.from_variables(tiny_cfg(jax_get_config),
                                           variables)
    path = tmp_path_factory.mktemp("export") / "depth.pt2"
    port.export_program(str(path), batch=B)
    rgb, sparse = requests(7, B, H, W)
    x = np.concatenate([rgb, sparse[..., None]], axis=-1)
    return port, ref, path, x, rgb, sparse


def cspn_nodes(program) -> list[str]:
    """Every call in the graph that is one of the port's operators or
    whose target names the CSPN."""
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "cspn" in str(n.target)]


def test_loaded_program_equals_predict_batch(exported):
    port, _, path, x, rgb, sparse = exported
    program = load_program(str(path), device="cpu")
    got = program(torch.from_numpy(x)).numpy()
    assert got.shape == (B, H, W, 1) and got.dtype == np.float32
    want = port.predict_batch(rgb, sparse)
    np.testing.assert_allclose(got[..., 0], want, rtol=1e-6, atol=1e-6)
    m = sparse > 0
    np.testing.assert_array_equal(got[..., 0][m], sparse[m])


def test_loaded_program_matches_jax_export_stablehlo(exported, tmp_path):
    import jax.numpy as jnp
    from jax import export as jax_export

    _, ref, path, x, _, _ = exported
    stablehlo = tmp_path / "depth.stablehlo"
    ref.export_stablehlo(str(stablehlo), batch=B)
    want = np.asarray(jax_export.deserialize(stablehlo.read_bytes()).call(
        jnp.asarray(x)))
    got = load_program(str(path), device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, H, W, 1)
    assert_close(got, want)


LOADER = """
import sys
import numpy as np
import torch
import cspn_monodepth_tpu_torch.ops.library as library

program = library.load_program(sys.argv[1], device="cpu")
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], program(x).numpy())
print("jax" in sys.modules)
"""


def test_fresh_process_loads_with_the_op_library_alone(exported, tmp_path):
    """A process that imports torch and ops/library.py by name, builds no
    model and reads no config, loads the program and gets predict_batch's
    answer; it imports no JAX."""
    port, _, path, x, rgb, sparse = exported
    np.save(tmp_path / "x.npy", x)
    out = subprocess.run(
        [sys.executable, "-c", LOADER, str(path), str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], capture_output=True, text=True,
        timeout=120, check=True, cwd=Path(__file__).parents[1])
    assert out.stdout.split() == ["False"]
    got = np.load(tmp_path / "y.npy")
    np.testing.assert_allclose(got[..., 0], port.predict_batch(rgb, sparse),
                               rtol=1e-6, atol=1e-6)


def test_graph_holds_one_k1_node_and_no_training_path(exported, tmp_path):
    """export_program traces without gradients even when its caller is in
    grad mode: one node of the K1 operator, nothing of the stash forward
    (its (B, T, H, W) stack). A bare export in grad mode is the control:
    it traces the training branch, with no operator node."""
    port, _, _, _, _, _ = exported
    assert torch.is_grad_enabled()
    program = port.export_program(str(tmp_path / "p.pt2"), batch=1)
    assert cspn_nodes(program) == [str(OPS.cspn_fwd.default)]
    targets = {str(n.target) for n in program.graph.nodes}
    assert "aten.stack.default" not in targets
    bare = torch.export.export(
        port.model, (torch.zeros(1, H, W, 4, device="cpu"),))
    assert cspn_nodes(bare) == []
    assert "aten.stack.default" in {str(n.target) for n in bare.graph.nodes}


def test_tiled_route_exports_one_k4_node(tmp_path):
    _, variables = jax_model_variables(
        "rgbd", H, W, seed=5, **model_kw(tiny_cfg(jax_get_config)))
    port = DepthPredictor.from_variables(
        tiny_cfg(get_config, **{"model.cspn_impl": "cuda_tiled"}),
        variables, device="cpu")
    path = tmp_path / "tiled.pt2"
    program = port.export_program(str(path), batch=1)
    assert cspn_nodes(program) == [str(OPS.cspn_tiled_fwd_raw.default)]
    rgb, sparse = requests(3, 1, H, W)
    x = np.concatenate([rgb, sparse[..., None]], axis=-1)
    got = load_program(str(path), device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy()[..., 0],
                               port.predict_batch(rgb, sparse),
                               rtol=1e-6, atol=1e-6)


def test_load_program_on_another_device_raises(exported):
    """A program exported on the CPU holds a CPU autocast node: asked for
    the card, load_program refuses before it runs anything."""
    _, _, path, _, _, _ = exported
    with pytest.raises(ValueError, match="exported on cpu, not cuda"):
        load_program(str(path), device="cuda")
    assert library.exported_device(torch.export.load(str(path))).type == \
        "cpu"


def op_samples(channels: int):
    rng = np.random.default_rng(11)
    planes = torch.from_numpy(
        rng.normal(size=(2, channels, 9, 11)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0.5, 9.5, (2, 9, 11)).astype(
        np.float32))
    sp = torch.where(d > 8.0, d, torch.zeros_like(d))
    return planes, d, sp


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("num_iters", [0, 3])
def test_opcheck_cspn_fwd(sparse, num_iters):
    guid, blur, sp = op_samples(8)
    args = (guid, blur, sp if sparse else None, num_iters, "8sum_clamp")
    torch.library.opcheck(OPS.cspn_fwd.default, args)
    want = cspn_cuda.cspn_fwd_plain(*args[:3], num_iters=num_iters,
                                    norm_type="8sum_clamp")
    torch.testing.assert_close(OPS.cspn_fwd(*args), want, rtol=0, atol=0)


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("num_iters", [0, 3])
def test_opcheck_cspn_tiled_fwd(sparse, num_iters):
    """The gates9 contract of K4 before it took raw guidance, kept for the
    programs exported then: K7's function."""
    gates9, d0, sp = op_samples(9)
    args = (gates9, d0, sp if sparse else None, num_iters)
    torch.library.opcheck(OPS.cspn_tiled_fwd.default, args)
    want = cspn_cuda.cspn_prenorm_fwd_plain(*args[:3], num_iters=num_iters)
    torch.testing.assert_close(OPS.cspn_tiled_fwd(*args), want, rtol=0,
                               atol=0)


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("num_iters", [0, 3])
def test_opcheck_cspn_tiled_fwd_raw(sparse, num_iters):
    guid, blur, sp = op_samples(8)
    args = (guid, blur, sp if sparse else None, num_iters, "8sum_abs")
    torch.library.opcheck(OPS.cspn_tiled_fwd_raw.default, args)
    want = cspn_cuda.cspn_tiled_fwd_plain(*args[:3], num_iters=num_iters,
                                          norm_type="8sum_abs")
    torch.testing.assert_close(OPS.cspn_tiled_fwd_raw(*args), want, rtol=0,
                               atol=0)


@pytest.mark.parametrize("norm", ["8sum", "8sum_abs", "8sum_clamp"])
def test_opcheck_cspn_gates9(norm):
    guid, _, _ = op_samples(8)
    torch.library.opcheck(OPS.cspn_gates9.default, (guid, norm))
    torch.testing.assert_close(OPS.cspn_gates9(guid, norm),
                               prenorm_gates9(guid, norm), rtol=0, atol=0)


def test_ops_take_float32_only():
    guid, blur, sp = op_samples(8)
    with pytest.raises(ValueError, match="float32"):
        OPS.cspn_fwd(guid.double(), blur, sp, 2, "8sum")
    with pytest.raises(ValueError, match="float32"):
        OPS.cspn_tiled_fwd_raw(guid, blur.double(), sp, 2, "8sum")
    with pytest.raises(ValueError, match="float32"):
        OPS.cspn_gates9(guid.double(), "8sum")
    gates9, d0, sp = op_samples(9)
    with pytest.raises(ValueError, match="float32"):
        OPS.cspn_tiled_fwd(gates9, d0.double(), sp, 2)


class Gates9ContractCSPN(torch.nn.Module):
    """The CSPN step as a program exported before K4 took raw guidance held
    it: the plain normalization and anchor, then the operator
    cspn_tiled_fwd on gates9."""

    def forward(self, x):
        sp = x[:, 9]
        gates9 = prenorm_gates9(x[:, :8], "8sum_clamp")
        return OPS.cspn_tiled_fwd(gates9, anchor(x[:, 8], sp), sp, 5)


def test_a_program_on_the_gates9_contract_still_loads(tmp_path):
    """A program whose graph holds cspn_tiled_fwd on gates9 loads and runs,
    and equals the raw contract's K4 on the same inputs."""
    guid, blur, sp = op_samples(8)
    x = torch.cat([guid, blur[:, None], sp[:, None]], 1)
    path = tmp_path / "gates9_contract.pt2"
    with torch.no_grad():
        torch.export.save(torch.export.export(Gates9ContractCSPN(), (x,)),
                          str(path))
    program = torch.export.load(str(path))
    assert cspn_nodes(program) == [str(OPS.cspn_tiled_fwd.default)]
    got = load_program(str(path), device="cpu")(x)
    want = OPS.cspn_tiled_fwd_raw(guid, blur, sp, 5, "8sum_clamp")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
