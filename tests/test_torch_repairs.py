"""Small differences between the port and the JAX package, each pinned on
the CPU against the JAX package:

* conv kernels are drawn as flax's `lecun_normal` draws them (a normal
  truncated at two standard deviations, variance 1/fan_in), each input
  part of a decoder concat conv with its own fan-in, as JAX's `*_up` and
  `*_skip` kernels. The random generators differ, so the moments are
  compared, not the bits: every |w| sqrt(fan_in) <= 2 / 0.8796 (the
  truncation), and each kernel's std within 3 % of the JAX kernel's of the
  same name and shape (ResNet-18 at full width: the smallest kernel has
  8192 weights, whose sample std varies by ~1 %);
* `SyntheticDataset(length=)` gives as many records as JAX's, the same
  ones;
* `CSPN_NATIVE=0` selects the numpy augmentation executor, as in JAX;
* a `model.dtype` other than bfloat16 or float32 is refused by name;
* `native.lib()` called from a second thread while the first loads the
  library waits for it: it had returned None, so a worker thread took the
  numpy executor for its record, and a process's first epoch differed from
  its later ones in the last bits of some rgb (the JAX package's
  native/__init__.py has the same pattern).
"""

import threading
import time


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from cspn_monodepth_tpu.models import CSPNDepthNet as JaxCSPNDepthNet
from cspn_monodepth_tpu_torch import native
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.data import transforms as tf
from cspn_monodepth_tpu_torch.data.datasets import SyntheticDataset
from cspn_monodepth_tpu_torch.models import CSPNDepthNet, jax_variables

# |z| <= 2 in units of std = 1 / (0.87962566 sqrt(fan_in)).
MAX_SCALED = 2.2737
STD_REL_TOL = 0.03


def kernel_leaves(tree, prefix=""):
    """{path: array} of the 4-D kernels of a parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(kernel_leaves(v, f"{prefix}/{k}"))
        elif np.ndim(v) == 4:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("block", ["upproj", "upconv"])
def test_conv_init_is_flax_lecun_normal(block):
    model = JaxCSPNDepthNet(arch="resnet18", decoder_block=block,
                            dtype=jnp.float32)
    want = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, 64, 4)), train=False))(jax.random.PRNGKey(0))
    want = kernel_leaves(jax.tree.map(np.asarray, want["params"]))
    got = kernel_leaves(jax_variables(CSPNDepthNet(
        arch="resnet18", decoder_block=block))["params"])
    assert got.keys() == want.keys()
    halves = [p for p in got if p.endswith(("_up", "_skip", "_skip/kernel"))]
    assert len(halves) == (18 if block == "upproj" else 9)
    checked = 0
    for path, w in want.items():
        if not w.any():                 # the zero heads
            assert not got[path].any(), path
            continue
        fan_in = np.prod(w.shape[:3])
        assert np.abs(got[path]).max() * np.sqrt(fan_in) <= MAX_SCALED, path
        assert np.abs(w).max() * np.sqrt(fan_in) <= MAX_SCALED, path
        assert got[path].std() == pytest.approx(w.std(), rel=STD_REL_TOL), \
            path
        checked += 1
    assert checked == len(want) - 2


def test_synthetic_dataset_takes_a_length():
    cfg = get_config("synthetic_tiny").data
    jax_cfg = jax_get_config("synthetic_tiny").data
    for split, n in (("train", 32), ("val", 5)):
        got = SyntheticDataset(cfg, split, seed=3, length=n)
        want = JaxSynthetic(jax_cfg, split, seed=3, length=n)
        assert len(got) == len(want) == n
        for i in (0, n - 1):
            for k in ("rgb", "depth"):
                np.testing.assert_array_equal(got.get(i)[k], want.get(i)[k])
    assert len(SyntheticDataset(cfg, "train")) == 64


def test_cspn_native_0_selects_the_numpy_executor(monkeypatch):
    """Under CSPN_NATIVE=0 `lib()` is None and the augmentation is the
    numpy executor's, bit for bit; where g++ builds the native library,
    that is the one without the variable, and the records agree within the
    executors' tolerance (rgb 1e-5, depth bit for bit)."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    depth = (rng.uniform(0, 90, (90, 120))
             * (rng.random((90, 120)) < 0.3)).astype(np.float32)

    def records():
        return [tf.train_transform(rgb, depth, np.random.default_rng(s),
                                   out_h=64, out_w=96, rotate_deg=5.0,
                                   scale_max=1.5, hflip_prob=0.5, jitter=0.2,
                                   crop=crop)
                for s in range(3) for crop in ("bottom", "center")]

    with monkeypatch.context() as m:
        m.setenv("CSPN_NATIVE", "0")
        assert native.lib() is None
        assert native.executor() == "numpy"
        switched = records()
    with monkeypatch.context() as m:
        m.setattr(native, "lib", lambda: None)
        plain = records()
    for a, b in zip(switched, plain):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if native.lib() is None:
        return                          # no compiler: nothing else to pick
    assert native.executor() == "native"
    for a, b in zip(records(), switched):
        np.testing.assert_allclose(a[0], b[0], atol=1e-5)
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_unsupported_model_dtype_is_refused_by_name(dtype):
    with pytest.raises(ValueError, match="bfloat16.*float32"):
        CSPNDepthNet(arch="resnet18", dtype=dtype)
    assert CSPNDepthNet(arch=None, encoder_stages=(1, 1, 1, 1),
                        encoder_width=16, decoder_channels=(32, 24, 16, 16),
                        decoder_out=16, dtype="float32").dtype == torch.float32


def test_a_second_caller_waits_for_the_native_library(monkeypatch):
    """While one thread loads the native library (slowed here), a second
    caller of `lib()` gets the library, not None."""
    loaded = object()

    def slow_bind(_):
        time.sleep(0.5)
        return loaded

    monkeypatch.delenv("CSPN_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path", lambda: native.SOURCE)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: None)
    monkeypatch.setattr(native, "_bind", slow_bind)
    first = []
    loader = threading.Thread(target=lambda: first.append(native.lib()))
    loader.start()
    time.sleep(0.1)
    second = native.lib()
    loader.join()
    assert first == [loaded]
    assert second is loaded
    assert native.executor() == "native"
