"""Import hygiene of the port: it imports PyTorch, never JAX.

cspn_monodepth_tpu_torch/ and chip_smoke.py run on a machine that has no
JAX, so neither may import jax, flax, optax, orbax or the JAX package
cspn_monodepth_tpu (the port keeps its own copy of what it needs). The
module name is matched exactly: cspn_monodepth_tpu_torch starts with
cspn_monodepth_tpu and is allowed.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "cspn_monodepth_tpu")
SOURCES = sorted((ROOT / "cspn_monodepth_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in FORBIDDEN)


def imported_modules(path: Path) -> list[str]:
    """Absolute module names imported anywhere in the file, in functions
    too, and string arguments of importlib.import_module / __import__."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ast.unparse(node.func) in ("importlib.import_module",
                                             "import_module", "__import__")):
            found.append(node.args[0].value)
    return found


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "flax.linen", "optax",
                                  "orbax.checkpoint", "cspn_monodepth_tpu",
                                  "cspn_monodepth_tpu.ops.cspn_ref"])
def test_matcher_flags_forbidden(name):
    assert forbidden(name)


@pytest.mark.parametrize("name", ["cspn_monodepth_tpu_torch",
                                  "cspn_monodepth_tpu_torch.ops", "torch",
                                  "jaxtyping", "numpy"])
def test_matcher_allows_the_port(name):
    assert not forbidden(name)


def test_sources_are_found():
    rel = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"chip_smoke.py", "cspn_monodepth_tpu_torch/serving.py",
            "cspn_monodepth_tpu_torch/ops/cspn_cuda.py",
            "cspn_monodepth_tpu_torch/train/loop.py",
            "cspn_monodepth_tpu_torch/data/pipeline.py",
            "cspn_monodepth_tpu_torch/data/transforms.py",
            "cspn_monodepth_tpu_torch/native/__init__.py",
            "cspn_monodepth_tpu_torch/parallel/mesh.py",
            "cspn_monodepth_tpu_torch/parallel/comm.py",
            "cspn_monodepth_tpu_torch/parallel/halo.py",
            "cspn_monodepth_tpu_torch/parallel/launch.py",
            "cspn_monodepth_tpu_torch/main.py",
            "cspn_monodepth_tpu_torch/train/checkpoint.py",
            "cspn_monodepth_tpu_torch/utils/__init__.py",
            "cspn_monodepth_tpu_torch/utils/logging.py",
            "cspn_monodepth_tpu_torch/utils/tensorboard.py"} <= rel


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import_in_source(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_without_jax():
    """Importing the port and chip_smoke in a fresh interpreter loads none
    of the forbidden modules."""
    code = (
        "import sys\n"
        "import cspn_monodepth_tpu_torch\n"
        "import cspn_monodepth_tpu_torch.models.convert\n"
        "import cspn_monodepth_tpu_torch.ops.cspn_cuda\n"
        "import cspn_monodepth_tpu_torch.serving\n"
        "import cspn_monodepth_tpu_torch.train\n"
        "import cspn_monodepth_tpu_torch.data\n"
        "import cspn_monodepth_tpu_torch.ops.sparse\n"
        "import cspn_monodepth_tpu_torch.ops.cspn\n"
        "import cspn_monodepth_tpu_torch.data.datasets\n"
        "import cspn_monodepth_tpu_torch.data.transforms\n"
        "import cspn_monodepth_tpu_torch.native\n"
        "import cspn_monodepth_tpu_torch.parallel\n"
        "import cspn_monodepth_tpu_torch.main\n"
        "import cspn_monodepth_tpu_torch.train.checkpoint\n"
        "import cspn_monodepth_tpu_torch.utils\n"
        "import cspn_monodepth_tpu_torch.utils.logging\n"
        "import cspn_monodepth_tpu_torch.utils.tensorboard\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(sorted(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
