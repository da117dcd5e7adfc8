"""The port stands alone: no JAX, nothing of the JAX package, nothing
built at import, and the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches  # noqa: F401

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax"), (f, mod)
            assert root != "triton", (f, "triton is imported at use only")


def test_import_succeeds_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LOADED, 'a kernel was built at import'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    from repro_torch.models.cnn import params_from_numpy, resnet_like
    from repro_torch.serve.cnn import CnnServeEngine
    m = resnet_like()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"stem": {"w": np.zeros((3, 3, 3, 16))}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CnnServeEngine(m, m.init(0, device="cpu"), (32, 32, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CnnServeEngine(m, {}, (32, 32, 3), device="cuda")


def test_default_plan_is_for_the_card_and_its_warmup_raises_without_cuda():
    import repro_torch as rt
    from repro_torch.core import convspec
    from repro_torch.models.cnn import resnet_like
    g = resnet_like().graph((1, 8, 8, 3))
    gp = rt.plan_graph(g)
    assert gp.backend == "cuda"
    assert resnet_like().graph_plan((1, 8, 8, 3)).backend == "cuda"
    assert convspec.plan(g.conv_nodes[0].spec).backend == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gp.warmup()
    assert gp.warmup(device="cpu")["nodes"]


def test_cpu_is_served_only_when_asked_for():
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve.cnn import CnnServeEngine
    m = resnet_like()
    eng = CnnServeEngine(m, m.init(0, device="cpu"), (8, 8, 3),
                         buckets=(1,), device="cpu")
    assert eng.device.type == "cpu"
    assert eng.programs.backend == "cpu"
    eng2 = CnnServeEngine(m, m.init(0, device="cpu"), (8, 8, 3),
                          buckets=(1,), device="cpu", backend="cuda")
    assert eng2.programs.plan(1).backend == "cuda"


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels import conv1x1
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        conv1x1.conv1x1_gemm(x, torch.zeros((3, 2), device="meta"))


def test_build_dir_is_inside_the_checkout_and_ignored():
    from repro_torch.kernels import _build
    root = PKG.parents[1]
    assert _build.build_dir().resolve().is_relative_to(root)
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == sorted(
        f"{n}.cu" for n in _build.LIBRARIES)
