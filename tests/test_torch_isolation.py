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


def test_serving_entry_points_raise_without_cuda():
    """The async frontend, the sharded dispatcher (and its serve mesh)
    and the launcher run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.cnn import tiny_cnn
    from repro_torch.serve import AsyncServeFrontend, ShardedServeDispatcher
    m = tiny_cnn()
    params = m.init(0, device="cpu")
    geoms = {(8, 8, 3): (2,)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncServeFrontend(m, params, geoms)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedServeDispatcher(m, params, geoms)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--cnn-dist", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--requests", "1"])
    # asked for the CPU, each runs there
    assert AsyncServeFrontend(m, params, geoms, device="cpu") \
        .programs[(8, 8, 3)].device.type == "cpu"
    assert ShardedServeDispatcher(m, params, geoms, device="cpu").mesh == (
        torch.device("cpu"),)


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


@pytest.mark.parametrize("mod", ["repro_torch.train", "repro_torch.optim",
                                 "repro_torch.data",
                                 "repro_torch.launch.train",
                                 "repro_torch.launch.steps",
                                 "repro_torch.dist.compress",
                                 "repro_torch.dist.sharding",
                                 "repro_torch.launch.mesh",
                                 "repro_torch.launch.dryrun",
                                 "repro_torch.roofline",
                                 "repro_torch.roofline.analysis"])
def test_the_training_modules_import_no_jax(mod):
    code = (f"import sys, importlib\n"
            f"importlib.import_module({mod!r})\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'jaxlib', 'repro')]\n"
            f"assert not bad, bad\n"
            f"print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_training_entry_points_raise_without_cuda(tmp_path):
    """The trainer, the launcher and restore run on the card unless
    asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(smoke_variant(get_config("qwen2-1.5b")),
                              grad_accum=1)
    data = SyntheticLMData(cfg.vocab_size, 2, 8)
    tcfg = TrainConfig(steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, tcfg, data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1",
                       "--ckpt-dir", str(tmp_path)])
    tr = Trainer(cfg, tcfg, data, device="cpu")
    tr.run()
    assert tr.state["step"].device.type == "cpu"
    like = tr.init_state(device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore_checkpoint(tmp_path, 1, like)
    assert int(ckpt.restore_checkpoint(tmp_path, 1, like,
                                       device="cpu")["step"]) == 1
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, tcfg, data, mesh=object(), device="cpu")
    # a training mesh lies on the card unless a gloo group or the caller
    # says otherwise: no process group and no card raises, never a CPU
    # mesh
    from repro_torch.launch.mesh import make_debug_mesh, \
        make_production_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_debug_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        make_debug_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1",
                       "--ckpt-dir", str(tmp_path), "--mesh", "debug"])


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


# ---------------------------------------------------------------------------
# the reference's public names, module by module

REF = PKG.parent / "repro"
#: reference module -> the port's module of another name
RENAMED = {"kernels/winograd_pallas.py": "kernels/winograd_fused.py"}
#: names the port lacks on purpose, with the reason
ABSENT = {
    "core/executors.py": {
        "FUSED_VMEM_BUDGET": "the TPU's 12 MB VMEM budget; Hopper's "
                             "limits are _build.SMEM_LIMIT and registers"},
    "kernels/_compat.py": {
        "CompilerParams": "Pallas TPU compiler params; nvcc flags live in "
                          "_build._command"},
    "kernels/cuconv_fused.py": {
        "vmem_bytes": "the Pallas kernel's VMEM footprint; the CUDA "
                      "kernel's is smem_bytes / launch_geometry"},
    "kernels/direct_conv.py": {
        "vmem_bytes": "as cuconv_fused: smem_bytes / launch_geometry"},
    "kernels/winograd_pallas.py": {
        "vmem_bytes": "as cuconv_fused: launch_geometry's smem"},
    "kernels/ops.py": {
        "int8_gemm": "removed as unused when the int8 executor became one "
                     "int8_conv launch per node"},
    "launch/dryrun.py": {
        "os": "the reference sets XLA_FLAGS through os.environ at import "
              "to force 512 host devices; the port's placeholders are a "
              "fake process group that main() brings up"},
}
#: modules ported in part: the names still to come (none: every ported
#: module is whole)
PARTIAL = {}
#: reference modules not ported yet (none: the port has every module)
NOT_PORTED = set()
REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _public_names(path):
    """Top-level public names a module defines (and, in an __init__,
    re-exports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_the_module_lists_cover_the_reference():
    assert len(REF_MODULES) > 50
    port = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    for rel in REF_MODULES:
        assert (rel in NOT_PORTED) != (RENAMED.get(rel, rel) in port), rel
    assert set(ABSENT) | set(PARTIAL) <= set(REF_MODULES)


@pytest.mark.parametrize("rel", [m for m in REF_MODULES
                                 if m not in NOT_PORTED])
def test_the_port_has_every_public_name_of_the_reference(rel):
    """Every public top-level name of a ported reference module exists in
    the port's module, less the deliberate absences (each with its
    reason) and, for a module ported in part, the names still to come;
    neither list names a name the port has."""
    want = _public_names(REF / rel)
    have = _public_names(PKG / RENAMED.get(rel, rel))
    absent, partial = set(ABSENT.get(rel, {})), PARTIAL.get(rel, set())
    assert absent | partial <= want, rel
    assert not (absent | partial) & have, rel
    assert want - have == absent | partial, rel


EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
TWINS = ["quickstart", "cnn_inference", "serve_lm", "train_lm"]


def test_the_examples_twins_import_no_jax_nor_the_jax_package():
    files = sorted(EXAMPLES.glob("*.py"))
    assert sorted(f.stem for f in files) == sorted(TWINS)
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax"), (f, mod)


@pytest.mark.parametrize("twin", TWINS)
def test_an_examples_twin_raises_without_cuda_unless_asked_for_the_cpu(
        twin, tmp_path):
    """Run as a user runs it, with no ``--device``: the twin defaults to
    the card, so with none it exits non-zero with the missing-CUDA error
    before any work (no silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent),
               REPRO_CACHE_DIR=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(EXAMPLES / f"{twin}.py")]
                         + (["--ckpt-dir", str(tmp_path / "ck")]
                            if twin == "train_lm" else []),
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
    assert "RuntimeError" in out.stderr
    assert out.stdout.strip() == "", out.stdout
    assert not (tmp_path / "ck").exists()
