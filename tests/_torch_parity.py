"""Shared helpers of the repro_torch parity tests.

The same numpy inputs, made from a seed, go to the JAX package and to
the port; outputs come back as numpy and are compared at the tolerance
each test states.  JAX is imported only inside the helpers that need it,
so the card-only tests (``tests/test_torch_cuda.py``) also run where JAX
is not installed.
"""
import numpy as np
import pytest
import torch

#: skip a test where no card is visible.  The condition is a string, so
#: pytest evaluates it when the test is set up, not when the module is
#: imported: every xdist worker collects the same tests.
requires_cuda = pytest.mark.skipif(
    "not __import__('torch').cuda.is_available()",
    reason="needs a CUDA card: the CUDA kernels have no CPU mode")

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (its helpers; its
    ``main`` is not run): loaded from the file, beside ``tests/``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rand(rng, shape, dtype="float32"):
    """Standard-normal numpy input, rounded to ``dtype`` (so both
    packages see bit-identical bf16 values)."""
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def to_jax(a, dtype="float32"):
    import jax.numpy as jnp
    return None if a is None else jnp.asarray(a, jnp.float32).astype(dtype)


def to_torch(a, dtype="float32", device="cpu"):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, np.float32)).to(device,
                                                        TORCH_DTYPES[dtype])


def np32(a):
    """Any jax array or torch tensor as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def ref_params_numpy(params):
    """The JAX package's name-keyed params as numpy (for
    ``repro_torch.models.cnn.params_from_numpy``)."""
    return {node: {k: np.asarray(v, np.float32) for k, v in p.items()}
            for node, p in params.items()}


@pytest.fixture(autouse=True)
def _clear_port_caches(tmp_path, monkeypatch):
    """Each test gets its own empty plan store and zeroed counters."""
    from repro_torch.core import autotune, convspec, graph
    from repro_torch.kernels import _build
    from repro_torch.quant import calibrate
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    autotune.clear_cache()
    graph.clear_cache()
    calibrate.clear_cache()
    convspec.reset_plan_stats()
    autotune.reset_measure_stats()
    _build.reset_launches()
    yield
    autotune.clear_cache()
    graph.clear_cache()
    calibrate.clear_cache()
