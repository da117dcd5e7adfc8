"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (interpret mode), on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so
these tests pin the arithmetic the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The grids are those
of ``tests/test_kernels.py`` plus fused stride 2, addend, max/avg pool,
``rows > 1`` and a ragged ``tm``.  Bounds: fp32 2e-5, bf16 2e-2.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (_clear_port_caches, np32, rand, to_jax,  # noqa: F401
                           to_torch)
from repro.kernels import conv1x1 as rk1
from repro.kernels import cuconv_fused as rkf
from repro.kernels import cuconv_stage1 as rks1
from repro.kernels import cuconv_stage2 as rks2
from repro.kernels import ops as rops
from repro_torch.kernels import (_build, conv1x1, cuconv_fused,
                                 cuconv_stage1, cuconv_stage2, ops, ref)

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,C,M", [(64, 32, 16), (300, 130, 70),
                                   (17, 257, 129), (1024, 64, 256)])
def test_conv1x1_gemm_plain_matches_pallas(rng, P, C, M, dtype):
    x, w = rand(rng, (P, C), dtype), rand(rng, (C, M), dtype)
    got = conv1x1.conv1x1_gemm(to_torch(x, dtype), to_torch(w, dtype))
    want = rk1.conv1x1_gemm(to_jax(x, dtype), to_jax(w, dtype),
                            interpret=True)
    assert got.dtype == to_torch(x, dtype).dtype
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,P,C,M", [(9, 50, 16, 8), (25, 128, 48, 32),
                                     (4, 33, 7, 5)])
def test_stage1_plain_matches_pallas(rng, T, P, C, M, dtype):
    xs, w = rand(rng, (T, P, C), dtype), rand(rng, (T, C, M), dtype)
    got = cuconv_stage1.stage1_tap_gemm(to_torch(xs, dtype),
                                        to_torch(w, dtype))
    want = rks1.stage1_tap_gemm(to_jax(xs, dtype), to_jax(w, dtype),
                                interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])


@pytest.mark.parametrize("T,P,M", [(9, 64, 32), (25, 100, 20), (1, 7, 3)])
def test_stage2_plain_matches_pallas(rng, T, P, M):
    temps = rand(rng, (T, P, M))
    got = cuconv_stage2.stage2_tap_sum(to_torch(temps))
    want = rks2.stage2_tap_sum(to_jax(temps), interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS["float32"])


# (N, H, W, C, KH, KW, M, stride, pad, tm, rows, epilogue): the reference
# grid, plus the fused forms the graph pass produces
FUSED = [
    (1, 7, 7, 16, 3, 3, 8, (1, 1), 1, 128, 1, "none"),
    (2, 9, 11, 4, 5, 5, 6, (1, 1), 2, 128, 1, "none"),
    (1, 13, 13, 32, 3, 3, 16, (1, 1), 1, 128, 1, "none"),
    (2, 8, 8, 8, 1, 1, 12, (1, 1), 0, 128, 1, "none"),
    (1, 6, 6, 3, 3, 3, 5, (1, 1), 0, 128, 1, "none"),
    (1, 9, 9, 8, 3, 3, 6, (2, 2), 1, 128, 1, "bias_relu"),
    (2, 11, 13, 4, 5, 5, 3, (2, 1), 2, 128, 2, "bias"),
    (2, 10, 10, 6, 3, 3, 20, (2, 2), 1, 8, 2, "add"),          # ragged tm
    (1, 12, 12, 5, 3, 3, 10, (1, 1), 1, 4, 4, "add_relu"),
    (1, 16, 16, 3, 3, 3, 16, (1, 1), 1, 16, 4, "maxpool"),
    (2, 12, 12, 4, 3, 3, 9, (1, 1), 1, 5, 6, "avgpool"),
]


def _fused_operands(rng, geom, dtype):
    N, H, W, C, KH, KW, M, stride, pad, tm, rows, epi = geom
    oh = (H + 2 * pad - KH) // stride[0] + 1
    ow = (W + 2 * pad - KW) // stride[1] + 1
    arrays = {"x": rand(rng, (N, H, W, C), dtype),
              "w": rand(rng, (KH, KW, C, M), dtype)}
    kw = dict(stride=stride, padding=(pad, pad), tm=tm, rows=rows,
              activation=("relu" if epi in ("bias_relu", "add_relu",
                                            "maxpool") else None))
    if epi in ("bias", "bias_relu"):
        arrays["bias"] = rand(rng, (M,), dtype)
    if epi.startswith("add"):
        arrays["addend"] = rand(rng, (N, oh, ow, M), dtype)
    if epi.endswith("pool"):
        kw["pool"] = (epi[:3], 2, 2)
    return arrays, kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", FUSED)
def test_cuconv_fused_plain_matches_pallas(rng, geom, dtype):
    arrays, kw = _fused_operands(rng, geom, dtype)
    got = cuconv_fused.cuconv_fused(
        **{k: to_torch(v, dtype) for k, v in arrays.items()}, **kw)
    want = rkf.cuconv_fused(
        **{k: to_jax(v, dtype) for k, v in arrays.items()},
        interpret=True, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])


@pytest.mark.parametrize("N,H,W,C,KH,KW,M,pad", [
    (1, 7, 7, 16, 3, 3, 8, 1),
    (2, 9, 9, 8, 5, 5, 4, 2),
])
def test_cuconv_two_stage_ops_matches_pallas(rng, N, H, W, C, KH, KW, M,
                                             pad):
    x, w = rand(rng, (N, H, W, C)), rand(rng, (KH, KW, C, M))
    got = ops.cuconv_two_stage(to_torch(x), to_torch(w), (pad, pad))
    want = rops.cuconv_two_stage(to_jax(x), to_jax(w), (pad, pad),
                                 interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS["float32"])


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("window,stride,padding", [
    ((2, 2), (2, 2), (0, 0)), ((3, 3), (2, 2), (1, 1)),
    ((2, 3), (1, 2), (0, 1))])
def test_pool2d_matches_reference(rng, kind, window, stride, padding):
    x = rand(rng, (2, 9, 10, 5))
    got = ops.pool2d(to_torch(x), kind, window, stride, padding)
    want = rops.pool2d(to_jax(x), kind, window, stride, padding)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS["float32"])


def test_oracles_match_reference_oracles(rng):
    from repro.core.cuconv import conv_lax
    from repro.kernels import ref as rref
    x, w = rand(rng, (2, 9, 9, 4)), rand(rng, (3, 3, 4, 6))
    np.testing.assert_allclose(
        np32(ref.conv2d_ref(to_torch(x), to_torch(w), 2, (1, 1))),
        np32(conv_lax(to_jax(x), to_jax(w), 2, (1, 1))), rtol=2e-5,
        atol=2e-5)
    np.testing.assert_allclose(
        np32(ref.conv2d_pad_ref(to_torch(x), to_torch(w), (1, 0))),
        np32(rref.conv2d_pad_ref(to_jax(x), to_jax(w), (1, 0))), rtol=2e-5,
        atol=2e-5)
    xs, ws = rand(rng, (3, 10, 4)), rand(rng, (3, 4, 5))
    np.testing.assert_allclose(
        np32(ref.stage1_ref(to_torch(xs), to_torch(ws))),
        np32(rref.stage1_ref(to_jax(xs), to_jax(ws))), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        np32(ref.stage2_ref(to_torch(xs))), np32(rref.stage2_ref(to_jax(xs))),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        np32(ref.conv1x1_ref(to_torch(xs[0]), to_torch(ws[0]))),
        np32(rref.conv1x1_ref(to_jax(xs[0]), to_jax(ws[0]))), rtol=2e-5,
        atol=2e-5)


# ---------------------------------------------------------------------------
# the wrappers' checks hold on the CPU as on the card

def test_cpu_tensors_never_count_as_launches(rng):
    x = to_torch(rand(rng, (1, 8, 8, 4)))
    cuconv_fused.cuconv_fused(x, to_torch(rand(rng, (3, 3, 4, 8))),
                              padding=(1, 1))
    conv1x1.conv1x1_gemm(x.reshape(64, 4), to_torch(rand(rng, (4, 8))))
    cuconv_stage2.stage2_tap_sum(to_torch(rand(rng, (2, 3, 4))))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtype"), ("noncontig", "contiguous"), ("pool_rows", "rows %"),
    ("pool_add", "mutually exclusive"), ("addend_shape", "addend shape"),
    ("activation", "activation"), ("smem", "shared memory")])
def test_cuconv_fused_wrapper_refuses(rng, bad, match):
    x = to_torch(rand(rng, (1, 8, 8, 4)))
    w = to_torch(rand(rng, (3, 3, 4, 8)))
    kw = dict(padding=(1, 1))
    if bad == "dtype":
        w = w.double()
    elif bad == "noncontig":
        x = x.transpose(1, 2)
    elif bad == "pool_rows":
        kw.update(pool=("max", 2, 2), rows=3)
    elif bad == "pool_add":
        kw.update(pool=("max", 2, 2), rows=2, addend=torch.zeros(1, 8, 8, 8))
    elif bad == "addend_shape":
        kw.update(addend=torch.zeros(1, 8, 8, 7))
    elif bad == "activation":
        kw.update(activation="gelu")
    else:
        x = to_torch(rand(rng, (1, 8, 1024, 4)))
        kw.update(pool=("max", 2, 2), rows=8, tm=64)
    with pytest.raises(ValueError, match=match):
        cuconv_fused.cuconv_fused(x, w, **kw)


def test_gemm_wrappers_refuse(rng):
    with pytest.raises(ValueError, match="contract"):
        conv1x1.conv1x1_gemm(torch.zeros(4, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="shared memory"):
        conv1x1.conv1x1_gemm(torch.zeros(4, 1024), torch.zeros(1024, 2),
                             tc=1024)
    with pytest.raises(ValueError, match="float32"):
        cuconv_stage2.stage2_tap_sum(torch.zeros(2, 3, 4,
                                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        cuconv_stage1.stage1_tap_gemm(torch.zeros(2, 3, 4),
                                      torch.zeros(2, 4, 5,
                                                  dtype=torch.bfloat16))


def test_smem_model_is_what_the_wrapper_launches_with():
    """The planner's shared-memory model and the launch size are one
    function: the pool block grows with rows and the fused stem's
    largest 224x224 row block no longer fits."""
    base = cuconv_fused.smem_bytes((1, 224, 224, 3), (3, 3, 3, 16), tm=16,
                                   rows=8, pad=(1, 1))
    pooled = cuconv_fused.smem_bytes((1, 224, 224, 3), (3, 3, 3, 16), tm=16,
                                     rows=8, pad=(1, 1),
                                     pool=("max", 2, 2))
    assert pooled - base == 4 * 8 * 224 * 16
    assert cuconv_fused.smem_bytes(
        (1, 224, 224, 3), (3, 3, 3, 16), tm=16, rows=16, pad=(1, 1),
        pool=("max", 2, 2)) > _build.SMEM_LIMIT
    assert conv1x1.smem_bytes(256) == 4 * 256 * 129
