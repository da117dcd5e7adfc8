"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (interpret mode), on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so
these tests pin the arithmetic the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The grids are those
of ``tests/test_kernels.py`` plus fused stride 2, addend, max/avg pool,
``rows > 1`` and a ragged ``tm``.  Bounds: fp32 2e-5, bf16 2e-2.  The
Winograd kernel is held to the reference's Winograd bounds,
1e-4·max(1, max|ref|) at F(2,3) and 2e-3·max(1, max|ref|) at F(4,3)
in fp32, 3e-2 in bf16; the int8 GEMM is bit-equal.
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
from repro.kernels import direct_conv as rkd
from repro.kernels import int8_gemm as rki8
from repro.kernels import ops as rops
from repro.kernels import winograd_pallas as rkw
from repro_torch.kernels import (_build, conv1x1, cuconv_fused,
                                 cuconv_stage1, cuconv_stage2, direct_conv,
                                 int8_gemm, ops, ref, winograd_fused)

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


# (N, H, W, C, KH, KW, M, pad): stride-1 two-stage shapes, a ragged C and
# M among them
TWO_STAGE = [
    (1, 7, 7, 16, 3, 3, 8, 1),
    (2, 9, 9, 8, 5, 5, 4, 2),
    (2, 6, 7, 5, 3, 2, 9, 1),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", TWO_STAGE)
def test_two_stage_view_free_path_matches_pallas(rng, geom, dtype):
    """The view-free stage-1 entry, which reads each tap's rows straight
    from the padded input, against the reference's stage 1 on its
    stacked views; and ``ops.cuconv_two_stage``, which now calls it,
    against the reference's two-stage op."""
    N, H, W, C, KH, KW, M, pad = geom
    x, w = rand(rng, (N, H, W, C), dtype), rand(rng, (KH, KW, C, M), dtype)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    xs = np.stack([xp[:, i:i + OH, j:j + OW, :].reshape(-1, C)
                   for i in range(KH) for j in range(KW)])
    got = cuconv_stage1.stage1_tap_conv(to_torch(xp, dtype),
                                        to_torch(w, dtype))
    want = rks1.stage1_tap_gemm(to_jax(xs, dtype),
                                to_jax(w.reshape(KH * KW, C, M), dtype),
                                interpret=True)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape) == (KH * KW, N * OH * OW, M)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])
    got = ops.cuconv_two_stage(to_torch(x, dtype), to_torch(w, dtype),
                               (pad, pad))
    want = rops.cuconv_two_stage(to_jax(x, dtype), to_jax(w, dtype),
                                 (pad, pad), interpret=True)
    assert str(got.dtype)[6:] == dtype
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])


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


# (N, H, W, C, M, padding, m, tt, tm, tc, epilogue)
WINOGRAD = [
    (1, 8, 8, 3, 4, (1, 1), 2, 128, 128, 128, "none"),
    (2, 9, 7, 5, 6, (0, 0), 4, 128, 128, 128, "bias_relu"),
    (4, 16, 16, 16, 16, (1, 1), 2, 256, 16, 16, "bias_relu"),
    (1, 10, 10, 6, 5, (1, 1), 4, 64, 128, 64, "add_relu"),
    (2, 7, 9, 4, 7, (2, 1), 2, 16, 4, 8, "add"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", WINOGRAD)
def test_winograd_fused_plain_matches_pallas(rng, geom, dtype):
    N, H, W, C, M, pad, m, tt, tm, tc, epi = geom
    oh, ow = H + 2 * pad[0] - 2, W + 2 * pad[1] - 2
    arrays = {"x": rand(rng, (N, H, W, C), dtype),
              "w": rand(rng, (3, 3, C, M), dtype)}
    if epi in ("bias", "bias_relu"):
        arrays["bias"] = rand(rng, (M,), dtype)
    if epi.startswith("add"):
        arrays["addend"] = rand(rng, (N, oh, ow, M), dtype)
    act = "relu" if epi.endswith("relu") else None
    got = winograd_fused.winograd_fused(
        **{k: to_torch(v, dtype) for k, v in arrays.items()}, padding=pad,
        activation=act, m=m, tt=tt, tm=tm, tc=tc)
    want = rkw.winograd_fused(
        **{k: to_jax(v, dtype) for k, v in arrays.items()}, padding=pad,
        activation=act, m=m, tt=tt, tm=tm, tc=tc, interpret=True)
    want = np32(want)
    assert tuple(got.shape) == want.shape == (N, oh, ow, M)
    tol = {2: 1e-4, 4: 2e-3}[m] if dtype == "float32" else 3e-2
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# (N, H, W, C, KH, KW, M, stride, pad, tm, tc): stride 1 and 2, C above
# one tc slice, a ragged tm
DIRECT = [
    (1, 7, 7, 16, 3, 3, 8, (1, 1), 1, 128, 256),
    (2, 9, 9, 20, 3, 3, 6, (2, 2), 1, 128, 8),
    (1, 8, 10, 12, 5, 5, 10, (1, 2), 2, 4, 5),
    (2, 6, 6, 9, 1, 1, 7, (1, 1), 0, 64, 4),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", DIRECT)
def test_direct_conv_plain_matches_pallas(rng, geom, dtype):
    N, H, W, C, KH, KW, M, stride, pad, tm, tc = geom
    x, w = rand(rng, (N, H, W, C), dtype), rand(rng, (KH, KW, C, M), dtype)
    got = direct_conv.direct_conv(to_torch(x, dtype), to_torch(w, dtype),
                                  (pad, pad), stride, tm=tm, tc=tc)
    want = rkd.direct_conv(to_jax(x, dtype), to_jax(w, dtype), (pad, pad),
                           stride, tm=tm, tc=tc, interpret=True)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])


@pytest.mark.parametrize("P,K,M,tiles", [
    (64, 32, 16, (256, 128, 512)), (300, 130, 70, (128, 64, 128)),
    (67, 27, 5, (64, 64, 8))])
def test_int8_gemm_plain_is_bit_equal_to_pallas(rng, P, K, M, tiles):
    x = rng.integers(-127, 128, (P, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, M)).astype(np.int8)
    tp, tm, tc = tiles
    got = int8_gemm.int8_gemm(torch.from_numpy(x), torch.from_numpy(w),
                              tp=tp, tm=tm, tc=tc)
    want = rki8.int8_gemm(x, w, tp=tp, tm=tm, tc=tc, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the wrappers' checks hold on the CPU as on the card

def test_cpu_tensors_never_count_as_launches(rng):
    x = to_torch(rand(rng, (1, 8, 8, 4)))
    cuconv_fused.cuconv_fused(x, to_torch(rand(rng, (3, 3, 4, 8))),
                              padding=(1, 1))
    conv1x1.conv1x1_gemm(x.reshape(64, 4), to_torch(rand(rng, (4, 8))))
    cuconv_stage2.stage2_tap_sum(to_torch(rand(rng, (2, 3, 4))))
    winograd_fused.winograd_fused(x, to_torch(rand(rng, (3, 3, 4, 8))))
    direct_conv.direct_conv(x, to_torch(rand(rng, (3, 3, 4, 8))))
    int8_gemm.int8_gemm(torch.ones((4, 4), dtype=torch.int8),
                        torch.ones((4, 2), dtype=torch.int8))
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
        # the block tile no longer grows with rows * OW; what it cannot
        # stage is a pool window wider than its 64 pixels
        x = to_torch(rand(rng, (1, 18, 18, 4)))
        kw.update(pool=("max", 9, 9), rows=9, tm=64)
    with pytest.raises(ValueError, match=match):
        cuconv_fused.cuconv_fused(x, w, **kw)


def test_gemm_wrappers_refuse(rng):
    with pytest.raises(ValueError, match="contract"):
        conv1x1.conv1x1_gemm(torch.zeros(4, 3), torch.zeros(4, 2))
    # stage 1's geometry is its own (tc stages nothing, so tc=1024 runs);
    # what it refuses is a tile that is not a tile, and a filter that
    # does not contract; the int8 GEMM's geometry is its own too, and
    # what it refuses is a contraction long enough to overflow int32
    assert cuconv_stage1.stage1_tap_gemm(
        torch.zeros(1, 4, 1024), torch.zeros(1, 1024, 2),
        tc=1024).shape == (1, 4, 2)
    with pytest.raises(ValueError, match="must be >= 1"):
        cuconv_stage1.stage1_tap_gemm(torch.zeros(1, 4, 8),
                                      torch.zeros(1, 8, 2), tc=0)
    with pytest.raises(ValueError, match="filter depth"):
        cuconv_stage1.stage1_tap_conv(torch.zeros(1, 5, 5, 4),
                                      torch.zeros(3, 3, 3, 2))
    with pytest.raises(ValueError, match="overflow"):
        int8_gemm.int8_gemm(
            torch.zeros((4, int8_gemm.K_MAX + 1), dtype=torch.int8),
            torch.zeros((int8_gemm.K_MAX + 1, 2), dtype=torch.int8),
            tc=2048)
    with pytest.raises(ValueError, match="float32"):
        cuconv_stage2.stage2_tap_sum(torch.zeros(2, 3, 4,
                                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        cuconv_stage1.stage1_tap_gemm(torch.zeros(2, 3, 4),
                                      torch.zeros(2, 4, 5,
                                                  dtype=torch.bfloat16))


def test_new_wrappers_refuse(rng):
    x = to_torch(rand(rng, (1, 8, 8, 4)))
    w3 = to_torch(rand(rng, (3, 3, 4, 8)))
    with pytest.raises(ValueError, match="3x3"):
        winograd_fused.winograd_fused(x, to_torch(rand(rng, (5, 5, 4, 8))))
    with pytest.raises(ValueError, match="got m=3"):
        winograd_fused.winograd_fused(x, w3, m=3)
    with pytest.raises(ValueError, match="addend shape"):
        winograd_fused.winograd_fused(x, w3, addend=torch.zeros(1, 8, 8, 7))
    with pytest.raises(ValueError, match="dtype"):
        direct_conv.direct_conv(x, w3.double())
    # 225 taps: even the smallest tile's two-stage ring of filter slices
    # is more than a block's shared memory
    assert direct_conv.launch_geometry((1, 20, 20, 2), (15, 15, 2, 64))[
        "smem"] > _build.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        direct_conv.direct_conv(to_torch(rand(rng, (1, 20, 20, 2))),
                                torch.zeros((15, 15, 2, 64)), tm=64)
    with pytest.raises(ValueError, match="int8"):
        int8_gemm.int8_gemm(torch.zeros((4, 4)),
                            torch.zeros((4, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="contract"):
        int8_gemm.int8_gemm(torch.zeros((4, 3), dtype=torch.int8),
                            torch.zeros((4, 2), dtype=torch.int8))


def test_new_smem_models_are_what_the_kernels_stage():
    """The shapes the kernels pick, and the shared memory that follows:
    the Winograd kernel's block follows m and the channel cap alone and
    stays bounded (it runs all of C inside a block), the direct
    kernel's grows with the filter and the stride (its halo and filter
    slices), not with C, the int8 GEMM's with its one output tile and
    the staged depth."""
    narrow = winograd_fused.launch_geometry(2, 256, 16, tm=16)
    assert (narrow["bt"], narrow["bn"], narrow["blocks"]) == (64, 16, 4)
    assert narrow["smem"] == (2 * (64 * (16 * 8 + 8) + 9 * 8 * 16) * 4
                              + (16 * 64 * 8 + 16 * 8 * 16) * 4)
    wide = winograd_fused.launch_geometry(4, 1568, 64, tm=128)
    assert (wide["bt"], wide["bn"], wide["blocks"]) == (16, 32, 196)
    assert max(winograd_fused.launch_geometry(m, 100, 64, tm)["smem"]
               for m in (2, 4) for tm in (16, 128)) == \
        2 * (32 * (36 * 8 + 8) + 9 * 8 * 16) * 4 + (36 * 32 * 8
                                                     + 36 * 8 * 16) * 4
    # b2c1@224 (3x3, stride 2): a 4 x 8 pixel tile, its 9 x 17 halo of
    # 8 channels (+ 16 bytes a position) and a 16-channel filter slice,
    # two stages, after the 612-byte halo table (rounded to 624)
    geo = direct_conv.launch_geometry((1, 112, 112, 16), (3, 3, 16, 32),
                                      (2, 2), (1, 1))
    assert (geo["th"], geo["tw"], geo["bn"], geo["chunk"],
            geo["stages"]) == (4, 8, 16, 8, 2)
    assert geo["smem"] == 624 + 2 * (9 * 17 * 12 + 9 * 8 * 24) * 4
    # C does not size it: t4_B's tile at C = 384 and at C = 3840
    small, big = (direct_conv.launch_geometry((1, 13, 13, c), (3, 3, c, 384),
                                              padding=(1, 1))
                  for c in (384, 3840))
    assert small["smem"] == big["smem"]
    # an 11x11 filter fits at the smallest tile only
    geo = direct_conv.launch_geometry((1, 40, 40, 3), (11, 11, 3, 64))
    assert (geo["bm"], geo["bn"], geo["stages"]) == (32, 16, 2)
    assert geo["smem"] <= _build.SMEM_LIMIT < direct_conv.smem_bytes(
        geo["th"], geo["tw"], 32, 32, geo["chunk"], (11, 11, 3, 64),
        stages=2)
    # b2c2 at batch 1: a 16 x 32 tile, all 288 codes of K staged for
    # 16 + 32 rows, 16 bytes of padding each
    assert int8_gemm.launch_geometry(64, 288, 32)["smem"] == 48 * 304


def test_smem_model_is_what_the_wrapper_launches_with():
    """The planner's shared-memory model and the launch size are one
    function.  The fused kernel's follows its block tile, not rows x OW:
    the 224x224 pooled stem stages one 3-stage ring of a 64-pixel x
    16-channel tile (2 rows x 32 columns of whole 2x2 windows), the same
    with and without the pool: the finished fp32 tile reuses the ring;
    no tile comes near the budget."""
    stem = cuconv_fused.launch_geometry((1, 224, 224, 3), (3, 3, 3, 16),
                                        padding=(1, 1), pool=("max", 2, 2))
    assert (stem["bm"], stem["bn"], stem["th"], stem["tw"]) == (64, 16, 2,
                                                                 32)
    assert (stem["tiles"], stem["splits"], stem["blocks"]) == (784, 1, 784)
    assert stem["smem"] == 3 * (64 * 36 + 32 * 24) * 4
    bare = cuconv_fused.launch_geometry((1, 224, 224, 3), (3, 3, 3, 16),
                                        padding=(1, 1))
    assert bare["smem"] == stem["smem"] > 4 * 64 * (16 + 4)
    assert cuconv_fused.smem_bytes(64, 64, 2) == 3 * (64 * 40 + 32 * 72) * 2
    assert max(cuconv_fused.smem_bytes(bm, bn, size) for bm in (32, 64)
               for bn in (16, 32, 64) for size in (2, 4)) < \
        _build.SMEM_LIMIT // 4
    # stage 1's 3-stage ring: (bm x (32 + 16 bytes) + 32 x (bn + 8)), or
    # the finished fp32 tile where that is larger
    assert cuconv_stage1.smem_bytes(32, 32) == 3 * (32 * 36 + 32 * 40) * 4
    assert cuconv_stage1.smem_bytes(64, 64, 2) == 3 * (64 * 40 + 32 * 72) * 2
    assert cuconv_stage1.launch_geometry(9, 49, 192, 384)["smem"] == \
        cuconv_stage1.smem_bytes(32, 32)
    # the 1x1 GEMM's 3-stage ring: (bm x (32 + 16 bytes) + 32 x 72) each
    assert conv1x1.smem_bytes(64) == 3 * (64 * 36 + 32 * 72) * 4
    assert conv1x1.smem_bytes(32, 2) == 3 * (32 * 40 + 32 * 72) * 2
