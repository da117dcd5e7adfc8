"""The tensor-core kernels' numerics and launch geometry, on the CPU.

``conv1x1_gemm`` and ``winograd_fused`` run their fp32 products on the
TF32 tensor cores in the 3xTF32 split (``csrc/mma_tf32.cuh``).  The
first tests emulate that split in torch: round to TF32 as
``cvt.rna.tf32.f32`` does, then big*big + big*small + small*big in
fp32, at the paper's three 1x1 shapes and at resnet50's two Winograd
rows (their per-position products).  It meets the kernels' fp32 bound,
2e-5 * max(1, max|ref|), against a float64 product; a plain TF32
product misses it, which is why the kernels split.

The rest hold each kernel's ``launch_geometry`` (what the wrapper
launches, and what the planner's ``vmem_bytes`` reads) to the card: at
the five main-path shapes it launches at least one wave of 132 blocks,
its contraction splits cover C exactly in whole 32-deep steps, and the
wrapper launches with the same shared memory the executor models.
"""
import contextlib

import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches  # noqa: F401
from repro_torch.configs.cnn_paper import PROFILED
from repro_torch.core import convspec as tcs
from repro_torch.core import executors
from repro_torch.core.winograd import matrices, transform_filters
from repro_torch.kernels import _build, conv1x1, winograd_fused

FP32_TOL = 2e-5
SMS = 132
GEMM_SHAPES = {label: (hw * hw * n, c, m)              # (P, C, M)
               for label, (hw, n, k, m, c) in PROFILED.items() if k == 1}
# resnet50's 3x3 layers at batch 8 (chip_smoke's WINOGRAD_ROWS):
# (H=W, C, M, F(m,3) variant, tm of the reference's config)
WINO_ROWS = {"r50_56x56x64": (56, 64, 64, 4, 64),
             "r50_28x28x128": (28, 128, 128, 2, 128)}


def tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding to nearest
    with ties away from zero (on the sign-magnitude bit pattern)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def product_3xtf32(a, b):
    """(..., P, C) @ (..., C, M) as the kernels run it: each operand
    split into TF32 big and small parts, three products summed in fp32,
    the small terms first."""
    ab, bb = tf32(a), tf32(b)
    asm, bsm = tf32(a - ab), tf32(b - bb)
    return asm @ bb + ab @ bsm + ab @ bb


def _error(got, a, b):
    ref = a.double() @ b.double()
    err = (got.double() - ref).abs().max().item()
    return err, FP32_TOL * max(1.0, ref.abs().max().item())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      1 + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    big = tf32(x)
    # the split is exact: x - big is a float32, and big + small gets x
    # back within TF32's resolution of the remainder
    assert torch.equal(big + (x - big), x)


def _winograd_operands(hw, c, m, fm, seed):
    """The per-position operands of F(m,3) at batch 8: V (R, tiles, C)
    from a seeded input, U (R, C, M) from seeded weights."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, hw, hw, c),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, c, m),
                                             dtype=np.float32))
    bt = matrices(fm)[0]
    a = fm + 2
    th = -(-hw // fm)
    xp = torch.nn.functional.pad(x, (0, 0, 1, fm * th + 1 - hw,
                                     1, fm * th + 1 - hw))
    tiles = xp.unfold(1, a, fm).unfold(2, a, fm)
    V = torch.einsum("pi,nhwcij,qj->pqnhwc", bt, tiles, bt)
    return (V.reshape(a * a, -1, c).contiguous(),
            transform_filters(w, fm).reshape(a * a, c, m).contiguous())


def _operands(label):
    if label in WINO_ROWS:
        hw, c, m, fm, _ = WINO_ROWS[label]
        return _winograd_operands(hw, c, m, fm, seed=1)
    P, C, M = GEMM_SHAPES[label]
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((P, C), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((C, M), dtype=np.float32)))


@pytest.mark.parametrize("label", sorted(GEMM_SHAPES) + sorted(WINO_ROWS))
def test_3xtf32_meets_the_fp32_bound_and_1xtf32_misses_it(label):
    a, b = _operands(label)
    err, bound = _error(product_3xtf32(a, b), a, b)
    assert err <= bound, (label, err, bound)
    err1, _ = _error(tf32(a) @ tf32(b), a, b)
    assert err1 > bound, (label, err1, bound)


# ---------------------------------------------------------------------------
# launch geometry

def _main_path_geometries():
    """(label, launch geometry) of the five main-path shapes."""
    out = {label: conv1x1.launch_geometry(P, C, M)
           for label, (P, C, M) in GEMM_SHAPES.items()}
    for label, (hw, c, m, fm, tm) in WINO_ROWS.items():
        tiles = 8 * (-(-hw // fm)) ** 2
        out[label] = winograd_fused.launch_geometry(fm, tiles, m, tm)
    return out


@pytest.mark.parametrize("label", sorted(GEMM_SHAPES) + sorted(WINO_ROWS))
def test_main_path_shapes_launch_a_wave(label):
    geo = _main_path_geometries()[label]
    assert geo["blocks"] >= SMS, geo
    assert geo["smem"] <= _build.SMEM_LIMIT


@pytest.mark.parametrize("P,C,M", [(49, 832, 256), (196, 256, 1024),
                                   (729, 64, 256), (17, 257, 129),
                                   (5000, 40, 8), (1, 1, 1)])
def test_k_splits_cover_c_exactly_in_whole_steps(P, C, M):
    geo = conv1x1.launch_geometry(P, C, M)
    ranges = conv1x1.split_ranges(C, geo["splits"])
    assert len(ranges) == geo["splits"] <= geo["k_steps"]
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for b, e in ranges:
        assert b < e and b % conv1x1.BK == 0
        assert e == C or e % conv1x1.BK == 0
    # one wave, or every output tile already a block, or every step split
    assert (geo["blocks"] >= SMS or geo["splits"] == 1
            and geo["tiles"] >= SMS or geo["splits"] == geo["k_steps"])


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch arguments, recorded on the CPU: on_card says
    yes, and the library records each call and reports success."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            return lambda *args: calls.append((fn, args)) or 0

    monkeypatch.setattr(_build, "on_card", lambda name, t: True)
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return calls


@pytest.mark.parametrize("label", sorted(GEMM_SHAPES))
def test_conv1x1_wrapper_launches_the_executors_geometry(label, fake_card):
    hw, n, _, m, c = PROFILED[label]
    spec = tcs.ConvSpec((n, hw, hw, c), (1, 1, c, m))
    p = tcs.plan(spec, backend="cuda")
    assert p.algorithm == "conv1x1_pallas"
    P, C, M = GEMM_SHAPES[label]
    conv1x1.conv1x1_gemm(torch.zeros((P, C)), torch.zeros((C, M)),
                         **p.config.as_dict())
    (fn, args), = fake_card
    geo = conv1x1.launch_geometry(P, C, M)
    # ..., dtype, P, C, M, bm, splits, vec, smem, stream
    assert fn == "conv1x1_gemm_launch"
    assert args[6:12] == (P, C, M, geo["bm"], geo["splits"], 1)
    assert args[12] == geo["smem"] == p.executor.vmem_bytes(spec, p.config)
    assert (args[3] is None) == (geo["splits"] == 1)
    assert _build.LAUNCHES["conv1x1_gemm"] == 1


@pytest.mark.parametrize("label", sorted(WINO_ROWS))
def test_winograd_wrapper_launches_the_executors_geometry(label, fake_card):
    hw, c, m, fm, tm = WINO_ROWS[label]
    spec = tcs.ConvSpec((8, hw, hw, c), (3, 3, c, m), padding=(1, 1))
    ex = executors.get("winograd_pallas")
    cfg = {"m": fm, "tt": 256, "tm": tm, "tc": c}
    assert ex.config_supports(spec, cfg)[0]
    winograd_fused.winograd_fused(torch.zeros((8, hw, hw, c)),
                                  torch.zeros((3, 3, c, m)), m=fm, tt=256,
                                  tm=tm, tc=c)
    (fn, args), = fake_card
    geo = _main_path_geometries()[label]
    # ..., m, bn, vec, relu, smem, stream
    assert fn == "winograd_fused_launch"
    assert args[15:18] == (fm, geo["bn"], 1)
    assert args[19] == geo["smem"] == ex.vmem_bytes(spec, cfg)
    assert _build.LAUNCHES["winograd_fused"] == 1
