"""The tensor-core kernels' numerics and launch geometry, on the CPU.

``conv1x1_gemm``, ``cuconv_fused``, ``winograd_fused``,
``direct_conv``, ``stage1_tap_gemm`` and ``flash_attention`` run their
fp32 products on the TF32 tensor cores in the 3xTF32 split
(``csrc/mma_tf32.cuh``).  The first tests emulate that
split in torch: round to TF32 as ``cvt.rna.tf32.f32`` does, then
big*big + big*small + small*big in fp32, at the paper's three 1x1
shapes, resnet50's two Winograd rows (their per-position products), the
fused kernel's implicit GEMMs at the paper's 3x3 and 5x5 rows, and the
two attention products at qwen2's head_dim.  It meets the kernels' fp32
bound, 2e-5 * max(1, max|ref|), against a float64 product; a plain TF32
product misses it, which is why the kernels split.

The rest hold each kernel's ``launch_geometry`` (what the wrapper
launches, and what the planner's ``vmem_bytes`` reads) to the card: at
the fourteen main-path paper shapes it launches at least one wave of 132
blocks, its contraction splits cover the contraction exactly in whole
steps (or, for the direct conv, whole chunks of channels), a pooled
tile holds whole windows, the wrapper launches with the same geometry
and shared memory the executor models, stage 1's row rule reads,
from the padded input, the rows of the stacked tap views, and at the
served int8 nodes each ``int8_gemm`` block owns one output tile.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches  # noqa: F401
from repro_torch.configs.cnn_paper import PROFILED
from repro_torch.core import convspec as tcs
from repro_torch.core import executors
from repro_torch.core.winograd import matrices, transform_filters
from repro_torch.kernels import (_build, conv1d_tap, conv1x1, cuconv_fused,
                                 cuconv_stage1, cuconv_stage2, direct_conv,
                                 flash_attention, int8_gemm, ops,
                                 winograd_fused)

FP32_TOL = 2e-5
SMS = 132
GEMM_SHAPES = {label: (hw * hw * n, c, m)              # (P, C, M)
               for label, (hw, n, k, m, c) in PROFILED.items() if k == 1}
# resnet50's 3x3 layers at batch 8 (chip_smoke's WINOGRAD_ROWS):
# (H=W, C, M, F(m,3) variant, tm of the reference's config)
WINO_ROWS = {"r50_56x56x64": (56, 64, 64, 4, 64),
             "r50_28x28x128": (28, 128, 128, 2, 128)}
# the paper's 3x3 and 5x5 rows, on cuconv_fused: (x shape, w shape, pad)
FUSED_ROWS = {label: ((n, hw, hw, c), (k, k, c, m), (k - 1) // 2)
              for label, (hw, n, k, m, c) in PROFILED.items() if k > 1}
# qwen2-1.5b's attention at its served prefill: (S, head_dim)
ATTN_SHAPE = (512, 128)


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


def _im2col(x, kh, kw, pad):
    """The fused kernel's implicit A operand, (pixels, KH*KW*C) in HWIO
    order, made explicit."""
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=3).reshape(n * h * w, kh * kw * c)


def _attention_operands(which):
    """qwen2's two attention products at the served prefill, one head:
    Q Kᵀ, and P V with P the softmax numerators of those scores."""
    S, D = ATTN_SHAPE
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, D),
                                                    dtype=np.float32))
               for _ in range(3))
    if which == "qk":
        return q, k.t().contiguous()
    s = q.double() @ k.t().double() / D ** 0.5
    return torch.exp(s - s.amax(dim=-1, keepdim=True)).float(), v


def _operands(label):
    if label in ("attn_qk", "attn_pv"):
        return _attention_operands(label[5:])
    if label in FUSED_ROWS:
        x_shape, w_shape, pad = FUSED_ROWS[label]
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal(x_shape, dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal(w_shape, dtype=np.float32))
        return (_im2col(x, w_shape[0], w_shape[1], pad),
                w.reshape(-1, w_shape[3]))
    if label in WINO_ROWS:
        hw, c, m, fm, _ = WINO_ROWS[label]
        return _winograd_operands(hw, c, m, fm, seed=1)
    P, C, M = GEMM_SHAPES[label]
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((P, C), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((C, M), dtype=np.float32)))


@pytest.mark.parametrize("label", sorted(GEMM_SHAPES) + sorted(WINO_ROWS)
                         + sorted(FUSED_ROWS) + ["attn_qk", "attn_pv"])
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


# ---------------------------------------------------------------------------
# cuconv_fused: the implicit GEMM's geometry

def _fused_geometry(label, itemsize=4):
    x_shape, w_shape, pad = FUSED_ROWS[label]
    return cuconv_fused.launch_geometry(x_shape, w_shape, (1, 1),
                                        (pad, pad), None, itemsize)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("label", sorted(FUSED_ROWS))
def test_fused_paper_rows_launch_a_wave(label, itemsize):
    geo = _fused_geometry(label, itemsize)
    assert geo["blocks"] >= SMS, geo
    assert geo["smem"] <= _build.SMEM_LIMIT
    # never more than MAX_SPLITS, each split two steps or more
    assert geo["splits"] <= min(cuconv_fused.MAX_SPLITS,
                                geo["k_steps"] // 2)


def test_fused_geometry_is_the_measured_table():
    """The geometry the rule gives at the paper's rows: the large tile
    split 16 ways where that makes two blocks per SM (t4_B), else a
    smaller tile (t5_B: 32 pixels; t4_A: 32 x 32; t5_A: 32 x 16)."""
    got = {label: tuple(_fused_geometry(label)[k] for k in
                        ("bm", "bn", "tiles", "splits", "blocks"))
           for label in FUSED_ROWS}
    assert got == {"t4_A": (32, 32, 24, 16, 384),
                   "t4_B": (64, 64, 18, 16, 288),
                   "t5_A": (32, 16, 16, 16, 256),
                   "t5_B": (32, 64, 26, 16, 416)}
    # resnet_like's 224x224 nodes: tiles of their own width fill the card
    # (b1c1), or shrink before any split (b2c1, b2proj)
    served = {"b1c1": ((1, 112, 112, 16), (3, 3, 16, 16), 1, 1),
              "b2c1": ((1, 112, 112, 16), (3, 3, 16, 32), 2, 1),
              "b2c2": ((1, 56, 56, 32), (3, 3, 32, 32), 1, 1),
              "b2proj": ((1, 112, 112, 16), (1, 1, 16, 32), 2, 0)}
    got = {label: tuple(cuconv_fused.launch_geometry(
        x, w, (st, st), (pad, pad))[k] for k in ("bm", "bn", "splits",
                                                 "blocks"))
        for label, (x, w, st, pad) in served.items()}
    assert got == {"b1c1": (64, 16, 1, 196), "b2c1": (32, 16, 1, 196),
                   "b2c2": (32, 32, 4, 392), "b2proj": (32, 16, 1, 196)}


@pytest.mark.parametrize("x_shape,w_shape,stride,pad", [
    ((1, 13, 13, 384), (3, 3, 384, 384), (1, 1), (1, 1)),   # t4_B
    ((1, 7, 7, 48), (5, 5, 48, 128), (1, 1), (2, 2)),       # t5_A
    ((1, 112, 112, 16), (3, 3, 16, 32), (2, 2), (1, 1)),    # b2c1@224
    ((1, 56, 56, 16), (1, 1, 16, 32), (2, 2), (0, 0)),      # b2proj
    ((2, 9, 9, 130), (3, 3, 130, 7), (1, 1), (1, 1)),
    ((1, 3, 3, 3), (3, 3, 3, 5), (1, 1), (1, 1)),
])
def test_fused_k_splits_cover_k_exactly_in_whole_steps(x_shape, w_shape,
                                                       stride, pad):
    geo = cuconv_fused.launch_geometry(x_shape, w_shape, stride, pad)
    K = w_shape[0] * w_shape[1] * w_shape[2]
    assert geo["k_steps"] == -(-K // cuconv_fused.BK)
    # both kernels cut K as csrc/splitk.cuh does (split_steps)
    ranges = conv1x1.split_ranges(K, geo["splits"])
    assert len(ranges) == geo["splits"] <= geo["k_steps"]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for b, e in ranges:
        assert b < e and b % cuconv_fused.BK == 0
        assert e == K or e % cuconv_fused.BK == 0
    # one wave; or the tiles alone fill it; or the smallest tile with as
    # many splits as the rule allows
    capped = geo["splits"] == max(1, min(cuconv_fused.MAX_SPLITS,
                                         geo["k_steps"] // 2))
    assert (geo["blocks"] >= SMS
            or geo["splits"] == 1 and geo["tiles"] >= SMS
            or capped and (geo["bm"], geo["bn"]) == (32, 16))


@pytest.mark.parametrize("OH,OW,psh,psw", [
    (224, 224, 2, 2), (32, 32, 2, 2), (8, 8, 2, 2), (6, 30, 3, 3),
    (12, 4, 2, 4), (2, 128, 2, 2), (18, 18, 3, 3), (4, 6, 1, 3)])
def test_pooled_tiles_hold_whole_windows(OH, OW, psh, psw):
    """Every pooled block tile is whole windows of one image: TH and TW
    multiples of the window, TH x TW within the 64-pixel tile, and the
    tiles (ragged edges included) cover the output exactly.  Pooled
    specs take no K-split."""
    th, tw = cuconv_fused.pool_tile(OH, OW, psh, psw)
    assert th % psh == 0 and tw % psw == 0 and 0 < th * tw <= 64
    covered = set()
    for r0 in range(0, OH, th):
        for c0 in range(0, OW, tw):
            rows = range(r0, min(r0 + th, OH))
            cols = range(c0, min(c0 + tw, OW))
            assert len(rows) % psh == 0 and len(cols) % psw == 0
            covered |= {(r, c) for r in rows for c in cols}
    assert len(covered) == OH * OW
    geo = cuconv_fused.launch_geometry((2, OH, OW, 8), (1, 1, 8, 40),
                                       pool=("max", psh, psw))
    assert (geo["th"], geo["tw"], geo["splits"]) == (th, tw, 1)
    assert geo["tiles"] == 2 * -(-OH // th) * -(-OW // tw) * 1


def test_pool_window_wider_than_a_tile_is_refused():
    with pytest.raises(ValueError, match="does not fit"):
        cuconv_fused.pool_tile(18, 18, 9, 9)
    spec = tcs.ConvSpec((1, 18, 18, 4), (3, 3, 4, 8), padding=(1, 1),
                        fused_pool=("max", 9, 9, 9, 9, 0, 0))
    ok, why = executors.get("cuconv_pallas").supports(spec)
    assert not ok and "does not fit" in why


_FUSED_SERVED = {   # resnet_like's 224x224 nodes: x, w, stride, pad, pool
    "stem": ((1, 224, 224, 3), (3, 3, 3, 16), 1, 1, ("max", 2, 2)),
    "b2c1": ((1, 112, 112, 16), (3, 3, 16, 32), 2, 1, None),
}


@pytest.mark.parametrize("label", sorted(FUSED_ROWS) + sorted(_FUSED_SERVED))
def test_fused_wrapper_launches_the_executors_geometry(label, fake_card):
    if label in FUSED_ROWS:
        x_shape, w_shape, pad = FUSED_ROWS[label]
        stride, pool, fused_pool = 1, None, None
    else:
        x_shape, w_shape, stride, pad, pool = _FUSED_SERVED[label]
        fused_pool = pool and (pool[0], 2, 2, 2, 2, 0, 0)
    spec = tcs.ConvSpec(x_shape, w_shape, (stride, stride), (pad, pad),
                        fused_pool=fused_pool)
    p = tcs.plan(spec, force="cuconv_pallas", backend="cuda")
    cuconv_fused.cuconv_fused(torch.zeros(x_shape), torch.zeros(w_shape),
                              stride=(stride, stride), padding=(pad, pad),
                              pool=pool, **p.config.as_dict())
    (fn, args), = fake_card
    geo = cuconv_fused.launch_geometry(x_shape, w_shape, (stride, stride),
                                       (pad, pad), pool)
    # ..., th, tw, bm, bn, tiles, splits, vec_a, vec_b, smem, stream
    assert fn == "cuconv_fused_launch"
    assert args[8:15] == tuple(x_shape) + tuple(w_shape[:2]) + (w_shape[3],)
    assert args[25:31] == ((geo["th"] or 0), (geo["tw"] or 0), geo["bm"],
                           geo["bn"], geo["tiles"], geo["splits"])
    assert args[31:33] == (int(x_shape[3] % 4 == 0), 1)
    assert args[33] == geo["smem"] == p.executor.vmem_bytes(spec, p.config)
    assert (args[5] is None) == (geo["splits"] == 1)
    assert _build.LAUNCHES["cuconv_fused"] == 1


# ---------------------------------------------------------------------------
# flash_attention

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 512, 12, 2, 128), (1, 100, 3, 1, 40), (2, 64, 6, 3, 64)])
def test_flash_wrapper_launches_its_model(shape, dtype, fake_card):
    """The grid (64 query rows, head, batch), the padded head dimension
    and the shared memory of ``launch_geometry`` are what the wrapper
    launches with."""
    B, S, H, KVH, D = shape
    q = torch.zeros((B, S, H, D), dtype=dtype)
    kv = torch.zeros((B, S, KVH, D), dtype=dtype)
    out = flash_attention.flash_attention(q, kv, kv, causal=True)
    (fn, args), = fake_card
    geo = flash_attention.launch_geometry(B, S, H, D, q.element_size())
    # q, k, v, out, dtype, B, Sq, Sk, H, KVH, D, dp, scale, causal, smem
    assert fn == "flash_attention_launch"
    assert args[5:12] == (B, S, S, H, KVH, D, geo["dp"])
    assert args[13:15] == (1, geo["smem"])
    assert geo["grid"] == (-(-S // 64), H, B) and geo["threads"] == 128
    assert geo["smem"] == flash_attention.smem_bytes(D, q.element_size())
    assert out.shape == q.shape and out.dtype == dtype
    assert _build.LAUNCHES["flash_attention"] == 1


# ---------------------------------------------------------------------------
# direct_conv and stage1_tap_gemm: the tensor-core redesigns' geometry

# chip_smoke's forced direct rows and resnet_like's stride-2 b2c1 at
# 224x224: (x shape, w shape, stride, pad)
DIRECT_ROWS = {f"{label}:direct": ((n, hw, hw, c), (k, k, c, m), 1,
                                   (k - 1) // 2)
               for label, (hw, n, k, m, c) in PROFILED.items()
               if label in ("t3_A", "t4_B", "t5_B")}
DIRECT_ROWS["b2c1@224:direct"] = ((1, 112, 112, 16), (3, 3, 16, 32), 2, 1)
# chip_smoke's forced two-stage rows: (T, P, C, M), and x, w, pad
TWO_STAGE_ROWS = {f"{label}:two_stage": ((k * k, n * hw * hw, c, m),
                                         ((n, hw, hw, c), (k, k, c, m),
                                          (k - 1) // 2))
                  for label, (hw, n, k, m, c) in PROFILED.items()
                  if label in ("t4_A", "t5_A")}
PAPER_ROWS = ("t3_A:direct", "t4_B:direct", "t5_B:direct", "t4_A:two_stage",
              "t5_A:two_stage")


def _redesigned_geometry(label, itemsize=4):
    if label in DIRECT_ROWS:
        x_shape, w_shape, st, pad = DIRECT_ROWS[label]
        return direct_conv.launch_geometry(x_shape, w_shape, (st, st),
                                           (pad, pad), itemsize)
    return cuconv_stage1.launch_geometry(*TWO_STAGE_ROWS[label][0],
                                         itemsize=itemsize)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("label", sorted(DIRECT_ROWS)
                         + sorted(TWO_STAGE_ROWS))
def test_direct_and_stage1_main_path_shapes_launch_a_wave(label, itemsize):
    geo = _redesigned_geometry(label, itemsize)
    if label in PAPER_ROWS:
        assert geo["blocks"] >= SMS, geo
    assert geo["blocks"] == geo["tiles"] * (
        geo["splits"] if label in DIRECT_ROWS else
        TWO_STAGE_ROWS[label][0][0])
    assert geo["smem"] <= _build.SMEM_LIMIT


def test_direct_and_stage1_geometry_is_the_planned_table():
    """The rule's geometry at the paper's rows in fp32: t4_B keeps its
    64 x 64 tile (4 x 13 pixels) and splits C 16 ways; the others shrink
    to 32 rows and narrower channel tiles first.  Stage 1 needs no
    split: the taps fill the card."""
    keys = ("th", "tw", "bn", "splits", "stages", "blocks")
    got = {label: tuple(_redesigned_geometry(label)[k] for k in keys)
           for label in DIRECT_ROWS}
    assert got == {"t3_A:direct": (4, 7, 16, 13, 2, 416),
                   "t4_B:direct": (4, 13, 64, 16, 3, 384),
                   "t5_B:direct": (4, 7, 32, 6, 2, 384),
                   "b2c1@224:direct": (4, 8, 16, 1, 2, 196)}
    got = {label: tuple(_redesigned_geometry(label)[k] for k in
                        ("bm", "bn", "tiles", "blocks"))
           for label in TWO_STAGE_ROWS}
    assert got == {"t4_A:two_stage": (32, 32, 24, 216),
                   "t5_A:two_stage": (32, 32, 8, 200)}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("x_shape,w_shape,stride,pad", [
    ((1, 7, 7, 832), (1, 1, 832, 256), (1, 1), (0, 0)),     # t3_A
    ((1, 13, 13, 384), (3, 3, 384, 384), (1, 1), (1, 1)),   # t4_B
    ((8, 7, 7, 48), (5, 5, 48, 128), (1, 1), (2, 2)),       # t5_B
    ((1, 112, 112, 16), (3, 3, 16, 32), (2, 2), (1, 1)),    # b2c1@224
    ((2, 9, 9, 130), (3, 3, 130, 7), (1, 1), (1, 1)),
    ((1, 5, 5, 3), (1, 1, 3, 5), (1, 1), (0, 0)),
    ((2, 13, 13, 9), (7, 7, 9, 40), (2, 1), (3, 3)),
])
def test_direct_c_splits_cover_c_exactly_in_whole_chunks(x_shape, w_shape,
                                                         stride, pad,
                                                         itemsize):
    geo = direct_conv.launch_geometry(x_shape, w_shape, stride, pad,
                                      itemsize)
    C = w_shape[2]
    chunk = geo["chunk"]
    assert chunk % direct_conv.KSTEP[itemsize] == 0
    assert geo["chunks"] == -(-C // chunk)
    ranges = direct_conv.split_ranges(C, chunk, geo["splits"])
    assert len(ranges) == geo["splits"] <= min(geo["chunks"],
                                               direct_conv.MAX_SPLITS)
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    for (_, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    for b, e in ranges:
        assert b < e and b % chunk == 0
        assert e == C or e % chunk == 0
    # the pixel tile fits the block's mma rows and tiles the output
    OH, OW = cuconv_fused._geometry(x_shape, w_shape, stride, pad)
    assert geo["th"] * geo["tw"] <= geo["bm"]
    assert geo["tiles"] == (x_shape[0] * -(-OH // geo["th"])
                            * -(-OW // geo["tw"])
                            * -(-w_shape[3] // geo["bn"]))
    # one wave; or the tiles alone fill it; or the smallest tile
    assert (geo["blocks"] >= SMS or geo["splits"] == 1
            and geo["tiles"] >= SMS or (geo["bm"], geo["bn"]) == (32, 16))


@pytest.mark.parametrize("label", sorted(DIRECT_ROWS))
def test_direct_wrapper_launches_the_executors_geometry(label, fake_card):
    x_shape, w_shape, st, pad = DIRECT_ROWS[label]
    spec = tcs.ConvSpec(x_shape, w_shape, (st, st), (pad, pad))
    p = tcs.plan(spec, force="direct", backend="cuda")
    direct_conv.direct_conv(torch.zeros(x_shape), torch.zeros(w_shape),
                            (pad, pad), (st, st), **p.config.as_dict())
    (fn, args), = fake_card
    geo = direct_conv.launch_geometry(x_shape, w_shape, (st, st), (pad, pad))
    # ..., OH, OW, th, tw, bm, bn, kc, stages, tiles, splits, vec_a,
    # vec_b, smem, stream
    assert fn == "direct_conv_launch"
    assert args[6:13] == tuple(x_shape) + tuple(w_shape[:2]) + (w_shape[3],)
    assert args[19:29] == (geo["th"], geo["tw"], geo["bm"], geo["bn"],
                           geo["chunk"], geo["stages"], geo["tiles"],
                           geo["splits"], 1, 1)
    assert args[29] == geo["smem"] == p.executor.vmem_bytes(spec, p.config)
    assert (args[3] is None) == (geo["splits"] == 1)
    assert _build.LAUNCHES["direct_conv"] == 1


@pytest.mark.parametrize("label", sorted(TWO_STAGE_ROWS))
def test_stage1_wrappers_launch_the_executors_geometry(label, fake_card):
    """The executor's path (``ops.cuconv_two_stage``) launches stage 1 on
    the padded input under the conv row rule, then stage 2; the stacked
    entry launches the same geometry under the stacked rule."""
    (T, P, C, M), (x_shape, w_shape, pad) = TWO_STAGE_ROWS[label]
    spec = tcs.ConvSpec(x_shape, w_shape, padding=(pad, pad))
    p = tcs.plan(spec, force="cuconv_two_stage_pallas", backend="cuda")
    ops.cuconv_two_stage(torch.zeros(x_shape), torch.zeros(w_shape),
                         (pad, pad), **p.config.as_dict())
    cuconv_stage1.stage1_tap_gemm(torch.zeros((T, P, C)),
                                  torch.zeros((T, C, M)))
    (fn, args), (fn2, _), (fn3, args3) = fake_card
    assert (fn, fn2, fn3) == ("stage1_tap_gemm_launch",
                              "stage2_tap_sum_launch",
                              "stage1_tap_gemm_launch")
    geo = cuconv_stage1.launch_geometry(T, P, C, M)
    xp_shape = (x_shape[0], x_shape[1] + 2 * pad, x_shape[2] + 2 * pad, C)
    rules = [cuconv_stage1.conv_rule(xp_shape, w_shape),
             cuconv_stage1.stacked_rule(T, P, C)]
    # x, w, out, dtype, T, P, C, M, KW, tap_row, tap_col, OHW, OW, img,
    # row, bm, bn, tiles, vec_a, vec_b, smem, stream
    for a, rule in zip((args, args3), rules):
        assert a[4:8] == (T, P, C, M)
        assert a[8:15] == tuple(rule[k] for k in ("KW", "tap_row", "tap_col",
                                                  "OHW", "OW", "img", "row"))
        assert a[15:21] == (geo["bm"], geo["bn"], geo["tiles"], 1, 1,
                            geo["smem"])
    assert geo["smem"] == p.executor.vmem_bytes(spec, p.config)
    assert _build.LAUNCHES["stage1_tap_gemm"] == 2
    assert _build.LAUNCHES["stage2_tap_sum"] == 1


@pytest.mark.parametrize("T,P,M", [
    (9, 49, 384), (25, 49, 128),     # t4_A, t5_A
    (1, 7, 5), (2, 33, 7), (49, 196, 64), (10, 3, 3), (400, 50, 12),
    (9, 1000, 999)])
def test_stage2_geometry_covers_every_output(T, P, M):
    """Every quad of 4 outputs has a column, every tap a row's run, and
    the two-stage paper rows launch one wave of blocks or more."""
    geo = cuconv_stage2.launch_geometry(T, P, M)
    quads = -(-(P * M) // 4)
    assert geo["quads"] == quads
    assert geo["blocks"] * geo["cols"] >= quads > (geo["blocks"] - 1) \
        * geo["cols"]
    assert geo["rows"] * geo["taps_per_thread"] >= T
    assert geo["rows"] == int(np.ceil(np.sqrt(T)))
    assert geo["threads"] == geo["cols"] * geo["rows"] <= 1024
    assert geo["smem"] == (16 * geo["threads"] if geo["rows"] > 1 else 0)
    if (T, P, M) in ((9, 49, 384), (25, 49, 128)):
        assert geo["blocks"] >= SMS
    if quads >= SMS:
        assert geo["blocks"] >= SMS


def test_stage2_wrapper_launches_its_geometry(fake_card):
    """t4_A's and t5_A's sums, and a misaligned view and PM % 4 != 0
    (scalar loads), in both output dtypes."""
    shapes = [((9, 49, 384), 0), ((25, 49, 128), 0), ((9, 49, 384), 1),
              ((4, 5, 7), 0)]
    for (T, P, M), off in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            fake_card.clear()
            temps = torch.zeros(T * P * M + off)[off:].view(T, P, M)
            out = cuconv_stage2.stage2_tap_sum(temps, out_dtype=dtype)
            assert out.shape == (P, M) and out.dtype == dtype
            (fn, args), = fake_card
            geo = cuconv_stage2.launch_geometry(T, P, M)
            vec = int((P * M) % 4 == 0 and off == 0)
            # temps, out, out_dtype, T, PM, cols, rows, blocks, vec_in,
            # vec_out, unroll, stream
            assert fn == "stage2_tap_sum_launch"
            assert args[2:11] == (int(dtype == torch.bfloat16), T, P * M,
                                  geo["cols"], geo["rows"], geo["blocks"],
                                  vec, int((P * M) % 4 == 0), 1)
    assert _build.LAUNCHES["stage2_tap_sum"] == 8


@pytest.mark.parametrize("unroll", [True, False])
def test_stage2_wrapper_passes_which_body(fake_card, unroll):
    """``unroll=False`` asks the kernel for its runtime-T loop at t4_A's
    9 taps; the geometry is the same either way."""
    cuconv_stage2.stage2_tap_sum(torch.zeros(9, 49, 384), unroll=unroll)
    (fn, args), = fake_card
    geo = cuconv_stage2.launch_geometry(9, 49, 384)
    assert args[5:8] == (geo["cols"], geo["rows"], geo["blocks"])
    assert args[10] == int(unroll)
    assert _build.LAUNCHES["stage2_tap_sum"] == 1


@pytest.mark.parametrize("xp_shape,kernel", [
    ((1, 9, 9, 192), (3, 3)),        # t4_A, padded
    ((1, 11, 11, 48), (5, 5)),       # t5_A, padded
    ((3, 6, 8, 5), (3, 2)), ((2, 4, 4, 3), (1, 1)), ((1, 3, 7, 2), (3, 7)),
])
def test_stage1_row_rule_reads_the_stacked_views(xp_shape, kernel):
    """The kernel's address rule (``row_offsets``, the arithmetic of
    ``stage1_tc_kernel``) reads, from the padded input, exactly the rows
    of the stacked tap views; under the stacked rule it reads the stack
    itself."""
    KH, KW = kernel
    N, Hp, Wp, C = xp_shape
    T, P = KH * KW, N * (Hp - KH + 1) * (Wp - KW + 1)
    xp = torch.arange(np.prod(xp_shape), dtype=torch.float64).reshape(
        xp_shape)
    stack = cuconv_stage1.stack_taps(xp, KH, KW)
    assert stack.shape == (T, P, C)
    cols = torch.arange(C)
    rule = cuconv_stage1.conv_rule(xp_shape, (KH, KW, C, 1))
    offs = cuconv_stage1.row_offsets(rule, T, P, C)
    assert torch.equal(xp.reshape(-1)[offs.unsqueeze(-1) + cols], stack)
    stacked = cuconv_stage1.stacked_rule(T, P, C)
    offs = cuconv_stage1.row_offsets(stacked, T, P, C)
    assert torch.equal(stack.reshape(-1)[offs.unsqueeze(-1) + cols], stack)


# ---------------------------------------------------------------------------
# int8_gemm: one output tile per block at the served int8 nodes

_INT8_SERVED = {}     # label -> (spec, calibrated activation scale)
INT8_LABELS = [f"resnet32b{b}:int8:{n}" for b in (1, 4)
               for n in ("b1c1", "b1c2", "b2c1", "b2c2")]


@pytest.fixture
def served_int8():
    """The int8 conv nodes of resnet_like served at 32x32 (buckets 1 and
    4) under the default ``QuantPolicy``, calibrated on one seeded batch
    as chip_smoke does; planned once per process (before a fake
    card is set up: calibration runs the model)."""
    if not _INT8_SERVED:
        from repro_torch.models.cnn import resnet_like
        from repro_torch.quant import Calibrator, QuantPolicy
        m = resnet_like(num_classes=10)
        params = m.init(0, device="cpu")
        x = np.random.default_rng(0).standard_normal((4, 32, 32, 3),
                                                     dtype=np.float32)
        m.graph_plan(x.shape).warmup(device="cpu",
                                     calibrate=Calibrator(x, params))
        for b in (1, 4):
            gp = m.graph_plan((b, 32, 32, 3), backend="cuda",
                              precision=QuantPolicy())
            for n, p in gp.conv_plans.items():
                if p.algorithm == "cuconv_int8":
                    _INT8_SERVED[f"resnet32b{b}:int8:{n}"] = (
                        p.spec, p.quant.x_scale)
        assert sorted(_INT8_SERVED) == sorted(INT8_LABELS)
    return _INT8_SERVED


@pytest.mark.parametrize("label", INT8_LABELS)
def test_int8_wrapper_launches_one_tile_per_block(label, served_int8,
                                                  fake_card):
    """At the served int8 shapes each block owns one output tile (``bn``
    is M rounded up to 8, no tile over 32 x 32), the tile's staging fits
    a block's shared memory, and the executor's node launches the
    conv entry once with the geometry and shared memory the planner
    reads."""
    from repro_torch.kernels import int8_gemm
    spec, x_scale = served_int8[label]
    ex = executors.get("cuconv_int8")
    P, M, K = ex._gemm_dims(spec)
    assert (P, K, M) in {(256, 144, 16), (64, 144, 32), (64, 288, 32),
                         (1024, 144, 16), (256, 144, 32), (256, 288, 32)}
    geo = int8_gemm.launch_geometry(P, K, M)
    assert geo["bn"] == -(-M // 8) * 8 and geo["bm"] in (16, 32)
    assert geo["blocks"] == geo["tiles"] == (-(-P // geo["bm"])
                                             * -(-M // geo["bn"]))
    assert geo["kc"] >= K and geo["chunks"] == 1      # K staged in one go
    assert geo["smem"] <= _build.SMEM_LIMIT
    cfg = ex.default_config(spec)
    assert geo["smem"] == ex.vmem_bytes(spec, cfg)
    x = torch.zeros(spec.in_shape)
    addend = (torch.zeros(spec.out_shape) if spec.fused_add != "none"
              else None)
    ex.execute(spec, x, torch.zeros(spec.filter_shape), torch.zeros(M),
               addend, config=cfg,
               quant=types.SimpleNamespace(x_scale=x_scale))
    (fn, args), = fake_card
    # x, w, out, scale, wscale, bias, addend, in_float, w_km, N, H, W, C,
    # KH, KW, M, sh, sw, ph, pw, OH, OW, bm, bn, kc, relu, vec_a, vec_b,
    # smem, stream
    assert fn == "int8_gemm_launch"
    assert args[7:9] == (1, 0) and (args[6] is None) == (addend is None)
    assert args[9:22] == (spec.in_shape + spec.filter_shape[:2] + (M,)
                          + spec.stride + spec.padding + spec.out_shape[1:3])
    relu = (spec.fused_add == "add_relu" if spec.fused_add != "none"
            else spec.wants_relu)
    assert args[22:29] == (geo["bm"], geo["bn"], geo["kc"], int(relu), 1, 1,
                           geo["smem"])
    assert _build.LAUNCHES["int8_gemm"] == 1


# ---------------------------------------------------------------------------
# no kernel launches on an input that requires grad: the kernels have no
# backward, so their output would carry no gradient

def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


#: kernel name -> (wrapper, its arguments); the first argument is the
#: one made to require grad
GRAD_CALLS = {
    "conv1x1_gemm": (conv1x1.conv1x1_gemm, lambda: (_z(8, 4), _z(4, 8)), {}),
    "cuconv_fused": (cuconv_fused.cuconv_fused,
                     lambda: (_z(1, 8, 8, 4), _z(3, 3, 4, 8)),
                     {"padding": (1, 1)}),
    "stage1_tap_gemm": (cuconv_stage1.stage1_tap_gemm,
                        lambda: (_z(9, 16, 4), _z(9, 4, 8)), {}),
    "stage1_tap_conv": (cuconv_stage1.stage1_tap_conv,
                        lambda: (_z(1, 6, 6, 4), _z(3, 3, 4, 8)), {}),
    "stage2_tap_sum": (cuconv_stage2.stage2_tap_sum,
                       lambda: (_z(9, 16, 8),), {}),
    "winograd_fused": (winograd_fused.winograd_fused,
                       lambda: (_z(1, 8, 8, 4), _z(3, 3, 4, 8)), {}),
    "direct_conv": (direct_conv.direct_conv,
                    lambda: (_z(1, 8, 8, 4), _z(3, 3, 4, 8)),
                    {"padding": (1, 1)}),
    "int8_conv": (int8_gemm.int8_conv,
                  lambda: (_z(1, 8, 8, 4), _z(8, 3, 3, 4, dtype=torch.int8)),
                  {"padding": (1, 1), "scale": torch.ones(1),
                   "w_scales": torch.ones(8)}),
    "flash_attention": (flash_attention.flash_attention,
                        lambda: (_z(1, 16, 2, 8), _z(1, 16, 1, 8),
                                 _z(1, 16, 1, 8)), {}),
    "conv1d_tap": (conv1d_tap.conv1d_tap,
                   lambda: (_z(1, 16, 8), _z(4, 8), _z(8)), {}),
}


@pytest.mark.parametrize("kernel", sorted(GRAD_CALLS))
def test_wrapper_refuses_an_input_that_requires_grad(kernel, fake_card):
    """On the card, a wrapper raises naming its kernel before any launch
    where grad mode is on and an input requires grad; under no_grad, or
    with no input requiring grad, it launches; on the CPU its plain
    version runs and autograd differentiates it."""
    fn, make, kw = GRAD_CALLS[kernel]
    args = make()
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{kernel}: an input requires "
                                           f"grad"):
        fn(*args, **kw)
    assert not fake_card and sum(_build.LAUNCHES.values()) == 0
    with torch.no_grad():
        fn(*args, **kw)
    assert len(fake_card) == 1
    fn(*(a.detach() for a in args), **kw)
    assert len(fake_card) == 2


# int8_conv's plain version quantizes its input: no gradient flows there
@pytest.mark.parametrize("kernel", sorted(set(GRAD_CALLS) - {"int8_conv"}))
def test_wrapper_differentiates_its_plain_version_on_the_cpu(kernel):
    fn, make, kw = GRAD_CALLS[kernel]
    args = [a.normal_() if a.is_floating_point() else a for a in make()]
    args[0].requires_grad_(True)
    out = fn(*args, **kw)
    (g,) = torch.autograd.grad(out.float().sum(), args[0])
    assert g.shape == args[0].shape
    assert sum(_build.LAUNCHES.values()) == 0
