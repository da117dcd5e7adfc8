"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here needs the card and skips without one.  The stage-2 sum
is held to the fp32 bound and must repeat its bits; the served
programs' CUDA graphs (``serve/graphs.py``) must replay bit-equal to the
eager programs and count the same launches.  On a machine with
a card: ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
The bounds are ``max|kernel - plain| <= tol * max(1, max|plain|)`` with
tol 2e-5 in fp32 (both sides FFMA/cuBLAS fp32, TF32 off; only the
summation order differs) and 3e-2 in bf16 (one bf16 rounding of the
output).  The Winograd kernel sums in another order over the Winograd
domain than its plain version, so it is held to the reference's own
Winograd bounds in fp32: 1e-4 at F(2,3), 2e-3 at F(4,3).  The 1x1 GEMM,
the fused conv, the direct conv, stage 1, the Winograd products and
flash attention run on the tensor cores in 3xTF32, which holds the fp32
bounds (``tests/test_torch_tensor_cores.py``).  The int8 GEMM
is exact: both its entries must equal their plain versions bit for bit,
the conv entry's fp32 epilogue too.  The LM kernels
(flash attention, causal conv1d) keep the conv kernels' bounds; the
flash plain version takes one softmax over all keys where the kernel
keeps a running max, which in bf16 rounds p against another max (within
the bf16 bound).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (_clear_port_caches, chip_smoke,  # noqa: F401
                           requires_cuda)
from repro_torch.kernels import (_build, conv1d_tap, conv1x1, cuconv_fused,
                                 cuconv_stage1, cuconv_stage2, direct_conv,
                                 flash_attention, int8_gemm, winograd_fused)

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DTYPES = (torch.float32, torch.bfloat16)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.float().abs().max().item())


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to("cuda", dtype)


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [
    # (N, H, W, C, KH, KW, M, stride, pad, tm, rows, epilogue)
    (1, 7, 7, 16, 3, 3, 8, (1, 1), (1, 1), 128, 1, "none"),
    (2, 9, 11, 4, 5, 5, 6, (1, 1), (2, 2), 128, 2, "bias_relu"),
    (2, 11, 13, 5, 3, 3, 70, (2, 1), (1, 1), 64, 4, "add"),
    (1, 13, 13, 96, 3, 3, 200, (1, 1), (1, 1), 128, 8, "add_relu"),
    (1, 16, 16, 3, 3, 3, 16, (1, 1), (1, 1), 16, 4, "maxpool"),
    (2, 12, 12, 8, 3, 3, 40, (1, 1), (1, 1), 32, 6, "avgpool"),
    (1, 9, 9, 7, 1, 1, 33, (2, 2), (0, 0), 33, 3, "bias"),
    # the implicit GEMM's cases: stride 2, C = 3 and C = 130 (scalar
    # gather), odd M, split-K with addend + ReLU, pools on 2-D tiles
    (2, 15, 15, 16, 3, 3, 32, (2, 2), (1, 1), 128, 1, "bias_relu"),
    (1, 20, 20, 3, 3, 3, 17, (1, 1), (1, 1), 16, 1, "bias"),
    (1, 9, 9, 130, 3, 3, 45, (1, 1), (1, 1), 128, 1, "add_relu"),
    (1, 13, 13, 384, 3, 3, 384, (1, 1), (1, 1), 384, 8, "add_relu"),
    (1, 7, 7, 48, 5, 5, 128, (1, 1), (2, 2), 128, 7, "bias_relu"),
    (2, 34, 70, 16, 3, 3, 24, (1, 1), (1, 1), 16, 2, "maxpool"),
    (1, 40, 40, 3, 3, 3, 16, (1, 1), (1, 1), 16, 8, "avgpool"),
])
def test_cuconv_fused_kernel_matches_plain(geom, dtype):
    N, H, W, C, KH, KW, M, stride, pad, tm, rows, epi = geom
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, (N, H, W, C), dtype)
    w = _randn(gen, (KH, KW, C, M), dtype)
    oh = (H + 2 * pad[0] - KH) // stride[0] + 1
    ow = (W + 2 * pad[1] - KW) // stride[1] + 1
    kw = dict(stride=stride, padding=pad)
    if epi in ("bias", "bias_relu"):
        kw["bias"] = _randn(gen, (M,), dtype)
    if epi in ("relu", "bias_relu", "add_relu", "maxpool"):
        kw["activation"] = "relu"
    if epi.startswith("add"):
        kw["addend"] = _randn(gen, (N, oh, ow, M), dtype)
    if epi.endswith("pool"):
        kw["pool"] = (epi[:3], 2, 2)
    got = cuconv_fused.cuconv_fused(x, w, tm=tm, rows=rows, **kw)
    _close(got, cuconv_fused.cuconv_fused_plain(x, w, **kw), dtype)
    assert _build.LAUNCHES["cuconv_fused"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuconv_fused_takes_misaligned_pointers(dtype):
    """Base pointers off 16 bytes take the scalar-load variants."""
    gen = torch.Generator().manual_seed(12)
    x = _randn(gen, (2 * 9 * 9 * 16 + 1,), dtype)[1:].view(2, 9, 9, 16)
    w = _randn(gen, (3 * 3 * 16 * 24 + 1,), dtype)[1:].view(3, 3, 16, 24)
    assert cuconv_fused.vectorized(x, w) == (False, False)
    kw = dict(padding=(1, 1), activation="relu",
              bias=_randn(gen, (24,), dtype))
    _close(cuconv_fused.cuconv_fused(x, w, **kw),
           cuconv_fused.cuconv_fused_plain(x, w, **kw), dtype)


def _split_operands(gen):
    """t4_B with an addend: 16 K-splits of 18 tiles."""
    x = _randn(gen, (1, 13, 13, 384), torch.float32)
    w = _randn(gen, (3, 3, 384, 384), torch.float32)
    kw = dict(padding=(1, 1), activation="relu",
              bias=_randn(gen, (384,), torch.float32),
              addend=_randn(gen, (1, 13, 13, 384), torch.float32))
    assert cuconv_fused.launch_geometry(x.shape, w.shape, (1, 1),
                                        (1, 1))["splits"] == 16
    return x, w, kw


@requires_cuda
def test_cuconv_fused_split_is_deterministic():
    """The split partials are summed in split order by whichever block
    arrives last: calls give the same bits."""
    x, w, kw = _split_operands(torch.Generator().manual_seed(13))
    outs = [cuconv_fused.cuconv_fused(x, w, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@requires_cuda
def test_cuconv_fused_split_replays_in_a_cuda_graph():
    x, w, kw = _split_operands(torch.Generator().manual_seed(14))
    eager = cuconv_fused.cuconv_fused(x, w, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuconv_fused.cuconv_fused(x, w, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cuconv_fused.cuconv_fused(x, w, **kw)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,C,M,tiles", [
    (64, 32, 16, (256, 128, 512)), (300, 130, 70, (128, 64, 128)),
    (17, 257, 129, (128, 128, 256)), (49, 832, 256, (49, 128, 256)),
    # K-splits (C >= 832, P <= 64), aligned and not (C % 4 != 0)
    (64, 1024, 96, (64, 96, 512)), (50, 833, 64, (50, 64, 512)),
    (196, 256, 1024, (196, 512, 256)), (729, 64, 256, (512, 256, 64)),
])
def test_conv1x1_gemm_kernel_matches_plain(P, C, M, tiles, dtype):
    gen = torch.Generator().manual_seed(1)
    x, w = _randn(gen, (P, C), dtype), _randn(gen, (C, M), dtype)
    tp, tm, tc = tiles
    got = conv1x1.conv1x1_gemm(x, w, tp=tp, tm=tm, tc=min(tc, C))
    _close(got, conv1x1.conv1x1_gemm_plain(x, w), dtype)
    assert _build.LAUNCHES["conv1x1_gemm"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1x1_gemm_takes_misaligned_pointers(dtype):
    """A base pointer off 16 bytes takes the scalar-load variant."""
    gen = torch.Generator().manual_seed(9)
    P, C, M = 40, 64, 32
    xs = _randn(gen, (P * C + 1,), dtype)
    x = xs[1:].view(P, C)
    w = _randn(gen, (C, M), dtype)
    assert x.is_contiguous() and not conv1x1.vectorized(x, w)
    _close(conv1x1.conv1x1_gemm(x, w), conv1x1.conv1x1_gemm_plain(x, w),
           dtype)


@requires_cuda
@pytest.mark.parametrize("P,C,M", [(49, 832, 256), (50, 833, 64)])
def test_conv1x1_gemm_split_is_deterministic(P, C, M):
    """The split partials are summed in split order by whichever block
    arrives last: two calls give the same bits."""
    assert conv1x1.launch_geometry(P, C, M)["splits"] > 1
    gen = torch.Generator().manual_seed(10)
    x, w = (_randn(gen, (P, C), torch.float32),
            _randn(gen, (C, M), torch.float32))
    outs = [conv1x1.conv1x1_gemm(x, w) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@requires_cuda
def test_conv1x1_gemm_replays_in_a_cuda_graph():
    """Workspace and counters come from the wrapper's allocations, so a
    captured call replays and equals the eager output."""
    gen = torch.Generator().manual_seed(11)
    x, w = (_randn(gen, (49, 832), torch.float32),
            _randn(gen, (832, 256), torch.float32))
    eager = conv1x1.conv1x1_gemm(x, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv1x1.conv1x1_gemm(x, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = conv1x1.conv1x1_gemm(x, w)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,P,C,M", [(9, 50, 16, 8), (25, 128, 48, 32),
                                     (4, 33, 7, 5)])
def test_stage_kernels_match_plain(T, P, C, M, dtype):
    gen = torch.Generator().manual_seed(2)
    xs, w = _randn(gen, (T, P, C), dtype), _randn(gen, (T, C, M), dtype)
    temps = cuconv_stage1.stage1_tap_gemm(xs, w, tp=128, tm=64, tc=128)
    _close(temps, cuconv_stage1.stage1_tap_gemm_plain(xs, w), torch.float32)
    out = cuconv_stage2.stage2_tap_sum(temps, out_dtype=dtype)
    _close(out, cuconv_stage2.stage2_tap_sum_plain(temps, dtype), dtype)
    assert _build.LAUNCHES["stage1_tap_gemm"] == 1
    assert _build.LAUNCHES["stage2_tap_sum"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [
    # (N, H, W, C, M, pad, m, tt, tm, epilogue)
    (1, 8, 8, 3, 4, (1, 1), 2, 128, 128, "none"),
    (2, 9, 7, 5, 6, (0, 0), 4, 128, 128, "bias_relu"),
    (4, 16, 16, 16, 16, (1, 1), 2, 256, 16, "bias_relu"),
    (2, 14, 14, 20, 40, (1, 1), 4, 16, 32, "add_relu"),
    (1, 13, 11, 33, 70, (2, 1), 2, 64, 128, "add"),
    # resnet50's layers at batch 2, and a 16-wide one at F(4,3)
    (2, 56, 56, 64, 64, (1, 1), 4, 256, 64, "none"),
    (2, 28, 28, 128, 128, (1, 1), 2, 256, 128, "bias_relu"),
    (4, 32, 32, 16, 16, (1, 1), 4, 256, 16, "add_relu"),
])
def test_winograd_fused_kernel_matches_plain(geom, dtype):
    N, H, W, C, M, pad, m, tt, tm, epi = geom
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, (N, H, W, C), dtype)
    w = _randn(gen, (3, 3, C, M), dtype)
    oh, ow = H + 2 * pad[0] - 2, W + 2 * pad[1] - 2
    kw = dict(padding=pad, m=m)
    if epi in ("bias", "bias_relu"):
        kw["bias"] = _randn(gen, (M,), dtype)
    if epi in ("bias_relu", "add_relu"):
        kw["activation"] = "relu"
    if epi.startswith("add"):
        kw["addend"] = _randn(gen, (N, oh, ow, M), dtype)
    got = winograd_fused.winograd_fused(x, w, tt=tt, tm=tm, **kw)
    want = winograd_fused.winograd_fused_plain(x, w, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = {2: 1e-4, 4: 2e-3}[m] if dtype == torch.float32 else TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item())
    assert _build.LAUNCHES["winograd_fused"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [
    # (N, H, W, C, KH, KW, M, stride, pad, tm)
    (1, 7, 7, 16, 3, 3, 8, (1, 1), (1, 1), 128),
    (2, 9, 11, 20, 5, 5, 6, (1, 1), (2, 2), 16),
    (1, 112, 112, 16, 3, 3, 32, (2, 2), (1, 1), 32),
    (1, 7, 7, 100, 1, 1, 70, (1, 1), (0, 0), 64),
    (2, 13, 13, 9, 7, 7, 40, (2, 1), (3, 3), 256),
])
def test_direct_conv_kernel_matches_plain(geom, dtype):
    N, H, W, C, KH, KW, M, stride, pad, tm = geom
    gen = torch.Generator().manual_seed(4)
    x = _randn(gen, (N, H, W, C), dtype)
    w = _randn(gen, (KH, KW, C, M), dtype)
    got = direct_conv.direct_conv(x, w, pad, stride, tm=tm)
    _close(got, direct_conv.direct_conv_plain(x, w, pad, stride), dtype)
    assert _build.LAUNCHES["direct_conv"] == 1


# the paper's rows on the direct conv (chip_smoke's forced rows) and
# resnet_like's stride-2 b2c1 at 224x224: (x shape, w shape, stride, pad)
DIRECT_PAPER = {"t3_A": ((1, 7, 7, 832), (1, 1, 832, 256), 1, 0),
                "t4_B": ((1, 13, 13, 384), (3, 3, 384, 384), 1, 1),
                "t5_B": ((8, 7, 7, 48), (5, 5, 48, 128), 1, 2),
                "b2c1@224": ((1, 112, 112, 16), (3, 3, 16, 32), 2, 1)}
# the paper's rows on the two-stage pipeline: (padded x shape, w shape)
STAGE1_PAPER = {"t4_A": ((1, 9, 9, 192), (3, 3, 192, 384)),
                "t5_A": ((1, 11, 11, 48), (5, 5, 48, 128))}


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", sorted(DIRECT_PAPER))
def test_direct_conv_paper_rows_match_plain(label, dtype):
    x_shape, w_shape, st, pad = DIRECT_PAPER[label]
    gen = torch.Generator().manual_seed(15)
    x, w = _randn(gen, x_shape, dtype), _randn(gen, w_shape, dtype)
    got = direct_conv.direct_conv(x, w, (pad, pad), (st, st))
    _close(got, direct_conv.direct_conv_plain(x, w, (pad, pad), (st, st)),
           dtype)
    assert _build.LAUNCHES["direct_conv"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_direct_conv_takes_misaligned_pointers(dtype):
    """Base pointers off 16 bytes take the scalar-load variants, with a
    C-split (C = 384 over 16 splits)."""
    gen = torch.Generator().manual_seed(16)
    x = _randn(gen, (13 * 13 * 384 + 1,), dtype)[1:].view(1, 13, 13, 384)
    w = _randn(gen, (9 * 384 * 64 + 1,), dtype)[1:].view(3, 3, 384, 64)
    assert direct_conv.vectorized(x, w) == (False, False)
    assert direct_conv.launch_geometry(x.shape, w.shape, padding=(1, 1),
                                       itemsize=x.element_size())[
        "splits"] > 1
    _close(direct_conv.direct_conv(x, w, (1, 1)),
           direct_conv.direct_conv_plain(x, w, (1, 1)), dtype)


@requires_cuda
def test_direct_conv_split_is_deterministic_and_replays_in_a_cuda_graph():
    """t4_B's 16 C-splits are summed in split order by whichever block
    arrives last: calls give the same bits, and a captured call replays
    to them."""
    x_shape, w_shape, _, _ = DIRECT_PAPER["t4_B"]
    gen = torch.Generator().manual_seed(17)
    x, w = (_randn(gen, x_shape, torch.float32),
            _randn(gen, w_shape, torch.float32))
    assert direct_conv.launch_geometry(x_shape, w_shape,
                                       padding=(1, 1))["splits"] == 16
    outs = [direct_conv.direct_conv(x, w, (1, 1)) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        direct_conv.direct_conv(x, w, (1, 1))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = direct_conv.direct_conv(x, w, (1, 1))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, outs[0])


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", sorted(STAGE1_PAPER) + ["odd", "misaligned"])
def test_stage1_entries_match_plain_and_each_other(label, dtype):
    """Both stage-1 entries at the paper's rows, at a ragged C and M (the
    scalar loads and stores), and from pointers off 16 bytes: each within
    the bound of the plain version, and the two equal bit for bit."""
    gen = torch.Generator().manual_seed(18)
    xp_shape, w_shape = STAGE1_PAPER.get(label, ((2, 7, 6, 7), (3, 2, 7, 5)))
    if label == "misaligned":
        xp_shape, w_shape = (1, 9, 9, 64), (3, 3, 64, 32)
        n = int(np.prod(xp_shape))
        xp = _randn(gen, (n + 1,), dtype)[1:].view(xp_shape)
        assert xp.data_ptr() % 16
    else:
        xp = _randn(gen, xp_shape, dtype)
    w = _randn(gen, w_shape, dtype)
    kh, kw, c, m = w_shape
    got = cuconv_stage1.stage1_tap_conv(xp, w)
    _close(got, cuconv_stage1.stage1_tap_conv_plain(xp, w), torch.float32)
    stacked = cuconv_stage1.stage1_tap_gemm(
        cuconv_stage1.stack_taps(xp, kh, kw).contiguous(),
        w.reshape(kh * kw, c, m))
    torch.cuda.synchronize()
    assert torch.equal(got, stacked)
    assert _build.LAUNCHES["stage1_tap_gemm"] == 2


@requires_cuda
@pytest.mark.parametrize("P,K,M,tiles", [
    (1024, 144, 16, (512, 16, 144)), (256, 288, 32, (256, 32, 288)),
    (67, 27, 5, (64, 64, 8)), (300, 1000, 130, (128, 64, 128)),
])
def test_int8_gemm_kernel_is_exact(P, K, M, tiles):
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (P, K), generator=gen,
                      dtype=torch.int8).cuda()
    w = torch.randint(-127, 128, (K, M), generator=gen,
                      dtype=torch.int8).cuda()
    tp, tm, tc = tiles
    got = int8_gemm.int8_gemm(x, w, tp=tp, tm=tm, tc=tc)
    want = int8_gemm.int8_gemm_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert _build.LAUNCHES["int8_gemm"] == 1


# the int8 conv entry: (N, H, W, C, KH, KW, M, stride, pad, epilogue,
# input): two served node shapes, a ragged P (105 rows) with M = 24,
# C = 6 at stride 2 without padding (byte-wise gather), a zero scale,
# inputs far beyond +-127 s (clamped), exact half-way ties x = (k + 1/2) s
# at s = 1/4 (round half to even), and a misaligned input
INT8_CONV = {
    "b1c1": (1, 16, 16, 16, 3, 3, 16, 1, 1, "bias_relu", "normal"),
    "b2c1": (4, 16, 16, 16, 3, 3, 32, 2, 1, "bias_relu", "normal"),
    "b1c2": (1, 16, 16, 16, 3, 3, 16, 1, 1, "add_relu", "normal"),
    "ragged_p": (3, 5, 7, 16, 3, 3, 24, 1, 1, "bias", "normal"),
    "c6_stride2": (2, 9, 9, 6, 3, 3, 5, 2, 0, "add_relu", "normal"),
    "zero_scale": (1, 6, 6, 16, 3, 3, 8, 1, 1, "bias", "zero"),
    "clamp": (1, 8, 8, 32, 3, 3, 16, 1, 1, "bias_relu", "clamp"),
    "ties": (2, 7, 7, 16, 3, 3, 16, 1, 1, "bias", "ties"),
    "ties_c6": (1, 7, 7, 6, 3, 3, 8, 2, 1, "bias", "ties"),
    "misaligned": (1, 8, 8, 16, 3, 3, 16, 1, 1, "bias", "misaligned"),
}


@requires_cuda
@pytest.mark.parametrize("label", sorted(INT8_CONV))
def test_int8_conv_entry_is_bit_equal_to_plain(label):
    """The conv entry's fp32 output (quantized on load, the epilogue in
    the reference's order) and its int32 accumulator on codes equal the
    eager composition bit for bit; the stacked entry on the patch matrix
    gives the same accumulator."""
    from repro_torch.quant import symmetric
    N, H, W, C, KH, KW, M, s, p, epi, kind = INT8_CONV[label]
    gen = torch.Generator().manual_seed(7)
    stride, pad = (s, s), (p, p)
    scale = torch.tensor(0.02, device="cuda")
    x = torch.randn((N, H, W, C), generator=gen).cuda()
    if kind == "zero":
        scale = torch.zeros((), device="cuda")
    elif kind == "clamp":
        x = x * 20
    elif kind == "ties":
        scale = torch.tensor(0.25, device="cuda")
        x = ((torch.randint(-140, 140, (N, H, W, C), generator=gen).float()
              + 0.5) * 0.25).cuda()
    elif kind == "misaligned":
        x = torch.randn(x.numel() + 1, generator=gen).cuda()[1:].view(
            x.shape)
        assert x.data_ptr() % 16
    w = torch.randint(-127, 128, (M, KH, KW, C), generator=gen,
                      dtype=torch.int8).cuda()
    w_scales = (torch.rand(M, generator=gen) * 1e-2 + 1e-3).cuda()
    oh, ow = (H + 2 * p - KH) // s + 1, (W + 2 * p - KW) // s + 1
    kw = dict(relu=epi.endswith("relu"))
    if epi.startswith("bias"):
        kw["bias"] = torch.randn(M, generator=gen).cuda()
    if epi.startswith("add"):
        kw["addend"] = torch.randn((N, oh, ow, M), generator=gen).cuda()
    got = int8_gemm.int8_conv(x, w, stride, pad, scale, w_scales, **kw)
    want = int8_gemm.int8_conv_plain(x, w, stride, pad, scale, w_scales,
                                     **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    codes = symmetric.quantize_to_int8(x, scale)
    if kind == "misaligned":
        codes = torch.cat([codes.new_zeros(1), codes.reshape(-1)])[1:] \
            .view(codes.shape)
        assert codes.data_ptr() % 16
    acc = int8_gemm.int8_conv(codes, w, stride, pad)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, int8_gemm.int8_conv_plain(codes, w, stride, pad))
    patches = int8_gemm.conv_patches(codes, KH, KW, stride, pad).contiguous()
    stacked = int8_gemm.int8_gemm(patches, w.reshape(M, -1).t().contiguous())
    torch.cuda.synchronize()
    assert torch.equal(stacked.reshape(acc.shape), acc)
    assert _build.LAUNCHES["int8_gemm"] == 3


@requires_cuda
def test_wrappers_refuse_mixed_devices_and_oversized_configs():
    x = torch.zeros((1, 8, 8, 4), device="cuda")
    with pytest.raises(ValueError, match="is on cpu"):
        cuconv_fused.cuconv_fused(x, torch.zeros((3, 3, 4, 8)))
    with pytest.raises(ValueError, match="shared"):
        direct_conv.direct_conv(torch.zeros((1, 20, 20, 2), device="cuda"),
                                torch.zeros((15, 15, 2, 64), device="cuda"))
    # the int8 GEMM's tile is its own (tc=2048 sizes nothing); what it
    # refuses is a contraction long enough to overflow int32
    with pytest.raises(ValueError, match="overflow"):
        int8_gemm.int8_gemm(
            torch.zeros((8, int8_gemm.K_MAX + 1), dtype=torch.int8,
                        device="cuda"),
            torch.zeros((int8_gemm.K_MAX + 1, 8), dtype=torch.int8,
                        device="cuda"), tc=2048)
    assert sum(_build.LAUNCHES.values()) == 0


@requires_cuda
def test_served_resnet_like_on_card_matches_cpu():
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
    model = resnet_like(num_classes=4)
    params = model.init(0)
    cpu = {n: {k: v.cpu() for k, v in p.items()} for n, p in params.items()}
    imgs = np.random.default_rng(0).normal(size=(3, 32, 32, 3)) \
        .astype(np.float32)
    outs = []
    for eng in (CnnServeEngine(model, params, (32, 32, 3), buckets=(1, 2)),
                CnnServeEngine(model, cpu, (32, 32, 3), buckets=(1, 2),
                               device="cpu", backend="cuda")):
        eng.submit(ImageRequest(0, imgs))
        outs.append(eng.run()[0].out)
    assert _build.LAUNCHES["cuconv_fused"] >= 6
    np.testing.assert_allclose(outs[0], outs[1], rtol=0,
                               atol=3e-4 * np.abs(outs[1]).max())


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [
    # (B, Sq, Sk, H, KVH, D, causal)
    (2, 40, 40, 3, 3, 16, True),
    (1, 100, 100, 4, 2, 32, True),
    (1, 64, 128, 2, 1, 8, False),
    (2, 130, 130, 12, 2, 128, True),
    (1, 77, 200, 6, 3, 64, False),
    (1, 300, 300, 2, 2, 128, True),
    # the tensor-core kernel's cases: D = 64 and 128 at GQA ratios 1, 2
    # and 6, causal and not, Sq not a multiple of 64, Sq != Sk; D = 36
    # (bf16 takes the scalar loads)
    (2, 129, 129, 4, 4, 128, False),
    (1, 70, 70, 6, 1, 64, False),
    (1, 50, 120, 4, 2, 128, True),
    (4, 512, 512, 12, 2, 128, True),
    (1, 65, 65, 6, 1, 64, True),
    (1, 90, 90, 2, 1, 36, True),
])
def test_flash_attention_kernel_matches_plain(geom, dtype):
    B, Sq, Sk, H, KVH, D, causal = geom
    gen = torch.Generator().manual_seed(6)
    q = _randn(gen, (B, Sq, H, D), dtype)
    k = _randn(gen, (B, Sk, KVH, D), dtype)
    v = _randn(gen, (B, Sk, KVH, D), dtype)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    _close(got, flash_attention.flash_attention_plain(q, k, v, causal),
           dtype)
    assert _build.LAUNCHES["flash_attention"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_bh_layout_and_misaligned_pointers(D, dtype):
    """The (BH, S, D) layout at both padded head dims, from pointers off
    16 bytes (the scalar loads)."""
    gen = torch.Generator().manual_seed(8)
    q, k, v = (_randn(gen, (3 * 77 * D + 1,), dtype)[1:].view(3, 77, D)
               for _ in range(3))
    for causal in (True, False):
        got = flash_attention.flash_attention(q, k, v, causal=causal)
        _close(got, flash_attention.flash_attention_plain(q, k, v, causal),
               dtype)
    assert _build.LAUNCHES["flash_attention"] == 2


@requires_cuda
def test_flash_attention_kernel_takes_the_bh_layout():
    gen = torch.Generator().manual_seed(7)
    q, k, v = (_randn(gen, (6, 90, 32), torch.float32) for _ in range(3))
    got = flash_attention.flash_attention(q, k, v, causal=True)
    _close(got, flash_attention.flash_attention_plain(q, k, v, True),
           torch.float32)
    assert _build.LAUNCHES["flash_attention"] == 1


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,D,K,bias", [
    (2, 37, 24, 4, True), (1, 128, 64, 4, False), (3, 16, 8, 2, True),
    (4, 512, 4096, 4, True), (4, 512, 128, 4, True), (1, 3, 200, 8, True),
])
def test_conv1d_tap_kernel_matches_plain(B, L, D, K, bias, dtype):
    gen = torch.Generator().manual_seed(8)
    x = _randn(gen, (B, L, D), dtype)
    w = _randn(gen, (K, D), dtype)
    b = _randn(gen, (D,), dtype) if bias else None
    got = conv1d_tap.conv1d_tap(x, w, b)
    _close(got, conv1d_tap.conv1d_tap_plain(x, w, b), dtype)
    assert _build.LAUNCHES["conv1d_tap"] == 1


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_served_lm_smoke_on_card_matches_cpu(arch):
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = smoke_variant(get_config(arch))
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (5, 24))
    logs = []
    for eng in (ServeEngine(cfg, params, slots=2, max_len=40),
                ServeEngine(cfg, _cpu(params), slots=2, max_len=40,
                            device="cpu")):
        log = []
        for name in ("_prefill", "_decode"):
            def wrapped(*a, fn=getattr(eng, name)):
                logits, cache = fn(*a)
                log.append(logits.float().cpu())
                return logits, cache
            setattr(eng, name, wrapped)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p.astype(np.int32), max_new_tokens=6))
        assert len(eng.run(prompt_len=24)) == 5
        logs.append(log)
    kernel = "flash_attention" if arch == "qwen2-1.5b" else "conv1d_tap"
    assert _build.LAUNCHES[kernel] >= cfg.num_layers * 3
    # fp32 params against a bf16 cache: a cache entry may round one bf16
    # step apart between card and CPU
    assert len(logs[0]) == len(logs[1]) == 3 * 6
    for card, cpu in zip(*logs):
        assert (card - cpu).abs().max() <= 1e-2 * cpu.abs().max()


def _cpu(node):
    if isinstance(node, dict):
        return {k: _cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_cpu(v) for v in node]
    return node.cpu()


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,P,M,off", [
    (9, 49, 384, 0), (25, 49, 128, 0),      # t4_A, t5_A
    (9, 7, 7, 0), (9, 49, 384, 1),          # PM % 4 != 0; a misaligned view
    (2, 50, 33, 0), (49, 98, 64, 0), (10, 40, 12, 0)])
def test_stage2_tap_sum_matches_plain_and_repeats_its_bits(T, P, M, off,
                                                           dtype):
    """The unrolled taps (9, 25), the runtime ones (2, 10, 49), the
    scalar loads and stores (PM % 4 != 0, temps off 16 bytes); two runs
    give the same bits (the thread rows add in one fixed order)."""
    gen = torch.Generator().manual_seed(19)
    temps = _randn(gen, (T * P * M + off,), torch.float32)[off:].view(T, P,
                                                                     M)
    assert (temps.data_ptr() % 16 != 0) == bool(off)
    got = cuconv_stage2.stage2_tap_sum(temps, out_dtype=dtype)
    _close(got, cuconv_stage2.stage2_tap_sum_plain(temps, dtype), dtype)
    again = cuconv_stage2.stage2_tap_sum(temps, out_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _build.LAUNCHES["stage2_tap_sum"] == 2


@requires_cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,P,M", [(9, 49, 384), (25, 49, 128)])
def test_stage2_tap_sum_runtime_loop_gives_the_unrolled_bits(T, P, M, dtype):
    """At t4_A and t5_A the runtime-T loop (``unroll=False``) adds in the
    unrolled body's order: the same bits, both near the plain sum."""
    gen = torch.Generator().manual_seed(23)
    temps = _randn(gen, (T, P, M), torch.float32)
    unrolled = cuconv_stage2.stage2_tap_sum(temps, out_dtype=dtype)
    loop = cuconv_stage2.stage2_tap_sum(temps, out_dtype=dtype, unroll=False)
    torch.cuda.synchronize()
    _close(loop, cuconv_stage2.stage2_tap_sum_plain(temps, dtype), dtype)
    assert torch.equal(unrolled, loop)


def _served_engines():
    """resnet_like's served buckets: fp32 at 224x224 (b1) and 32x32 (b1,
    b4), int8 at 32x32 (b1, b4; calibrated on one seeded batch of 4, so
    b1c1-b2c2 run the int8 kernel)."""
    from repro_torch.models.cnn import resnet_like
    from repro_torch.quant import Calibrator, QuantPolicy
    from repro_torch.serve.cnn import CnnServeEngine
    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    calib = np.random.default_rng(3).standard_normal((4, 32, 32, 3),
                                                     dtype=np.float32)
    model.graph_plan(calib.shape, backend="cuda").warmup(
        calibrate=Calibrator(calib, params))
    return params, [
        CnnServeEngine(model, params, (224, 224, 3), buckets=(1,)),
        CnnServeEngine(model, params, (32, 32, 3), buckets=(1, 4)),
        CnnServeEngine(model, params, (32, 32, 3), buckets=(1, 4),
                       precision=QuantPolicy())]


@requires_cuda
def test_served_bucket_graphs_replay_bit_equal_to_eager():
    """Every served bucket, fp32 and int8: the graph's replay equals the
    eager program ``fn(b)`` bit for bit, and launches what it launches."""
    _, engines = _served_engines()
    rng = np.random.default_rng(0)
    for eng in engines:
        eng.warmup()
        progs = eng.programs
        for b in eng.buckets:
            assert progs.graphs[b].captures == 1
            xb = rng.normal(size=(b,) + eng.image_shape).astype(np.float32)
            _build.reset_launches()
            want = progs.fn(b)(eng.params, progs.put(xb))
            torch.cuda.synchronize()
            eager = dict(_build.LAUNCHES)
            _build.reset_launches()
            got = progs.serve_batch(b, xb).clone()
            torch.cuda.synchronize()
            assert dict(_build.LAUNCHES) == eager
            assert sum(eager.values()) >= 6
            assert progs.graphs[b].replays == 1
            assert torch.equal(got, want), (eng.image_shape, b)
    assert all(n == 4 for n in (
        sum(p.algorithm == "cuconv_int8"
            for p in engines[2].programs.plan(b).conv_plans.values())
        for b in (1, 4)))


@requires_cuda
def test_a_capture_survives_graphs_left_in_reference_cycles():
    """CUDA graphs held by reference cycles are freed by the garbage
    collector; one freed during a capture would invalidate it, so a
    capture collects first and holds the collector off."""
    import gc
    from repro_torch.serve.graphs import GraphedProgram
    x = torch.arange(4096, dtype=torch.float32, device="cuda")
    for _ in range(16):
        cycle = {"graph": torch.cuda.CUDAGraph()}
        with torch.cuda.graph(cycle["graph"]):
            cycle["out"] = x * 2
        cycle["self"] = cycle
    del cycle
    prog = GraphedProgram(
        lambda p, _, t: [t * p["w"] + i for i in range(8)][-1],
        [torch.zeros_like(x)])
    params = {"w": torch.full_like(x, 3.0)}
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)             # collect at almost every object
    try:
        eager = prog(params, None, x).clone()
        replayed = prog(params, None, x).clone()
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()
    assert (prog.captures, prog.replays) == (1, 1)
    assert torch.equal(eager, x * 3 + 7) and torch.equal(replayed, eager)


@requires_cuda
def test_a_changed_parameter_recaptures_the_bucket_graph():
    params, engines = _served_engines()
    progs = engines[1].programs
    xb = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    before = progs.serve_batch(4, xb).clone()
    progs.serve_batch(4, xb)
    assert (progs.graphs[4].captures, progs.graphs[4].replays) == (1, 1)
    params["stem"]["w"].mul_(2.0)                 # in place
    got = progs.serve_batch(4, xb).clone()        # eager, then capture
    assert progs.graphs[4].captures == 2
    again = progs.serve_batch(4, xb).clone()      # the new graph
    want = progs.fn(4)(params, progs.put(xb))
    torch.cuda.synchronize()
    assert progs.graphs[4].replays == 2
    assert torch.equal(got, want) and torch.equal(again, want)
    assert not torch.equal(before, want)


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_decode_graph_gives_the_eager_tokens(arch):
    """16 greedy decode steps at full size (bf16, 4 slots, prompts of
    64) through the engine's graphs and through eager ``lm`` calls: the
    same tokens.  The largest logit difference is printed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(arch)
    params = lm.init_lm(cfg, seed=0)
    slots, S, steps = 4, 64, 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (slots, S)).astype(np.int32))
    eng = ServeEngine(cfg, params, slots=slots, max_len=S + steps)
    cache = lm.init_cache(cfg, slots, S + steps)
    sample = (lambda lg: lg[..., :cfg.vocab_size].float().argmax(-1)
              .view(slots, 1).to(torch.int32))
    lg_g, _ = eng._prefill(params, {"tokens": toks}, eng.cache)
    lg_e, cache = lm.prefill(params, cfg, {"tokens": toks.cuda()}, cache)
    lg_e = lg_e[:, -1, :]
    got, want, diff = [], [], 0.0
    cur_g, cur_e = sample(lg_g), sample(lg_e)
    for t in range(steps):
        lg_g, _ = eng._decode(params, {"tokens": cur_g}, eng.cache, S + t)
        lg_e, cache = lm.decode_step(params, cfg, {"tokens": cur_e}, cache,
                                     S + t)
        lg_e = lg_e[:, -1, :]
        diff = max(diff, (lg_g.float() - lg_e.float()).abs().max().item())
        cur_g, cur_e = sample(lg_g), sample(lg_e)
        got.append(cur_g.cpu())
        want.append(cur_e.cpu())
    g = eng.graphs["decode"]
    print(f"{arch}: max |graph - eager| logit over {steps} steps: {diff}")
    assert (g.captures, g.replays) == (1, steps - 1)
    assert torch.equal(torch.cat(got, 1), torch.cat(want, 1))


@requires_cuda
def test_device_ms_times_a_kernel_and_drops_its_graph():
    """The tuning harness: a positive device time per call, the launch
    counters untouched by the capture, and no memory kept across many
    timings (each graph's pool goes with it)."""
    from repro_torch.core import autotune
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, (1, 28, 28, 64), torch.float32)
    w = _randn(gen, (3, 3, 64, 64), torch.float32)

    def call():
        return cuconv_fused.cuconv_fused(x, w, padding=(1, 1))
    autotune.device_ms(call)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    _build.reset_launches()
    times = [autotune.device_ms(call) for _ in range(20)]
    assert all(t > 0 for t in times)
    # the eager warm calls count; the captured and replayed ones do not
    assert _build.LAUNCHES["cuconv_fused"] == 20 * autotune.WARM_CALLS
    assert torch.cuda.memory_reserved() <= reserved


@requires_cuda
def test_plan_tune_full_on_card_persists_under_cuda_and_replays():
    from repro_torch.core import autotune, executors
    from repro_torch.core import convspec as cs
    from repro_torch.core.cuconv import conv_lax
    spec = cs.ConvSpec((1, 14, 14, 32), (3, 3, 32, 64), (1, 1), (1, 1))
    p = cs.plan(spec, tune="full")
    stats = autotune.reset_measure_stats()
    timed = {r["algorithm"] for r in stats["timed"] if r["kind"] == "algo"}
    kernels = {n for n in executors.supporting(spec)
               if executors.get(n).kernels}
    assert kernels <= timed and "lax" in timed
    assert not [r for r in stats["failed"]
                if executors.get(r["algorithm"]).kernels], stats["failed"]
    assert autotune.cached_best(spec, "cuda") == p.algorithm
    assert autotune.cached_best(spec, "cpu") is None
    autotune.clear_cache()
    p2 = cs.plan(spec, tune="full")
    assert (p2.algorithm, p2.config) == (p.algorithm, p.config)
    assert not any(autotune.reset_measure_stats().values())
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, spec.in_shape, torch.float32)
    w = _randn(gen, spec.filter_shape, torch.float32)
    want = conv_lax(x, w, padding=(1, 1))
    tol = 2e-3 if p.config.get("m") == 4 else 3e-4
    assert (p(x, w) - want).abs().max().item() <= \
        tol * max(1.0, want.abs().max().item())


@requires_cuda
def test_serving_warmup_tune_captures_the_tuned_programs_again():
    from repro_torch.core import autotune
    _, engines = _served_engines()
    eng = engines[1]
    eng.warmup()
    old = dict(eng.programs.graphs)
    eng.warmup(tune="algo")
    assert autotune.MEASURE_STATS["algo_sweeps"] > 0
    for b in eng.buckets:
        g = eng.programs.graphs[b]
        assert g is not old[b] and g.captures == 1
        xb = np.random.default_rng(b).normal(
            size=(b,) + eng.image_shape).astype(np.float32)
        want = eng.programs.fn(b)(eng.params, eng.programs.put(xb))
        got = eng.programs.serve_batch(b, xb).clone()
        torch.cuda.synchronize()
        assert g.replays == 1 and torch.equal(got, want)


def _dispatch_programs(depth=2, telemetry=None):
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve.cnn import BucketPrograms
    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    progs = BucketPrograms(model, params, (32, 32, 3), buckets=(4,),
                           pipeline_depth=depth, telemetry=telemetry)
    progs.warmup()
    return progs


def _chunk(rid, x):
    from repro_torch.serve.cnn import ImageRequest
    r = ImageRequest(rid, x)
    return [(r, j) for j in range(x.shape[0])]


@requires_cuda
@pytest.mark.parametrize("in_flight", [2, 5])
def test_dispatch_slots_keep_in_flight_batches_apart(in_flight):
    """Depth 2, one bucket: ``in_flight`` batches dispatched before any
    harvest (2: the pipeline's depth; 5: past the ring of 3 slots, whose
    unread outputs are read out before a slot is reused) each harvest
    their own output, bit-equal to the eager program; the slots were
    allocated by warmup, pinned."""
    progs = _dispatch_programs()
    assert len(progs._slots) == 3
    assert all(s.host_in.is_pinned() and s.host_out.is_pinned()
               for s in progs._slots)
    rng = np.random.default_rng(in_flight)
    xs = [rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
          for _ in range(in_flight)]
    handles = [progs.dispatch(4, _chunk(i, x)) for i, x in enumerate(xs)]
    assert all(h.transfer_t0 <= h.transfer_t1 <= h.dispatch_t
               for h in handles)
    replays = progs.graphs[4].replays
    outs = [progs.harvest(h) for h in handles]
    assert progs.graphs[4].replays == replays       # harvest replays none
    for x, y in zip(xs, outs):
        want = progs.fn(4)(progs.params, progs.put(x)).cpu().numpy()
        np.testing.assert_array_equal(y, want)
    assert not np.array_equal(outs[0], outs[1])


@requires_cuda
def test_traced_dispatch_records_slots_copies_and_captures():
    """Spans on, on the card: warmup records its bucket's plan, eager run
    and capture, then the slots; five batches dispatched before any
    harvest (past the ring of 3 slots) each record the slot, pack, copy,
    copy wait and launch, the fourth and fifth a forced read of an
    unharvested slot, and count one replay and no capture; their
    timelines are the spans' edges and their outputs the eager
    program's."""
    from repro_torch.serve.telemetry import Telemetry
    tel = Telemetry(trace=True)
    progs = _dispatch_programs(telemetry=tel)
    assert [s.name for s in tel.spans] == [
        "warmup", "warmup.plan", "warmup.eager", "warmup.capture",
        "warmup.slots"]
    assert progs.graphs[4].captures == 1
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
          for _ in range(5)]
    handles = [progs.dispatch(4, _chunk(i, x), seq=i)
               for i, x in enumerate(xs)]
    outs = [progs.harvest(h) for h in handles]
    for seq, (h, x, y) in enumerate(zip(handles, xs, outs)):
        assert tel.counters[seq] == {
            "packed_bytes": 4 * 32 * 32 * 3 * 4, "replays": 1,
            "captures": 0, "forced_reads": int(seq >= 3)}
        mine = {s.name: s for s in tel.spans if s.batch == seq}
        assert list(mine) == (
            ["dispatch", "dispatch.slot"]
            + ["dispatch.slot.wait"] * (seq >= 3)
            + ["dispatch.pack", "dispatch.copy", "dispatch.copy_wait",
               "dispatch.launch"])
        assert [s.name for s in mine.values() if s.wait] == [
            n for n in ("dispatch.slot.wait", "dispatch.copy_wait")
            if n in mine]
        assert h.transfer_t0 == mine["dispatch.copy"].t0
        assert h.transfer_t1 == mine["dispatch.copy_wait"].t1
        assert h.dispatch_t == mine["dispatch.launch"].t1 \
            == mine["dispatch"].t1
        want = progs.fn(4)(progs.params, progs.put(x)).cpu().numpy()
        np.testing.assert_array_equal(y, want)


@requires_cuda
def test_traced_frontend_on_card_waits_in_its_wait_spans():
    """AsyncServeFrontend(trace=True) on the card: every batch has its
    form, dispatch and harvest spans, with the copy wait and the output
    wait marked; the sharded one-card mesh records the same names."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve import AsyncServeFrontend, ServeRequest
    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    names = []
    for mesh in (None, make_serve_mesh(1)):
        fe = AsyncServeFrontend(model, params, {(32, 32, 3): (4,)},
                                mesh=mesh, trace=True)
        fe.warmup()
        for i in range(5):
            fe.submit(ServeRequest(rid=i, images=rng.normal(
                size=(4, 32, 32, 3)).astype(np.float32)))
        assert all(r.status == "served" for r in fe.run())
        tel = fe.telemetry
        assert [b.seq for b in tel.batches] == list(range(5))
        for b in tel.batches:
            mine = [s for s in tel.spans if s.batch == b.seq]
            assert [s.name for s in mine if s.wait] == [
                "dispatch.copy_wait", "harvest.wait"]
            assert tel.counters[b.seq]["replays"] == 1
        names.append([s.name for s in tel.spans])
    assert names[0] == names[1]


@requires_cuda
def test_async_frontend_on_card_matches_cpu_and_sharded_one_card():
    """resnet_like through AsyncServeFrontend on the card against the CPU
    engine (3e-4 of the abs max), and the one-card sharded dispatcher
    bit-equal to the plain frontend."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve import (AsyncServeFrontend, CnnServeEngine,
                                   ImageRequest, ServeRequest,
                                   ShardedServeDispatcher)
    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in params.items()}
    geoms = {(32, 32, 3): (1, 4), (16, 16, 3): (1, 2)}
    rng = np.random.default_rng(0)
    reqs = [rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
            for n, hw in [(1, 32), (3, 16), (4, 32), (2, 16), (3, 32)]]
    fe = AsyncServeFrontend(model, params, geoms, pipeline_depth=2)
    disp = ShardedServeDispatcher(model, params, geoms,
                                  mesh=make_serve_mesh(1))
    outs = []
    for server in (fe, disp):
        server.warmup()
        for i, x in enumerate(reqs):
            server.submit(ServeRequest(rid=i, images=x))
        done = sorted(server.run(), key=lambda r: r.rid)
        assert all(r.status == "served" for r in done)
        outs.append([r.out for r in done])
    assert disp.stats()["devices"] == 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for shape, buckets in geoms.items():
        eng = CnnServeEngine(model, cpu_params, shape, buckets=buckets,
                             device="cpu", backend="cuda")
        idx = [i for i, x in enumerate(reqs) if x.shape[1:] == shape]
        for i in idx:
            eng.submit(ImageRequest(i, reqs[i]))
        for i, r in zip(idx, eng.run()):
            bound = 3e-4 * np.abs(r.out).max()
            assert np.abs(outs[0][i] - r.out).max() <= bound
    st = fe.stats()
    assert st["overlapped_batches"] >= 1 and st["max_inflight"] == 2
    for t in fe.telemetry.requests:
        assert t.compute_ms <= t.total_ms and t.queue_ms <= t.total_ms


# ---------------------------------------------------------------------------
# MoE and MLA on the card; train mode's gradients

@requires_cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_served_moe_smoke_on_card_matches_cpu(arch):
    """test_served_lm_smoke_on_card_matches_cpu for the MoE archs, at
    capacity factor 8 (the empty slots of the last wave are equal rows
    whose gates differ in their last bits: which of them a binding
    capacity drops is decided by rounding)."""
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              capacity_factor=8.0)
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (5, 24))
    logs = []
    for eng in (ServeEngine(cfg, params, slots=2, max_len=40),
                ServeEngine(cfg, _cpu(params), slots=2, max_len=40,
                            device="cpu")):
        log = []
        for name in ("_prefill", "_decode"):
            def wrapped(*a, fn=getattr(eng, name)):
                logits, cache = fn(*a)
                log.append(logits.float().cpu())
                return logits, cache
            setattr(eng, name, wrapped)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p.astype(np.int32), max_new_tokens=6))
        assert len(eng.run(prompt_len=24)) == 5
        logs.append(log)
    n_gqa = 0 if cfg.mla else sum(mx == "attn" for mx, _ in cfg.layer_kinds())
    assert _build.LAUNCHES["flash_attention"] == n_gqa * 3
    assert len(logs[0]) == len(logs[1]) == 3 * 6
    for card, cpu in zip(*logs):
        assert (card - cpu).abs().max() <= 1e-2 * cpu.abs().max()


@requires_cuda
def test_moe_fwd_on_card_repeats_its_bits_and_replays_them():
    """deepseek-moe-16b's MoE layer at full width in bf16 on a prefill
    wave (4 x 512 tokens, the capacity path) and a dropless decode step:
    two eager calls give the same bits, and a CUDA graph's replay gives
    them too.  The decode step is within the bf16 bound of the CPU's on
    the same params and inputs (in the wave, a gate a rounding apart at
    an expert's capacity cut would drop another token)."""
    from repro_torch.configs.base import get_config
    from repro_torch.nn import moe as M
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = M.moe_init(gen, cfg)
    for B, S, dropless in ((4, 512, False), (4, 1, True)):
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        a, aux = M.moe_fwd(p, cfg, x, dropless=dropless)
        b, _ = M.moe_fwd(p, cfg, x, dropless=dropless)
        assert torch.equal(a, b)
        static = x.clone()
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            M.moe_fwd(p, cfg, static, dropless=dropless)     # warm
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            out, _ = M.moe_fwd(p, cfg, static, dropless=dropless)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, a)
        if dropless:
            cpu, caux = M.moe_fwd(_cpu(p), cfg, x.cpu().float(),
                                  dropless=True)
            assert (a.float().cpu() - cpu).abs().max() <= \
                3e-2 * max(1.0, cpu.abs().max().item())
            assert float(aux["dropped_frac"]) == float(
                caux["dropped_frac"]) == 0.0
        else:
            assert 0.0 <= float(aux["dropped_frac"]) < 0.5


@requires_cuda
def test_flash_wrapper_refuses_grad_on_the_card():
    q = torch.zeros((1, 16, 2, 64), device="cuda", requires_grad=True)
    kv = torch.zeros((1, 16, 1, 64), device="cuda")
    with pytest.raises(RuntimeError, match="flash_attention: an input "
                                           "requires grad"):
        flash_attention.flash_attention(q, kv, kv)
    with torch.no_grad():
        flash_attention.flash_attention(q, kv, kv)
    assert _build.LAUNCHES["flash_attention"] == 1


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-moe-16b"])
def test_train_mode_on_card_has_the_cpus_gradients(arch):
    """lm_forward(mode="train") on the card launches no kernel and its
    fp32 gradients match the CPU's (TF32 off)."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import lm
    cfg = smoke_variant(get_config(arch))
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    grads = []
    for p in (params, _cpu(params)):
        leaves = []
        _leaves(p, leaves)
        for t in leaves:
            t.requires_grad_(True)
        logits, _, aux = lm.lm_forward(p, cfg, {"tokens":
                                                toks.to(leaves[0].device)})
        loss = logits.float().square().mean() + aux["load_balance_loss"]
        grads.append(torch.autograd.grad(loss, leaves))
    assert sum(_build.LAUNCHES.values()) == 0
    for card, cpu in zip(*grads):
        assert (card.cpu() - cpu).abs().max() <= \
            2e-4 * max(1.0, cpu.abs().max().item())


def _leaves(node, out):
    if isinstance(node, dict):
        for v in node.values():
            _leaves(v, out)
    elif isinstance(node, list):
        for v in node:
            _leaves(v, out)
    else:
        out.append(node)


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-moe-16b"])
def test_train_step_on_card_matches_the_cpu(arch):
    """Two fp32 make_train_step steps (the smoke config's grad_accum) on
    the card and on the CPU from the same params and batch: loss and
    grad_norm within 1e-4 relative, each leaf's update within 1e-2
    relative in L2; no kernel launched (train mode takes the plain
    versions)."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves
    cfg = smoke_variant(get_config(arch))
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, peak_lr=3e-3)
    runs = []
    for p in (params, _cpu(params)):
        dev = leaves(p)[0].device
        state = {"params": p, "opt": adamw_init(p),
                 "step": torch.zeros((), dtype=torch.int32)}
        ms = []
        for _ in range(2):
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((ms, leaves(state["params"]), leaves(p)))
    assert sum(_build.LAUNCHES.values()) == 0
    (card_m, card_p, p0), (cpu_m, cpu_p, _) = runs
    np.testing.assert_allclose(card_m, cpu_m, rtol=1e-4)
    for a, b, z in zip(card_p, cpu_p, p0):
        da, db = a.cpu() - z.cpu(), b - z.cpu()
        assert (da - db).norm() <= 1e-2 * max(db.norm().item(), 1e-12)


@requires_cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A bf16 train state saved from the card restores onto it (and onto
    the CPU) bit for bit, with the reference's stacked keys."""
    import json
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.launch.steps import state_specs
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves
    cfg = smoke_variant(get_config("qwen2-1.5b"))
    params = lm.init_lm(cfg, seed=0)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.tensor(3, dtype=torch.int32, device="cuda")}
    ckpt.save_checkpoint(tmp_path, 3, state, async_=True).join()
    like = state_specs(cfg)
    for dev in ("cuda", "cpu"):
        back = ckpt.restore_checkpoint(tmp_path, 3, like, device=dev)
        for a, b in zip(leaves(state), leaves(back)):
            assert b.device.type == dev and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())
    manifest = json.loads((tmp_path / "step_3" / "manifest.json")
                          .read_text())["arrays"]
    assert manifest["params/segments/0/pos0/ln1/scale"]["shape"] == [
        cfg.num_layers, cfg.d_model]


@pytest.fixture
def card_mesh(tmp_path):
    """A world-size-1 NCCL process group and make_debug_mesh() over it,
    (1, 1) on the card; destroyed after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: an NCCL group lies on the card")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_debug_mesh()
    finally:
        dist.destroy_process_group()


@requires_cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-moe-16b"])
def test_mesh_step_on_card_matches_the_unsharded_step(arch, card_mesh):
    """One fp32 step (grad_accum 2) through Trainer(mesh=(1, 1)) and
    through the unsharded Trainer on the card, from the same seed and
    batch: loss and grad_norm within 1e-5 relative, each leaf's update
    within 1e-2 relative in L2; no kernel launched."""
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves, map_tree
    assert tuple(card_mesh.shape) == (1, 1)
    assert card_mesh.device_type == "cuda"
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), grad_accum=2)
    data = SyntheticLMData(cfg.vocab_size, 4, 32)
    _build.reset_launches()
    runs = []
    for kw in ({"mesh": card_mesh}, {"device": "cuda"}):
        t = Trainer(cfg, TrainConfig(peak_lr=3e-3), data, **kw)
        st = t.init_state()
        st["params"] = map_tree(lambda a: a.float(), st["params"])
        st["opt"] = adamw_init(st["params"])
        full = (lambda x: x.full_tensor().clone()) if "mesh" in kw else (
            lambda x: x.clone())
        p0 = [full(x) for x in leaves(st["params"])]
        st, m = t.step_fn(st, t.batch_at(0))
        runs.append((float(m["loss"]), float(m["grad_norm"]), p0,
                     [full(x) for x in leaves(st["params"])]))
    assert sum(_build.LAUNCHES.values()) == 0
    (lm_, gm, a0, a1), (lo, go, b0, b1) = runs
    np.testing.assert_allclose([lm_, gm], [lo, go], rtol=1e-5)
    for x0, x1, y0, y1 in zip(a0, a1, b0, b1):
        assert torch.equal(x0, y0)
        assert ((x1 - x0) - (y1 - y0)).norm() <= 1e-2 * max(
            (y1 - y0).norm().item(), 1e-12)


@requires_cuda
def test_mesh_checkpoint_and_compressed_psum_on_card(card_mesh, tmp_path):
    """The mesh trainer's bf16 checkpoint restores onto the mesh and
    without it bit-equal to the state it saved; compressed_psum over the
    one-rank group is the codec bit for bit."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist import compress as C
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves
    cfg = smoke_variant(get_config("qwen2-1.5b"))
    t = Trainer(cfg, TrainConfig(steps=2, ckpt_every=2,
                                 ckpt_dir=str(tmp_path / "run")),
                SyntheticLMData(cfg.vocab_size, 4, 16), mesh=card_mesh)
    t.run()
    saved = [x.full_tensor().clone() for x in leaves(t.state)]
    like = t.init_state(device="meta")
    onto = ckpt.restore_checkpoint(tmp_path / "run", 2, like,
                                   shardings=t.shardings)
    plain = ckpt.restore_checkpoint(tmp_path / "run", 2, like,
                                    device="cuda")
    for a, b, c in zip(saved, leaves(onto), leaves(plain), strict=True):
        assert torch.equal(a, b.full_tensor()) and torch.equal(a, c)
        assert b.to_local().is_cuda and c.is_cuda
    x = torch.randn(4, 5000, device="cuda")
    e = torch.randn(4, 5000, device="cuda") * 1e-2
    got, ne = C.compressed_psum(x, card_mesh["data"], e)
    (q, s, shape), want_e = C.quantize_with_feedback(x, e)
    assert torch.equal(got, C.dequantize(q, s, shape))
    assert torch.equal(ne, want_e)


@requires_cuda
@pytest.mark.parametrize("arch,head_dim", [("qwen2-vl-2b", 16),
                                           ("musicgen-large", 64)])
def test_embeds_programs_replay_bit_equal_to_eager(arch, head_dim):
    """chip_smoke's programs for the archs fed embeddings, at smoke width
    in bf16 (musicgen at its real head dim, 64): two waves of 2 slots x
    24, then 5 decode steps each, qwen2-vl's prompts an M-RoPE image
    grid and its decode positions off the cache offset.  Every call's
    logits, eager first calls and replays, equal an eager
    ``lm.prefill``/``decode_step`` on a cache of its own bit for bit,
    and every prefill launches ``flash_attention`` once a layer."""
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import lm
    cs = chip_smoke()
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              head_dim=head_dim)
    params = lm.init_lm(cfg, seed=0)
    slots, S, steps, max_len = 2, 24, 5, 32
    progs = cs.embeds_programs(cfg, slots, S, torch.bfloat16, "cuda",
                               torch.cuda.graph_pool_handle())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def embeds(n):
        return torch.randn((slots, n, cfg.d_model), generator=gen,
                           device="cuda").to(torch.bfloat16)
    grid, nxt = cs.mrope_grid(4, 4, 4)
    assert grid.shape == (3, S) and nxt == 12
    pos = (torch.from_numpy(grid).cuda()[:, None].expand(3, slots, S)
           .contiguous(),) if cfg.mrope_sections else ()
    caches = [lm.init_cache(cfg, slots, max_len) for _ in range(2)]
    for _ in range(2):
        calls = [(0, (embeds(S),) + pos)]
        for t in range(steps):
            step_pos = ((torch.full((3, slots, 1), nxt + t, dtype=torch.int32,
                                    device="cuda"),)
                        if cfg.mrope_sections else ())
            calls.append((1, (embeds(1),) + step_pos + (S + t,)))
        for which, args in calls:
            got = progs[which](params, caches[0], *args).clone()
            want = progs[which].fn(params, caches[1], *args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (which, args[-1])
    assert (progs[0].captures, progs[0].replays) == (1, 1)
    assert (progs[1].captures, progs[1].replays) == (1, 2 * steps - 1)
    # two graphed waves (one eager, one replayed) and two eager ones
    assert _build.LAUNCHES["flash_attention"] == 4 * cfg.num_layers
