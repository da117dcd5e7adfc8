"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here needs the card and skips without one.  On a machine with
a card: ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
The bounds are ``max|kernel - plain| <= tol * max(1, max|plain|)`` with
tol 2e-5 in fp32 (both sides FFMA/cuBLAS fp32, TF32 off; only the
summation order differs) and 3e-2 in bf16 (one bf16 rounding of the
output).
"""
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, requires_cuda  # noqa: F401
from repro_torch.kernels import (_build, conv1x1, cuconv_fused,
                                 cuconv_stage1, cuconv_stage2)

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
@pytest.mark.parametrize("P,C,M,tiles", [
    (64, 32, 16, (256, 128, 512)), (300, 130, 70, (128, 64, 128)),
    (17, 257, 129, (128, 128, 256)), (49, 832, 256, (49, 128, 256)),
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
def test_wrappers_refuse_mixed_devices_and_oversized_configs():
    x = torch.zeros((1, 8, 8, 4), device="cuda")
    with pytest.raises(ValueError, match="is on cpu"):
        cuconv_fused.cuconv_fused(x, torch.zeros((3, 3, 4, 8)))
    with pytest.raises(ValueError, match="shared"):
        conv1x1.conv1x1_gemm(torch.zeros((8, 1024), device="cuda"),
                             torch.zeros((1024, 8), device="cuda"), tc=1024)
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
