"""Public wrappers around the CUDA kernels, in the reference's layouts.

Each wrapper shapes NHWC/HWIO operands (or the LM's (B, S, H, D) and
(B, L, D) tensors) for its kernel and follows the device of its inputs:
CUDA tensors launch the kernel, CPU tensors run its plain version (the
kernel modules decide, never a fallback here).
``pool2d`` is the graph IR's pool executor: plain PyTorch, no kernel.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core.convspec import normalize_stride
from repro_torch.kernels import (conv1d_tap as _c1d, conv1x1 as _c1,
                                 cuconv_fused as _cf, cuconv_stage1 as _s1,
                                 cuconv_stage2 as _s2, direct_conv as _dcv,
                                 flash_attention as _fa, int8_gemm as _i8,
                                 winograd_fused as _wg)
from repro_torch.kernels._compat import clamp_tiles  # noqa: F401  (re-export)


def conv1x1(x, w, tp=256, tm=128, tc=512):
    """x: (N, H, W, C); w: (1, 1, C, M) or (C, M).  ``tp/tm/tc`` are the
    GEMM launch tiles (pixels / out-channels / contraction)."""
    if w.dim() == 4:
        w = w[0, 0]
    N, H, W_, C = x.shape
    out = _c1.conv1x1_gemm(x.reshape(N * H * W_, C).contiguous(),
                           w.contiguous(), tp=tp, tm=tm, tc=tc)
    return out.reshape(N, H, W_, -1)


def int8_conv(x, w, stride=(1, 1), padding=(0, 0), scale=None,
              w_scales=None, bias=None, addend=None, relu=False, tp=256,
              tm=128, tc=512):
    """x: (N, H, W, C) int8 codes or fp32; w: (M, KH, KW, C) int8 codes.
    The int8 conv in one kernel: the int32 accumulator on codes; on fp32,
    quantized on load with ``scale`` and requantized with ``w_scales``,
    ``bias``, ``addend`` and ReLU (see ``kernels/int8_gemm.py``)."""
    return _i8.int8_conv(
        x.contiguous(), w.contiguous(), normalize_stride(stride),
        tuple(padding), scale=scale, w_scales=w_scales,
        bias=None if bias is None else bias.contiguous(),
        addend=None if addend is None else addend.contiguous(), relu=relu,
        tp=tp, tm=tm, tc=tc)


def cuconv_two_stage(x, w, padding=(0, 0), tp=256, tm=128, tc=512):
    """Faithful two-kernel cuConv (stride 1): stage-1 temporaries in
    device memory, then the stage-2 sum.  Stage 1 reads each tap's rows
    straight from the padded input (no stack of shifted views);
    ``tp/tm/tc`` are the reference's stage-1 tiles, which size nothing
    on the card."""
    from repro_torch.core.cuconv import _pad_input
    N, H, W_, C = x.shape
    KH, KW, _, M = w.shape
    ph, pw = padding
    xp = _pad_input(x, ph, pw)
    OH, OW = H + 2 * ph - KH + 1, W_ + 2 * pw - KW + 1
    temps = _s1.stage1_tap_conv(xp.contiguous(), w.contiguous(), tp=tp,
                                tm=tm, tc=tc)
    out = _s2.stage2_tap_sum(temps)
    return out.reshape(N, OH, OW, M).to(x.dtype)


def cuconv_fused(x, w, padding=(0, 0), stride=1, bias=None, activation=None,
                 addend=None, pool=None, tm=128, rows=1):
    """Single-kernel fused cuConv, any stride >= 1, with the fused
    bias / residual-add / ReLU / pool epilogue; ``tm``/``rows`` are the
    reference's launch config (the kernel's geometry is its own)."""
    return _cf.cuconv_fused(
        x.contiguous(), w.contiguous(),
        None if bias is None else bias.contiguous(),
        stride=normalize_stride(stride), padding=tuple(padding),
        activation=activation,
        addend=None if addend is None else addend.contiguous(),
        pool=tuple(pool) if pool is not None else None, tm=tm, rows=rows)


def winograd_fused(x, w, padding=(1, 1), bias=None, activation=None,
                   addend=None, m=2, tt=128, tm=128, tc=128):
    """Winograd F(m,3) conv (3x3, stride 1) with the fused bias /
    residual-add / ReLU epilogue; ``m`` and ``tt/tm/tc`` are its launch
    config."""
    return _wg.winograd_fused(
        x.contiguous(), w.contiguous(), tuple(padding),
        bias=None if bias is None else bias.contiguous(),
        activation=activation,
        addend=None if addend is None else addend.contiguous(),
        m=m, tt=tt, tm=tm, tc=tc)


def direct_conv(x, w, padding=(0, 0), stride=(1, 1), tm=128, tc=256):
    """Im2col-free direct conv (Li et al. 1610.03618), any stride, no
    epilogue; ``tm/tc`` are the direct executor's launch config."""
    return _dcv.direct_conv(x.contiguous(), w.contiguous(), tuple(padding),
                            normalize_stride(stride), tm=tm, tc=tc)


def pool2d(x, kind="max", window=(2, 2), stride=(2, 2), padding=(0, 0)):
    """Windowed max/avg pooling over NHWC.

    Avg pooling divides by the full window size (padding counts as
    zeros), i.e. ``count_include_pad=True``; max pooling pads with -inf.
    """
    if kind not in ("max", "avg"):
        raise ValueError(f"pool kind must be 'max' or 'avg'; got {kind!r}")
    ph, pw = padding
    xn = x.permute(0, 3, 1, 2)
    if ph or pw:
        xn = F.pad(xn, (pw, pw, ph, ph),
                   value=float("-inf") if kind == "max" else 0.0)
    if kind == "max":
        y = F.max_pool2d(xn, tuple(window), tuple(stride))
    else:
        y = F.avg_pool2d(xn, tuple(window), tuple(stride))
    return y.permute(0, 2, 3, 1)


def conv1d_causal(x, w, b=None):
    """Causal depthwise conv1d.  x: (B, L, D); w: (K, D); b: (D,) or
    None.  The bias is added in fp32 before the one write."""
    return _c1d.conv1d_tap(x.contiguous(), w.contiguous(),
                           None if b is None else b.contiguous())


def flash_attention(q, k, v, causal=True):
    """q: (B, Sq, H, D) with k, v (B, Sk, KVH, D), KVH dividing H (the
    kernel reads kv head h // (H/KVH) by stride: no repeat); or all
    (BH, S, D).  Top-left causal mask."""
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)
