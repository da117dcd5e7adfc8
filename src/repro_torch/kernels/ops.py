"""Public wrappers around the CUDA kernels, in the reference's layouts.

Each wrapper shapes NHWC/HWIO operands for its kernel and follows the
device of its inputs: CUDA tensors launch the kernel, CPU tensors run
its plain version (the kernel modules decide, never a fallback here).
``pool2d`` is the graph IR's pool executor: plain PyTorch, no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.convspec import normalize_stride
from repro_torch.kernels import (conv1x1 as _c1, cuconv_fused as _cf,
                                 cuconv_stage1 as _s1, cuconv_stage2 as _s2)
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


def cuconv_two_stage(x, w, padding=(0, 0), tp=256, tm=128, tc=512):
    """Faithful two-kernel cuConv (stride 1): stage-1 temporaries in
    device memory, then the stage-2 sum.  ``tp/tm/tc`` are stage 1's
    launch tiles."""
    from repro_torch.core.cuconv import _pad_input, _tap_views
    N, H, W_, C = x.shape
    KH, KW, _, M = w.shape
    ph, pw = padding
    xp = _pad_input(x, ph, pw)
    OH, OW = H + 2 * ph - KH + 1, W_ + 2 * pw - KW + 1
    views = _tap_views(xp, KH, KW, OH, OW, 1)
    xs = torch.stack([v.reshape(N * OH * OW, C) for v in views], 0)
    temps = _s1.stage1_tap_gemm(xs.contiguous(),
                                w.reshape(KH * KW, C, M).contiguous(),
                                tp=tp, tm=tm, tc=tc)
    out = _s2.stage2_tap_sum(temps)
    return out.reshape(N, OH, OW, M).to(x.dtype)


def cuconv_fused(x, w, padding=(0, 0), stride=1, bias=None, activation=None,
                 addend=None, pool=None, tm=128, rows=1):
    """Single-kernel fused cuConv, any stride >= 1, with the fused
    bias / residual-add / ReLU / pool epilogue; ``tm``/``rows`` are its
    launch config."""
    return _cf.cuconv_fused(
        x.contiguous(), w.contiguous(),
        None if bias is None else bias.contiguous(),
        stride=normalize_stride(stride), padding=tuple(padding),
        activation=activation,
        addend=None if addend is None else addend.contiguous(),
        pool=tuple(pool) if pool is not None else None, tm=tm, rows=rows)


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
