"""cuConv: tap-decomposed direct convolution (the paper's contribution).

The paper decomposes a KH x KW convolution by *filter tap*: stage 1
computes, for every tap (i, j), the channel-axis dot product of that
filter row with every input row — a plain GEMM per tap, with no im2col
transform; stage 2 sums the KH*KW per-tap partial matrices.  1x1
filters skip stage 2 (the paper's best-case region).

All algorithms below are numerically equivalent, policy-free executor
*functions* on NHWC x and HWIO w: each is wrapped by a registered
``core.executors.Executor``, and which one runs is decided by
``core.convspec.plan``.  Every contraction accumulates in fp32 and casts
back to the input dtype.

  lax              ``F.conv2d`` (cuDNN on the card, TF32 off) — the
                   library baseline, and the grouped-conv executor
  im2col           explicit patch matrix + one GEMM
  cuconv_two_stage faithful paper algorithm in plain PyTorch
  cuconv           fused tap accumulation in plain PyTorch
  *_pallas         the CUDA kernels (``kernels/``) under the JAX
                   package's registry names
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.convspec import Pad  # noqa: F401  (public re-export)
from repro_torch.core.convspec import (normalize_pad as _norm_pad,
                                       normalize_stride as _norm_stride,
                                       out_size as _out_size)


def _pad_input(x, ph, pw):
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, pw, pw, ph, ph))


def _tap_views(xp, kh, kw, oh, ow, stride):
    """The KH*KW shifted input views (strided slices, nothing copied)."""
    sh, sw = _norm_stride(stride)
    return [xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]


# ---------------------------------------------------------------------------
# Baselines

def conv_lax(x, w, stride=1, padding: Pad = "same", groups=1):
    """Library convolution (``F.conv2d``, cuDNN on the card), in fp32
    with TF32 off; ``groups`` runs grouped/depthwise specs."""
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _norm_pad(padding, kh, kw)
    xn = x.float().permute(0, 3, 1, 2)
    wn = w.float().permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xn, wn, stride=_norm_stride(stride), padding=(ph, pw),
                     groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv_im2col(x, w, stride=1, padding: Pad = "same"):
    """Explicit-GEMM convolution: the patch matrix duplicates input
    elements KH*KW-fold — the memory cost cuConv avoids."""
    kh, kw, C, M = w.shape
    ph, pw = _norm_pad(padding, kh, kw)
    sh, sw = _norm_stride(stride)
    xp = _pad_input(x, ph, pw)
    N = xp.shape[0]
    oh = _out_size(x.shape[1], kh, ph, sh)
    ow = _out_size(x.shape[2], kw, pw, sw)
    patches = torch.stack(_tap_views(xp, kh, kw, oh, ow, (sh, sw)), dim=3)
    patches = patches.reshape(N * oh * ow, kh * kw * C).float()
    out = patches @ w.reshape(kh * kw * C, M).float()
    return out.reshape(N, oh, ow, M).to(x.dtype)


# ---------------------------------------------------------------------------
# cuConv: the paper's two stages

def cuconv_stage1(x, w, stride=1, padding: Pad = "same"):
    """Stage 1: the (KH*KW, N, OH, OW, M) per-tap partial results."""
    kh, kw, C, M = w.shape
    ph, pw = _norm_pad(padding, kh, kw)
    sh, sw = _norm_stride(stride)
    xp = _pad_input(x, ph, pw).float()
    oh = _out_size(x.shape[1], kh, ph, sh)
    ow = _out_size(x.shape[2], kw, pw, sw)
    taps = w.reshape(kh * kw, C, M).float()
    return torch.stack([v @ taps[t] for t, v in enumerate(
        _tap_views(xp, kh, kw, oh, ow, (sh, sw)))], dim=0)


def cuconv_stage2(temps):
    """Stage 2: sum the KH*KW per-tap partial matrices."""
    return temps.sum(dim=0)


def conv_cuconv_two_stage(x, w, stride=1, padding: Pad = "same"):
    """Faithful paper pipeline: materialized temporaries + separate sum
    (1x1 filters skip stage 2)."""
    kh, kw = w.shape[0], w.shape[1]
    temps = cuconv_stage1(x, w, stride, padding)
    if kh == 1 and kw == 1:
        return temps[0].to(x.dtype)
    return cuconv_stage2(temps).to(x.dtype)


def conv_cuconv(x, w, stride=1, padding: Pad = "same"):
    """Fused tap accumulation (no temporaries)."""
    kh, kw, C, M = w.shape
    ph, pw = _norm_pad(padding, kh, kw)
    sh, sw = _norm_stride(stride)
    xp = _pad_input(x, ph, pw).float()
    oh = _out_size(x.shape[1], kh, ph, sh)
    ow = _out_size(x.shape[2], kw, pw, sw)
    taps = w.reshape(kh * kw, C, M).float()
    acc = None
    for t, v in enumerate(_tap_views(xp, kh, kw, oh, ow, (sh, sw))):
        y = v @ taps[t]
        acc = y if acc is None else acc + y
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels, as bare executor functions

def conv_cuconv_pallas(x, w, stride=1, padding: Pad = "same"):
    """The fused CUDA kernel (``kernels/cuconv_fused.py``), any stride."""
    from repro_torch.kernels import ops
    kh, kw = w.shape[0], w.shape[1]
    return ops.cuconv_fused(x, w, _norm_pad(padding, kh, kw),
                            stride=_norm_stride(stride))


def conv_conv1x1_pallas(x, w, stride=1, padding: Pad = "same"):
    """The 1x1 GEMM CUDA kernel: all N*H*W pixels in one GEMM."""
    kh, kw = w.shape[0], w.shape[1]
    if ((kh, kw) != (1, 1) or _norm_stride(stride) != (1, 1)
            or _norm_pad(padding, kh, kw) != (0, 0)):
        raise ValueError("conv1x1 kernel needs 1x1 filter, stride 1, pad 0; "
                         "plan() routes other specs elsewhere")
    from repro_torch.kernels import ops
    return ops.conv1x1(x, w)


def conv_cuconv_two_stage_pallas(x, w, stride=1, padding: Pad = "same"):
    """The paper's two CUDA kernels (stride 1): stage-1 temporaries in
    device memory + the stage-2 sum."""
    if _norm_stride(stride) != (1, 1):
        raise ValueError("two-stage kernels are stride-1 only; "
                         "plan() routes strided specs elsewhere")
    from repro_torch.kernels import ops
    kh, kw = w.shape[0], w.shape[1]
    return ops.cuconv_two_stage(x, w, _norm_pad(padding, kh, kw))


def conv2d(x, w, stride=1, padding: Pad = "same", algorithm="auto",
           bias=None, activation: Optional[str] = None, groups=1):
    """Public conv entry point: a thin wrapper over the ConvSpec planner.

    x: (N,H,W,C) NHWC; w: (KH,KW,C/groups,M) HWIO; bias: optional (M,);
    activation: None | 'relu'.  Runs on the device of ``x`` and plans
    for it (backend ``"cuda"`` on the card).  ``algorithm="auto"`` lets
    plan() negotiate; naming a registered executor forces it.
    """
    from repro_torch.core.convspec import ConvSpec, backend_for, plan
    spec = ConvSpec.for_conv(x, w, stride, padding, bias=bias,
                             activation=activation, groups=groups)
    p = plan(spec, force=None if algorithm == "auto" else algorithm,
             backend=backend_for(x.device))
    return p(x, w, bias)
