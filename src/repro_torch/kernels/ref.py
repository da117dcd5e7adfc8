"""Plain PyTorch oracles for the conv kernels (the allclose references).

Every oracle computes in fp32 on the device of its inputs.  The conv
oracles call ``F.conv2d`` with TF32 off, so on the card they are IEEE
fp32 like the kernels they check.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv_nhwc(x, w, stride, padding, groups=1):
    """NHWC x HWIO -> NHWC through ``F.conv2d`` in fp32, TF32 off."""
    xn = x.float().permute(0, 3, 1, 2)
    wn = w.float().permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xn, wn, stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_ref(x, w, stride=1, padding=(0, 0)):
    """NHWC direct convolution via the platform library op (fp32 out)."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    return _conv_nhwc(x, w, s, tuple(padding))


def conv2d_pad_ref(x, w, padding=(0, 0)):
    return _conv_nhwc(x, w, (1, 1), tuple(padding))


def conv1x1_ref(x2d, w):
    return (x2d.float() @ w.float()).to(x2d.dtype)


def stage1_ref(xs, w):
    """xs: (T, P, C); w: (T, C, M) -> (T, P, M) f32."""
    return torch.bmm(xs.float(), w.float())


def stage2_ref(temps):
    return temps.float().sum(dim=0)
