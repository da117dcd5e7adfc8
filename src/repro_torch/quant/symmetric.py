"""Symmetric int8 scale/clip/round core.

The one place the port maps float tensors onto the signed-127 grid.
Convention (the JAX package's): symmetric around zero with the -128 code
unused, ``q = clip(round(x / scale), -127, 127)`` with
``scale = amax / 127``.  The rounding is half-to-even (``torch.round``,
as ``jnp.round``) and the input is divided by the scale, not multiplied
by its reciprocal, so the codes are bit-equal to the reference's for the
same inputs.  A zero ``amax`` quantizes to all zeros through a guarded
divisor, and dequantizing with the unguarded zero scale is exact.
"""
from __future__ import annotations

import torch

#: largest magnitude representable: symmetric grid, -128 unused
QMAX = 127.0


def scale_for(amax):
    """Symmetric int8 scale for a known absolute maximum."""
    return amax / QMAX


def safe_scale(scale):
    """Divisor-safe view of a scale tensor: zero scales divide as 1.0
    (the quantized values are all zero either way)."""
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize_to_int8(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8, zero-scale safe."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / safe_scale(scale)),
                       -QMAX, QMAX).to(torch.int8)


def dequantize_int8(q, scale):
    """Back to fp32; no zero-guard needed (a zero scale means the values
    quantized to all zeros, and 0 * 0 is already right)."""
    return q.float() * scale


def abs_max(x, axis=None, keepdims: bool = False):
    """max|x| in fp32 — the amax every symmetric scale derives from."""
    a = x.float().abs()
    if axis is None:
        return a.amax()
    return a.amax(dim=axis, keepdim=keepdims)


def channel_scales(w):
    """Per-output-channel symmetric scales for an HWIO filter: shape
    ``(M,)`` fp32, ``max|w[..., m]| / 127``."""
    return scale_for(abs_max(w, axis=tuple(range(w.dim() - 1))))
