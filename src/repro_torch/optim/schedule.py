"""Learning-rate schedules (pure functions of the step counter).

``cosine_schedule`` gives the float32 bits the reference's jitted train
step computes for the same step.  XLA folds each division by a constant
into a product with its float32 reciprocal, contracts ``a * b + c`` into
one fused multiply-add and takes the cosine from the C library's
``cosf``; the schedule is one scalar a step, so the port computes it on
the host in numpy float32 the same way (the fma through float64, where a
float32 product is exact).  ``torch.cos`` rounds 505 of 11,901 of this
schedule's angles otherwise than ``cosf`` does.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

_F32 = np.float32


def _libm_cosf():
    name = ctypes.util.find_library("m")
    try:
        fn = ctypes.CDLL(name).cosf
    except (OSError, AttributeError, TypeError):
        return None
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


_COSF = _libm_cosf()


def _cos(x: np.float32) -> np.float32:
    if _COSF is not None:
        return _F32(_COSF(float(x)))
    return _F32(math.cos(float(x)))


def _fma(a, b, c) -> np.float32:
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def cosine_schedule(step, *, peak_lr=3e-4, warmup_steps=100,
                    total_steps=10_000, min_ratio=0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_ratio * peak_lr``: a 0-d float32 tensor on the host.  ``step``
    is an int or a 0-d tensor (read once: a card tensor syncs)."""
    s = _F32(int(step))
    peak = _F32(peak_lr)
    warm = min(_F32(_F32(s + _F32(1)) * _F32(1.0 / max(1, warmup_steps))),
               _F32(1)) * peak
    prog = _F32(_F32(s + _F32(-warmup_steps))
                * _F32(1.0 / max(1, total_steps - warmup_steps)))
    prog = min(_F32(1), max(_F32(0), prog))
    c = _cos(_F32(prog * _F32(math.pi)))
    cos = _fma(_F32(c + _F32(1)), _F32((1 - min_ratio) * 0.5),
               _F32(min_ratio))
    lr = warm if s < warmup_steps else _F32(cos * peak)
    return torch.tensor(lr, dtype=torch.float32)
