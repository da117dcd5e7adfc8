"""Winograd F(m, 3) convolution — the paper's strongest competitor.

Lavin & Gray 2015 minimal filtering: each (m+2)x(m+2) input tile
(m x m output, overlap 2) is transformed with B^T d B, filters once
with G g G^T, the elementwise products accumulate over channels, and
A^T m A produces the m x m output tile.  F(2x2,3x3) saves 2.25x
multiplies over direct conv, F(4x4,3x3) saves 4x, at the price of the
transforms.  F(4x4,3x3)'s larger constants make its numeric error
measurably bigger; ``tests/test_torch_winograd.py`` pins both bounds.

This module owns the port's copy of the transform matrices — the JAX
package's constants, kept here so the port imports nothing of it.
``matrices(m)`` is the one home the plain path below and the
``winograd`` executor read them from; the CUDA kernel spells the same
matrices out in ``csrc/winograd_fused.cu`` and forms G g G^T itself.

Plain PyTorch (stride 1, 3x3 filters): the Winograd domain is computed
in fp32 whatever the operand dtype, as (m+2)^2 per-position
(tiles x C) @ (C x M) products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.convspec import normalize_pad

# F(2x2, 3x3) transform matrices (Lavin & Gray / Winograd 1980)
_BT = ((1, 0, -1, 0),
       (0, 1, 1, 0),
       (0, -1, 1, 0),
       (0, 1, 0, -1))
_G = ((1, 0, 0),
      (0.5, 0.5, 0.5),
      (0.5, -0.5, 0.5),
      (0, 0, 1))
_AT = ((1, 1, 1, 0),
       (0, 1, -1, -1))

# F(4x4, 3x3) transform matrices (points {0, ±1, ±2})
_BT4 = ((4, 0, -5, 0, 1, 0),
        (0, -4, -4, 1, 1, 0),
        (0, 4, -4, -1, 1, 0),
        (0, -2, -1, 2, 1, 0),
        (0, 2, -1, -2, 1, 0),
        (0, 4, 0, -5, 0, 1))
_G4 = ((1 / 4, 0, 0),
       (-1 / 6, -1 / 6, -1 / 6),
       (-1 / 6, 1 / 6, -1 / 6),
       (1 / 24, 1 / 12, 1 / 6),
       (1 / 24, -1 / 12, 1 / 6),
       (0, 0, 1))
_AT4 = ((1, 1, 1, 1, 1, 0),
        (0, 1, -1, 2, -2, 0),
        (0, 1, 1, 4, 4, 0),
        (0, 1, -1, 8, -8, 1))


def _f32(rows):
    return torch.tensor(rows, dtype=torch.float32)


#: F(m, 3) variant -> (B^T, G, A^T) as fp32 CPU tensors
MATRICES = {2: (_f32(_BT), _f32(_G), _f32(_AT)),
            4: (_f32(_BT4), _f32(_G4), _f32(_AT4))}

# (m, device) -> the matrices on that device, copied there once: a copy
# per call would cost a host-to-device transfer on every Winograd conv
# (and cannot be captured in a CUDA graph)
_ON_DEVICE = {}


def matrices(m: int, device=None):
    """``(B^T, G, A^T)`` for the F(m x m, 3 x 3) variant; m in {2, 4}."""
    try:
        mats = MATRICES[m]
    except KeyError:
        raise ValueError(f"Winograd F(m,3) variant must be one of "
                         f"{sorted(MATRICES)}; got m={m}") from None
    if device is None:
        return mats
    key = (m, torch.device(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = tuple(t.to(device) for t in mats)
    return _ON_DEVICE[key]


def transform_filters(w, m: int = 2):
    """w: (3, 3, C, M) -> (m+2, m+2, C, M) fp32: U = G g G^T per (C, M)."""
    G = matrices(m, w.device)[1]
    # two batched matmuls over (C, M), not a three-operand einsum, which
    # plans its contraction on every call
    return (G @ w.float().permute(2, 3, 0, 1) @ G.T).permute(2, 3, 0, 1)


def winograd_f32(x, w, padding, m: int = 2):
    """The fp32 F(m, 3) convolution of NHWC x by 3x3 HWIO w, stride 1,
    ``padding`` a (ph, pw) pair: (N, OH, OW, M) in fp32."""
    if w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError(f"F(m,3) needs 3x3 filters; got {tuple(w.shape)}")
    BT, _, AT = matrices(m, x.device)
    a = m + 2
    N, H, W, C = x.shape
    M = w.shape[3]
    ph, pw = padding
    OH, OW = H + 2 * ph - 2, W + 2 * pw - 2
    # pad so output tiles of m x m cover OH x OW exactly
    th, tw = -(-OH // m), -(-OW // m)
    Hp, Wp = m * th + 2, m * tw + 2
    xp = F.pad(x.float(), (0, 0, pw, Wp - W - pw, ph, Hp - H - ph))
    # overlapping a x a tiles with stride m: (N, th, tw, C, a, a)
    tiles = xp.unfold(1, a, m).unfold(2, a, m)
    V = torch.einsum("pi,nhwcij,qj->pqnhwc", BT, tiles, BT)
    U = transform_filters(w, m)                     # (a, a, C, M)
    # elementwise product in the Winograd domain == a*a channel GEMMs
    Md = torch.bmm(V.reshape(a * a, N * th * tw, C),
                   U.reshape(a * a, C, M)).reshape(a, a, N, th, tw, M)
    Y = torch.einsum("up,pqnhwm,vq->nhuwvm", AT, Md, AT)
    return Y.reshape(N, m * th, m * tw, M)[:, :OH, :OW, :]


def conv_winograd(x, w, stride=1, padding="same", m: int = 2):
    """x: (N, H, W, C) NHWC; w: (3, 3, C, M); stride must be 1.
    Returns (N, OH, OW, M) in x.dtype."""
    if w.shape[0] != 3 or w.shape[1] != 3:
        raise ValueError("F(m,3) needs 3x3 filters")
    if stride not in (1, (1, 1)):
        raise ValueError("the Winograd baseline is stride-1 (as in the "
                         "paper)")
    return winograd_f32(x, w, normalize_pad(padding, 3, 3), m).to(x.dtype)
