"""Int8 x int8 -> int32 GEMM — the quantized inference path's kernel
(``csrc/int8_gemm.cu``).

``int8_gemm`` returns the raw (P, M) int32 accumulator of
(P, K) int8 @ (K, M) int8, what the JAX package's Pallas kernel of the
same name computes; dequantization is the ``cuconv_int8`` executor's
epilogue.  The CUDA kernel packs four int8 values per 32-bit word and
sums them with ``__dp4a``; ``(tp, tm, tc)`` are its launch config (the
block's pixel x channel tile and the contraction depth staged per
step), and ``smem_bytes`` is what a block stages.

``int8_gemm_plain`` is the same function in plain PyTorch.  PyTorch has
no integer matmul on the card, so it multiplies in float64: every
product of two int8 codes and every partial sum of K of them is an
integer of magnitude below K * 127^2, far under 2^53, so float64
represents each one exactly whatever the summation order, and the
result equals the int32 accumulator bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._compat import clamp_tiles

SUB = 64          # the kernel's sub-tile edge (pixels and channels)


def smem_bytes(tc: int) -> int:
    """Shared memory of one block: ``ceil(tc/4)`` packed words per row of
    the (64 x tc) x slice, stored transposed with one pad column, and of
    the (tc x 64) w slice."""
    return 4 * (-(-int(tc) // 4)) * (2 * SUB + 1)


def int8_gemm_plain(x2d, w):
    """Exact int32 accumulator through float64 (see the module doc)."""
    return (x2d.double() @ w.double()).to(torch.int32)


def int8_gemm(x2d, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """x2d: (P, K) int8 pixels-major; w: (K, M) int8.  Returns (P, M)
    int32, the undequantized accumulator.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    name = "int8_gemm"
    if x2d.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x2d must be (P, K) and w (K, M); got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    P, K = x2d.shape
    Kw, M = w.shape
    if Kw != K or min(P, K, M) < 1:
        raise ValueError(f"{name}: shapes {tuple(x2d.shape)} and "
                         f"{tuple(w.shape)} do not contract")
    for arg, t in (("x2d", x2d), ("w", w)):
        if t.dtype != torch.int8:
            raise ValueError(f"{name}: {arg} must be int8; got {t.dtype}")
        if t.device != x2d.device:
            raise ValueError(f"{name}: {arg} is on {t.device} but x2d is "
                             f"on {x2d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    (tp, tm, tc), _ = clamp_tiles((P, M, K), (tp, tm, tc))
    smem = smem_bytes(tc)
    _build.check_smem(name, smem, f"config tp={tp}, tm={tm}, tc={tc}")
    if not _build.on_card(name, x2d):
        return int8_gemm_plain(x2d, w)
    out = torch.empty((P, M), dtype=torch.int32, device=x2d.device)
    lib = _build.library("int8_gemm")
    with torch.cuda.device(x2d.device):
        code = lib.int8_gemm_launch(
            x2d.data_ptr(), w.data_ptr(), out.data_ptr(), P, K, M, tp, tm,
            tc, smem, _build.stream_of(x2d))
    _build.check("int8_gemm", name, code)
    _build.LAUNCHES[name] += 1
    return out
