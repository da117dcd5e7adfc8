"""1x1 convolution as one GEMM — the paper's best-case region.

``conv1x1_gemm`` computes (P, C) @ (C, M) with fp32 accumulation and
writes x2d.dtype, what the JAX package's Pallas kernel of the same name
computes, in the CUDA tile GEMM of ``csrc/tile_gemm.cuh``
(``csrc/conv1x1.cu``).  ``(tp, tm, tc)`` are its launch config: the
block's pixel x channel output tile and the contraction depth staged
per step; ``smem_bytes`` is what a block stages, used both by the
planner to prune configs and by the wrapper to size the launch.
``conv1x1_gemm_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._compat import clamp_tiles

SUB = 64          # the kernel's sub-tile edge (pixels and channels)


def smem_bytes(tc: int) -> int:
    """Shared memory of the tile GEMM: the fp32 (64 x tc) input slice,
    stored transposed with one pad column, and the (tc x 64) filter
    slice."""
    return 4 * int(tc) * (2 * SUB + 1)


def conv1x1_gemm_plain(x2d, w):
    return (x2d.float() @ w.float()).to(x2d.dtype)


def gemm_checks(name: str, a, b, tp: int, tm: int, tc: int):
    """Shared validation of the tile-GEMM wrappers: a (..., P, C),
    b (..., C, M); returns the clamped ``(tp, tm, tc)`` and the shared
    memory the launch stages."""
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    P, C = a.shape[-2:]
    M = b.shape[-1]
    if min(P, C, M) < 1:
        raise ValueError(f"{name}: empty operand {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    (tp, tm, tc), _ = clamp_tiles((P, M, C), (tp, tm, tc))
    _build.check_operands(name, a.device, a.dtype, a=a, b=b)
    smem = smem_bytes(tc)
    _build.check_smem(name, smem, f"config tp={tp}, tm={tm}, tc={tc}")
    return (tp, tm, tc), smem


def conv1x1_gemm(x2d, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """x2d: (P, C) pixels-major; w: (C, M).  Returns (P, M) in x2d.dtype.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    name = "conv1x1_gemm"
    if x2d.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x2d must be (P, C) and w (C, M); got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    (tp, tm, tc), smem = gemm_checks(name, x2d, w, tp, tm, tc)
    if not _build.on_card(name, x2d):
        return conv1x1_gemm_plain(x2d, w)
    P, C = x2d.shape
    M = w.shape[1]
    out = torch.empty((P, M), dtype=x2d.dtype, device=x2d.device)
    lib = _build.library("conv1x1")
    with torch.cuda.device(x2d.device):
        code = lib.conv1x1_gemm_launch(
            x2d.data_ptr(), w.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(x2d.dtype)[6:]], P, C, M, tp, tm, tc,
            smem, _build.stream_of(x2d))
    _build.check("conv1x1", name, code)
    _build.LAUNCHES[name] += 1
    return out
