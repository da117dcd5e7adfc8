"""cuConv stage 1 (faithful): per-tap channel contraction.

``stage1_tap_gemm`` takes the (T, P, C) stacked shifted views and the
(T, C, M) filter taps and returns the (T, P, M) fp32 temporaries,
written to device memory on purpose — what the JAX package's Pallas
kernel of the same name computes.  The CUDA kernel
(``csrc/cuconv_stage1.cu``) is the tile GEMM of ``csrc/tile_gemm.cuh``
batched over T, with the same ``(tp, tm, tc)`` launch config and
shared-memory model as ``conv1x1_gemm``.  ``stage1_tap_gemm_plain`` is
the same function in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1x1 import gemm_checks


def stage1_tap_gemm_plain(xs, w):
    return torch.bmm(xs.float(), w.float())


def stage1_tap_gemm(xs, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """xs: (T, P, C) stacked shifted views; w: (T, C, M) filter taps.
    Returns the stage-1 temporaries (T, P, M) in fp32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    name = "stage1_tap_gemm"
    if xs.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: xs must be (T, P, C) and w (T, C, M); "
                         f"got {tuple(xs.shape)} and {tuple(w.shape)}")
    (tp, tm, tc), smem = gemm_checks(name, xs, w, tp, tm, tc)
    if not _build.on_card(name, xs):
        return stage1_tap_gemm_plain(xs, w)
    T, P, C = xs.shape
    M = w.shape[2]
    out = torch.empty((T, P, M), dtype=torch.float32, device=xs.device)
    lib = _build.library("cuconv_stage1")
    with torch.cuda.device(xs.device):
        code = lib.stage1_tap_gemm_launch(
            xs.data_ptr(), w.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(xs.dtype)[6:]], T, P, C, M, tp, tm, tc,
            smem, _build.stream_of(xs))
    _build.check("cuconv_stage1", name, code)
    _build.LAUNCHES[name] += 1
    return out
