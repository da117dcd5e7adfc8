"""cuConv stage 2 (faithful): sum the KH*KW per-tap partial matrices.

``stage2_tap_sum`` reduces the (T, P, M) fp32 stage-1 temporaries over
T to (P, M) in ``out_dtype`` — what the JAX package's Pallas kernel of
the same name computes.  The CUDA kernel (``csrc/cuconv_stage2.cu``) is
a flat, bandwidth-bound grid-stride pass.  ``stage2_tap_sum_plain`` is
the same function in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def stage2_tap_sum_plain(temps, out_dtype=torch.float32):
    return temps.float().sum(dim=0).to(out_dtype)


def stage2_tap_sum(temps, out_dtype=torch.float32):
    """temps: (T, P, M) fp32 stage-1 partials -> (P, M) sums in
    ``out_dtype`` (float32 or bfloat16).  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    name = "stage2_tap_sum"
    if temps.dim() != 3 or min(temps.shape) < 1:
        raise ValueError(f"{name}: temps must be a non-empty (T, P, M); "
                         f"got {tuple(temps.shape)}")
    if temps.dtype != torch.float32:
        raise ValueError(f"{name}: temps must be float32 (stage-1 "
                         f"temporaries); got {temps.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16; "
                         f"got {out_dtype}")
    _build.check_operands(name, temps.device, temps.dtype, temps=temps)
    if not _build.on_card(name, temps):
        return stage2_tap_sum_plain(temps, out_dtype)
    T, P, M = temps.shape
    out = torch.empty((P, M), dtype=out_dtype, device=temps.device)
    lib = _build.library("cuconv_stage2")
    with torch.cuda.device(temps.device):
        code = lib.stage2_tap_sum_launch(
            temps.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(out_dtype)[6:]], T, P * M,
            _build.stream_of(temps))
    _build.check("cuconv_stage2", name, code)
    _build.LAUNCHES[name] += 1
    return out
