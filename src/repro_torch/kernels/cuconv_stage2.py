"""cuConv stage 2 (faithful): sum the KH*KW per-tap partial matrices.

``stage2_tap_sum`` reduces the (T, P, M) fp32 stage-1 temporaries over
T to (P, M) in ``out_dtype`` — what the JAX package's Pallas kernel of
the same name computes.  The CUDA kernel (``csrc/cuconv_stage2.cu``) is
bound by bytes and, at the main path's sizes, by the latency of one
round of loads: each thread owns a quad of 4 outputs and a run of taps,
issues all its loads back to back (unrolled at the main path's 9 and 25
taps, a loop at any other T), and the block's thread rows add their
partials in one fixed order.  ``launch_geometry`` is the launch.
``stage2_tap_sum_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

SMS = 132            # the H100's streaming multiprocessors
MAX_THREADS = 1024   # threads a block may have


def launch_geometry(T: int, P: int, M: int) -> dict:
    """What the wrapper launches for a (T, P, M) sum: the output cut
    into ``quads`` of 4 elements, ``cols`` quads a block (blockDim.x),
    ``rows`` = ceil(sqrt(T)) thread rows a block (blockDim.y), each
    summing a run of ``taps_per_thread`` taps, ``blocks`` in all and the
    ``smem`` the rows' partials take.  ``cols`` is the widest of 32, 16,
    ..., 1 that still gives one wave of SMS blocks (or 1 where the
    quads are fewer than SMS)."""
    PM = P * M
    quads = -(-PM // 4)
    rows = math.isqrt(T - 1) + 1 if T > 1 else 1
    if rows > MAX_THREADS:
        raise ValueError(f"stage2_tap_sum: {T} taps need {rows} thread "
                         f"rows > {MAX_THREADS}")
    cols = 1
    for c in (32, 16, 8, 4, 2):
        if c * rows <= MAX_THREADS and -(-quads // c) >= SMS:
            cols = c
            break
    return {"quads": quads, "cols": cols, "rows": rows,
            "taps_per_thread": -(-T // rows), "threads": cols * rows,
            "blocks": -(-quads // cols),
            "smem": rows * cols * 16 if rows > 1 else 0}


def stage2_tap_sum_plain(temps, out_dtype=torch.float32):
    return temps.float().sum(dim=0).to(out_dtype)


def empty_launch(device) -> None:
    """Launch an empty kernel (one block of 32 threads) from the stage-2
    library on ``device``'s current stream: the floor under any launch,
    which chip_smoke times beside the kernels.  Counts no launch."""
    device = torch.device(device)
    lib = _build.library("cuconv_stage2")
    with torch.cuda.device(device):
        code = lib.empty_launch(torch.cuda.current_stream(device).cuda_stream)
    _build.check("cuconv_stage2", "empty_launch", code)


def stage2_tap_sum(temps, out_dtype=torch.float32, *, unroll=True):
    """temps: (T, P, M) fp32 stage-1 partials -> (P, M) sums in
    ``out_dtype`` (float32 or bfloat16).  CPU tensors run the plain
    version; CUDA tensors launch the kernel.  ``unroll=False`` takes the
    kernel's runtime-T loop at 9 and 25 taps too, where it would run the
    unrolled body (the same bits; chip_smoke times the two)."""
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
    T, P, M = temps.shape
    geo = launch_geometry(T, P, M)
    if not _build.on_card(name, temps):
        return stage2_tap_sum_plain(temps, out_dtype)
    _build.refuse_grad(name, temps)
    PM = P * M
    out = torch.empty((P, M), dtype=out_dtype, device=temps.device)
    vec_in = PM % 4 == 0 and temps.data_ptr() % 16 == 0
    vec_out = PM % 4 == 0 and out.data_ptr() % (4 * out.element_size()) == 0
    lib = _build.library("cuconv_stage2")
    with torch.cuda.device(temps.device):
        code = lib.stage2_tap_sum_launch(
            temps.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(out_dtype)[6:]], T, PM, geo["cols"],
            geo["rows"], geo["blocks"], int(vec_in), int(vec_out),
            int(unroll), _build.stream_of(temps))
    _build.check("cuconv_stage2", name, code)
    _build.LAUNCHES[name] += 1
    return out
