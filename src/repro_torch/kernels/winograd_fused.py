"""Fused Winograd F(m, 3) convolution in one CUDA kernel
(``csrc/winograd_fused.cu``).

``winograd_fused`` computes a 3x3 stride-1 convolution of NHWC x by
HWIO w through F(m x m, 3 x 3), m in {2, 4}: B^T d B, the (m+2)^2
per-position channel products accumulated over C in fp32, A^T m A, then
the fused bias / residual addend / ReLU epilogue and one write in
x.dtype — what the JAX package's Pallas kernel of the same name
computes.  U = G g G^T is computed once per call in fp32 here and handed
to the kernel; the kernel reads the unpadded input and the NHWC addend
itself, with masks, so no tile gather happens in PyTorch.  The CUDA
design is described in the source; ``smem_bytes`` is its shared-memory
model, used both by the planner and by the wrapper to size the launch.

``winograd_fused_plain`` is the same function in plain PyTorch
(``core/winograd.py``'s fp32 path, then the epilogue): the wrapper runs
it for CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.winograd import transform_filters, winograd_f32
from repro_torch.kernels import _build

KC = 8           # channels transformed and staged per chunk (kKC)
THREADS = 256
VARIANTS = (2, 4)


def sub_tile(m: int, tm: int):
    """``(ST, MT)``: the tiles x output channels a block walks its region
    in, as the kernel picks them from ``m`` and ``tm`` (each thread holds
    2 channels of 2 tiles at m=2, of 1 tile at m=4)."""
    mt = 16 if tm <= 16 else 32
    ty = THREADS // (mt // 2)
    return ty * (2 if m == 2 else 1), mt


def smem_bytes(m: int = 2, tm: int = 128) -> int:
    """Bytes of shared memory the kernel stages: the transformed input
    chunk [R][KC][ST] and U's slice [R][KC][MT], fp32, R = (m+2)^2."""
    st, mt = sub_tile(m, tm)
    return 4 * (m + 2) ** 2 * KC * (st + mt)


def winograd_fused_plain(x, w, padding=(1, 1), bias=None, activation=None,
                         addend=None, m: int = 2):
    """The kernel's function in plain PyTorch (fp32 throughout)."""
    y = winograd_f32(x, w, tuple(padding), m)
    if bias is not None:
        y = y + bias.float()
    if addend is not None:
        y = y + addend.float()
    if activation == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def winograd_fused(x, w, padding=(1, 1), bias=None,
                   activation: Optional[str] = None, addend=None, m: int = 2,
                   tt: int = 128, tm: int = 128, tc: int = 128):
    """x: (N, H, W, C) NHWC; w: (3, 3, C, M) HWIO; stride 1.

    bias: optional (M,); activation: None | 'relu'; addend: optional
    (N, OH, OW, M) residual added after the bias and before the
    activation.  ``m`` is the F(m, 3) variant; ``tt``/``tm`` are the
    block's tiles x output channels; ``tc`` is the reference's
    contraction tile, accepted for its launch configs (the kernel runs
    all of C inside a block).  Returns (N, OH, OW, M) in x.dtype.  CPU
    tensors run the plain version; CUDA tensors launch the kernel.
    """
    name = "winograd_fused"
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC and w HWIO; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    KH, KW, Cw, M = w.shape
    if (KH, KW) != (3, 3):
        raise ValueError(f"{name}: F(m,3) needs 3x3 filters; got "
                         f"{(KH, KW)}")
    if Cw != C:
        raise ValueError(f"{name}: filter depth {Cw} != input channels {C}")
    if m not in VARIANTS:
        raise ValueError(f"{name}: F(m,3) variant must be one of "
                         f"{VARIANTS}; got m={m}")
    ph, pw = padding
    if min(ph, pw) < 0:
        raise ValueError(f"{name}: bad padding {padding}")
    OH, OW = H + 2 * ph - 2, W + 2 * pw - 2
    if OH < 1 or OW < 1:
        raise ValueError(f"{name}: empty output {(OH, OW)}")
    if activation not in (None, "relu"):
        raise ValueError(f"{name}: activation must be None or 'relu'; "
                         f"got {activation!r}")
    if min(tt, tm, tc) < 1:
        raise ValueError(f"{name}: tt, tm and tc must be >= 1; got "
                         f"tt={tt}, tm={tm}, tc={tc}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != {(M,)}")
    if addend is not None and tuple(addend.shape) != (N, OH, OW, M):
        raise ValueError(f"{name}: addend shape {tuple(addend.shape)} != "
                         f"conv output shape {(N, OH, OW, M)}")
    _build.check_operands(name, x.device, x.dtype, x=x, w=w, bias=bias,
                          addend=addend)
    P = N * -(-OH // m) * -(-OW // m)
    tt, tm = min(int(tt), P), min(int(tm), M)
    smem = smem_bytes(m, tm)
    _build.check_smem(name, smem, f"config m={m}, tm={tm}")
    if not _build.on_card(name, x):
        return winograd_fused_plain(x, w, padding, bias, activation, addend,
                                    m)
    U = transform_filters(w, m).reshape((m + 2) ** 2, C, M).contiguous()
    out = torch.empty((N, OH, OW, M), dtype=x.dtype, device=x.device)
    lib = _build.library("winograd_fused")
    with torch.cuda.device(x.device):
        code = lib.winograd_fused_launch(
            x.data_ptr(), U.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if addend is None else addend.data_ptr(),
            out.data_ptr(), _build.DTYPE_CODES[str(x.dtype)[6:]],
            N, H, W, C, M, ph, pw, OH, OW, m, tt, tm,
            int(activation == "relu"), smem, _build.stream_of(x))
    _build.check("winograd_fused", name, code)
    _build.LAUNCHES[name] += 1
    return out
