"""Fused Winograd F(m, 3) convolution in one CUDA kernel
(``csrc/winograd_fused.cu``).

``winograd_fused`` computes a 3x3 stride-1 convolution of NHWC x by
HWIO w through F(m x m, 3 x 3), m in {2, 4}: B^T d B, the (m+2)^2
per-position channel products accumulated over C in fp32 on the tensor
cores (3xTF32 ``mma.sync``), A^T m A, then the fused bias / residual
addend / ReLU epilogue and one write in x.dtype — what the JAX
package's Pallas kernel of the same name computes.  The kernel forms
U = G g G^T itself from the HWIO filter and reads the unpadded input and
the NHWC addend with masks, so nothing is transformed or gathered in
PyTorch.  ``launch_geometry`` is the block shape the kernel takes and
its shared memory, used both by the planner and by the wrapper to size
the launch.

``winograd_fused_plain`` is the same function in plain PyTorch
(``core/winograd.py``'s fp32 path, then the epilogue): the wrapper runs
it for CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.winograd import winograd_f32
from repro_torch.kernels import _build

KC = 8           # channels per chunk, one mma k-step (kKC)
VARIANTS = (2, 4)
# (m, channel tile) -> tiles per block: 4 warps, each 16 tiles x 8*J
# channels, J = 2 at m=2 and 1 at m=4 (launch_wino_variant)
_TILES = {(2, 32): 32, (2, 16): 64, (4, 32): 16, (4, 16): 32}


def launch_geometry(m: int, tiles: int, M: int, tm: int = 128,
                    itemsize: int = 4) -> dict:
    """The block the kernel launches for ``tiles`` output tiles of F(m,3)
    and M output channels: ``bt`` tiles x ``bn`` channels (16 channels
    where ``tm`` or M is 16 or less, else 32), ``blocks`` in all, and
    the ``smem`` one block stages: a 2-stage ring of raw input patches
    [bt][R*8 + 8] and filter slices [9][8][bn] in x's dtype, and the
    transformed V [R][bt][8] and U [R][8][bn] in fp32, R = (m+2)^2."""
    if m not in VARIANTS:
        raise ValueError(f"F(m,3) variant must be one of {VARIANTS}; "
                         f"got m={m}")
    bn = 16 if min(int(tm), int(M)) <= 16 else 32
    bt = _TILES[(m, bn)]
    r = (m + 2) ** 2
    smem = (2 * (bt * (r * KC + 8) + 9 * KC * bn) * itemsize
            + (r * bt * KC + r * KC * bn) * 4)
    return {"bt": bt, "bn": bn, "blocks": -(-tiles // bt) * -(-M // bn),
            "smem": smem}


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
    activation.  ``m`` is the F(m, 3) variant; ``tm`` caps the channel
    tile (16 or 32, ``launch_geometry``); ``tt`` and ``tc`` are the
    reference's tiles, checked and kept for its launch configs, and size
    nothing here.  Returns (N, OH, OW, M) in x.dtype.  CPU tensors run
    the plain version; CUDA tensors launch the kernel.
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
    geo = launch_geometry(m, P, M, tm, x.element_size())
    _build.check_smem(name, geo["smem"], f"block {geo['bt']}x{geo['bn']}")
    if not _build.on_card(name, x):
        return winograd_fused_plain(x, w, padding, bias, activation, addend,
                                    m)
    _build.refuse_grad(name, x, w, bias, addend)
    v = 16 // x.element_size()
    vec = (C % v == 0 and M % v == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    out = torch.empty((N, OH, OW, M), dtype=x.dtype, device=x.device)
    lib = _build.library("winograd_fused")
    with torch.cuda.device(x.device):
        code = lib.winograd_fused_launch(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if addend is None else addend.data_ptr(),
            out.data_ptr(), _build.DTYPE_CODES[str(x.dtype)[6:]],
            N, H, W, C, M, ph, pw, OH, OW, m, geo["bn"], int(vec),
            int(activation == "relu"), geo["smem"], _build.stream_of(x))
    _build.check("winograd_fused", name, code)
    _build.LAUNCHES[name] += 1
    return out
