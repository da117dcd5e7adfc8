"""Im2col-free direct convolution in one CUDA kernel
(``csrc/direct_conv.cu``).

``direct_conv`` computes the bare convolution of NHWC x by HWIO w at any
stride and padding — no epilogue, C accumulated in fp32, one write in
x.dtype — what the JAX package's Pallas kernel of the same name
computes.  The TPU kernel stages a whole padded image per channel slice;
the CUDA kernel also tiles space (one block per output-pixel tile x
``tm`` channels x image) and stages each tile's input halo, read with
masks from the unpadded input.  ``smem_bytes`` is its shared-memory
model, used both by the planner to prune configs and by the wrapper to
size the launch.

``direct_conv_plain`` is the same function in plain PyTorch (the fused
kernel's plain version without an epilogue: per-tap fp32 products
summed): the wrapper runs it for CPU tensors, and ``chip_smoke.py``
holds the kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cuconv_fused import _geometry, cuconv_fused_plain

KC = 8           # input channels staged per chunk (kKC in the source)
THREADS = 256


def tile(tm: int):
    """``(MT, THD, TWD)``: the channel sub-tile and the output-pixel tile
    (rows x columns) a block covers, as the kernel picks them from
    ``tm`` (4 x 4 outputs per thread)."""
    mt = 16 if tm <= 16 else 32 if tm <= 32 else 64
    pix = 4 * (THREADS // (mt // 4))
    twd = 16 if pix >= 128 else 8
    return mt, pix // twd, twd


def smem_bytes(w_shape, tm: int = 128, stride=(1, 1)) -> int:
    """Bytes of shared memory the kernel stages: the fp32 input halo of
    one pixel tile [KC][IH_T][IW_T] and the filter slice [KH*KW][KC][MT]."""
    KH, KW = w_shape[0], w_shape[1]
    mt, thd, twd = tile(min(int(tm), w_shape[3]))
    iht = (thd - 1) * stride[0] + KH
    iwt = (twd - 1) * stride[1] + KW
    return 4 * KC * (iht * iwt + KH * KW * mt)


def direct_conv_plain(x, w, padding=(0, 0), stride=(1, 1)):
    """The kernel's function in plain PyTorch (fp32 throughout)."""
    return cuconv_fused_plain(x, w, stride=stride, padding=padding)


def direct_conv(x, w, padding=(0, 0), stride=(1, 1), tm: int = 128,
                tc: int = 256):
    """x: (N, H, W, C) NHWC; w: (KH, KW, C, M) HWIO; any stride >= 1.

    Bare conv (no epilogue: the direct executor applies bias, activation
    and fusions after it).  ``tm`` is the block's output-channel tile;
    ``tc`` is the reference's channel slice, accepted for its launch
    configs (the kernel runs all of C inside a block).  Returns
    (N, OH, OW, M) in x.dtype.  CPU tensors run the plain version; CUDA
    tensors launch the kernel.
    """
    name = "direct_conv"
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC and w HWIO; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    KH, KW, Cw, M = w.shape
    if Cw != C:
        raise ValueError(f"{name}: filter depth {Cw} != input channels {C}")
    sh, sw = stride
    ph, pw = padding
    if min(sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"{name}: bad stride {stride} / padding {padding}")
    OH, OW = _geometry(x.shape, w.shape, stride, padding)
    if OH < 1 or OW < 1:
        raise ValueError(f"{name}: empty output {(OH, OW)}")
    if min(tm, tc) < 1:
        raise ValueError(f"{name}: tm and tc must be >= 1; got tm={tm}, "
                         f"tc={tc}")
    tm = min(int(tm), M)
    _build.check_operands(name, x.device, x.dtype, x=x, w=w)
    smem = smem_bytes(w.shape, tm, stride)
    _build.check_smem(name, smem, f"config tm={tm}, filter {KH}x{KW}")
    if not _build.on_card(name, x):
        return direct_conv_plain(x, w, padding, stride)
    out = torch.empty((N, OH, OW, M), dtype=x.dtype, device=x.device)
    lib = _build.library("direct_conv")
    with torch.cuda.device(x.device):
        code = lib.direct_conv_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(x.dtype)[6:]], N, H, W, C, KH, KW, M,
            sh, sw, ph, pw, OH, OW, tm, smem, _build.stream_of(x))
    _build.check("direct_conv", name, code)
    _build.LAUNCHES[name] += 1
    return out
