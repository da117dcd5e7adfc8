"""Fused cuConv: both stages in one CUDA kernel (``csrc/cuconv_fused.cu``).

``cuconv_fused`` computes ``act(sum over taps of X_shift(t) . W[t] + b +
addend)`` for NHWC x and HWIO w at any stride and padding, or a
non-overlapping max/avg pool of ``act(... + b)``, with fp32 accumulation
and one write in x.dtype — what the JAX package's Pallas kernel of the
same name computes.  The CUDA design (one block per image x ``rows``
output rows x ``tm`` output channels, the tap and channel loops inside
the block, masked reads of the unpadded input) is described in the
source; ``smem_bytes`` is its shared-memory model, used both by the
planner to prune launch configs and by the wrapper to size the launch.

``cuconv_fused_plain`` is the same function in plain PyTorch (per-tap
fp32 products summed in tap order, then the epilogue): the wrapper runs
it for CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

KC = 16          # (tap, channel) pairs per staged chunk (kKC in the source)
THREADS = 256


def sub_tile(tm: int) -> Tuple[int, int]:
    """``(MT, PT)``: the channel x pixel sub-tile a block walks its region
    in, as the kernel picks it from ``tm`` (4 x 4 outputs per thread)."""
    mt = 16 if tm <= 16 else 32 if tm <= 32 else 64
    return mt, 4 * (THREADS // (mt // 4))


def _geometry(x_shape, w_shape, stride, padding):
    _, H, W, _ = x_shape
    KH, KW, _, _ = w_shape
    OH = (H + 2 * padding[0] - KH) // stride[0] + 1
    OW = (W + 2 * padding[1] - KW) // stride[1] + 1
    return OH, OW


def smem_bytes(x_shape, w_shape, tm: int = 128, rows: int = 1,
               pad=(0, 0), stride=(1, 1), pool=None) -> int:
    """Bytes of shared memory the kernel stages under launch config
    ``(tm, rows)``: the fp32 input tile [KC][PT+1] and filter tile
    [KC][MT], plus, under a pool, the fp32 block of finished outputs
    [rows*OW][MT] that is pooled before the write."""
    OH, OW = _geometry(x_shape, w_shape, stride, pad)
    rows = max(1, min(int(rows), OH))
    mt, pt = sub_tile(min(int(tm), w_shape[3]))
    need = 4 * KC * (pt + 1) + 4 * KC * mt
    if pool is not None:
        need += 4 * rows * OW * mt
    return need


def cuconv_fused_plain(x, w, bias=None, stride=(1, 1), padding=(0, 0),
                       activation=None, addend=None, pool=None):
    """The kernel's function in plain PyTorch (fp32 throughout)."""
    N, H, W, C = x.shape
    KH, KW, _, M = w.shape
    sh, sw = stride
    OH, OW = _geometry(x.shape, w.shape, stride, padding)
    xp = F.pad(x.float(), (0, 0, padding[1], padding[1],
                           padding[0], padding[0]))
    wf = w.float()
    acc = None
    for di in range(KH):
        for dj in range(KW):
            view = xp[:, di:di + sh * (OH - 1) + 1:sh,
                      dj:dj + sw * (OW - 1) + 1:sw, :]
            part = view.reshape(-1, C) @ wf[di, dj]
            acc = part if acc is None else acc + part
    acc = acc.reshape(N, OH, OW, M)
    if bias is not None:
        acc = acc + bias.float()
    if addend is not None:
        acc = acc + addend.float()
    if activation == "relu":
        acc = torch.relu(acc)
    if pool is not None:
        kind, psh, psw = pool
        blocks = acc.reshape(N, OH // psh, psh, OW // psw, psw, M)
        if kind == "max":
            acc = blocks.amax(dim=(2, 4))
        else:
            acc = blocks.sum(dim=(2, 4)) / (psh * psw)
    return acc.to(x.dtype)


def cuconv_fused(x, w, bias=None, stride=(1, 1), padding=(0, 0),
                 activation: Optional[str] = None, addend=None, pool=None,
                 tm: int = 128, rows: int = 1):
    """x: (N, H, W, C) NHWC; w: (KH, KW, C, M) HWIO; stride (sh, sw) >= 1.

    bias: optional (M,); activation: None | 'relu'; addend: optional
    (N, OH, OW, M) residual added after the bias and before the
    activation; pool: optional ``(kind, psh, psw)`` non-overlapping
    max/avg pool (window == stride) of the finished block, exclusive
    with ``addend``, needing ``rows % psh == 0``, ``OH % rows == 0`` and
    ``OW % psw == 0``.  ``tm``/``rows`` are the launch config.  Returns
    (N, OH, OW, M), pooled to (N, OH/psh, OW/psw, M), in x.dtype.  CPU
    tensors run the plain version; CUDA tensors launch the kernel.
    """
    name = "cuconv_fused"
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
    if activation not in (None, "relu"):
        raise ValueError(f"{name}: activation must be None or 'relu'; "
                         f"got {activation!r}")
    rows = min(int(rows), OH)
    tm = min(int(tm), M)
    if rows < 1 or tm < 1:
        raise ValueError(f"{name}: rows and tm must be >= 1; got "
                         f"rows={rows}, tm={tm}")
    if bias is not None and tuple(bias.shape) != (M,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != {(M,)}")
    if addend is not None and tuple(addend.shape) != (N, OH, OW, M):
        raise ValueError(f"{name}: addend shape {tuple(addend.shape)} != "
                         f"conv output shape {(N, OH, OW, M)}")
    if pool is not None:
        if addend is not None:
            raise ValueError(f"{name}: pool and addend fusions are "
                             f"mutually exclusive")
        kind, psh, psw = pool
        if kind not in ("max", "avg"):
            raise ValueError(f"{name}: pool kind must be 'max' or 'avg'; "
                             f"got {pool!r}")
        if rows % psh or OH % rows or OW % psw:
            raise ValueError(
                f"{name}: fused pool needs rows % psh == 0, OH % rows == 0 "
                f"and OW % psw == 0; got rows={rows}, OH={OH}, OW={OW}, "
                f"pool={pool!r}")
    _build.check_operands(name, x.device, x.dtype, x=x, w=w, bias=bias,
                          addend=addend)
    smem = smem_bytes(x.shape, w.shape, tm, rows, padding, stride, pool)
    _build.check_smem(name, smem, f"config tm={tm}, rows={rows}")
    if not _build.on_card(name, x):
        return cuconv_fused_plain(x, w, bias, stride, padding, activation,
                                  addend, pool)
    lib = _build.library("cuconv_fused")
    if pool is None:
        out = torch.empty((N, OH, OW, M), dtype=x.dtype, device=x.device)
        pool_kind, psh, psw = 0, 1, 1
    else:
        kind, psh, psw = pool
        out = torch.empty((N, OH // psh, OW // psw, M), dtype=x.dtype,
                          device=x.device)
        pool_kind = 1 if kind == "max" else 2
    with torch.cuda.device(x.device):
        code = lib.cuconv_fused_launch(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if addend is None else addend.data_ptr(),
            out.data_ptr(), _build.DTYPE_CODES[str(x.dtype)[6:]],
            N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW, tm, rows,
            int(activation == "relu"), pool_kind, psh, psw, smem,
            _build.stream_of(x))
    _build.check("cuconv_fused", name, code)
    _build.LAUNCHES[name] += 1
    return out
