"""Causal depthwise conv1d, the Mamba2 block's stream conv
(``csrc/conv1d_tap.cu``).

``conv1d_tap(x, w, b)`` computes y[b, l, d] = Σ_k x[b, l-K+1+k, d] ·
w[k, d] + b[d] in fp32 and writes x.dtype: what the JAX package's
``nn/mamba.py::causal_conv1d`` computes, and what its Pallas kernel
``kernels/conv1d_tap.py::conv1d_tap`` computes up to where the bias is
added (the TPU wrapper adds it after its cast to x.dtype, so in bf16 the
two can differ by one rounding).

The CUDA kernel reads the unpadded (B, L, D) input with masks: no
(K, B·L, D) stack of shifted views is built.  Each thread walks a run of
positions of one channel with a K-wide window in registers; it is bound
by bytes (x read once, y written once) and stages nothing in shared
memory.  ``conv1d_tap_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_TAPS = 8      # the kernel is instantiated for K = 1..8
THREADS = 128     # channels per block (csrc/conv1d_tap.cu kC1dThreads)
RUN = 32          # positions of l per thread (kC1dRun)


def launch_geometry(B: int, L: int, D: int) -> dict:
    """The kernel's launch for a (B, L, D) stream: a thread per channel
    and run of RUN positions, grid (ceil(D/THREADS), ceil(L/RUN), B)."""
    grid = (-(-D // THREADS), -(-L // RUN), B)
    return {"grid": grid, "threads": THREADS,
            "blocks": grid[0] * grid[1] * grid[2]}


def conv1d_tap_plain(x, w, b=None):
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    y = torch.zeros_like(x, dtype=torch.float32)    # a DTensor's too
    for k in range(K):
        y = y + xp[:, k:k + L, :] * w[k].float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def flops(x_shape, w_shape) -> int:
    """The kernel's work, as its bound counts it: K multiply-adds an
    output element."""
    return 2 * w_shape[0] * x_shape[0] * x_shape[1] * x_shape[2]


@torch.library.custom_op("repro_torch::conv1d_tap", mutates_args=())
def _kernel(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor]) -> torch.Tensor:
    """The launch on the card (validated by ``conv1d_tap``)."""
    name = "conv1d_tap"
    B, L, D = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.library("conv1d_tap")
    with torch.cuda.device(x.device):
        code = lib.conv1d_tap_launch(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), _build.DTYPE_CODES[str(x.dtype)[6:]], B, L, D,
            w.shape[0], _build.stream_of(x))
    _build.check("conv1d_tap", name, code)
    _build.LAUNCHES[name] += 1
    return y


@_kernel.register_fake
def _(x, w, b):
    return torch.empty_like(x)


_build.flop_formula(_kernel, lambda x, w, b, *_: flops(x, w))


def conv1d_tap(x, w, b=None):
    """x: (B, L, D); w: (K, D); b: (D,) or None, all of x's dtype.
    Returns (B, L, D) in x.dtype.  CPU tensors run the plain version;
    CUDA tensors launch the kernel; meta tensors give the output's shape
    and dtype and launch nothing (the op ``repro_torch::conv1d_tap``,
    whose FLOPs are ``flops``, on the card and on meta)."""
    name = "conv1d_tap"
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"{name}: x must be (B, L, D) and w (K, D); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    K = w.shape[0]
    if not 1 <= K <= MAX_TAPS:
        raise ValueError(f"{name}: {K} taps; the kernel takes 1..{MAX_TAPS}")
    if b is not None and tuple(b.shape) != (x.shape[2],):
        raise ValueError(f"{name}: bias must be ({x.shape[2]},); got "
                         f"{tuple(b.shape)}")
    _build.check_operands(name, x.device, x.dtype, x=x, w=w, b=b)
    # meta: the op's shape function (no launch)
    if x.device.type != "meta" and not _build.on_card(name, x):
        return conv1d_tap_plain(x, w, b)
    _build.refuse_grad(name, x, w, b)
    return _kernel(x, w, b)
