"""1x1 convolution as one GEMM — the paper's best-case region.

``conv1x1_gemm`` computes (P, C) @ (C, M) with fp32 accumulation and
writes x2d.dtype, what the JAX package's Pallas kernel of the same name
computes, on the tensor cores (``csrc/conv1x1.cu``: 3xTF32 ``mma.sync``
in fp32, bf16 ``mma.sync`` in bf16, a cp.async ring in shared memory).
The kernel owns its block tile: ``launch_geometry`` picks it, and how
many blocks split the contraction, from the shape alone so the launch
fills the card's 132 SMs.  The reference's ``(tp, tm, tc)`` stay in the
signature, the plan and its cache key, so plans read like the
reference's, but on the card they size nothing.
``conv1x1_gemm_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SMS = 132        # the H100's streaming multiprocessors
BK = 32          # contraction depth of one pipeline stage (kBK)
BN = 64          # output channels per block (kBN)
STAGES = 3       # cp.async ring depth (kStages)


def smem_bytes(bm: int, itemsize: int = 4) -> int:
    """Shared memory of the ring: STAGES x (A tile bm x (BK + 16 bytes)
    + B tile BK x (BN + 8)), in the input dtype."""
    pad_a = 16 // itemsize
    return STAGES * (bm * (BK + pad_a) + BK * (BN + 8)) * itemsize


def launch_geometry(P: int, C: int, M: int, itemsize: int = 4) -> dict:
    """What the wrapper launches for a (P, C) @ (C, M) product: block
    tile ``bm`` x ``bn``, ``splits`` contraction splits over ``k_steps``
    steps of BK, ``tiles`` output tiles, ``blocks`` in all and the
    ``smem`` each block stages.  A 64-row tile, or 32 rows where even a
    full split of 64-row tiles stays under one wave; then splits of C
    until the blocks fill the SMs (or every step is its own split)."""
    k_steps = -(-C // BK)
    bm = 64
    if -(-P // 64) * -(-M // BN) * k_steps < SMS:
        bm = 32
    tiles = -(-P // bm) * -(-M // BN)
    splits = 1 if tiles >= SMS else min(k_steps, -(-SMS // tiles))
    return {"bm": bm, "bn": BN, "splits": splits, "k_steps": k_steps,
            "tiles": tiles, "blocks": tiles * splits,
            "smem": smem_bytes(bm, itemsize)}


def split_ranges(C: int, splits: int):
    """The ``[begin, end)`` channel range of each split, as the kernel
    cuts it: fixed runs of whole BK steps, the last ending at C."""
    k_steps = -(-C // BK)
    return [(z * k_steps // splits * BK,
             min((z + 1) * k_steps // splits * BK, C))
            for z in range(splits)]


def vectorized(x2d, w) -> bool:
    """Whether the ring fills by 16-byte cp.async (rows and base
    pointers 16-byte aligned) or by masked scalar loads."""
    v = 16 // x2d.element_size()
    return (x2d.shape[1] % v == 0 and w.shape[1] % v == 0
            and x2d.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def conv1x1_gemm_plain(x2d, w):
    return (x2d.float() @ w.float()).to(x2d.dtype)


def conv1x1_gemm(x2d, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """x2d: (P, C) pixels-major; w: (C, M).  Returns (P, M) in x2d.dtype.
    ``tp``/``tm``/``tc`` are the reference's tiles, checked and kept for
    its launch configs; the kernel's own geometry is
    ``launch_geometry``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    name = "conv1x1_gemm"
    if x2d.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x2d must be (P, C) and w (C, M); got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if x2d.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x2d.shape)} and "
                         f"{tuple(w.shape)} do not contract")
    P, C = x2d.shape
    M = w.shape[1]
    if min(P, C, M) < 1:
        raise ValueError(f"{name}: empty operand {tuple(x2d.shape)} x "
                         f"{tuple(w.shape)}")
    if min(tp, tm, tc) < 1:
        raise ValueError(f"{name}: tile sizes must be >= 1; got "
                         f"{(tp, tm, tc)}")
    _build.check_operands(name, x2d.device, x2d.dtype, x2d=x2d, w=w)
    geo = launch_geometry(P, C, M, x2d.element_size())
    _build.check_smem(name, geo["smem"], f"block tile {geo['bm']}x{BN}")
    if not _build.on_card(name, x2d):
        return conv1x1_gemm_plain(x2d, w)
    _build.refuse_grad(name, x2d, w)
    out = torch.empty((P, M), dtype=x2d.dtype, device=x2d.device)
    ws = counters = None
    if geo["splits"] > 1:
        ws = torch.empty((geo["splits"], P, M), dtype=torch.float32,
                         device=x2d.device)
        counters = torch.zeros(geo["tiles"], dtype=torch.int32,
                               device=x2d.device)
    lib = _build.library("conv1x1")
    with torch.cuda.device(x2d.device):
        code = lib.conv1x1_gemm_launch(
            x2d.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _build.DTYPE_CODES[str(x2d.dtype)[6:]], P, C, M, geo["bm"],
            geo["splits"], int(vectorized(x2d, w)), geo["smem"],
            _build.stream_of(x2d))
    _build.check("conv1x1", name, code)
    _build.LAUNCHES[name] += 1
    return out
