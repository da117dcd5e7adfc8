"""Fused cuConv: both stages in one CUDA kernel (``csrc/cuconv_fused.cu``).

``cuconv_fused`` computes ``act(sum over taps of X_shift(t) . W[t] + b +
addend)`` for NHWC x and HWIO w at any stride and padding, or a
non-overlapping max/avg pool of ``act(... + b)``, with fp32 accumulation
and one write in x.dtype — what the JAX package's Pallas kernel of the
same name computes.  On the card it is an implicit GEMM on the tensor
cores (3xTF32 ``mma.sync`` in fp32, bf16 ``mma.sync`` in bf16, a
cp.async ring fed by an im2col gather of the unpadded input; the design
is in the source).  The kernel owns its geometry: ``launch_geometry``
picks the block tile and how many blocks split the contraction from the
shape alone, so the launch fills the card's 132 SMs; the planner's
``vmem_bytes`` reads it.  The reference's ``(tm, rows)`` stay in the
signature, the plan and its cache key, so plans read like the
reference's, but on the card they size nothing.

``cuconv_fused_plain`` is the same function in plain PyTorch (per-tap
fp32 products summed in tap order, then the epilogue): the wrapper runs
it for CPU tensors, and ``chip_smoke.py`` holds the kernel against it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SMS = 132        # the H100's streaming multiprocessors
BK = 32          # contraction depth of one pipeline stage (kBK)
STAGES = 3       # cp.async ring depth (kStages)
POOL_BM = 64     # pixels of a pooled block tile
MAX_SPLITS = 16  # K-splits of one tile, each summed by the tile's last block


def _geometry(x_shape, w_shape, stride, padding):
    _, H, W, _ = x_shape
    KH, KW, _, _ = w_shape
    OH = (H + 2 * padding[0] - KH) // stride[0] + 1
    OW = (W + 2 * padding[1] - KW) // stride[1] + 1
    return OH, OW


def smem_bytes(bm: int, bn: int, itemsize: int = 4) -> int:
    """Shared memory of one block: STAGES x (A tile bm x (BK + 16 bytes)
    + B tile BK x (bn + 8)) in the input dtype, or, where larger, the
    finished fp32 tile bm x (bn + 4) that every block stages over the
    drained ring for its epilogue."""
    ring = STAGES * (bm * (BK + 16 // itemsize) + BK * (bn + 8)) * itemsize
    return max(ring, 4 * bm * (bn + 4))


def pool_tile(OH: int, OW: int, psh: int, psw: int, bm: int = POOL_BM):
    """``(TH, TW)``: the spatial tile of a pooled block, TW a multiple of
    psw and TH of psh, TH x TW <= bm, so it holds whole windows."""
    tw = min(OW, bm // psh) // psw * psw
    th = min(OH, (bm // tw if tw else 0) // psh * psh)
    if tw < psw or th < psh:
        raise ValueError(f"cuconv_fused: pool window {psh}x{psw} does not "
                         f"fit the {bm}-pixel block tile the kernel stages "
                         f"in shared memory")
    return th, tw


def launch_geometry(x_shape, w_shape, stride=(1, 1), padding=(0, 0),
                    pool=None, itemsize: int = 4) -> dict:
    """What the wrapper launches: block tile ``bm`` output pixels x
    ``bn`` output channels, ``splits`` contraction splits over
    ``k_steps`` steps of BK (k = tap, channel), ``tiles`` output tiles,
    ``blocks`` in all, and the ``smem`` each block stages.

    The tile starts at 64 pixels (32 where P <= 64) x ``bn`` following
    M (16, 32 or 64).  Where its tiles are under one wave of SMS, K is
    split into runs of at least two steps, up to MAX_SPLITS, aiming at
    four blocks per SM.  Where that still leaves under two blocks per
    SM, and the tiles alone under one wave, the tile shrinks (32 pixels, then bn halves down to 16) and the
    splits are chosen again: a split's partial tile is summed by one
    block, so many small tiles with few splits beat a few large tiles
    with many (``PERF.md``).  Under a pool the tile is ``pool_tile``
    (``th`` x ``tw`` pixels of one image) and K is not split: the pooled
    stem already has hundreds of tiles."""
    N = x_shape[0]
    KH, KW, C, M = w_shape
    OH, OW = _geometry(x_shape, w_shape, stride, padding)
    k_steps = -(-KH * KW * C // BK)
    bn = 16 if M <= 16 else 32 if M <= 32 else 64
    th = tw = None
    if pool is None:
        P = N * OH * OW
        bm = 32 if P <= 64 else 64
        while True:
            tiles = -(-P // bm) * -(-M // bn)
            splits = 1 if tiles >= SMS else max(1, min(
                MAX_SPLITS, k_steps // 2, -(-4 * SMS // tiles)))
            if tiles >= SMS or tiles * splits >= 2 * SMS:
                break
            if bm == 64:
                bm = 32
            elif bn > 16:
                bn //= 2
            else:
                break
    else:
        bm = POOL_BM
        th, tw = pool_tile(OH, OW, pool[1], pool[2], bm)
        tiles = N * -(-OH // th) * -(-OW // tw) * -(-M // bn)
        splits = 1
    return {"bm": bm, "bn": bn, "th": th, "tw": tw, "splits": splits,
            "k_steps": k_steps, "tiles": tiles, "blocks": tiles * splits,
            "smem": smem_bytes(bm, bn, itemsize)}


def vectorized(x, w):
    """``(vec_a, vec_b)``: whether the input and the filter stage by
    16-byte cp.async (channels and base pointer 16-byte aligned) or by
    masked scalar loads."""
    v = 16 // x.element_size()
    return (x.shape[3] % v == 0 and x.data_ptr() % 16 == 0,
            w.shape[3] % v == 0 and w.data_ptr() % 16 == 0)


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
    ``OW % psw == 0``.  ``tm``/``rows`` are the reference's launch
    config, checked and kept; the kernel's own geometry is
    ``launch_geometry``.  Returns (N, OH, OW, M), pooled to (N, OH/psh,
    OW/psw, M), in x.dtype.  CPU tensors run the plain version; CUDA
    tensors launch the kernel.
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
    if max(x.numel(), w.numel(), N * OH * OW * M) >= 2 ** 31:
        raise ValueError(f"{name}: tensors of 2**31 elements or more are "
                         f"not supported (int offsets)")
    geo = launch_geometry(x.shape, w.shape, stride, padding, pool,
                          x.element_size())
    _build.check_smem(name, geo["smem"],
                      f"block tile {geo['bm']}x{geo['bn']}")
    if not _build.on_card(name, x):
        return cuconv_fused_plain(x, w, bias, stride, padding, activation,
                                  addend, pool)
    _build.refuse_grad(name, x, w, bias, addend)
    if pool is None:
        out = torch.empty((N, OH, OW, M), dtype=x.dtype, device=x.device)
        pool_kind, psh, psw, th, tw = 0, 1, 1, 0, 0
    else:
        kind, psh, psw = pool
        out = torch.empty((N, OH // psh, OW // psw, M), dtype=x.dtype,
                          device=x.device)
        pool_kind, th, tw = 1 if kind == "max" else 2, geo["th"], geo["tw"]
    ws = counters = None
    if geo["splits"] > 1:
        # one fp32 partial tile per (split, tile), tile-major
        if geo["splits"] * geo["tiles"] * geo["bm"] * geo["bn"] >= 2 ** 31:
            raise ValueError(f"{name}: split workspace exceeds 2**31 "
                             f"elements")
        ws = torch.empty((geo["splits"], geo["tiles"],
                          geo["bm"] * geo["bn"]), dtype=torch.float32,
                         device=x.device)
        counters = torch.zeros(geo["tiles"], dtype=torch.int32,
                               device=x.device)
    vec_a, vec_b = vectorized(x, w)
    lib = _build.library("cuconv_fused")
    with torch.cuda.device(x.device):
        code = lib.cuconv_fused_launch(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if addend is None else addend.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _build.DTYPE_CODES[str(x.dtype)[6:]],
            N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW,
            int(activation == "relu"), pool_kind, psh, psw, th, tw,
            geo["bm"], geo["bn"], geo["tiles"], geo["splits"], int(vec_a),
            int(vec_b), geo["smem"], _build.stream_of(x))
    _build.check("cuconv_fused", name, code)
    _build.LAUNCHES[name] += 1
    return out
