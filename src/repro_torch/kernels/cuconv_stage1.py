"""cuConv stage 1 (faithful): per-tap channel contraction.

``stage1_tap_gemm`` takes the (T, P, C) stacked shifted views and the
(T, C, M) filter taps and returns the (T, P, M) fp32 temporaries,
written to device memory on purpose — what the JAX package's Pallas
kernel of the same name computes.  ``stage1_tap_conv`` computes the same
temporaries straight from the padded NHWC input and the HWIO filter,
with no stack: row p = (n, oh, ow) of tap (di, dj) is ``xp[n, oh + di,
ow + dj, :]``.  Both launch one CUDA kernel (``csrc/cuconv_stage1.cu``),
a batched GEMM on the tensor cores (3xTF32 ``mma.sync`` in fp32, bf16
``mma.sync`` in bf16, a cp.async ring) that reads its A operand through
a row rule: ``stacked_rule`` and ``conv_rule`` give the two entries'
rules, and ``row_offsets`` is the kernel's arithmetic on them.

The kernel owns its block tile: ``launch_geometry`` picks it from
(T, P, C, M) so the launch fills the card's 132 SMs, and the planner's
``vmem_bytes`` reads its shared memory.  The reference's
``(tp, tm, tc)`` stay in the signature, the plan and its cache key, so
plans read like the reference's, but on the card they size nothing.
``stage1_tap_gemm_plain`` is the same function in plain PyTorch, and
the plain version of both entries.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SMS = 132        # the H100's streaming multiprocessors
BK = 32          # contraction depth of one pipeline stage (kBK)
STAGES = 3       # cp.async ring depth (kStages)


def smem_bytes(bm: int, bn: int, itemsize: int = 4) -> int:
    """Shared memory of one block: STAGES x (A tile bm x (BK + 16 bytes)
    + B tile BK x (bn + 8)) in the input dtype, or, where larger, the
    finished fp32 tile bm x (bn + 4) staged over the drained ring."""
    ring = STAGES * (bm * (BK + 16 // itemsize) + BK * (bn + 8)) * itemsize
    return max(ring, 4 * bm * (bn + 4))


def launch_geometry(T: int, P: int, C: int, M: int,
                    itemsize: int = 4) -> dict:
    """What the wrappers launch for T taps of (P, C) @ (C, M): block tile
    ``bm`` rows x ``bn`` channels of one tap, ``tiles`` output tiles per
    tap, ``blocks`` = T x tiles in all, ``k_steps`` steps of BK, and the
    ``smem`` each block stages.  The tile starts at 64 rows (32 where
    P <= 64) x ``bn`` following M (16, 32 or 64), and shrinks (32 rows,
    then bn halves down to 16) while the blocks are under one wave of
    SMS.  C is never split: every block writes its own temporaries."""
    bm = 32 if P <= 64 else 64
    bn = 16 if M <= 16 else 32 if M <= 32 else 64
    while True:
        tiles = -(-P // bm) * -(-M // bn)
        if T * tiles >= SMS:
            break
        if bm == 64:
            bm = 32
        elif bn > 16:
            bn //= 2
        else:
            break
    return {"bm": bm, "bn": bn, "k_steps": -(-C // BK), "tiles": tiles,
            "blocks": T * tiles, "smem": smem_bytes(bm, bn, itemsize)}


def stacked_rule(T: int, P: int, C: int) -> dict:
    """The row rule of a stacked (T, P, C) input: tap t at t*P*C, row p
    at p*C after it."""
    return {"KW": T, "tap_row": 0, "tap_col": P * C, "OHW": P, "OW": P,
            "img": 0, "row": 0}


def conv_rule(xp_shape, w_shape) -> dict:
    """The row rule of a padded NHWC input (N, Hp, Wp, C) under a
    (KH, KW, C, M) filter at stride 1: tap (di, dj) at (di*Wp + dj)*C,
    row p = (n, oh, ow) at ((n*Hp + oh)*Wp + ow)*C after it."""
    _, Hp, Wp, C = xp_shape
    KH, KW = w_shape[:2]
    OW = Wp - KW + 1
    return {"KW": KW, "tap_row": Wp * C, "tap_col": C,
            "OHW": (Hp - KH + 1) * OW, "OW": OW, "img": Hp * Wp * C,
            "row": Wp * C}


def row_offsets(rule: dict, T: int, P: int, C: int) -> torch.Tensor:
    """(T, P) element offsets at which the kernel reads row p of tap t:
    the same arithmetic as ``stage1_tc_kernel``, for the CPU tests."""
    t = torch.arange(T).unsqueeze(1)
    p = torch.arange(P).unsqueeze(0)
    di, dj = t // rule["KW"], t % rule["KW"]
    n, rem = p // rule["OHW"], p % rule["OHW"]
    oh, ow = rem // rule["OW"], rem % rule["OW"]
    return (di * rule["tap_row"] + dj * rule["tap_col"]
            + n * rule["img"] + oh * rule["row"] + ow * C)


def stack_taps(xp, KH: int, KW: int):
    """The (KH*KW, N*OH*OW, C) stack of a padded input's stride-1 tap
    views, as the reference's wrapper builds it (``stage1_tap_gemm``'s
    input)."""
    from repro_torch.core.cuconv import _tap_views
    _, Hp, Wp, C = xp.shape
    views = _tap_views(xp, KH, KW, Hp - KH + 1, Wp - KW + 1, 1)
    return torch.stack([v.reshape(-1, C) for v in views], 0)


def stage1_tap_gemm_plain(xs, w):
    return torch.bmm(xs.float(), w.float())


def stage1_tap_conv_plain(xp, w):
    """``stage1_tap_conv``'s function in plain PyTorch: the stack of tap
    views through ``stage1_tap_gemm_plain``."""
    KH, KW, C, M = w.shape
    return stage1_tap_gemm_plain(stack_taps(xp, KH, KW),
                                 w.reshape(KH * KW, C, M))


def _launch(name, x, w, T, P, C, M, rule, tiles):
    if min(tiles) < 1:
        raise ValueError(f"{name}: tile sizes must be >= 1; got {tiles}")
    _build.check_operands(name, x.device, x.dtype, x=x, w=w)
    if max(x.numel(), w.numel(), T * P * M) >= 2 ** 31:
        raise ValueError(f"{name}: tensors of 2**31 elements or more are "
                         f"not supported (int offsets)")
    geo = launch_geometry(T, P, C, M, x.element_size())
    _build.check_smem(name, geo["smem"],
                      f"block tile {geo['bm']}x{geo['bn']}")
    if not _build.on_card("stage1_tap_gemm", x):
        return None
    _build.refuse_grad(name, x, w)
    out = torch.empty((T, P, M), dtype=torch.float32, device=x.device)
    v = 16 // x.element_size()
    vec_a = C % v == 0 and x.data_ptr() % 16 == 0
    vec_b = M % v == 0 and w.data_ptr() % 16 == 0
    lib = _build.library("cuconv_stage1")
    with torch.cuda.device(x.device):
        code = lib.stage1_tap_gemm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(x.dtype)[6:]], T, P, C, M, rule["KW"],
            rule["tap_row"], rule["tap_col"], rule["OHW"], rule["OW"],
            rule["img"], rule["row"], geo["bm"], geo["bn"], geo["tiles"],
            int(vec_a), int(vec_b), geo["smem"], _build.stream_of(x))
    _build.check("cuconv_stage1", "stage1_tap_gemm", code)
    _build.LAUNCHES["stage1_tap_gemm"] += 1
    return out


def stage1_tap_gemm(xs, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """xs: (T, P, C) stacked shifted views; w: (T, C, M) filter taps.
    Returns the stage-1 temporaries (T, P, M) in fp32.  ``tp/tm/tc`` are
    the reference's tiles, checked and kept; the kernel's own geometry
    is ``launch_geometry``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    name = "stage1_tap_gemm"
    if xs.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: xs must be (T, P, C) and w (T, C, M); "
                         f"got {tuple(xs.shape)} and {tuple(w.shape)}")
    T, P, C = xs.shape
    if w.shape[:2] != (T, C) or min(T, P, C, w.shape[2]) < 1:
        raise ValueError(f"{name}: shapes {tuple(xs.shape)} and "
                         f"{tuple(w.shape)} do not contract")
    M = w.shape[2]
    out = _launch(name, xs, w, T, P, C, M, stacked_rule(T, P, C),
                  (tp, tm, tc))
    return stage1_tap_gemm_plain(xs, w) if out is None else out


def stage1_tap_conv(xp, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """xp: (N, Hp, Wp, C) padded NHWC input; w: (KH, KW, C, M) HWIO.
    Returns the stride-1 stage-1 temporaries (KH*KW, N*OH*OW, M) in fp32,
    what ``stage1_tap_gemm`` returns for the stack of xp's tap views,
    read by the kernel straight from xp.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    name = "stage1_tap_conv"
    if xp.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: xp must be NHWC and w HWIO; got "
                         f"{tuple(xp.shape)} and {tuple(w.shape)}")
    N, Hp, Wp, C = xp.shape
    KH, KW, Cw, M = w.shape
    if Cw != C:
        raise ValueError(f"{name}: filter depth {Cw} != input channels {C}")
    OH, OW = Hp - KH + 1, Wp - KW + 1
    if min(OH, OW, M) < 1:
        raise ValueError(f"{name}: empty output {(OH, OW, M)}")
    out = _launch(name, xp, w, KH * KW, N * OH * OW, C, M,
                  conv_rule(xp.shape, w.shape), (tp, tm, tc))
    return stage1_tap_conv_plain(xp, w) if out is None else out
