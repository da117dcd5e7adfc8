"""Int8 x int8 -> int32 GEMM — the quantized inference path's kernel
(``csrc/int8_gemm.cu``), on the int8 tensor cores.

Two entries launch the one CUDA kernel:

- ``int8_gemm`` returns the raw (P, M) int32 accumulator of
  (P, K) int8 @ (K, M) int8, what the JAX package's Pallas kernel of the
  same name computes;
- ``int8_conv`` is the ``cuconv_int8`` executor's node: the same product
  with the patch matrix gathered by the kernel from an unpadded NHWC
  input (K ordered (tap, channel), as the executor's stack of tap views
  orders it) and the filter given as (M, KH, KW, C) codes.  On int8
  codes it returns the int32 accumulator; on fp32 it quantizes the input
  as it stages it and returns the fp32 requantization epilogue.

The kernel owns its geometry: ``launch_geometry`` gives each block
exactly one output tile (``bm`` x ``bn``) and stages the tile's whole
contraction.  The reference's ``(tp, tm, tc)`` stay in the signatures,
checked and kept, but size nothing.

``int8_gemm_plain`` is the same GEMM in plain PyTorch.  PyTorch has no
general integer matmul on the card, so it multiplies in float64: every
product of two int8 codes and every partial sum of K of them is an
integer of magnitude below K * 127^2, far under 2^53, so float64
represents each one exactly whatever the summation order, and the
result equals the int32 accumulator bit for bit.  ``int8_conv_plain``
is the executor's eager composition around it (quantize, the stack of
tap views, the GEMM, the epilogue), the plain version of ``int8_conv``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._compat import clamp_tiles

SMS = 132        # the H100's streaming multiprocessors
KSTEP = 32       # k of one mma.sync.m16n8k32
KC_MAX = 512     # k staged per chunk, at most
ROW_PAD = 16     # bytes after each staged row
WARPS = 4        # warps of a block; each sums its own k-steps
#: the longest K whose int32 sums of products of codes in [-127, 127]
#: cannot overflow: K * 127^2 < 2^31
K_MAX = (2 ** 31 - 1) // 127 ** 2


def smem_bytes(bm: int, bn: int, kc: int) -> int:
    """Shared memory of one block: the staged (bm + bn) rows of kc codes
    (+ ROW_PAD bytes each), or, where larger, the WARPS partial int32
    tiles bm x (bn + 8) summed over it afterwards."""
    return max((bm + bn) * (kc + ROW_PAD), 4 * WARPS * bm * (bn + 8))


def launch_geometry(P: int, K: int, M: int) -> dict:
    """What the wrappers launch for (P, K) @ (K, M): each block owns one
    output tile of ``bm`` rows x ``bn`` channels (``bn`` = M rounded up
    to 8, at most 32; ``bm`` 32 where that still gives a wave of SMS
    blocks, else 16), so ``blocks`` = ``tiles``; ``kc`` codes of K are
    staged at a time (all of it up to KC_MAX), in ``k_steps`` steps of
    KSTEP; ``smem`` is what a block stages."""
    bn = min(32, -(-M // 8) * 8)
    n_tiles = -(-M // bn)
    bm = 32 if -(-P // 32) * n_tiles >= SMS else 16
    tiles = -(-P // bm) * n_tiles
    kc = min(-(-K // KSTEP) * KSTEP, KC_MAX)
    return {"bm": bm, "bn": bn, "kc": kc, "k_steps": -(-K // KSTEP),
            "chunks": -(-K // kc), "tiles": tiles, "blocks": tiles,
            "smem": smem_bytes(bm, bn, kc)}


def int8_gemm_plain(x2d, w):
    """Exact int32 accumulator through float64 (see the module doc)."""
    return (x2d.double() @ w.double()).to(torch.int32)


def conv_patches(x, KH: int, KW: int, stride, padding):
    """The (N*OH*OW, KH*KW*C) patch matrix of an NHWC input, K ordered
    (tap, channel): the stack of tap views the executor builds."""
    from repro_torch.core.cuconv import _pad_input, _tap_views
    N, H, W, C = x.shape
    OH, OW = _out_hw(H, W, KH, KW, stride, padding)
    xp = _pad_input(x, *padding)
    return torch.stack(_tap_views(xp, KH, KW, OH, OW, tuple(stride)),
                       dim=3).reshape(N * OH * OW, KH * KW * C)


def int8_conv_plain(x, w, stride=(1, 1), padding=(0, 0), scale=None,
                    w_scales=None, bias=None, addend=None, relu=False):
    """``int8_conv``'s function in plain PyTorch: the executor's eager
    composition, step for step."""
    N, H, W, _ = x.shape
    M, KH, KW, C = w.shape
    OH, OW = _out_hw(H, W, KH, KW, stride, padding)
    codes = x
    if x.dtype != torch.int8:
        from repro_torch.quant import symmetric
        codes = symmetric.quantize_to_int8(x, scale)
    acc = int8_gemm_plain(conv_patches(codes, KH, KW, stride, padding),
                          w.reshape(M, KH * KW * C).t())
    acc = acc.reshape(N, OH, OW, M)
    if x.dtype == torch.int8:
        return acc
    # the reference's fp32 order: the int32 accumulator times the outer
    # product of scales, THEN bias / residual / activation
    y = acc.float() * (scale * w_scales)
    if bias is not None:
        y = y + bias
    if addend is not None:
        y = y + addend
    if relu:
        y = torch.relu(y)
    return y


def _out_hw(H, W, KH, KW, stride, padding):
    (sh, sw), (ph, pw) = stride, padding
    return (H + 2 * ph - KH) // sh + 1, (W + 2 * pw - KW) // sw + 1


def _check_k(name, K):
    if K > K_MAX:
        raise ValueError(f"{name}: K = {K} > {K_MAX}: int32 sums of int8 "
                         f"products could overflow")


def _launch(x, w, out, conv, geo, *, in_float, w_km, scale=None,
            w_scales=None, bias=None, addend=None, relu=False):
    """One launch of the kernel; ``conv`` is (N, H, W, C, KH, KW, M, sh,
    sw, ph, pw, OH, OW)."""
    C, K = conv[3], conv[3] * conv[4] * conv[5]
    vec_a = C % 16 == 0 and x.data_ptr() % 16 == 0
    vec_b = not w_km and K % 16 == 0 and w.data_ptr() % 16 == 0

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _build.library("int8_gemm")
    with torch.cuda.device(x.device):
        code = lib.int8_gemm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ptr(scale),
            ptr(w_scales), ptr(bias), ptr(addend), int(in_float), int(w_km),
            *conv, geo["bm"], geo["bn"], geo["kc"], int(relu), int(vec_a),
            int(vec_b), geo["smem"], _build.stream_of(x))
    _build.check("int8_gemm", "int8_gemm", code)
    _build.LAUNCHES["int8_gemm"] += 1
    return out


def _check_tensor(name, arg, t, device, dtype, shape=None):
    if t.device != device:
        raise ValueError(f"{name}: {arg} is on {t.device} but the input is "
                         f"on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {arg} must be {dtype}; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")


def int8_gemm(x2d, w, tp: int = 256, tm: int = 128, tc: int = 512):
    """x2d: (P, K) int8 pixels-major; w: (K, M) int8.  Returns (P, M)
    int32, the undequantized accumulator.  ``tp/tm/tc`` are the
    reference's tiles, checked and kept; the kernel's geometry is
    ``launch_geometry``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    name = "int8_gemm"
    if x2d.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: x2d must be (P, K) and w (K, M); got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    P, K = x2d.shape
    Kw, M = w.shape
    if Kw != K or min(P, K, M) < 1:
        raise ValueError(f"{name}: shapes {tuple(x2d.shape)} and "
                         f"{tuple(w.shape)} do not contract")
    _check_tensor(name, "x2d", x2d, x2d.device, torch.int8)
    _check_tensor(name, "w", w, x2d.device, torch.int8)
    clamp_tiles((P, M, K), (tp, tm, tc))
    _check_k(name, K)
    geo = launch_geometry(P, K, M)
    _build.check_smem(name, geo["smem"], f"block tile {geo['bm']}x"
                      f"{geo['bn']}, kc={geo['kc']}")
    if not _build.on_card(name, x2d):
        return int8_gemm_plain(x2d, w)
    _build.refuse_grad(name, x2d, w)
    out = torch.empty((P, M), dtype=torch.int32, device=x2d.device)
    # the (P, K) rows as a (P, 1, 1, K) input under a 1x1 filter
    return _launch(x2d, w, out, (P, 1, 1, K, 1, 1, M, 1, 1, 0, 0, 1, 1),
                   geo, in_float=False, w_km=True)


def int8_conv(x, w, stride=(1, 1), padding=(0, 0), scale=None,
              w_scales=None, bias=None, addend=None, relu: bool = False,
              tp: int = 256, tm: int = 128, tc: int = 512):
    """x: (N, H, W, C) NHWC, unpadded, int8 codes or fp32; w: (M, KH, KW,
    C) int8 codes.  On codes: returns the (N, OH, OW, M) int32
    accumulator of the conv under ``stride`` and zero ``padding``.  On
    fp32: ``scale`` is the activation scale (a one-element fp32 tensor on
    x's device: nothing is read back to the host) and ``w_scales`` the
    (M,) per-channel weight scales; x is quantized as
    ``clamp(rint(x / s'), -127, 127)`` (s' = s, or 1 where s <= 0) and
    the result is ``float(acc) * (scale * w_scales)``, then ``+ bias``
    (M,), ``+ addend`` (N, OH, OW, M), then ReLU, in fp32.  ``tp/tm/tc``
    as for ``int8_gemm``.  CPU tensors run ``int8_conv_plain``; CUDA
    tensors launch the kernel."""
    name = "int8_conv"
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC and w (M, KH, KW, C); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    M, KH, KW, Cw = w.shape
    if Cw != C:
        raise ValueError(f"{name}: filter depth {Cw} != input channels {C}")
    stride, padding = tuple(map(int, stride)), tuple(map(int, padding))
    if min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"{name}: stride {stride} / padding {padding}")
    OH, OW = _out_hw(H, W, KH, KW, stride, padding)
    if min(N, OH, OW, M, C) < 1:
        raise ValueError(f"{name}: empty output {(N, OH, OW, M)}")
    dev = x.device
    _check_tensor(name, "w", w, dev, torch.int8)
    codes_in = x.dtype == torch.int8
    _check_tensor(name, "x", x, dev, torch.int8 if codes_in
                  else torch.float32)
    if codes_in:
        if any(v is not None for v in (scale, w_scales, bias, addend)) \
                or relu:
            raise ValueError(f"{name}: int8 codes give the raw accumulator; "
                             f"scales, bias, addend and relu go with fp32 x")
    else:
        if scale is None or w_scales is None:
            raise ValueError(f"{name}: fp32 x needs scale and w_scales")
        _check_tensor(name, "scale", scale, dev, torch.float32)
        if scale.numel() != 1:
            raise ValueError(f"{name}: scale must hold one value")
        _check_tensor(name, "w_scales", w_scales, dev, torch.float32, (M,))
        if bias is not None:
            _check_tensor(name, "bias", bias, dev, torch.float32, (M,))
        if addend is not None:
            _check_tensor(name, "addend", addend, dev, torch.float32,
                          (N, OH, OW, M))
    P, K = N * OH * OW, KH * KW * C
    clamp_tiles((P, M, K), (tp, tm, tc))
    _check_k(name, K)
    if max(x.numel(), w.numel(), P * M) >= 2 ** 31:
        raise ValueError(f"{name}: tensors of 2**31 elements or more are "
                         f"not supported (int offsets)")
    geo = launch_geometry(P, K, M)
    _build.check_smem(name, geo["smem"], f"block tile {geo['bm']}x"
                      f"{geo['bn']}, kc={geo['kc']}")
    if not _build.on_card("int8_gemm", x):
        return int8_conv_plain(x, w, stride, padding, scale, w_scales, bias,
                               addend, relu)
    _build.refuse_grad(name, x, w, scale, w_scales, bias, addend)
    out = torch.empty((N, OH, OW, M), device=dev,
                      dtype=torch.int32 if codes_in else torch.float32)
    return _launch(x, w, out, (N, H, W, C, KH, KW, M) + stride + padding
                   + (OH, OW), geo, in_float=not codes_in, w_km=False,
                   scale=scale, w_scales=w_scales, bias=bias,
                   addend=addend, relu=relu)
