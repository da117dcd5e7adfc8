"""Im2col-free direct convolution in one CUDA kernel
(``csrc/direct_conv.cu``).

``direct_conv`` computes the bare convolution of NHWC x by HWIO w at any
stride and padding — no epilogue, C accumulated in fp32, one write in
x.dtype — what the JAX package's Pallas kernel of the same name
computes.  The TPU kernel stages a whole padded image per channel slice;
the CUDA kernel tiles space (one block per tile of output pixels x
output channels x image), stages each tile's input halo once per chunk
of channels, read from the unpadded input, and runs every tap out of
shared memory on the tensor cores (3xTF32 ``mma.sync`` in fp32, bf16
``mma.sync`` in bf16).  The kernel owns its geometry:
``launch_geometry`` picks the pixel tile, the output-channel tile, the
channel chunk and how many blocks split C from the shape alone, so the
launch fills the card's 132 SMs; the planner's ``vmem_bytes`` reads its
shared memory.  The reference's ``(tm, tc)`` stay in the signature, the
plan and its cache key, so plans read like the reference's, but on the
card they size nothing.

``direct_conv_plain`` is the same function in plain PyTorch (the fused
kernel's plain version without an epilogue: per-tap fp32 products
summed): the wrapper runs it for CPU tensors, and ``chip_smoke.py``
holds the kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cuconv_fused import _geometry, cuconv_fused_plain

SMS = 132        # the H100's streaming multiprocessors
MAX_SPLITS = 16  # C-splits of one tile, each summed by the tile's last block
KSTEP = {4: 8, 2: 16}  # channels of one mma k-step, by itemsize


def pixel_tile(OH: int, OW: int, bm: int, stride, kernel):
    """``(TH, TW)``: rows x columns of output pixels a block covers,
    TH x TW <= bm: the fewest tiles per image, then the smallest input
    halo, then the widest (a warp's rows then read neighbouring halo
    positions, which fall in distinct banks)."""
    best = None
    for tw in range(min(OW, bm), 0, -1):
        th = min(OH, bm // tw)
        key = (-(-OH // th) * -(-OW // tw),
               ((th - 1) * stride[0] + kernel[0])
               * ((tw - 1) * stride[1] + kernel[1]))
        if best is None or key < best[0]:
            best = (key, th, tw)
    return best[1], best[2]


def smem_bytes(th: int, tw: int, bm: int, bn: int, chunk: int, w_shape,
               stride=(1, 1), stages: int = 3, itemsize: int = 4) -> int:
    """Shared memory of one block: the halo's int offset table (rounded
    up to 16 bytes), then ``stages`` x (the input halo [IHT*IWT][chunk +
    16 bytes] and the filter slice [KH*KW*chunk][bn + 8]) in the input
    dtype, or, where larger, the finished fp32 tile bm x (bn + 4)."""
    KH, KW = w_shape[0], w_shape[1]
    halo = ((th - 1) * stride[0] + KH) * ((tw - 1) * stride[1] + KW)
    table = -(-4 * halo // 16) * 16
    stage = halo * (chunk + 16 // itemsize) + KH * KW * chunk * (bn + 8)
    return table + max(stages * stage * itemsize, 4 * bm * (bn + 4))


def launch_geometry(x_shape, w_shape, stride=(1, 1), padding=(0, 0),
                    itemsize: int = 4) -> dict:
    """What the wrapper launches: a ``th`` x ``tw`` tile of output pixels
    in ``bm`` mma rows by ``bn`` output channels, C in ``chunks`` chunks
    of ``chunk`` channels (one mma k-step, four where the filter has
    one tap, two where it has two), ``splits`` C-splits of whole chunks,
    ``tiles`` output tiles, ``blocks`` in all, a ring of ``stages``
    chunks and the ``smem`` each block stages.

    The tile starts at 64 rows (32 where an image has 32 pixels or
    fewer) x ``bn`` following M (16, 32 or 64), and shrinks (32 rows,
    then bn halves down to 16) as ``cuconv_fused.launch_geometry``'s
    does: where its tiles are under one wave, C is split, up to
    MAX_SPLITS and at least two chunks a split (one where a chunk holds
    eight k-steps of taps or more), aiming at four blocks per SM; where
    that still leaves under two blocks per SM, the next smaller tile is
    taken.  A tile whose two-stage ring exceeds the shared memory a
    block can use is skipped; three stages where they fit and a split
    runs three chunks or more."""
    N = x_shape[0]
    KH, KW, C, M = w_shape
    OH, OW = _geometry(x_shape, w_shape, stride, padding)
    taps = KH * KW
    steps = max(1, 4 // taps)
    chunk = KSTEP[itemsize] * steps
    chunks = -(-C // chunk)
    per_split = 1 if taps * steps >= 8 else 2
    bn = 16 if M <= 16 else 32 if M <= 32 else 64
    shapes = [(64, bn)] if OH * OW > 32 else []
    while bn >= 16:
        shapes.append((32, bn))
        bn //= 2
    fits = None
    for bm, bn in shapes:
        th, tw = pixel_tile(OH, OW, bm, stride, (KH, KW))
        tiles = N * -(-OH // th) * -(-OW // tw) * -(-M // bn)
        splits = 1 if tiles >= SMS else max(1, min(
            MAX_SPLITS, chunks // per_split, -(-4 * SMS // tiles)))
        stages = 3 if -(-chunks // splits) >= 3 else 2
        smem = smem_bytes(th, tw, bm, bn, chunk, w_shape, stride, stages,
                          itemsize)
        if stages == 3 and smem > _build.SMEM_LIMIT:
            stages = 2
            smem = smem_bytes(th, tw, bm, bn, chunk, w_shape, stride, 2,
                              itemsize)
        geo = {"th": th, "tw": tw, "bm": bm, "bn": bn, "chunk": chunk,
               "chunks": chunks, "splits": splits, "stages": stages,
               "tiles": tiles, "blocks": tiles * splits, "smem": smem}
        if smem > _build.SMEM_LIMIT:
            continue
        fits = geo
        if tiles >= SMS or tiles * splits >= 2 * SMS:
            break
    return fits or geo


def split_ranges(C: int, chunk: int, splits: int):
    """The ``[begin, end)`` channel range of each split, as the kernel
    cuts it (``split_steps`` of ``csrc/splitk.cuh``): fixed runs of
    whole chunks, the last ending at C."""
    chunks = -(-C // chunk)
    return [(z * chunks // splits * chunk,
             min((z + 1) * chunks // splits * chunk, C))
            for z in range(splits)]


def vectorized(x, w):
    """``(vec_a, vec_b)``: whether the halo and the filter stage by
    16-byte cp.async (channels and base pointer 16-byte aligned) or by
    masked scalar loads."""
    v = 16 // x.element_size()
    return (x.shape[3] % v == 0 and x.data_ptr() % 16 == 0,
            w.shape[3] % v == 0 and w.data_ptr() % 16 == 0)


def direct_conv_plain(x, w, padding=(0, 0), stride=(1, 1)):
    """The kernel's function in plain PyTorch (fp32 throughout)."""
    return cuconv_fused_plain(x, w, stride=stride, padding=padding)


def direct_conv(x, w, padding=(0, 0), stride=(1, 1), tm: int = 128,
                tc: int = 256):
    """x: (N, H, W, C) NHWC; w: (KH, KW, C, M) HWIO; any stride >= 1.

    Bare conv (no epilogue: the direct executor applies bias, activation
    and fusions after it).  ``tm``/``tc`` are the reference's output and
    input channel tiles, checked and kept for its launch configs; the
    kernel's own geometry is ``launch_geometry``.  Returns (N, OH, OW, M)
    in x.dtype.  CPU tensors run the plain version; CUDA tensors launch
    the kernel.
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
    _build.check_operands(name, x.device, x.dtype, x=x, w=w)
    if max(x.numel(), w.numel(), N * OH * OW * M) >= 2 ** 31:
        raise ValueError(f"{name}: tensors of 2**31 elements or more are "
                         f"not supported (int offsets)")
    geo = launch_geometry(x.shape, w.shape, stride, padding,
                          x.element_size())
    _build.check_smem(name, geo["smem"],
                      f"filter {KH}x{KW} at stride {tuple(stride)}, block "
                      f"tile {geo['th']}x{geo['tw']}x{geo['bn']}")
    if not _build.on_card(name, x):
        return direct_conv_plain(x, w, padding, stride)
    _build.refuse_grad(name, x, w)
    out = torch.empty((N, OH, OW, M), dtype=x.dtype, device=x.device)
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
    lib = _build.library("direct_conv")
    with torch.cuda.device(x.device):
        code = lib.direct_conv_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _build.DTYPE_CODES[str(x.dtype)[6:]], N, H, W, C, KH, KW, M,
            sh, sw, ph, pw, OH, OW, geo["th"], geo["tw"], geo["bm"],
            geo["bn"], geo["chunk"], geo["stages"], geo["tiles"],
            geo["splits"], int(vec_a), int(vec_b), geo["smem"],
            _build.stream_of(x))
    _build.check("direct_conv", name, code)
    _build.LAUNCHES[name] += 1
    return out
