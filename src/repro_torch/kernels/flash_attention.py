"""Blockwise (flash) attention forward, with GQA by stride
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal)`` computes softmax(QKᵀ/√D)V for q
(B, Sq, H, D) against k, v (B, Sk, KVH, D), KVH dividing H, or for the
(BH, S, D) layout: what the JAX package's Pallas kernel
``kernels/flash_attention.py::flash_attention`` computes behind its
wrapper ``ops.flash_attention``.  Query head h reads kv head
h // (H / KVH) straight from k and v: no repeated K/V tensor is built
(the JAX wrapper materializes ``jnp.repeat``).  The causal mask is
aligned top-left (query i sees keys 0..i), as the TPU kernel's: right
when the queries start at key 0, as a prefill does.

The numerics are the TPU kernel's: fp32 scores scaled by 1/√D after the
dot, an online softmax with fp32 m, l and accumulator over KV tiles, p
rounded to v's dtype before PV, and one division by max(l, 1e-30).  On
the card both products run on the tensor cores (bf16 ``mma.sync`` for
bf16, 3xTF32 for fp32) with scores and P in registers, and K/V tiles
double-buffered by cp.async; at long sequences it is bound by
operations, at the served prefill by bytes.  ``launch_geometry`` is the
launch: grid, padded head dimension and the shared memory one block
stages.  ``flash_attention_plain`` is the same function in plain
PyTorch, with one softmax over all keys.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

BQ, BK = 64, 64      # query rows per block, keys per KV tile
THREADS = 128        # 4 warps, 16 query rows each
STAGES = 2           # K/V tiles double-buffered by cp.async (kFaStages)
MAX_HEAD_DIM = 128   # the accumulator fragments cover 128 columns
NEG_INF = -1e30


def padded_head_dim(head_dim: int) -> int:
    """The head dimension the kernel computes with (zero-padded)."""
    return 64 if head_dim <= 64 else 128


def smem_bytes(head_dim: int, itemsize: int = 2) -> int:
    """Shared memory of one block: the Q tile and STAGES K and V tiles,
    64 rows x the padded head dimension each, in the input dtype
    (swizzled, not padded)."""
    return (1 + 2 * STAGES) * BQ * padded_head_dim(head_dim) * itemsize


def launch_geometry(B: int, Sq: int, H: int, D: int, itemsize: int = 2
                    ) -> dict:
    """What the wrapper launches: a block of THREADS per (64 query rows,
    head, batch), ``dp`` the padded head dimension, ``smem`` per block."""
    grid = (-(-Sq // BQ), H, B)
    return {"grid": grid, "blocks": grid[0] * grid[1] * grid[2],
            "threads": THREADS, "dp": padded_head_dim(D),
            "smem": smem_bytes(D, itemsize)}


def _as_bshd(q, k, v):
    """The (B, S, H, D) view of either accepted layout, and whether the
    input was (BH, S, D)."""
    if q.dim() == 3 and k.dim() == 3 and v.dim() == 3:
        return q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), True
    if q.dim() == 4 and k.dim() == 4 and v.dim() == 4:
        return q, k, v, False
    raise ValueError(f"flash_attention: q, k, v must all be (B, S, H, D) or "
                     f"all (BH, S, D); got {tuple(q.shape)}, "
                     f"{tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention_plain(q, k, v, causal=True):
    q4, k4, v4, flat = _as_bshd(q, k, v)
    B, Sq, H, D = q4.shape
    Sk, KVH = k4.shape[1], k4.shape[2]
    kf = k4.repeat_interleave(H // KVH, dim=2).float()
    vf = v4.repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q4.float(), kf) * (1.0 / D ** 0.5)
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = (torch.arange(Sq, device=q.device)[:, None]
                 >= torch.arange(Sk, device=q.device)[None, :])
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf.float())
    out = (out / l).transpose(1, 2).to(q.dtype)
    return out.squeeze(2) if flat else out


def causal_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """The (query, key) pairs the kernel computes: query i sees keys
    0..i under the top-left causal mask."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


def flops(q_shape, k_shape, causal=True) -> int:
    """The kernel's work, as its bound counts it: QK^T and PV, 2 x D
    multiply-adds each, over every (query, key) pair of every head."""
    if len(q_shape) == 3:
        q_shape, k_shape = (q_shape[0], q_shape[1], 1, q_shape[2]), (
            k_shape[0], k_shape[1], 1, k_shape[2])
    B, Sq, H, D = q_shape
    return 4 * D * B * H * causal_pairs(Sq, k_shape[1], causal)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """The launch on the card (validated by ``flash_attention``)."""
    name = "flash_attention"
    q4, k4, _, _ = _as_bshd(q, k, v)
    B, Sq, H, D = q4.shape
    Sk, KVH = k4.shape[1], k4.shape[2]
    geo = launch_geometry(B, Sq, H, D, q.element_size())
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[str(q.dtype)[6:]], B, Sq, Sk, H, KVH, D,
            geo["dp"], 1.0 / D ** 0.5, int(bool(causal)), geo["smem"],
            _build.stream_of(q))
    _build.check("flash_attention", name, code)
    _build.LAUNCHES[name] += 1
    return out


@_kernel.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


_build.flop_formula(_kernel, lambda q, k, v, causal, *_:
                    flops(q, k, causal))


def flash_attention(q, k, v, causal=True):
    """q: (B, Sq, H, D), k, v: (B, Sk, KVH, D); or all (BH, S, D).
    Returns q's shape and dtype.  CPU tensors run the plain version;
    CUDA tensors launch the kernel; meta tensors give the output's shape
    and dtype and launch nothing.  On the card and on meta the call is
    the op ``repro_torch::flash_attention``, whose FLOPs are ``flops``
    (``torch.utils.flop_counter``), so a count on meta and one on the
    card agree."""
    name = "flash_attention"
    q4, k4, v4, _ = _as_bshd(q, k, v)
    B, Sq, H, D = q4.shape
    Sk, KVH = k4.shape[1], k4.shape[2]
    if (k4.shape[0] != B or tuple(v4.shape) != tuple(k4.shape)
            or k4.shape[3] != D or KVH < 1 or H % KVH):
        raise ValueError(f"{name}: k/v {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)} (KVH must divide H)")
    if min(B, Sq, Sk) < 1 or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: empty input or head_dim {D} outside "
                         f"1..{MAX_HEAD_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{name}: grid of ({B}, {H}) exceeds 65535")
    _build.check_operands(name, q.device, q.dtype, q=q, k=k, v=v)
    geo = launch_geometry(B, Sq, H, D, q.element_size())
    _build.check_smem(name, geo["smem"], f"head_dim {D}")
    # meta: the op's shape function (no launch)
    if q.device.type != "meta" and not _build.on_card(name, q):
        return flash_attention_plain(q, k, v, causal)
    _build.refuse_grad(name, q, k, v)
    return _kernel(q, k, v, bool(causal))
