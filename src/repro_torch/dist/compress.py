"""Int8 gradient compression with error feedback: the JAX package's
``dist/compress.py`` over the port's ``quant/symmetric.py``.

Symmetric per-block int8: each flattened 256-element block is scaled by
max|block|/127, so the worst-case per-element error is scale/2 <=
max|block|/254.  Error feedback carries the quantization residual into
the next step, so the *sum* of compressed gradients tracks the true sum
to within one quantization step.

The blocks of a tree's leaf are those of the reference's array: a leaf
of an LM layer is one row of the reference's repeats-stacked array
(``tree.walk``), so the rows are stacked, coded as one array and split
again, and a block may span two layers as it does there.  On a mesh the
leaves are DTensors: the stack is of their global rows (each gathered
whole), so the blocks are still the reference's, and the results are
placed back as the leaves were.

``compressed_psum`` is the reference's all-reduce of the payload inside
``shard_map``: each rank codes its own tensor with error feedback, and a
``torch.distributed.all_reduce`` sums the dequantized payloads over the
group of one mesh axis.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.dist.sharding import place_like, whole
from repro_torch.quant import symmetric
from repro_torch.tree import leaves, map_tree, unflatten, walk

BLOCK = 256


def quantize(x, block: int = BLOCK):
    """x: float tensor -> (q int8, scales (nblocks, 1) f32, orig shape)."""
    shape = tuple(x.shape)
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = symmetric.scale_for(
        symmetric.abs_max(blocks, axis=1, keepdims=True))
    q = symmetric.quantize_to_int8(blocks, scale)
    return q, scale, shape


def dequantize(q, scale, shape):
    flat = symmetric.dequantize_int8(q, scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def quantize_with_feedback(g, err) -> Tuple[Tuple, Any]:
    """Compress (g + err); the new residual is what compression lost."""
    target = g.to(torch.float32) + err
    q, s, shape = quantize(target)
    new_err = target - dequantize(q, s, shape)
    return (q, s, shape), new_err


def init_feedback(params):
    return map_tree(lambda a: torch.zeros_like(
        a, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)



def tree_quantize_with_feedback(grads, ef):
    """Per-leaf EF compression; returns (dequantized grads, new ef tree).
    The dequantized values are what the optimizer consumes — the int8
    payload is the wire format."""
    items = list(walk(grads))
    errs = leaves(ef)
    rows = {}                      # the reference's leaf -> its rows here
    for i, (path, _, _) in enumerate(items):
        rows.setdefault(path, []).append(i)
    deqs, new_errs = [None] * len(items), [None] * len(items)
    for idx in rows.values():
        stacked = items[idx[0]][1] is not None
        if stacked:
            g = torch.stack([whole(items[i][2]) for i in idx])
            e = torch.stack([whole(errs[i]) for i in idx])
        else:
            g, e = whole(items[idx[0]][2]), whole(errs[idx[0]])
        (q, s, shape), ne = quantize_with_feedback(g, e)
        d = dequantize(q, s, shape)
        if stacked:
            for j, i in enumerate(idx):
                deqs[i] = place_like(d[j], items[i][2])
                new_errs[i] = place_like(ne[j], errs[i])
        else:
            i = idx[0]
            deqs[i] = place_like(d, items[i][2])
            new_errs[i] = place_like(ne, errs[i])
    return unflatten(grads, deqs), unflatten(ef, new_errs)


def compressed_psum(x, axis_name, err):
    """EF-compressed all-reduce: each participant contributes its
    dequantized int8 payload.  ``axis_name``: the group to sum over, a
    ``ProcessGroup`` or a one-dimensional ``DeviceMesh`` (a mesh axis,
    ``mesh["data"]``); None is the default group.  Returns (sum,
    new_err), each of ``x``'s shape, fp32."""
    if hasattr(axis_name, "get_group"):
        if axis_name.ndim != 1:
            raise ValueError(f"compressed_psum sums over one mesh axis; "
                             f"got a {axis_name.ndim}-D mesh")
        axis_name = axis_name.get_group()
    (q, s, shape), new_err = quantize_with_feedback(x, err)
    out = dequantize(q, s, shape).contiguous()
    dist.all_reduce(out, group=axis_name)
    return out, new_err
