"""AdamW with fp32 master weights (mixed-precision training), the JAX
package's ``optim/adamw.py``.

Model params live in their own dtype (bf16 by default); the optimizer
carries fp32 master weights and fp32 first and second moments (12 bytes
a param).  The update runs as ``torch._foreach_*`` passes over groups of
leaves, so a step is a few dozen launches a group, not a dozen a leaf;
groups are capped in size so the pass's temporaries stay small.

Weight decay follows the reference's shapes.  It decays a leaf whose
array has more than one dim, and its LM params are stacked along a
leading repeats axis, so every per-layer leaf decays there (norm scales
and biases included) and only 1-d leaves outside the layers, such as
``final_norm.scale``, do not.  The port keeps one dict per layer, so a
leaf's dims are counted as the reference's stacked array has them
(``tree.walk`` gives its repeat).

On a mesh the leaves are DTensors of equal placements (a param, its
gradient, master and moments): the foreach passes run on the local
shards, and the global norm is one reduction over the mesh, each
shard's sum of squares counted once.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial

from repro_torch.dist.sharding import local_shard
from repro_torch.tree import leaves, map_tree, walk

#: leaves per foreach pass are grouped up to this many elements
GROUP_NUMEL = 1 << 26


def adamw_init(params) -> Dict[str, Any]:
    """fp32 master copies (never aliasing an fp32 param) and zeroed
    moments, each on its param's device."""
    f32 = lambda t: map_tree(
        lambda a: a.detach().to(torch.float32, copy=True), t)
    zeros = lambda t: map_tree(
        lambda a: torch.zeros_like(a, dtype=torch.float32,
                                   memory_format=torch.contiguous_format), t)
    return {"master": f32(params), "m": zeros(params), "v": zeros(params)}


def _sum_sq(ls) -> torch.Tensor:
    """The sum of squares of plain tensors, in fp32.  On the card one
    foreach pass; on the CPU a pairwise ``sum`` per leaf, since the CPU's
    norm kernel sums a tensor in one fp32 accumulator (7.5% low over
    233 M elements, qwen2-1.5b's embedding)."""
    if all(t.is_cuda for t in ls):
        sq = torch.stack(torch._foreach_norm(
            ls, 2, dtype=torch.float32)).square()
    else:
        sq = torch.stack([torch.sum(torch.square(t.float())) for t in ls])
    return torch.sum(sq)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, as a plain
    tensor.  DTensor leaves (all on one mesh): a rank sums the local
    shards of the leaves it is the first copy of (coordinate 0 on every
    mesh dim that replicates the leaf), then one all-reduce over the
    mesh adds the ranks' sums."""
    ls = leaves(tree)
    if not any(isinstance(t, DTensor) for t in ls):
        return torch.sqrt(_sum_sq(ls))
    if not all(isinstance(t, DTensor) for t in ls):
        raise TypeError("global_norm: a tree mixes DTensor and plain "
                        "leaves")
    mesh = ls[0].device_mesh
    coord = mesh.get_coordinate()
    mine = [t.to_local() for t in ls
            if all(p.is_shard() or c == 0
                   for p, c in zip(t.placements, coord))]
    dev = ls[0].to_local().device
    part = (_sum_sq(mine) if mine
            else torch.zeros((), dtype=torch.float32, device=dev))
    total = DTensor.from_local(part, mesh, [Partial()] * mesh.ndim,
                               run_check=False).full_tensor()
    return torch.sqrt(total)



def _groups(n_items, numel):
    start, size = 0, 0
    for i in range(n_items):
        if size and size + numel[i] > GROUP_NUMEL:
            yield range(start, i)
            start, size = i, 0
        size += numel[i]
    if start < n_items:
        yield range(start, n_items)


def adamw_update(params, grads, opt, step, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0, donate=False):
    """Returns (new_params, new_opt, metrics).  step is 0-based (an int or
    a 0-d tensor); lr a float or a 0-d tensor.  With ``donate`` the
    params' and the optimizer's tensors are updated in place and returned
    (the reference's jit donates the state); without, copies of them
    are."""
    if not donate:
        params, opt = (map_tree(lambda a: a.clone(), t)
                       for t in (params, opt))
    items = list(walk(params))
    g = leaves(grads)
    if not len(items) == len(g) == len(leaves(opt["master"])):
        raise ValueError("params, grads and optimizer state differ in "
                         "structure")
    # the reference decays a leaf of its stacked layout with ndim > 1
    decay = [leaf.dim() + (rep is not None) > 1 for _, rep, leaf in items]
    gnorm = global_norm(g)
    # the passes below run on the local shards of DTensor leaves
    p = [local_shard(leaf) for _, _, leaf in items]
    g = [local_shard(t) for t in g]
    mw, m, v = ([local_shard(t) for t in leaves(opt[k])]
                for k in ("master", "m", "v"))
    if not len(p) == len(g) == len(mw) == len(m) == len(v):
        raise ValueError("params, grads and optimizer state differ in "
                         "structure")
    scale = (torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
             if grad_clip > 0 else None)
    t = np.float32(int(step) + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    lr = float(lr)

    for idx in _groups(len(p), [x.numel() for x in p]):
        gs = [g[i].float() for i in idx]       # read, never written
        if scale is not None:
            gs = torch._foreach_mul(gs, scale)
        mg, vg, wg = ([m[i] for i in idx], [v[i] for i in idx],
                      [mw[i] for i in idx])
        torch._foreach_mul_(mg, b1)
        torch._foreach_mul_(vg, b2)
        # m = b1*m + (1-b1)*g;  v = b2*v + ((1-b2)*g)*g
        torch._foreach_add_(mg, torch._foreach_mul(gs, 1 - b1))
        sq = torch._foreach_mul(gs, 1 - b2)
        torch._foreach_mul_(sq, gs)
        torch._foreach_add_(vg, sq)
        del sq, gs
        # step = (m / bc1) / (sqrt(v / bc2) + eps) [+ wd * master]
        den = torch._foreach_div(vg, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mg, bc1)
        torch._foreach_div_(upd, den)
        del den
        dec = [j for j, i in enumerate(idx) if decay[i]]
        if dec:
            torch._foreach_add_([upd[j] for j in dec], torch._foreach_mul(
                [wg[j] for j in dec], weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(wg, upd)
        for i, w in zip(idx, wg):
            p[i].copy_(w)
        del upd
    return params, opt, {"grad_norm": gnorm}
