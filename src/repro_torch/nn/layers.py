"""Core layers: functional init/apply over plain dicts of tensors.

The JAX package's convention, kept so params carry across by name:
``*_init`` returns a dict of tensors, ``*_fwd`` consumes it.  Init draws
from a ``torch.Generator`` on the device the params live on; dense
weights default to bf16, norm scales stay fp32.

Mixed dtypes: JAX promotes bf16 x fp32 inside a product, where
``torch.matmul`` and ``torch.einsum`` raise; ``promote`` casts both
operands to the type JAX would compute in.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

DEFAULT_DTYPE = torch.bfloat16


def promote(*ts):
    """The operands cast to their common type (bf16 x fp32 -> fp32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def randn(gen: torch.Generator, shape, scale: float, dtype):
    if gen.device.type == "meta":         # shapes only (lm.init_lm)
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * scale).to(dtype)


def maybe_constrain(x, spec):
    """The reference's ``with_sharding_constraint``: pin an activation
    to ``spec``, a ``dist.sharding.NamedSharding`` (None: unconstrained,
    on one device), fitted to its shape as the batch it came from was
    (``placements_for``: a micro-batch of fewer rows than the batch
    ranks is replicated over the ranks it does not divide over).  ``x``
    must be a DTensor on the spec's mesh: a step asked to run on a mesh
    never quietly runs unsharded."""
    if spec is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"an activation spec {spec!r} needs a DTensor "
                        f"activation; got a {type(x).__name__}")
    return x.redistribute(spec.mesh, spec.placements_for(x.shape))


def like(t, ref):
    """``t``, a tensor the forward made itself (a rope table, a mask, a
    pad, zeros), as a replicated DTensor on ``ref``'s mesh where ``ref``
    is a DTensor; ``t`` itself otherwise.  Every rank makes the same
    ``t``, so no data moves."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def shard_local(fn, *args, dims=(0,), whole=()):
    """``fn`` run on each rank's shard of the tensor dims ``dims``: for a
    function that treats each index of those dims alone (the batch rows
    of the SSD scan; the (batch, head) pairs of attention), or, with
    ``dims=()``, on the whole of every argument on every rank (the MoE
    dispatch).  For the ops DTensor has no rule for (or a wrong one),
    named where each call is made.

    Every DTensor argument is brought to the first one's shards of
    ``dims`` and made whole on every other mesh dim: a ``Replicate`` ->
    ``Shard`` is a local chunk and moves no data.  The arguments at the
    positions ``whole`` (a table the rows index, a conv's taps) are
    whole on every rank instead.  A gradient comes back in its
    argument's shards; a whole argument's is the sum over the ranks
    that split the work (``Partial``).  Tensor outputs come back placed
    as the first DTensor argument.  Plain arguments run ``fn``
    directly."""
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    place = [p if p.is_shard() and p.dim % ref.dim() in dims
             else Replicate() for p in ref.placements]
    locs = []
    for i, a in enumerate(args):
        if not isinstance(a, DTensor):
            locs.append(a)
            continue
        keep = ([Replicate()] * mesh.ndim if i in whole else place)
        grad = [p if p.is_shard() else Partial() if q.is_shard()
                else Replicate() for p, q in zip(keep, place)]
        locs.append(a.redistribute(placements=keep).to_local(
            grad_placements=grad))
    out = fn(*locs)
    wrap = (lambda t: DTensor.from_local(t, mesh, place, run_check=False)
            if isinstance(t, torch.Tensor) else t)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def split_heads(t, n: int, d: int):
    """(B, S, n*d) -> (B, S, n, d).  On a mesh, where the last dim is cut
    over mesh dims whose size does not divide ``n`` (qwen2's 12 query
    and 2 kv heads over a 'model' axis of 16), those dims are gathered
    first: DTensor cannot cut a head across ranks, where GSPMD pads.
    ``pad_heads`` then splits the heads again for the attention core."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        cut = [i for i, p in enumerate(t.placements)
               if p.is_shard() and p.dim % t.dim() == last]
        if n % int(np.prod([t.device_mesh.shape[i] for i in cut])):
            t = t.redistribute(placements=[
                Replicate() if i in cut else p
                for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], n, d)


def merge_heads(t, n: int):
    """(B, S, n, d) -> (B, S, n*d), the inverse of ``split_heads``.  On
    a mesh, where a mesh dim of a size that does not divide ``n`` leaves
    the result whole, the result is cut over it on its last dim (a local
    chunk), so the backward gathers the gradient there before it splits
    it into heads: DTensor (torch 2.11) cannot split a cut dim into
    heads it does not divide."""
    B, S = t.shape[0], t.shape[1]
    out = t.reshape(B, S, -1)
    if isinstance(out, DTensor):
        sizes = out.device_mesh.shape
        last = out.dim() - 1
        place = [Shard(last) if not p.is_shard() and sizes[i] > 1
                 and n % sizes[i] and out.shape[last] % sizes[i] == 0
                 else p for i, p in enumerate(out.placements)]
        if tuple(place) != tuple(out.placements):
            out = out.redistribute(placements=place)
    return out


def _free_dims(t):
    """The mesh dims of size > 1 that cut none of a DTensor's dims."""
    return [i for i, (p, size) in enumerate(zip(t.placements,
                                                t.device_mesh.shape))
            if size > 1 and not p.is_shard()]


def pad_heads(*ts, dim=2):
    """(B, S, H, D) DTensors -> the same with their heads zero-padded to a
    multiple of the mesh dims that cut none of the first one's dims, and
    cut over them (a local chunk: no data moves), so an attention core
    run per (batch, head) (``shard_local``) is split over every rank.
    Returns the tensors and H.  A zero query head over zero keys gives a
    zero output that ``unpad_heads`` drops.  Plain tensors, heads already
    cut (over 'model', which divides them), or no free mesh dim pass
    through.  The pad, and ``unpad_heads``'s narrow, run on the local
    tensors: torch 2.11's DTensor gives either op on a 2-D mesh a spec
    of one placement."""
    H = ts[0].shape[dim]
    t0 = ts[0]
    if (not isinstance(t0, DTensor) or not _free_dims(t0)
            or any(p.is_shard(dim) for p in t0.placements)):
        return ts, H
    free = _free_dims(t0)
    n = int(np.prod([t0.device_mesh.shape[i] for i in free]))
    pad = (-H) % n
    out = []
    for t in ts:
        if pad:
            t = DTensor.from_local(
                F.pad(t.to_local(), (0, 0) * (t.dim() - 1 - dim) + (0, pad)),
                t.device_mesh, t.placements, run_check=False)
        out.append(t.redistribute(placements=[
            Shard(dim) if i in free else p
            for i, p in enumerate(t.placements)]))
    return tuple(out), H


def unpad_heads(t, H: int, dim=2):
    """The first ``H`` heads of a ``pad_heads`` result: where it padded,
    whole on the mesh dims it cut them over (an all-gather); else ``t``
    as it is (heads cut evenly)."""
    if not isinstance(t, DTensor) or t.shape[dim] == H:
        return t
    t = t.redistribute(placements=[
        Replicate() if p.is_shard(dim) else p for p in t.placements])
    return DTensor.from_local(t.to_local().narrow(dim, 0, H), t.device_mesh,
                              t.placements, run_check=False)


def write(dst, src):
    """``dst.copy_(src)``, a cache write.  On a mesh ``src`` is first
    placed as ``dst`` is: an in-place op cannot change its target's
    placements."""
    if (isinstance(dst, DTensor) and isinstance(src, DTensor)
            and src.placements != dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    return dst.copy_(src)


def write_at(buf, dim: int, index, src):
    """``buf.index_copy_(dim, index, src)``, the decode step's cache
    write.  On a mesh each rank writes its own shard of ``buf``: where
    ``dim`` is cut (the KV length of long-context decode), a rank whose
    shard the index misses writes back what it holds."""
    if not isinstance(buf, DTensor):
        return buf.index_copy_(dim, index, src)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = buf.device_mesh
    shape, off = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    keep = [Replicate() if p.is_shard(dim) else p for p in buf.placements]
    s = src.redistribute(mesh, keep).to_local()
    idx = index.to_local() if isinstance(index, DTensor) else index
    loc = buf.to_local()
    if shape[dim] == buf.shape[dim]:
        loc.index_copy_(dim, idx, s)
    elif shape[dim]:
        rel = idx - off[dim]
        hit = ((rel >= 0) & (rel < shape[dim])).view(
            [-1 if i == dim else 1 for i in range(loc.dim())])
        rel = rel.clamp(0, shape[dim] - 1)
        loc.index_copy_(dim, rel, torch.where(
            hit, s, loc.index_select(dim, rel)))
    return buf


def dense_init(gen, d_in, d_out, dtype=DEFAULT_DTYPE, bias=False,
               scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"w": randn(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_fwd(p, x):
    y = torch.matmul(*promote(x, p["w"]))
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_fwd(p, x, eps=1e-5, impl="f32"):
    if impl == "stat_f32":
        # fp32 only for the variance reduction; the normalize multiply and
        # the scale stay in x.dtype
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def embed_init(gen, vocab, d, dtype=DEFAULT_DTYPE):
    return {"embedding": randn(gen, (vocab, d), 0.02, dtype)}


def embed_fwd(p, ids):
    # on a mesh on each rank's batch rows, the table whole (torch 2.11's
    # DTensor cannot place the index_put of the lookup's backward)
    return shard_local(lambda i, w: w[i], ids, p["embedding"], whole=(1,))


def mlp_init(gen, d, d_ff, dtype=DEFAULT_DTYPE):
    return {"wi": dense_init(gen, d, d_ff, dtype),
            "wg": dense_init(gen, d, d_ff, dtype),
            "wo": dense_init(gen, d_ff, d, dtype)}


def mlp_fwd(p, x):
    """SwiGLU MLP (gate * silu(up))."""
    h = F.silu(dense_fwd(p["wi"], x)) * dense_fwd(p["wg"], x)
    return dense_fwd(p["wo"], h)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)

def rope_freqs(head_dim, theta, device="cpu"):
    """fp32 (head_dim/2,) inverse frequencies, computed in float64 as the
    reference's numpy does, on ``device`` (a host table copied to the
    card would synchronize the stream on every call)."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
    return (1.0 / theta ** (i / head_dim)).float()


def apply_rope(x, positions, theta=1e6, sections=(), impl="f32"):
    """x: (..., L, H, D). positions: (B, L) or (3, B, L) for M-RoPE.

    M-RoPE (qwen2-vl): the head_dim/2 frequency slots are split into
    ``sections`` (t, h, w); each section takes its angle from the matching
    row of the 3-axis position ids.  impl="bf16" rotates in x.dtype
    (angles still fp32).
    """
    d = x.shape[-1]
    freqs = like(rope_freqs(d, theta, x.device), x)              # (d/2,)
    if positions.dim() == 3 and sections:
        sec_id = like(torch.cat([torch.full((s,), i, device=x.device)
                                 for i, s in enumerate(sections)]), x)
        pos = positions[sec_id]                                  # (d/2, B, L)
        ang = pos.float().permute(1, 2, 0) * freqs               # (B, L, d/2)
    else:
        ang = positions[..., None].float() * freqs               # (B, L, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if impl == "bf16":
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    cos = cos[..., None, :]                                      # (B, L, 1, d/2)
    sin = sin[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def make_positions(batch, seq, offset=0, device="cpu"):
    """(batch, seq) int32 positions from ``offset``: an int, or a 0-d
    int64 tensor on ``device`` (the decode step's traced offset)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    return (pos + offset).expand(batch, seq)
