"""Logical-axis sharding rules for every architecture's param tree, and
the data-parallel serving placements: the JAX package's
``dist/sharding.py`` on ``torch.distributed``.

Training.  Each leaf's path (the reference's, ``tree.walk``) is matched
against ``_AXIS_TABLE`` to get logical axis names for its trailing dims,
and ``make_rules`` maps logical names onto mesh axes per execution mode:

  embed (d_model)  -> 'data'   FSDP: gathered around each matmul
  heads/ff/vocab   -> 'model'  tensor parallel
  experts          -> 'model'  expert parallel (the bank's E axis)
  moe_ff / latent  -> None     already covered by EP / too small to cut
  batch            -> 'data' (or ('pod','data') across pods)

A mesh is a ``DeviceMesh`` with the reference's axis names
(``launch/mesh.py``); a spec is ``P``, a tuple of mesh-axis entries per
tensor dim (None: replicated); ``named(mesh, spec)`` is the counterpart
of ``NamedSharding``, whose ``placements`` give, for each mesh dim,
``Shard(d)`` where tensor dim ``d`` names it and ``Replicate()`` else.
An entry such as ``("pod", "data")`` shards one dim over two mesh dims,
major first, as GSPMD does.  The state lives as ``DTensor``s with those
placements, so each rank holds only its shard.

The port keeps a segment as a list of per-repeat dicts (``tree.py``)
where the reference stacks one array along a leading repeats axis.
``logical_axes`` returns the reference's tuple (leading ``"layers"``
included) for each leaf; ``param_specs`` drops the leading entries of a
per-repeat leaf, which ``make_rules`` maps to None, so nothing is lost.

How the step is partitioned.  GSPMD computes the unsharded step's
function from the reference's shardings; the port does so by running
the forward and backward on DTensors, whose ops pick their own
collectives (an FSDP weight is all-gathered around its matmul, a
contraction over a TP dim is a partial sum all-reduced).  Three rules
keep it exact:
  * a tensor the forward makes itself (rope tables, masks, pads,
    zeros) meets a sharded one as a replicated DTensor on its mesh,
    through one helper, ``layers.like``;
  * where DTensor has no rule for an op, or a wrong one, the piece runs
    on local tensors through one helper, ``layers.shard_local``: each
    rank computes its own shard of the dims the piece treats one index
    at a time, with every other dim whole, and says so where it is
    called.  These pieces are the MoE dispatch (the stable sort over
    tokens, ``scatter``, ``gather``, ``index_select``: whole tokens on
    every rank; the expert products stay sharded), the attention core of
    train mode and prefill's ``flash_attention`` (per (batch, head)),
    Mamba2's SSD scan and causal conv, prefill's ``conv1d_tap`` too (per
    batch row), the embedding lookup (per batch row, the table whole)
    and the cross entropy's gather (per position, the vocab whole).
    The kernels take local tensors only.  Each argument is brought to
    the first one's shards (a ``Replicate`` -> ``Shard`` moves no
    data), or named whole.
  * prefill and decode write the caches (``cache_specs`` of the
    per-repeat layout ``lm.init_cache`` makes) through
    ``layers.write``/``write_at``: the new rows placed as the cache,
    each rank writing its own shard (the KV length's, in long-context
    decode).
The micro-batches of gradient accumulation are rows of the *global*
batch (``launch/steps.py``), and AdamW runs its foreach passes on the
local shards with one global norm over the mesh (``optim/adamw.py``).

A dim that its mesh dims do not divide (a micro-batch of 16 rows over
the multi-pod mesh's ('pod', 'data') = 32 ranks; 8 rows over 'data' =
16).  GSPMD pads such an array; DTensor leaves some ranks no rows, or
uneven rows, and its view and matmul rules fail.  Padding with rows is
not exact here: a padded row would enter the MoE's capacity routing,
which competes across tokens, and the loss's mean over rows.  So the
dim is cut over the largest set of its mesh dims whose size divides it
and replicated over the rest (16 rows on (2, 16, 16): over 'data',
replicated over 'pod'), which computes the same function.  One
function decides it, ``fit_placements``, and everything placed by a
spec reads it through ``NamedSharding.placements_for``: the batch
(``place``), each micro-batch (``place_like``) and the activations
(``layers.maybe_constrain``), so they cannot disagree.

Heads that the 'model' axis does not divide (qwen2's 12 query and 2 kv
heads, qwen3's 40, mistral's 96 and every GQA arch's 8 kv heads over a
'model' axis of 16).  DTensor cannot cut a head across ranks, where
GSPMD pads.  So a q/k/v projection cut over 'model' is gathered whole
over it before its reshape into heads (``layers.split_heads``), and the
attention core pads the heads with zeros to a multiple of the axis and
cuts them over it again (``layers.pad_heads``: a local chunk, no data
moved; a zero query head over zero keys gives a zero output, dropped by
``layers.unpad_heads``).  Per rank and attention layer this adds, in the
forward, an all-gather over 'model' of each undivided projection, (B_r,
S, H*D) with B_r the rank's batch rows, and one of the core's output,
(B_r, S, H_p*D) with H_p the padded count; the backward adds their
reduce-scatters.  Memory: those gathered (B_r, S, H*D) tensors, 'model'
times a shard's size, live around the reshape, and the core computes
H_p/H of the heads (16/12 for qwen2).  Prefill's kernel takes the kv
heads repeated to the query heads' count on a mesh (a rank's query
heads need not map onto a whole kv head), another (B_r, S, H*D) each
for k and v; decode attends with the heads whole on every 'model' rank.
Where 'model' divides the heads, nothing of this runs.

Serving.  CNN param trees carry no logical axes: inference params are
replicated wholesale and only the batch axis of each request batch is
cut over the serve mesh (``launch/mesh.make_serve_mesh``), a tuple of
devices.  So a serve placement is a device tuple, and a replicated param
tree is one copy of the tree per mesh device (``Replicated``), made once.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import fill, key, map_tree

# ---------------------------------------------------------------------------
# path -> logical axes for the trailing dims (first match wins)

_AXIS_TABLE = [
    # embeddings / head (lm_head has no bias in any current arch)
    (r"embed/embedding$",            ("vocab", "embed")),
    (r"lm_head/w$",                  ("embed", "vocab")),
    # any norm scale (ln1/ln2/q_norm/k_norm/kv_norm/final_norm/ssm norm)
    (r"scale$",                      ("null",)),
    # attention (GQA + MLA; only the qkv projections carry biases)
    (r"attn/w[qkv]/w$",              ("embed", "heads")),
    (r"attn/w[qkv]/b$",              ("heads",)),
    (r"attn/wo/w$",                  ("heads", "embed")),
    (r"attn/w_dkv/w$",               ("embed", "latent")),
    (r"attn/w_ukv/w$",               ("latent", "heads")),
    # MoE (experts bank leaves are raw (E, a, b) arrays)
    (r"router/w$",                   ("embed", "latent")),
    (r"experts/w[ig]$",              ("experts", "embed", "moe_ff")),
    (r"experts/wo$",                 ("experts", "moe_ff", "embed")),
    # dense / shared-expert SwiGLU MLP (bias-free in every current arch)
    (r"(mlp|shared)/w[ig]/w$",       ("embed", "ff")),
    (r"(mlp|shared)/wo/w$",          ("ff", "embed")),
    # mamba mixer (in-projections and out_proj are bias-free; the
    # depthwise conv taps keep theirs)
    (r"ssm/w(z|x|B|C|dt)/w$",        ("embed", "inner")),
    (r"ssm/conv_[xBC]/w$",           ("null", "inner")),
    (r"ssm/conv_[xBC]/b$",           ("inner",)),
    (r"ssm/(A_log|D|dt_bias)$",      ("null",)),
    (r"ssm/out_proj/w$",             ("inner", "embed")),
]
_AXIS_TABLE = [(re.compile(pat), ax) for pat, ax in _AXIS_TABLE]


class P:
    """A partition spec: one entry per tensor dim, each None
    (replicated), a mesh axis name, or a tuple of them (major first)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _axes_of(path, rep, leaf) -> Tuple[str, ...]:
    """The reference's logical axes of a leaf: its stacked array has one
    more (leading) dim where ``rep`` is set."""
    p = key(path)
    ndim = leaf.dim() + (rep is not None)
    for pat, trailing in _AXIS_TABLE:
        if pat.search(p):
            extra = ndim - len(trailing)
            if extra < 0:
                raise KeyError(f"{p}: rank {ndim} < {trailing}")
            return ("layers",) * extra + tuple(trailing)
    raise KeyError(f"no sharding rule matches param path {p!r}")


def logical_axes(tree) -> Any:
    """Every param leaf -> the reference's tuple of logical axis names
    (a tree of the port's structure whose leaves are tuples).  Raises
    KeyError on any unmatched path."""
    return fill(tree, _axes_of)


# ---------------------------------------------------------------------------
# logical name -> mesh axes per mode

def make_rules(mode: str, multi_pod: bool = False,
               long_context: bool = False) -> Dict[str, Optional[Tuple]]:
    rules: Dict[str, Optional[Tuple]] = {
        "batch": ("pod", "data") if multi_pod else ("data",),
        "seq": None,
        "kv_len": None,
        "layers": None,
        "null": None,
        "embed": ("data",),       # FSDP
        "heads": ("model",),      # TP
        "ff": ("model",),
        "inner": ("model",),
        "vocab": ("model",),
        "experts": ("model",),    # EP
        "moe_ff": None,
        "latent": None,
    }
    if mode == "decode" and long_context:
        # sequence parallelism: the KV length axis takes the data axis,
        # batch (typically 1) is replicated
        rules["batch"] = None
        rules["kv_len"] = ("data",)
    return rules


def _entry(mesh_axes):
    """Rules store mesh axes as tuples; unwrap singletons, as the
    reference does for its PartitionSpec equality."""
    if mesh_axes is None:
        return None
    if isinstance(mesh_axes, tuple) and len(mesh_axes) == 1:
        return mesh_axes[0]
    return mesh_axes


def _spec_of(axis_names, rules) -> P:
    return P(*[_entry(rules.get(a)) for a in axis_names])


def param_specs(shapes, rules) -> Any:
    """A ``P`` tree for a param (shape) tree under the given rules.  A
    per-repeat leaf drops the leading entry of the reference's stacked
    spec (the "layers" rule, None)."""
    def spec(path, rep, leaf):
        s = _spec_of(_axes_of(path, rep, leaf), rules)
        return P(*s.entries[len(s) - leaf.dim():])
    return fill(shapes, spec)


def opt_specs(pspecs) -> Dict[str, Any]:
    """AdamW state mirrors params three ways (master/m/v)."""
    return {"master": pspecs, "m": pspecs, "v": pspecs}


def batch_specs(batch_shapes: Dict[str, Any], rules) -> Dict[str, Any]:
    """Input-batch specs: batch axis sharded, everything else replicated.
    positions may be (3, B, S) for M-RoPE: batch axis is dim 1 there."""
    b = _entry(rules["batch"])
    out = {}
    for k, v in batch_shapes.items():
        if k == "positions" and v.dim() == 3:
            out[k] = P(None, b, None)
        else:
            out[k] = P(b, *([None] * (v.dim() - 1)))
    return out


def cache_specs(cache_shapes, cfg, rules) -> Any:
    """Decode-cache specs of ``lm.cache_shapes`` leaves, (shape, dtype)
    pairs of the reference's (layers, batch, length, ...) arrays.  Dim 2
    of rank>=4 leaves takes the kv_len rule so long-context decode can
    sequence-shard KV caches; SSM conv/state caches take it too, as in
    the reference.

    Given the port's own cache (``lm.init_cache``: per segment a list of
    per-repeat dicts of tensors, what ``lm_forward`` reads as
    ``cache[si][r]["pos{i}"]``), the specs take that layout: each leaf's
    is the stacked leaf's without its leading (repeats) entry."""
    del cfg
    b, kl = _entry(rules["batch"]), _entry(rules.get("kv_len"))

    def spec(shape):
        n = len(shape)
        if n >= 4:        # (layers, batch, length, heads...) caches
            return P(None, b, kl, *([None] * (n - 3)))
        if n >= 2:        # (layers, batch, ...) conv/ssm states
            return P(None, b, *([None] * (n - 2)))
        return P(*([None] * n))

    def walk(node):
        if isinstance(node, torch.Tensor):        # a per-repeat leaf
            return P(*spec((1,) + tuple(node.shape)).entries[1:])
        if (isinstance(node, tuple) and len(node) == 2
                and isinstance(node[1], torch.dtype)):
            return spec(tuple(node[0]))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return type(node)(walk(v) for v in node)
    return walk(cache_shapes)


def fit_placements(mesh, placements, shape) -> tuple:
    """``placements`` for a tensor of ``shape``: a dim cut over mesh
    dims whose sizes' product does not divide it is cut over the largest
    set of them whose product does (the minor dims where two sets tie),
    and replicated over the rest.  Placements that divide come back as
    they are."""
    from torch.distributed.tensor import Replicate
    sizes = tuple(mesh.shape)
    out = list(placements)
    size = lambda dims: math.prod(sizes[i] for i in dims)
    for d in sorted({p.dim for p in placements if p.is_shard()}):
        cut = [i for i, p in enumerate(placements) if p.is_shard(d)]
        if shape[d] % size(cut) == 0:
            continue
        keep = max((c for n in range(len(cut))
                    for c in itertools.combinations(cut, n)
                    if shape[d] % size(c) == 0),
                   key=lambda c: (size(c), c[::-1]))
        for i in cut:
            if i not in keep:
                out[i] = Replicate()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the DTensor placements it stands for.  A mesh
    dim of size 1 cuts nothing and stays ``Replicate`` (DTensor cannot
    flatten a dim of size 1 sharded over it, as a micro-batch of one
    row's matmul does)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.mesh_dim_names
        sizes = tuple(self.mesh.shape)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: the axes of dim {d} must "
                                 f"follow the mesh's order {names}")
            for i in idx:
                if isinstance(out[i], Shard):
                    raise ValueError(f"{self.spec}: mesh axis {names[i]!r} "
                                     f"shards two dims")
                out[i] = Shard(d) if sizes[i] > 1 else out[i]
        return tuple(out)

    def placements_for(self, shape) -> tuple:
        """The placements of a tensor of ``shape`` under this spec
        (``fit_placements``)."""
        return fit_placements(self.mesh, self.placements, shape)


def named(mesh, tree) -> Any:
    """``P`` tree -> ``NamedSharding`` tree on the given mesh."""
    if isinstance(tree, P):
        return NamedSharding(mesh, tree)
    return map_tree(lambda s: NamedSharding(mesh, s), tree)


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the same whole tensor on every rank) as a DTensor with
    ``sharding``'s placements for its shape: each rank keeps its own
    shard, and no rank's data is sent (every rank already holds the
    whole)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh,
                             sharding.placements_for(t.shape),
                             src_data_rank=None)


def place_tree(tree, shardings):
    """``place`` over a tree and its matching ``NamedSharding`` tree."""
    return map_tree(place, tree, shardings)


def place_like(t: torch.Tensor, like):
    """``t`` (the whole value, equal on every rank) placed as the DTensor
    ``like`` is, fitted to ``t``'s shape (``fit_placements``: a
    micro-batch of ``like``'s rows); no data sent.  ``t`` itself where
    ``like`` is plain."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(like, DTensor):
        return t
    return distribute_tensor(
        t.contiguous(), like.device_mesh,
        fit_placements(like.device_mesh, like.placements, t.shape),
        src_data_rank=None)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (gathered; a replicated
    one's is its local tensor, not a copy); a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def device_of(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place ops write the DTensor);
    a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# data-parallel serving (serve/distributed.py)

class Replicated(tuple):
    """A param tree replicated over a mesh: one copy per mesh device, in
    mesh order (copy ``i`` lives on ``mesh[i]``)."""


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def replicated(mesh) -> Tuple[torch.device, ...]:
    """Every device of ``mesh``: each holds a whole copy."""
    return tuple(_device(d) for d in mesh)


def batch_sharded(mesh, ndim: int, axis: str = "data"
                  ) -> Tuple[torch.device, ...]:
    """The devices a rank-``ndim`` batch's leading axis is cut over, in
    row order: device ``i`` takes the ``i``-th contiguous row slice."""
    if ndim < 1:
        raise ValueError(f"batch_sharded needs rank >= 1; got {ndim}")
    return replicated(mesh)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for node in tree for t in _leaves(node)]


def _place(tree, device: torch.device):
    """``tree`` with every tensor on ``device``; the tree itself when
    every tensor is there already (no copy)."""
    if all(t.device == device for t in _leaves(tree)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return tree


def is_replicated_on(tree, mesh) -> bool:
    """True when ``tree`` is already a ``Replicated`` tree over exactly
    ``mesh``'s devices (so replicating it again would be a re-transfer,
    not a placement)."""
    devs = replicated(mesh)
    return (isinstance(tree, Replicated) and len(tree) == len(devs)
            and all(all(t.device == d for t in _leaves(copy))
                    for copy, d in zip(tree, devs)))


def replicate_params(params, mesh: Sequence) -> Replicated:
    """Replicate an inference param tree onto ``mesh`` ONCE.

    A tree already replicated on this mesh passes through untouched, and
    a copy for a device the tree already lies on is the tree itself, so
    layers sharing one param tree (a dispatcher handing the same tree to
    several geometries' bucket programs) copy it at most once per device
    however many times this is called."""
    if is_replicated_on(params, mesh):
        return params
    return Replicated(_place(params, d) for d in replicated(mesh))
