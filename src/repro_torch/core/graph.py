"""Typed operator-IR graph layer: plan a whole network once, serve it.

  OpSpec      typed IR node, one frozen dataclass per operator:
              ConvOp (a ConvSpec — including grouped/depthwise),
              PoolOp (max/avg), AddOp (residual, optional ReLU),
              ConcatOp (channel axis), GapOp, DenseOp.  Nodes are
              *named* and name their input edges explicitly.
  Graph       a DAG of OpSpec nodes in topological order, shape-checked
              at construction.  ``signature()`` is its stable identity
              (the same string as the JAX package's for the same graph).
  ConvGraph   the chain-era constructor (``ConvGraph.chain``), lowered
              to a Graph of conv nodes ``conv0..convN`` by ``to_ir()``.
  fuse_graph  folds residual adds and conv->pool chains into the
              producing conv's epilogue (11 -> 8 nodes on resnet_like).
  GraphPlan   per-conv-node ConvPlans resolved ONCE (keyed by node
              name), one ``explain()`` table, ``warmup()`` (which also
              runs the measured sweep, ``tune=``), ``run()``.
              Each node runs as a plain call: PyTorch is eager, so the
              JAX package's per-node ``jax.jit`` has no counterpart.
  plan_graph  resolves a GraphPlan (of a Graph or a ConvGraph),
              consulting a persisted graph-level cache
              (``$REPRO_CACHE_DIR/torch/graphplans.json``) keyed by
              backend + signature — a warm process builds the whole
              program with ZERO per-node plan() resolutions.
  PrecisionPolicy
              graph-wide compute dtype (default + per-node overrides)
              landing in each conv node's ``ConvSpec.dtype``; its
              subclass ``quant.QuantPolicy`` also quantizes conv nodes to
              int8 (``plan_graph(quant=...)``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
import time
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.core.convspec import (ConvPlan, ConvSpec, canonical_dtype,
                                       default_backend, normalize_pad,
                                       normalize_stride, out_size, plan,
                                       resolve_config, resolve_device,
                                       torch_dtype)
from repro_torch.core.plancache import JsonCache


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Graph-wide compute-dtype policy: one default plus per-node
    overrides (``PrecisionPolicy("bf16", overrides={"stem": "fp32"})``).

    The policy lands in each conv node's ``ConvSpec.dtype``, so every
    cache key is precision-distinct.  Master params stay fp32;
    executors cast operands to the node dtype and accumulate in fp32.
    """
    default: str = "float32"
    overrides: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "default", canonical_dtype(self.default))
        ovr = self.overrides
        if isinstance(ovr, Mapping):
            ovr = tuple(sorted(ovr.items()))
        object.__setattr__(self, "overrides", tuple(
            (str(name), canonical_dtype(dt)) for name, dt in ovr))

    @classmethod
    def of(cls, value) -> "PrecisionPolicy":
        """Coerce policy | dtype spelling | None (fp32) into a policy."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        return cls(canonical_dtype(value))

    def dtype_for(self, node_name: str) -> str:
        for name, dt in self.overrides:
            if name == node_name:
                return dt
        return self.default

    def key(self) -> str:
        """Stable identity for plan-memo keys."""
        if not self.overrides:
            return self.default
        ovr = ",".join(f"{n}={d}" for n, d in self.overrides)
        return f"{self.default}[{ovr}]"

    def quantizer(self):
        """The quantization policy riding this precision policy, or None.

        Plain precision policies never quantize; ``quant.QuantPolicy``
        (a subclass) returns itself, and ``GraphModel.graph_plan`` hands
        it to ``plan_graph(quant=...)``."""
        return None


# Persisted graph-plan entry schema (the JAX package's v2):
# {"schema": 2, "rules": PLAN_RULES, "algorithms": {node_name: algo}}
GRAPH_SCHEMA = 2
# The version of the rules that fold and place conv nodes: an entry
# persisted under other rules is re-resolved, not replayed (its
# algorithms may still be capable, only no longer chosen).  Kept apart
# from GRAPH_SCHEMA, which is part of ``Graph.signature()``.
# 2: a pool folds only into a kernel that fuses it; unit-stride KxK
# convs outside 3x3 claim the fused kernel on the card.
PLAN_RULES = 2

# graph-level plan cache: {f"{backend}/{signature}": entry}
_STORE = JsonCache("graphplans.json")


def clear_cache() -> None:
    """Drop the in-memory mirror (tests); the JSON file is untouched."""
    _STORE.clear()


# ---------------------------------------------------------------------------
# the operator IR

_NAME_RE = re.compile(r"[A-Za-z0-9_.\-]+")


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Base IR node: a named operator with explicit input edges."""
    name: str
    inputs: Tuple[str, ...]

    op = "op"                    # overridden per subclass

    def __post_init__(self):
        # names are signature key material: restrict them to a charset
        # disjoint from descriptor() delimiters so signatures can never
        # be ambiguous
        for n in (self.name,) + tuple(self.inputs):
            if not _NAME_RE.fullmatch(n):
                raise ValueError(f"node/edge names must match "
                                 f"[A-Za-z0-9_.-]+; got {n!r}")
        if not self.inputs:
            raise ValueError(f"node {self.name!r} has no inputs")

    # -- IR contract per subclass ---------------------------------------
    def infer_shape(self, in_shapes: Sequence[Tuple[int, ...]]) -> Tuple:
        raise NotImplementedError

    def descriptor(self) -> str:
        """Stable per-node key material (feeds Graph.signature())."""
        return f"{self.op}:{self.name}<{','.join(self.inputs)}>"


@dataclasses.dataclass(frozen=True)
class ConvOp(OpSpec):
    """A planned convolution node (the only node kind plan() resolves).

    A spec carrying a cross-layer ``fused_add`` (the fusion pass's
    residual fold) takes a SECOND input edge — the shortcut operand,
    shape-checked against the conv's output shape; a ``fused_pool``
    spec keeps one input but yields the pooled ``final_shape``.
    """
    spec: ConvSpec = None

    op = "conv"

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.spec, ConvSpec):
            raise ValueError(f"conv node {self.name!r} needs a ConvSpec")
        want = 2 if self.spec.fused_add != "none" else 1
        if len(self.inputs) != want:
            raise ValueError(
                f"conv node {self.name!r} takes exactly {want} input(s) "
                f"(fused_add={self.spec.fused_add!r}); got {self.inputs}")

    def infer_shape(self, in_shapes):
        s = in_shapes[0]
        if tuple(s) != self.spec.in_shape:
            raise ValueError(f"conv node {self.name!r} expects input shape "
                             f"{self.spec.in_shape} but edge "
                             f"{self.inputs[0]!r} produces {tuple(s)}")
        if self.spec.fused_add != "none":
            a = tuple(in_shapes[1])
            if a != self.spec.out_shape:
                raise ValueError(
                    f"conv node {self.name!r}: fused-add operand "
                    f"{self.inputs[1]!r} has shape {a} but the conv "
                    f"produces {self.spec.out_shape}")
        return self.spec.final_shape

    def descriptor(self):
        return f"{super().descriptor()}:{self.spec.key()}"


@dataclasses.dataclass(frozen=True)
class PoolOp(OpSpec):
    """Windowed max/avg pooling (NHWC)."""
    kind: str = "max"                         # max | avg
    window: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)

    op = "pool"

    def __post_init__(self):
        super().__post_init__()
        if self.kind not in ("max", "avg"):
            raise ValueError(f"pool node {self.name!r}: kind must be "
                             f"'max' or 'avg'; got {self.kind!r}")
        if len(self.inputs) != 1:
            raise ValueError(f"pool node {self.name!r} takes exactly one "
                             f"input; got {self.inputs}")

    def infer_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 4:
            raise ValueError(f"pool node {self.name!r} needs an NHWC "
                             f"input; got shape {tuple(s)}")
        n, h, w, c = s
        (kh, kw), (sh, sw), (ph, pw) = self.window, self.stride, self.padding
        oh, ow = out_size(h, kh, ph, sh), out_size(w, kw, pw, sw)
        if oh <= 0 or ow <= 0:
            raise ValueError(f"pool node {self.name!r} produces empty "
                             f"output from input {tuple(s)}")
        return (n, oh, ow, c)

    def descriptor(self):
        return (f"{super().descriptor()}:{self.kind}{self.window[0]}x"
                f"{self.window[1]}s{self.stride[0]}x{self.stride[1]}"
                f"p{self.padding[0]}x{self.padding[1]}")


@dataclasses.dataclass(frozen=True)
class AddOp(OpSpec):
    """Elementwise sum of >= 2 same-shape inputs (residual connections);
    optional fused ReLU after the add (the post-residual activation)."""
    activation: str = "none"                  # none | relu

    op = "add"

    def __post_init__(self):
        super().__post_init__()
        if len(self.inputs) < 2:
            raise ValueError(f"add node {self.name!r} needs >= 2 inputs")
        if self.activation not in ("none", "relu"):
            raise ValueError(f"add node {self.name!r}: activation must be "
                             f"'none' or 'relu'; got {self.activation!r}")

    def infer_shape(self, in_shapes):
        first = tuple(in_shapes[0])
        for edge, s in zip(self.inputs, in_shapes):
            if tuple(s) != first:
                raise ValueError(
                    f"add node {self.name!r}: input {edge!r} has shape "
                    f"{tuple(s)} but {self.inputs[0]!r} has {first}")
        return first

    def descriptor(self):
        return f"{super().descriptor()}:{self.activation}"


@dataclasses.dataclass(frozen=True)
class ConcatOp(OpSpec):
    """Channel-axis concatenation (fire-module expand branches)."""

    op = "concat"

    def __post_init__(self):
        super().__post_init__()
        if len(self.inputs) < 2:
            raise ValueError(f"concat node {self.name!r} needs >= 2 inputs")

    def infer_shape(self, in_shapes):
        lead = tuple(in_shapes[0][:-1])
        for edge, s in zip(self.inputs, in_shapes):
            if tuple(s[:-1]) != lead:
                raise ValueError(
                    f"concat node {self.name!r}: input {edge!r} has "
                    f"non-channel dims {tuple(s[:-1])} but "
                    f"{self.inputs[0]!r} has {lead}")
        return lead + (sum(int(s[-1]) for s in in_shapes),)


@dataclasses.dataclass(frozen=True)
class GapOp(OpSpec):
    """Global average pool: (N, H, W, C) -> (N, C) (the classifier neck)."""

    op = "gap"

    def __post_init__(self):
        super().__post_init__()
        if len(self.inputs) != 1:
            raise ValueError(f"gap node {self.name!r} takes exactly one "
                             f"input; got {self.inputs}")

    def infer_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 4:
            raise ValueError(f"gap node {self.name!r} needs an NHWC "
                             f"input; got shape {tuple(s)}")
        return (s[0], s[3])


@dataclasses.dataclass(frozen=True)
class DenseOp(OpSpec):
    """Linear head: (N, C) @ (C, K) [+ b] -> (N, K)."""
    features: Tuple[int, int] = None          # (c_in, c_out)
    bias: bool = True

    op = "dense"

    def __post_init__(self):
        super().__post_init__()
        if (not isinstance(self.features, tuple) or len(self.features) != 2
                or any(int(f) < 1 for f in self.features)):
            raise ValueError(f"dense node {self.name!r} needs features="
                             f"(c_in, c_out); got {self.features!r}")
        if len(self.inputs) != 1:
            raise ValueError(f"dense node {self.name!r} takes exactly one "
                             f"input; got {self.inputs}")

    def infer_shape(self, in_shapes):
        (s,) = in_shapes
        if len(s) != 2 or int(s[1]) != self.features[0]:
            raise ValueError(f"dense node {self.name!r} needs input "
                             f"(N, {self.features[0]}); got {tuple(s)}")
        return (s[0], self.features[1])

    def descriptor(self):
        return (f"{super().descriptor()}:{self.features[0]}x"
                f"{self.features[1]}:bias={int(self.bias)}")


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    """A DAG of named OpSpec nodes over one graph input.

    ``nodes`` must be in topological order (every edge names the graph
    input or an earlier node — which also rules out cycles); shapes are
    inferred and checked edge-by-edge at construction.  ``output`` names
    the node whose value ``run`` returns (default: the last node).
    """
    nodes: Tuple[OpSpec, ...]
    in_shape: Tuple[int, ...]
    input_name: str = "input"
    output: Optional[str] = None

    def __post_init__(self):
        if not self.nodes:
            raise ValueError("Graph needs at least one node")
        shapes: Dict[str, Tuple[int, ...]] = {
            self.input_name: tuple(map(int, self.in_shape))}
        for node in self.nodes:
            if node.name in shapes:
                raise ValueError(f"duplicate node name {node.name!r}")
            missing = [e for e in node.inputs if e not in shapes]
            if missing:
                raise ValueError(
                    f"node {node.name!r} consumes undefined edge(s) "
                    f"{missing}: nodes must be listed after their inputs "
                    f"(topological order; cycles are impossible)")
            shapes[node.name] = node.infer_shape(
                [shapes[e] for e in node.inputs])
        out = self.output if self.output is not None else self.nodes[-1].name
        if out not in shapes or out == self.input_name:
            raise ValueError(f"output {out!r} is not a node of the graph")
        object.__setattr__(self, "output", out)
        object.__setattr__(self, "shapes", shapes)

    # -- derived ---------------------------------------------------------
    @property
    def out_shape(self) -> Tuple[int, ...]:
        return self.shapes[self.output]

    @property
    def conv_nodes(self) -> Tuple[ConvOp, ...]:
        return tuple(n for n in self.nodes if isinstance(n, ConvOp))

    def node(self, name: str) -> OpSpec:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def signature(self) -> str:
        """Stable graph identity: schema-versioned key material for the
        persisted plan cache."""
        blob = "|".join(
            [f"v{GRAPH_SCHEMA}", f"in{tuple(self.in_shape)}",
             f"out:{self.output}"] + [n.descriptor() for n in self.nodes])
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def __len__(self) -> int:
        return len(self.nodes)


class GraphBuilder:
    """Incremental Graph construction with shape threading.

    Each method appends one named node consuming named edges and returns
    the node name, so network definitions read as dataflow:

        b = GraphBuilder((1, 32, 32, 3))
        y = b.conv("stem", "input", 3, 16)
        y = b.pool("pool", y)
        ...
        b.graph()

    Shapes are tracked as nodes are added (conv specs are derived from
    the producer's shape), and the finished ``Graph`` re-validates the
    whole DAG at construction.
    """

    def __init__(self, in_shape, dtype: Union[str, PrecisionPolicy] = "float32",
                 input_name: str = "input"):
        self.in_shape = tuple(map(int, in_shape))
        # ``dtype`` accepts a plain dtype string (every node) or a
        # PrecisionPolicy (default + per-node overrides); model builders
        # pass through whatever GraphModel.graph hands them
        self.precision = PrecisionPolicy.of(dtype)
        self.input_name = input_name
        self.nodes: List[OpSpec] = []
        self.shapes: Dict[str, Tuple[int, ...]] = {
            input_name: self.in_shape}

    @property
    def dtype(self) -> str:
        return self.precision.default

    def _put(self, node: OpSpec) -> str:
        self.shapes[node.name] = node.infer_shape(
            [self.shapes[e] for e in node.inputs])
        self.nodes.append(node)
        return node.name

    def conv(self, name: str, src: str, k, c_out: int, *, stride=1,
             padding="same", epilogue: str = "bias_relu",
             groups: int = 1) -> str:
        kh, kw = (k, k) if isinstance(k, int) else k
        in_shape = self.shapes[src]
        spec = ConvSpec(in_shape, (kh, kw, in_shape[3] // groups, c_out),
                        normalize_stride(stride),
                        normalize_pad(padding, kh, kw),
                        self.precision.dtype_for(name), epilogue, groups)
        return self._put(ConvOp(name, (src,), spec))

    def pool(self, name: str, src: str, *, kind: str = "max", window=2,
             stride=None, padding=0) -> str:
        win = (window, window) if isinstance(window, int) else tuple(window)
        stride = win if stride is None else (
            (stride, stride) if isinstance(stride, int) else tuple(stride))
        pad = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)
        return self._put(PoolOp(name, (src,), kind, win, stride, pad))

    def add(self, name: str, srcs: Sequence[str], *,
            activation: str = "none") -> str:
        return self._put(AddOp(name, tuple(srcs), activation))

    def concat(self, name: str, srcs: Sequence[str]) -> str:
        return self._put(ConcatOp(name, tuple(srcs)))

    def gap(self, name: str, src: str) -> str:
        return self._put(GapOp(name, (src,)))

    def dense(self, name: str, src: str, c_out: int, *,
              bias: bool = True) -> str:
        c_in = int(self.shapes[src][-1])
        return self._put(DenseOp(name, (src,), (c_in, c_out), bias))

    def graph(self, output: Optional[str] = None) -> Graph:
        # a precision override that names no CONV node is a typo (or a
        # pool/add/dense node, which carries no planned dtype) and would
        # silently no-op — exactly the numerics it was written to protect
        convs = {n.name for n in self.nodes if isinstance(n, ConvOp)}
        ghosts = [n for n, _ in self.precision.overrides if n not in convs]
        if ghosts:
            raise ValueError(
                f"PrecisionPolicy overrides name non-conv node(s) "
                f"{ghosts}; only conv nodes plan a dtype — conv nodes "
                f"here: {sorted(convs)}")
        return Graph(tuple(self.nodes), self.in_shape,
                     self.input_name, output)


# ---------------------------------------------------------------------------
# the chained-ConvSpec constructor, lowering to the IR

LayerSpec = Tuple[int, int, int, int]          # (kh, kw, c_out, stride)


@dataclasses.dataclass(frozen=True)
class ConvGraph:
    """Ordered chain of ConvSpec nodes (the pre-IR graph API).

    ``plan_graph`` lowers it to a ``Graph`` of conv nodes named
    ``conv0..convN`` via ``to_ir()``.
    """
    nodes: Tuple[ConvSpec, ...]

    def __post_init__(self):
        if not self.nodes:
            raise ValueError("ConvGraph needs at least one node")
        for a, b in zip(self.nodes, self.nodes[1:]):
            if a.out_shape != b.in_shape:
                raise ValueError(f"graph chain broken: {a.key()} produces "
                                 f"{a.out_shape} but next node consumes "
                                 f"{b.in_shape}")

    @classmethod
    def chain(cls, layers: Sequence[LayerSpec], in_shape, *,
              padding="same", dtype: str = "float32",
              epilogue: Union[str, Sequence[str]] = "bias_relu"
              ) -> "ConvGraph":
        """Derive the spec chain from a layer list + input geometry.

        ``layers`` uses the SimpleCNN convention ``(kh, kw, c_out,
        stride)``; each node's output geometry feeds the next node.
        ``epilogue`` is one epilogue for every layer, or a per-layer
        sequence.
        """
        if isinstance(epilogue, str):
            epilogues = [epilogue] * len(layers)
        else:
            epilogues = list(epilogue)
            if len(epilogues) != len(layers):
                raise ValueError(f"epilogue sequence has {len(epilogues)} "
                                 f"entries for {len(layers)} layers")
        n, h, w, c = map(int, in_shape)
        nodes: List[ConvSpec] = []
        for (kh, kw, co, s), epi in zip(layers, epilogues):
            spec = ConvSpec((n, h, w, c), (kh, kw, c, co),
                            normalize_stride(s),
                            normalize_pad(padding, kh, kw), dtype, epi)
            nodes.append(spec)
            _, h, w, c = spec.out_shape
        return cls(tuple(nodes))

    @property
    def in_shape(self) -> Tuple[int, int, int, int]:
        return self.nodes[0].in_shape

    @property
    def out_shape(self) -> Tuple[int, int, int, int]:
        return self.nodes[-1].out_shape

    def to_ir(self) -> Graph:
        """Lower the chain to the operator IR: conv nodes ``conv{i}``,
        each consuming its predecessor."""
        prev, ops = "input", []
        for i, spec in enumerate(self.nodes):
            name = f"conv{i}"
            ops.append(ConvOp(name, (prev,), spec))
            prev = name
        return Graph(tuple(ops), self.in_shape)

    def signature(self) -> str:
        """The lowered IR's signature: chain callers and IR callers share
        one cache namespace."""
        return self.to_ir().signature()

    def __len__(self) -> int:
        return len(self.nodes)


GraphLike = Union[Graph, ConvGraph]


def _as_ir(graph: GraphLike) -> Graph:
    return graph.to_ir() if isinstance(graph, ConvGraph) else graph


# ---------------------------------------------------------------------------
# cross-layer fusion pass

def fuse_graph(graph: Graph, backend: Optional[str] = None
               ) -> Tuple[Graph, Dict[str, str]]:
    """Planning-time IR rewrite: fold fusable consumers into conv nodes.

    Two rewrite rules, applied to fixpoint:

      add   An ``AddOp`` over two edges where one producer is a conv
            with no other consumer, no existing fusion, and epilogue
            ``none``/``bias`` folds into that conv (latest such producer
            in topological order wins).  The conv absorbs the add's
            activation (``fused_add="add"|"add_relu"``), gains the OTHER
            edge as a second input, and moves to the add's slot.
      pool  A ``PoolOp`` whose single-consumer conv producer has no
            existing fusion folds into the conv as ``fused_pool``.

    An add only fires when some registered executor ``supports()`` the
    fused spec, a pool only when some executor fuses it in its kernel
    (``executors.fusing``): the others run the pool after the bare conv,
    so the fold would gain nothing and keep the conv off the kernels
    that run it unfused.  Neither fires where a persisted measurement
    has ruled the fusion a loss (``autotune.fusion_verdict``).  No
    ``plan()`` resolution happens here.  Returns ``(fused_graph,
    provenance)`` where provenance maps each fused conv node name to
    ``"add:<consumed>"`` / ``"pool:<consumed>"``; the original graph
    object comes back unchanged when nothing fuses.
    """
    from repro_torch.core import autotune, executors
    backend = backend or default_backend()
    nodes: List[OpSpec] = list(graph.nodes)
    output = graph.output
    fused: Dict[str, str] = {}

    def _rename(ns: List[OpSpec], old: str, new: str) -> List[OpSpec]:
        out = []
        for n in ns:
            if old in n.inputs:
                n = dataclasses.replace(n, inputs=tuple(
                    new if e == old else e for e in n.inputs))
            out.append(n)
        return out

    progress = True
    while progress:
        progress = False
        counts: Dict[str, int] = {}
        for n in nodes:
            for e in n.inputs:
                counts[e] = counts.get(e, 0) + 1
        counts[output] = counts.get(output, 0) + 1   # graph output consumes
        index = {n.name: i for i, n in enumerate(nodes)}
        for i, node in enumerate(nodes):
            if isinstance(node, AddOp) and len(node.inputs) == 2:
                best = None
                for pos, e in enumerate(node.inputs):
                    j = index.get(e)
                    if j is None:                    # the graph input
                        continue
                    prod = nodes[j]
                    if (not isinstance(prod, ConvOp)
                            or counts.get(e, 0) != 1
                            or prod.spec.has_fusion
                            or prod.spec.epilogue not in ("none", "bias")):
                        continue
                    if best is None or j > best[0]:
                        best = (j, pos)
                if best is None:
                    continue
                j, pos = best
                conv = nodes[j]
                mode = "add_relu" if node.activation == "relu" else "add"
                spec = dataclasses.replace(conv.spec, fused_add=mode)
                new_inputs = (conv.inputs[0], node.inputs[1 - pos])
                kind = "add"
            elif isinstance(node, PoolOp):
                j = index.get(node.inputs[0])
                if j is None:
                    continue
                conv = nodes[j]
                if (not isinstance(conv, ConvOp)
                        or counts.get(node.inputs[0], 0) != 1
                        or conv.spec.has_fusion):
                    continue
                spec = dataclasses.replace(
                    conv.spec,
                    fused_pool=(node.kind,
                                node.window[0], node.window[1],
                                node.stride[0], node.stride[1],
                                node.padding[0], node.padding[1]))
                new_inputs = conv.inputs
                kind = "pool"
            else:
                continue
            if not (executors.fusing(spec, "pool") if kind == "pool"
                    else executors.supporting(spec)):
                continue
            if autotune.fusion_verdict(spec, backend) is False:
                continue
            fused[conv.name] = f"{kind}:{node.name}"
            # the conv moves into the consumed node's slot (all of its
            # inputs are defined there, and nothing between consumed it)
            nodes[i] = ConvOp(conv.name, new_inputs, spec)
            del nodes[j]
            if output == node.name:
                output = conv.name
            nodes = _rename(nodes, node.name, conv.name)
            progress = True
            break

    if not fused:
        return graph, {}
    return Graph(tuple(nodes), graph.in_shape, graph.input_name,
                 output), fused


# ---------------------------------------------------------------------------
# the planned program

@dataclasses.dataclass
class GraphPlan:
    """Whole-network plan: one resolved ConvPlan per conv node, keyed by
    node name.  Execution never re-plans."""
    graph: Graph
    conv_plans: Dict[str, ConvPlan]
    backend: str
    source: str                  # resolved | graph_cache | forced
    # fusion provenance: {conv node: "add:<consumed>" | "pool:<consumed>"}
    fused: Dict[str, str] = dataclasses.field(default_factory=dict)
    # the pre-fusion IR (None when the pass was disabled): the persisted
    # cache key stays the UNFUSED signature
    base_graph: Optional[Graph] = None
    # quantization provenance: {conv node: quant.policy.NodeQuant} —
    # covers every conv node when a QuantPolicy planned this graph; empty
    # on fp plans
    quant: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def node_plans(self) -> Tuple[ConvPlan, ...]:
        """Conv-node plans in graph order."""
        return tuple(self.conv_plans[n.name] for n in self.graph.conv_nodes)

    def placement(self) -> Dict[str, object]:
        """Where the conv nodes run: ``kernel`` counts those whose
        executor launches the port's kernels, ``library`` those on a
        library's conv (``lax``), ``plain`` those on plain PyTorch;
        ``pools_unfolded`` names the pools the fusion pass left beside
        a conv it could have folded them into (no kernel fuses them, or
        a measurement ruled the fold a loss)."""
        out: Dict[str, object] = {"kernel": 0, "library": 0, "plain": 0}
        for p in self.conv_plans.values():
            ex = p.executor
            out["kernel" if ex.kernels else
                "library" if ex.library else "plain"] += 1
        unfolded = []
        if self.base_graph is not None:
            nodes = {n.name: n for n in self.graph.nodes}
            consumers: Dict[str, int] = {self.graph.output: 1}
            for n in self.graph.nodes:
                for e in n.inputs:
                    consumers[e] = consumers.get(e, 0) + 1
            for n in self.graph.nodes:
                prod = nodes.get(n.inputs[0])
                if (isinstance(n, PoolOp) and isinstance(prod, ConvOp)
                        and consumers[prod.name] == 1
                        and not prod.spec.has_fusion):
                    unfolded.append(n.name)
        out["pools_unfolded"] = unfolded
        return out

    def explain(self) -> str:
        """One aligned table for the whole network (every IR node):
        geometry, dtype, and executor provenance; the header counts the
        placement (``placement()``)."""
        pl = self.placement()
        lines = [f"GraphPlan[{self.source}] backend={self.backend} "
                 f"sig={self.graph.signature()} nodes={len(self.graph)} "
                 f"placement=kernel:{pl['kernel']},library:{pl['library']},"
                 f"plain:{pl['plain']} pools_unfolded="
                 f"{','.join(pl['pools_unfolded']) or '-'}"]
        for node in self.graph.nodes:
            if isinstance(node, ConvOp):
                p = self.conv_plans[node.name]
                s = p.spec
                n, h, w, c = s.in_shape
                kh, kw, _, m = s.filter_shape
                grp = f" g{s.groups}" if s.groups != 1 else ""
                cfg = (f" cfg[{p.config_source}]={p.config.key()}"
                       if p.config else "")
                fz = ""
                prov = self.fused.get(node.name)
                if prov:
                    kind, _, consumed = prov.partition(":")
                    fz = f" fused[{kind}]={consumed}"
                nq = self.quant.get(node.name)
                qz = f" quant[{nq.label()}]" if nq is not None else ""
                lines.append(
                    f"  {node.name:>8s}  {h:>3d}x{w:<3d} c{c:<4d} {kh}x{kw}/"
                    f"{s.stride[0]}{grp} m{m:<4d} {s.dtype:>9s} -> "
                    f"{p.algorithm:24s} [{p.source}]{cfg}{fz}{qz} "
                    f"{p.reason}")
            else:
                out = self.graph.shapes[node.name]
                lines.append(f"  {node.name:>8s}  {node.descriptor():50s} "
                             f"-> {out}")
        return "\n".join(lines)

    # -- execution -------------------------------------------------------
    def _named_params(self, params) -> Mapping[str, Mapping]:
        """Name-keyed params, or the chain-era list of ``(w, b)`` pairs
        assigned to the conv nodes in graph order."""
        if isinstance(params, Mapping):
            return params
        convs = self.graph.conv_nodes
        pairs = list(params)
        if len(pairs) != len(convs):
            raise ValueError(f"graph has {len(convs)} conv nodes but got "
                             f"{len(pairs)} weight pairs")
        return {node.name: ({"w": w} if b is None else {"w": w, "b": b})
                for node, (w, b) in zip(convs, pairs)}

    def _node_params(self, params: Mapping, node: OpSpec,
                     wants_bias: bool) -> Mapping:
        """One node's param dict, with errors that name the node."""
        p = params.get(node.name)
        if p is None or "w" not in p:
            raise ValueError(
                f"params missing {'entry' if p is None else 'weight'} for "
                f"{node.op} node {node.name!r} (param keys: "
                f"{sorted(params)})")
        if wants_bias and "b" not in p:
            raise ValueError(f"{node.op} node {node.name!r} wants a bias "
                             f"but params carry none")
        return p

    def run(self, x, params, observe: Optional[Callable] = None):
        """Execute the DAG on ``x`` with ``{node_name: {"w": ..., "b":
        ...}}`` params (or, for graphs lowered from ``ConvGraph.chain``,
        the legacy list of one ``(w, bias)`` pair per conv node in graph
        order), on the device of ``x``.  No plan() resolution happens
        here.  ``observe``, when given, is called as ``observe(name,
        value)`` with every conv node's INPUT activation (the
        calibration collector rides this hook)."""
        from repro_torch.kernels import ops
        params = self._named_params(params)
        values = {self.graph.input_name: x}
        for node in self.graph.nodes:
            ins = [values[e] for e in node.inputs]
            if isinstance(node, ConvOp):
                if observe is not None:
                    observe(node.name, ins[0])
                p = self._node_params(params, node, node.spec.has_bias)
                a = ins[1] if node.spec.fused_add != "none" else None
                y = self.conv_plans[node.name](
                    ins[0], p["w"], p["b"] if node.spec.has_bias else None, a)
            elif isinstance(node, PoolOp):
                y = ops.pool2d(ins[0], node.kind, node.window,
                               node.stride, node.padding)
            elif isinstance(node, AddOp):
                y = ins[0]
                for other in ins[1:]:
                    y = y + other
                if node.activation == "relu":
                    y = torch.relu(y)
            elif isinstance(node, ConcatOp):
                y = torch.cat(ins, dim=-1)
            elif isinstance(node, GapOp):
                y = ins[0].mean(dim=(1, 2))
            elif isinstance(node, DenseOp):
                p = self._node_params(params, node, node.bias)
                w = p["w"]
                # jnp-style promotion: a bf16 activation meets fp32 params
                dt = torch.promote_types(ins[0].dtype, w.dtype)
                y = ins[0].to(dt) @ w.to(dt)
                if node.bias:
                    y = y + p["b"]
            else:
                raise TypeError(f"unknown IR node type {type(node)}")
            values[node.name] = y
        return values[self.graph.output]

    def _attach_quant(self) -> None:
        """Attach the quantization payload (calibrated activation scale)
        to the int8 node plans — plan() knows nothing of calibration."""
        from repro_torch.quant.policy import QuantInfo
        for name, nq in self.quant.items():
            if nq.quantized and name in self.conv_plans:
                self.conv_plans[name] = dataclasses.replace(
                    self.conv_plans[name],
                    quant=QuantInfo(nq.x_scale, nq.source))

    # -- warmup / autotune --------------------------------------------------
    def warmup(self, *, measure: bool = False, tune: Optional[str] = None,
               repeats: int = 3, device=None,
               calibrate: Optional[object] = None) -> Dict:
        """Run every conv node once on zeros on ``device`` (default: the
        card, which raises where there is none), building its kernel on
        first use; measure-autotune the nodes first when asked.

        ``tune="algo"`` runs the per-node executor race
        (``autotune.tune_spec`` with each node's epilogue and groups) on
        ``device``; ``tune="full"`` also settles each fused node against
        its unfused form, runs the fusion pass again from the pre-fusion
        IR (a lost verdict splits the nodes; the nodes that result are
        tuned too) and races each winner's launch configs.  The plans
        then come from the graph-level entry where it still names every
        node's measured winner (with each winner's measured config);
        otherwise every node is resolved against the winners and the
        entry persisted again.  After that the plan serves with zero
        plan() resolutions, and tunes again with zero measurement.
        ``measure=True`` is the older spelling of ``tune="algo"``.  The
        plan's backend must be the device's (``tune_spec`` raises before
        any node is measured otherwise).

        ``calibrate`` takes a ``quant.Calibrator`` (sample batch + params
        + observer choice): the plan runs over the batch first, on the
        params' device, recording every conv node's input activation
        range into the persisted ``calibration.json`` — the scales a
        later ``QuantPolicy``-planned graph quantizes with.  Returns
        ``{"nodes": [...], "total_ms": float}``, plus the
        ``"calibration"`` entries when ``calibrate`` ran."""
        if measure and tune is None:
            tune = "algo"
        device = resolve_device(device)
        t_start = time.perf_counter()
        calib_entries = None
        if calibrate is not None:
            calib_entries = calibrate.collect(self)
        if tune is not None:
            self._tune(tune, repeats, device)
        rows = []
        for node in self.graph.conv_nodes:
            p = self.conv_plans[node.name]
            s = p.spec
            dt = torch_dtype(s.dtype)
            x = torch.zeros(s.in_shape, dtype=dt, device=device)
            w = torch.zeros(s.filter_shape, dtype=dt, device=device)
            b = (torch.zeros((s.filter_shape[3],), dtype=dt, device=device)
                 if s.has_bias else None)
            a = (torch.zeros(s.out_shape, dtype=dt, device=device)
                 if s.fused_add != "none" else None)
            t0 = time.perf_counter()
            p(x, w, b, a)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rows.append({"node": node.name, "key": s.key(),
                         "algorithm": p.algorithm, "source": p.source,
                         "config": (p.config.as_dict() if p.config else {}),
                         "config_source": p.config_source,
                         "first_call_ms": (time.perf_counter() - t0) * 1e3})
        out = {"nodes": rows,
               "total_ms": (time.perf_counter() - t_start) * 1e3}
        if calib_entries is not None:
            out["calibration"] = calib_entries
        return out

    def _tune(self, tune: str, repeats: int, device) -> None:
        from repro_torch.core import autotune
        for node in self.graph.conv_nodes:
            autotune.tune_spec(node.spec, tune=tune, backend=self.backend,
                               repeats=repeats, device=device)
        changed = False
        if tune == "full" and self.base_graph is not None:
            # re-run the pass from the pre-fusion IR: a lost verdict drops
            # its rewrite (and a won one is admitted again)
            refused, fmap = fuse_graph(self.base_graph, self.backend)
            if refused.signature() != self.graph.signature():
                old = {n.name: n.spec for n in self.graph.conv_nodes}
                self.graph, self.fused, changed = refused, fmap, True
                for node in self.graph.conv_nodes:
                    if old.get(node.name) != node.spec:
                        autotune.tune_spec(node.spec, tune=tune,
                                           backend=self.backend,
                                           repeats=repeats, device=device)
        # the graph-level entry serves while it names the measured
        # winners; otherwise every node is resolved against them
        plans = _plans_from_cache(self.graph, self.backend,
                                  key_graph=self.base_graph)
        resolved = plans is None
        if resolved:
            plans = {n.name: plan(n.spec, backend=self.backend)
                     for n in self.graph.conv_nodes}
        self.conv_plans = plans
        self._attach_quant()        # re-resolution dropped the scales
        if resolved or changed:
            _persist(self.base_graph or self.graph, self.backend,
                     self.conv_plans, alias=self.graph)


# ---------------------------------------------------------------------------
# resolution + persisted graph-level cache

def plan_graph(graph: GraphLike, *, backend: Optional[str] = None,
               force: Optional[str] = None,
               use_cache: bool = True, fuse: bool = True,
               quant: Optional[object] = None) -> GraphPlan:
    """Resolve a whole-network plan once, of the IR (``Graph``) or of the
    chain-era ``ConvGraph`` (lowered by ``to_ir``).

    A ``quant`` policy (``quant.QuantPolicy``) runs the int8 quantize
    pass over the IR first — eligible conv nodes' specs flip to int8 —
    so everything downstream (fusion, cache keys) sees the quantized
    graph and is dtype-distinct by construction.  The cross-layer fusion
    pass (``fuse_graph``) rewrites the IR next — ``fuse=False`` serves
    the unfused program.  Forced plans bypass the
    persisted cache in both directions.  Otherwise a persisted entry
    keyed by backend + the PRE-fusion graph signature reconstructs the
    program with zero per-node plan() resolutions; entries that are
    unversioned, carry a foreign schema or other ``PLAN_RULES``, or name
    unknown or no-longer-capable algorithms are dropped and
    re-resolved.
    """
    graph = _as_ir(graph)
    backend = backend or default_backend()
    qprov: Dict[str, object] = {}
    if quant is not None:
        from repro_torch.quant.policy import quantize_graph
        graph, qprov = quantize_graph(graph, quant, backend)
    fmap: Dict[str, str] = {}
    base = graph if fuse else None
    prog = graph
    if fuse:
        prog, fmap = fuse_graph(graph, backend)
    if force is not None:
        plans = {n.name: plan(n.spec, force=force, backend=backend)
                 for n in prog.conv_nodes}
        source = "forced"
    else:
        plans = (_plans_from_cache(prog, backend, key_graph=graph)
                 if use_cache else None)
        source = "graph_cache"
        if plans is None:
            plans = {n.name: plan(n.spec, backend=backend)
                     for n in prog.conv_nodes}
            source = "resolved"
            if use_cache:   # use_cache=False: no cache interaction AT ALL
                _persist(graph, backend, plans, alias=prog)
    gp = GraphPlan(prog, plans, backend, source, fused=fmap,
                   base_graph=base, quant=qprov)
    gp._attach_quant()
    return gp


def _graph_key(graph: Graph, backend: str) -> str:
    return f"{backend}/{graph.signature()}"


def _persist(graph: Graph, backend: str, plans: Mapping[str, ConvPlan],
             alias: Optional[Graph] = None) -> None:
    # ``graph`` is the addressing identity (the pre-fusion IR); the fused
    # program gets the same entry under its own signature
    entry = {"schema": GRAPH_SCHEMA, "rules": PLAN_RULES,
             "algorithms": {name: p.algorithm
                            for name, p in plans.items()}}
    _STORE.put(_graph_key(graph, backend), entry)
    if alias is not None and alias.signature() != graph.signature():
        _STORE.put(_graph_key(alias, backend), entry)


def _plans_from_cache(graph: Graph, backend: str,
                      key_graph: Optional[Graph] = None
                      ) -> Optional[Dict[str, ConvPlan]]:
    # ``graph`` is the (possibly fused) program whose conv specs the
    # entry must satisfy; ``key_graph`` is the pre-fusion IR the entry
    # is addressed by
    from repro_torch.core import autotune, executors
    entry = _STORE.get(_graph_key(key_graph or graph, backend))
    if not isinstance(entry, dict):
        return None
    if entry.get("schema") != GRAPH_SCHEMA:
        return None       # unversioned / foreign-schema entry: never decode
    if entry.get("rules") != PLAN_RULES:
        return None       # placed under other rules: re-resolve
    algos = entry.get("algorithms")
    conv_nodes = graph.conv_nodes
    if (not isinstance(algos, dict)
            or set(algos) != {n.name for n in conv_nodes}):
        return None
    plans: Dict[str, ConvPlan] = {}
    for node in conv_nodes:
        algo = algos[node.name]
        spec = node.spec
        if not executors.capable(algo, spec):
            return None                 # stale entry: caller re-resolves
        # a measured winner recorded since this entry was persisted wins
        measured = autotune.cached_best(spec, backend)
        if (measured is not None and measured != algo
                and executors.capable(measured, spec)):
            return None
        cfg, cfg_src = resolve_config(spec, algo, backend)
        plans[node.name] = ConvPlan(spec, algo, "graph_cache",
                                    "persisted graph-level plan", backend,
                                    config=cfg, config_source=cfg_src)
    return plans
