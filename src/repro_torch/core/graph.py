"""Typed operator-IR graph layer: plan a whole network once, serve it.

  OpSpec      typed IR node, one frozen dataclass per operator:
              ConvOp (a ConvSpec — including grouped/depthwise),
              PoolOp (max/avg), AddOp (residual, optional ReLU),
              ConcatOp (channel axis), GapOp, DenseOp.  Nodes are
              *named* and name their input edges explicitly.
  Graph       a DAG of OpSpec nodes in topological order, shape-checked
              at construction.  ``signature()`` is its stable identity
              (the same string as the JAX package's for the same graph).
  fuse_graph  folds residual adds and conv->pool chains into the
              producing conv's epilogue (11 -> 8 nodes on resnet_like).
  GraphPlan   per-conv-node ConvPlans resolved ONCE (keyed by node
              name), one ``explain()`` table, ``warmup()``, ``run()``.
              Each node runs as a plain call: PyTorch is eager, so the
              JAX package's per-node ``jax.jit`` has no counterpart.
  plan_graph  resolves a GraphPlan, consulting a persisted graph-level
              cache (``$REPRO_CACHE_DIR/torch/graphplans.json``) keyed by
              backend + signature — a warm process builds the whole
              program with ZERO per-node plan() resolutions.
  PrecisionPolicy
              graph-wide compute dtype (default + per-node overrides)
              landing in each conv node's ``ConvSpec.dtype``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

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
        """The quantization policy riding this policy: None (int8 serving
        is not ported yet)."""
        return None


# Persisted graph-plan entry schema (the JAX package's v2):
# {"schema": 2, "algorithms": {node_name: algo}}
GRAPH_SCHEMA = 2

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

    A rewrite only fires when some registered executor ``supports()``
    the fused spec and no persisted measurement has ruled the fusion a
    loss (``autotune.fusion_verdict``).  No ``plan()`` resolution
    happens here.  Returns ``(fused_graph, provenance)`` where
    provenance maps each fused conv node name to ``"add:<consumed>"`` /
    ``"pool:<consumed>"``; the original graph object comes back
    unchanged when nothing fuses.
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
            if not executors.supporting(spec):
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

    @property
    def node_plans(self) -> Tuple[ConvPlan, ...]:
        """Conv-node plans in graph order."""
        return tuple(self.conv_plans[n.name] for n in self.graph.conv_nodes)

    def explain(self) -> str:
        """One aligned table for the whole network (every IR node):
        geometry, dtype, and executor provenance."""
        lines = [f"GraphPlan[{self.source}] backend={self.backend} "
                 f"sig={self.graph.signature()} nodes={len(self.graph)}"]
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
                lines.append(
                    f"  {node.name:>8s}  {h:>3d}x{w:<3d} c{c:<4d} {kh}x{kw}/"
                    f"{s.stride[0]}{grp} m{m:<4d} {s.dtype:>9s} -> "
                    f"{p.algorithm:24s} [{p.source}]{cfg}{fz} {p.reason}")
            else:
                out = self.graph.shapes[node.name]
                lines.append(f"  {node.name:>8s}  {node.descriptor():50s} "
                             f"-> {out}")
        return "\n".join(lines)

    # -- execution -------------------------------------------------------
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

    def run(self, x, params):
        """Execute the DAG on ``x`` with ``{node_name: {"w": ..., "b":
        ...}}`` params, on the device of ``x``.  No plan() resolution
        happens here."""
        from repro_torch.kernels import ops
        values = {self.graph.input_name: x}
        for node in self.graph.nodes:
            ins = [values[e] for e in node.inputs]
            if isinstance(node, ConvOp):
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

    # -- warmup ------------------------------------------------------------
    def warmup(self, *, tune: Optional[str] = None, device=None) -> Dict:
        """Run every conv node once on zeros on ``device`` (default: the
        card, which raises where there is none), building its kernel on
        first use.  ``tune`` (the measured sweep) is not ported yet and
        raises.  Returns ``{"nodes": [...], "total_ms": float}``."""
        if tune is not None:
            raise NotImplementedError(
                f"tune={tune!r}: the measured autotune sweep is not ported "
                f"to repro_torch yet")
        device = resolve_device(device)
        t_start = time.perf_counter()
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
        return {"nodes": rows,
                "total_ms": (time.perf_counter() - t_start) * 1e3}


# ---------------------------------------------------------------------------
# resolution + persisted graph-level cache

def plan_graph(graph: Graph, *, backend: Optional[str] = None,
               force: Optional[str] = None,
               use_cache: bool = True, fuse: bool = True) -> GraphPlan:
    """Resolve a whole-network plan once.

    The cross-layer fusion pass (``fuse_graph``) rewrites the IR first —
    ``fuse=False`` serves the unfused program.  Forced plans bypass the
    persisted cache in both directions.  Otherwise a persisted entry
    keyed by backend + the PRE-fusion graph signature reconstructs the
    program with zero per-node plan() resolutions; entries that are
    unversioned, carry a foreign schema, or name unknown or no-longer-
    capable algorithms are dropped and re-resolved.
    """
    backend = backend or default_backend()
    fmap: Dict[str, str] = {}
    base = graph if fuse else None
    prog = graph
    if fuse:
        prog, fmap = fuse_graph(graph, backend)
    if force is not None:
        plans = {n.name: plan(n.spec, force=force, backend=backend)
                 for n in prog.conv_nodes}
        return GraphPlan(prog, plans, backend, "forced", fused=fmap,
                         base_graph=base)
    if use_cache:
        cached = _plans_from_cache(prog, backend, key_graph=graph)
        if cached is not None:
            return GraphPlan(prog, cached, backend, "graph_cache",
                             fused=fmap, base_graph=base)
    plans = {n.name: plan(n.spec, backend=backend) for n in prog.conv_nodes}
    if use_cache:       # use_cache=False means no cache interaction AT ALL
        _persist(graph, backend, plans, alias=prog)
    return GraphPlan(prog, plans, backend, "resolved", fused=fmap,
                     base_graph=base)


def _graph_key(graph: Graph, backend: str) -> str:
    return f"{backend}/{graph.signature()}"


def _persist(graph: Graph, backend: str, plans: Mapping[str, ConvPlan],
             alias: Optional[Graph] = None) -> None:
    # ``graph`` is the addressing identity (the pre-fusion IR); the fused
    # program gets the same entry under its own signature
    entry = {"schema": GRAPH_SCHEMA,
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
