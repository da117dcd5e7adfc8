"""CNN inference graphs over the cuConv core.

A model's whole forward pass — convs, pooling, residual adds, fire-module
concats, depthwise stages, GAP and the dense head — is one typed-IR
program planned through the graph layer (``core/graph.py``): a
``GraphPlan`` per input geometry, resolved once (memoized, and persisted
across processes), and every ``apply`` runs that program.
``GraphModel`` is the generic carrier with name-keyed params mirroring
the IR's node names (the JAX package's layout: ``{node: {"w": HWIO, "b":
(M,)}}``); ``SimpleCNN`` keeps the chain-era list-of-layers interface on
top of it; ``resnet_like``, ``mobilenet_like``, ``fire_like``,
``squeezenet_like`` and ``tiny_cnn`` are the JAX package's networks,
node for node.  ``params_from_numpy`` carries params across from the JAX
package so both compute the same thing.  ``conv_block`` and ``maxpool``
are the eager one-off layers for standalone experiments.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.convspec import (backend_for, default_backend,
                                       resolve_device)
from repro_torch.core.graph import (ConvOp, DenseOp, Graph, GraphBuilder,
                                    GraphPlan, PrecisionPolicy, plan_graph)


def init_conv(gen: torch.Generator, kh, kw, c_in, c_out) -> Dict:
    scale = 1.0 / np.sqrt(kh * kw * c_in)
    return {"w": torch.randn((kh, kw, c_in, c_out), generator=gen) * scale,
            "b": torch.zeros((c_out,))}


def conv_block(p, x, stride=1, padding="same", algorithm="auto"):
    """One eager conv with its bias + ReLU epilogue, planned per call
    (model inference goes through the pre-resolved GraphPlan)."""
    from repro_torch.core import cuconv
    return cuconv.conv2d(x, p["w"], stride, padding, algorithm,
                         bias=p["b"], activation="relu")


def maxpool(x, k=2, s=2):
    """Eager standalone max pooling (the IR's PoolOp nodes run the same
    function inside planned programs)."""
    from repro_torch.kernels import ops
    return ops.pool2d(x, "max", (k, k), (s, s))


def params_from_numpy(params, device=None) -> Dict:
    """The JAX package's params as numpy arrays -> the port's fp32
    tensors on ``device`` (default: the card).  Two layouts: name-keyed
    ``{node: {"w": HWIO, "b": (M,)}}``, and ``SimpleCNN``'s chain-era
    ``{"convs": [{"w", "b"}, ...], "head": (C, K)}``."""
    dev = resolve_device(device)

    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=dev)
    if "convs" in params:
        return {"convs": [{k: t(v) for k, v in p.items()}
                          for p in params["convs"]],
                "head": t(params["head"])}
    return {node: {k: t(v) for k, v in p.items()}
            for node, p in params.items()}


class GraphModel:
    """A CNN whose whole forward pass is one planned Graph program.

    ``builder(in_shape, precision) -> Graph`` defines the architecture
    for one input geometry; params are a name-keyed dict mirroring the
    IR.  Param shapes are geometry-independent (GAP decouples the head),
    so ``init`` builds the graph once at ``image_shape``.  Master params
    are fp32; a bf16 policy casts at the planned conv nodes.
    """

    def __init__(self, builder: Callable[[Tuple[int, ...], object], Graph],
                 image_shape: Tuple[int, int, int], name: str = "graph_cnn",
                 precision=None):
        self.builder = builder
        self.image_shape = tuple(map(int, image_shape))     # (H, W, C)
        self.name = name
        self.precision = (None if precision is None
                          else PrecisionPolicy.of(precision))
        self._plan_cache: Dict[tuple, GraphPlan] = {}

    def _policy(self, precision=None, dtype=None) -> PrecisionPolicy:
        """Per-call precision > model default > the input's dtype."""
        if precision is not None:
            return PrecisionPolicy.of(precision)
        if self.precision is not None:
            return self.precision
        return PrecisionPolicy.of(dtype)

    # -- graph planning --------------------------------------------------
    def graph(self, in_shape, dtype: str = "float32",
              precision=None) -> Graph:
        """The whole-network IR for one input geometry."""
        pol = self._policy(precision, dtype)
        return self.builder(tuple(map(int, in_shape)), pol)

    def graph_plan(self, in_shape, *, backend: Optional[str] = None,
                   force: Optional[str] = None, dtype: str = "float32",
                   precision=None, fuse: bool = True) -> GraphPlan:
        """The whole-network plan for one input geometry, resolved once
        per (geometry, backend, force, precision, fuse) and memoized.

        A ``quant.QuantPolicy`` rides the same ``precision=`` parameter
        (it is a PrecisionPolicy): the int8 quantize pass runs inside
        ``plan_graph``, and the memo key carries the calibration
        generation, so a recalibration re-quantizes instead of serving a
        plan built on stale scales."""
        backend = backend or default_backend()
        pol = self._policy(precision, dtype)
        quant = pol.quantizer()
        key = (tuple(map(int, in_shape)), backend, force, pol.key(), fuse)
        if quant is not None:
            from repro_torch.quant import calibrate
            key = key + (calibrate.generation(),)
        gp = self._plan_cache.get(key)
        if gp is None:
            gp = plan_graph(self.graph(in_shape, precision=pol),
                            backend=backend, force=force, fuse=fuse,
                            quant=quant)
            self._plan_cache[key] = gp
        return gp

    # -- params ----------------------------------------------------------
    def init(self, generator: Union[torch.Generator, int] = 0,
             device=None) -> Dict[str, Dict]:
        """Name-keyed fp32 params for every conv/dense node, drawn from
        ``generator`` (a ``torch.Generator`` or a seed) and placed on
        ``device`` (default: the card)."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        graph = self.graph((1,) + self.image_shape)
        params: Dict[str, Dict] = {}
        for node in graph.nodes:
            if isinstance(node, ConvOp):
                kh, kw, cpg, m = node.spec.filter_shape
                p = init_conv(generator, kh, kw, cpg, m)
                if not node.spec.has_bias:
                    del p["b"]
            elif isinstance(node, DenseOp):
                c_in, c_out = node.features
                p = {"w": torch.randn((c_in, c_out), generator=generator)
                     / np.sqrt(c_in)}
                if node.bias:
                    p["b"] = torch.zeros((c_out,))
            else:
                continue
            params[node.name] = {k: v.to(dev) for k, v in p.items()}
        return params

    # -- execution -------------------------------------------------------
    def apply(self, params, x, algorithm="auto",
              graph_plan: Optional[GraphPlan] = None, precision=None):
        """Run the planned program on the device of ``x`` (planned for
        it: backend ``"cuda"`` on the card).  ``algorithm`` other than
        "auto" forces that executor for every conv node; passing
        ``graph_plan`` skips the memo."""
        gp = graph_plan or self.graph_plan(
            x.shape, backend=backend_for(x.device),
            force=None if algorithm == "auto" else algorithm,
            dtype=str(x.dtype), precision=precision)
        return gp.run(x, params)


# ---------------------------------------------------------------------------
# the chain-era interface, lowered onto the IR

class SimpleCNN(GraphModel):
    """Sequential conv stack + GAP head; spec: [(kh, kw, c_out, stride),
    ...].

    The whole forward pass is one planned program.  Params keep the
    chain-era layout (``{"convs": [...], "head": matrix}``) and are
    mapped onto the IR's node names inside ``apply``.
    """

    def __init__(self, spec: Sequence[Tuple[int, int, int, int]],
                 num_classes: int = 10, in_channels: int = 3):
        self.spec, self.num_classes, self.in_channels = (
            tuple(spec), num_classes, in_channels)
        super().__init__(self._build, (32, 32, in_channels),
                         name="simple_cnn")

    def _build(self, in_shape, dtype) -> Graph:
        """The conv chain (bias_relu epilogue per block, node names as
        ``ConvGraph.chain(...).to_ir()`` makes them), GAP and a dense
        head without bias."""
        b = GraphBuilder(in_shape, dtype)
        y = "input"
        for i, (kh, kw, co, s) in enumerate(self.spec):
            y = b.conv(f"conv{i}", y, (kh, kw), co, stride=s)
        y = b.gap("gap", y)
        b.dense("head", y, self.num_classes, bias=False)
        return b.graph()

    def init(self, generator: Union[torch.Generator, int] = 0,
             device=None) -> Dict:
        """Chain-era fp32 params drawn from ``generator`` (a
        ``torch.Generator`` or a seed), on ``device`` (default: the
        card)."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        convs, c = [], self.in_channels
        for kh, kw, co, _ in self.spec:
            convs.append({k: v.to(dev) for k, v in
                          init_conv(generator, kh, kw, c, co).items()})
            c = co
        head = torch.randn((c, self.num_classes),
                           generator=generator) / np.sqrt(c)
        return {"convs": convs, "head": head.to(dev)}

    def apply(self, params, x, algorithm="auto",
              graph_plan: Optional[GraphPlan] = None, precision=None):
        """Run the planned program (see ``GraphModel.apply``)."""
        named = {f"conv{i}": p for i, p in enumerate(params["convs"])}
        named["head"] = {"w": params["head"]}
        return super().apply(named, x, algorithm, graph_plan, precision)


# ---------------------------------------------------------------------------
# the networks

def squeezenet_like():
    """Small SqueezeNet-flavoured stack (1x1-heavy: cuConv's best
    region)."""
    return SimpleCNN([
        (3, 3, 64, 2),
        (1, 1, 16, 1), (1, 1, 64, 1), (3, 3, 64, 1),
        (1, 1, 32, 1), (1, 1, 128, 1), (3, 3, 128, 1),
        (1, 1, 48, 1), (1, 1, 192, 1), (3, 3, 192, 1),
    ])


def tiny_cnn(num_classes: int = 3):
    """The two-conv stack the JAX package's multi-device smoke
    deployment serves."""
    return SimpleCNN([(3, 3, 6, 2), (1, 1, 4, 1)], num_classes=num_classes)


def resnet_like(num_classes: int = 10, image_shape=(32, 32, 3),
                precision=None):
    """Small ResNet-flavoured network: stem, maxpool, an identity
    residual block, a downsampling residual block with 1x1 projection,
    GAP + dense head — all inside ONE planned program (the JAX
    package's ``resnet_like``, node for node).

    Each residual branch's last conv plans epilogue ``bias`` (no ReLU);
    the post-add ReLU lives on the ``add`` node, as in the real network.
    """
    def build(in_shape, dtype):
        b = GraphBuilder(in_shape, dtype)
        y = b.conv("stem", "input", 3, 16)
        y = b.pool("pool", y, kind="max", window=2)
        # identity block
        z = b.conv("b1c1", y, 3, 16)
        z = b.conv("b1c2", z, 3, 16, epilogue="bias")
        y = b.add("b1add", (y, z), activation="relu")
        # downsampling block with projection shortcut
        z = b.conv("b2c1", y, 3, 32, stride=2)
        z = b.conv("b2c2", z, 3, 32, epilogue="bias")
        p = b.conv("b2proj", y, 1, 32, stride=2, epilogue="bias")
        y = b.add("b2add", (p, z), activation="relu")
        y = b.gap("gap", y)
        b.dense("head", y, num_classes)
        return b.graph()
    return GraphModel(build, image_shape, name="resnet_like",
                      precision=precision)


def mobilenet_like(num_classes: int = 10, image_shape=(32, 32, 3),
                   precision=None):
    """Small MobileNet-flavoured network: strided stem, two depthwise-
    separable stages (3x3 depthwise conv with groups=C, which plans onto
    the library executor as the JAX package's does, then 1x1
    pointwise), GAP + dense head — all inside one planned program."""
    def build(in_shape, dtype):
        b = GraphBuilder(in_shape, dtype)
        y = b.conv("stem", "input", 3, 16, stride=2)
        y = b.conv("dw1", y, 3, 16, groups=16)
        y = b.conv("pw1", y, 1, 32)
        y = b.conv("dw2", y, 3, 32, stride=2, groups=32)
        y = b.conv("pw2", y, 1, 64)
        y = b.gap("gap", y)
        b.dense("head", y, num_classes)
        return b.graph()
    return GraphModel(build, image_shape, name="mobilenet_like",
                      precision=precision)


def fire_like(num_classes: int = 10, image_shape=(32, 32, 3),
              precision=None):
    """SqueezeNet fire module: squeeze 1x1 feeding 1x1 and 3x3 expand
    branches whose outputs concatenate on the channel axis, then an avg
    pool, GAP and the head — one planned program."""
    def build(in_shape, dtype):
        b = GraphBuilder(in_shape, dtype)
        y = b.conv("stem", "input", 3, 16, stride=2)
        s = b.conv("squeeze", y, 1, 8)
        e1 = b.conv("expand1", s, 1, 16)
        e3 = b.conv("expand3", s, 3, 16)
        y = b.concat("cat", (e1, e3))
        y = b.pool("pool", y, kind="avg", window=2)
        y = b.gap("gap", y)
        b.dense("head", y, num_classes)
        return b.graph()
    return GraphModel(build, image_shape, name="fire_like",
                      precision=precision)
