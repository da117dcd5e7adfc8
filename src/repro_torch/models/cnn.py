"""CNN inference graphs over the cuConv core.

A model's whole forward pass — convs, pooling, residual adds, GAP and
the dense head — is one typed-IR program planned through the graph
layer (``core/graph.py``): a ``GraphPlan`` per input geometry, resolved
once (memoized, and persisted across processes), and every ``apply``
runs that program.  ``GraphModel`` is the generic carrier with
name-keyed params mirroring the IR's node names (the JAX package's
layout: ``{node: {"w": HWIO, "b": (M,)}}``); ``params_from_numpy``
carries such params across from the JAX package so both compute the
same thing.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

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


def params_from_numpy(params, device=None) -> Dict[str, Dict]:
    """Name-keyed params as numpy arrays (the JAX package's layout,
    ``{node: {"w": HWIO, "b": (M,)}}``) -> the port's fp32 tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {node: {k: torch.tensor(np.asarray(v, np.float32),
                                      device=dev)
                   for k, v in p.items()}
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
        per (geometry, backend, force, precision, fuse) and memoized."""
        backend = backend or default_backend()
        pol = self._policy(precision, dtype)
        key = (tuple(map(int, in_shape)), backend, force, pol.key(), fuse)
        gp = self._plan_cache.get(key)
        if gp is None:
            gp = plan_graph(self.graph(in_shape, precision=pol),
                            backend=backend, force=force, fuse=fuse)
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
