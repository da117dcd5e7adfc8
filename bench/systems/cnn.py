"""A node-list CNN served by ``repro_torch``: its ``GraphBuilder``
program through ``models.cnn.GraphModel``, behind the async front end
on one card.

The only module of the benchmark that imports the program.  Each node
asks the program for exactly what it says: ``groups`` for a grouped
conv, the epilogue of ``EPILOGUE_OF_ACT`` for a conv's ``act``,
``GraphBuilder.norm`` for a ``norm``.  Where the program lacks the
piece, ``check`` refuses the node list before any weight is drawn.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core import convspec
from repro_torch.core.graph import GraphBuilder
from repro_torch.kernels import _build
from repro_torch.models.cnn import GraphModel
from repro_torch.serve.frontend import AsyncServeFrontend, ServeRequest


#: a conv's bias and ``act`` as the program's epilogue
EPILOGUE_OF_ACT = {"none": "bias", "relu": "bias_relu", "gelu": "bias_gelu"}


def check(cfg: dict) -> None:
    """``NotImplementedError``, naming the node and the missing piece,
    where the program cannot run a node as the list states it."""
    for n in cfg["nodes"]:
        if n["op"] == "conv":
            epi = EPILOGUE_OF_ACT[n["act"]]
            if epi not in convspec.EPILOGUES:
                raise NotImplementedError(
                    f"node {n['name']!r}: act {n['act']!r} needs the conv "
                    f"epilogue {epi!r}, not in repro_torch's "
                    f"convspec.EPILOGUES {convspec.EPILOGUES}")
        elif n["op"] == "norm" and not hasattr(GraphBuilder, "norm"):
            raise NotImplementedError(
                f"node {n['name']!r}: a channel LayerNorm needs "
                f"GraphBuilder.norm, which repro_torch lacks")


def graph_model(cfg: dict, image=None, precision=None) -> GraphModel:
    """The port's model of a node list: one ``GraphBuilder`` call a node;
    a conv's bias and ``act`` are its epilogue."""
    check(cfg)

    def build(in_shape, dtype):
        b = GraphBuilder(in_shape, dtype)
        for n in cfg["nodes"]:
            op, name, src = n["op"], n["name"], n["in"]
            if op == "conv":
                b.conv(name, src, n["k"], n["out"], stride=n.get("stride", 1),
                       padding=n.get("pad", 0),
                       epilogue=EPILOGUE_OF_ACT[n["act"]],
                       groups=n.get("groups", 1))
            elif op == "pool":
                b.pool(name, src, kind=n["kind"], window=n["k"],
                       stride=n.get("stride", 1), padding=n.get("pad", 0))
            elif op == "add":
                b.add(name, src, activation=n.get("act", "none"))
            elif op == "concat":
                b.concat(name, src)
            elif op == "norm":
                b.norm(name, src, eps=n["eps"])
            elif op == "gap":
                b.gap(name, src)
            elif op == "dense":
                b.dense(name, src, n["out"])
            else:
                raise ValueError(f"node {name!r}: unknown op {op!r}")
        return b.graph()
    return GraphModel(build, tuple(image or cfg["image"]), name=cfg["name"],
                      precision=precision)


class Served:
    """The program a cell runs: a model, its params, and the server in
    front of them (``submit``/``poll``/``flush``/``run``) on the one
    device in ``devices`` (a card, or the CPU in tests)."""

    def __init__(self, cfg: dict, traffic: dict, params: Dict,
                 devices: Sequence, image=None, precision=None):
        if len(devices) != 1:
            raise ValueError(f"{cfg['name']}: serves on one device, "
                             f"not {len(devices)}")
        self.cfg, self.params = cfg, params
        self.image = tuple(image or cfg["image"])
        self.model = graph_model(cfg, self.image, precision)
        self.server = AsyncServeFrontend(
            self.model, params, {self.image: tuple(traffic["buckets"])},
            device=devices[0], max_wait_ms=traffic["max_wait_ms"],
            pipeline_depth=traffic["pipeline_depth"])
        self.programs = self.server.programs[self.image]

    def warmup(self) -> None:
        """Build the libraries of the kernels the buckets' plans launch
        (on the card, all at once), then warm and capture each bucket."""
        if self.programs.device.type == "cuda":
            kernels = {k for gp in self.plans().values()
                       for p in gp.conv_plans.values()
                       for k in p.executor.kernels}
            _build.build_all([lib for lib, fns in _build.LIBRARIES.items()
                              if any(f"{k}_launch" in fns for k in kernels)])
        self.server.warmup()

    def request(self, rid: int, images: np.ndarray) -> ServeRequest:
        return ServeRequest(rid, images)

    def pending(self) -> bool:
        return bool(self.server.pending_counts())

    def plans(self) -> Dict[int, object]:
        """Each bucket's ``GraphPlan``."""
        return {b: self.programs.plan(b) for b in self.programs.buckets}

    @property
    def batches(self):
        return self.server.telemetry.batches

    def node_kernels(self) -> Dict[int, Dict[str, tuple]]:
        """Per bucket, each conv node's executor's hand-written kernels,
        by launch name (empty on a library or plain PyTorch executor)."""
        return {b: {n: tuple(p.executor.kernels)
                    for n, p in gp.conv_plans.items()}
                for b, gp in self.plans().items()}

    def kernel_nodes(self) -> Dict[int, frozenset]:
        """Per bucket, the conv nodes whose executor launches a
        hand-written kernel of the port (the others run on a library or
        plain PyTorch executor)."""
        return {b: frozenset(n for n, ks in nodes.items() if ks)
                for b, nodes in self.node_kernels().items()}
