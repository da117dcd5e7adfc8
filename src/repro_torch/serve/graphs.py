"""Served programs captured as CUDA graphs: the port's ``jax.jit``.

The JAX package jits each CNN bucket's network and the LM's prefill and
decode into one program each.  Here a ``GraphedProgram`` records one
program's kernel launches in a ``torch.cuda.CUDAGraph`` over static
input tensors, so a call costs one graph launch instead of the host
work of every operator and wrapper in it.

A program is ``fn(params, buffers, *inputs)``.  ``params`` are read
(the graph reads their memory, so the program keeps them alive);
``buffers`` are updated in place by the program (the LM's cache: the
counterpart of the reference's donated argument).  A call copies its
inputs into the static ones and replays the graph, returning the static
outputs, which the next call overwrites.  The first call, and any call
that finds the params or buffers changed since the capture, runs ``fn``
eagerly on the static inputs (that call's result) and then captures the
graph for the calls after it; a capture runs nothing.  Changed means:
another params or buffers object, or, walking them again on every call,
a tensor of them at another ``data_ptr()``, shape or dtype (a tensor
swapped into the same dict too), or a param tensor at another
``_version`` (an in-place update bumps it).  So a graph is never replayed against parameters it
was not captured on.

Memory: the programs of one engine share one graph memory pool
(``pool``, from ``torch.cuda.graph_pool_handle()``), so a graph captured
later reuses what earlier captures freed instead of holding a pool of
its own.  That is safe because the engine replays them one at a time on
one stream and reads each call's outputs before the next call.

Launch counts: a capture records launches without running them, so the
launches it added to ``_build.LAUNCHES`` are taken back and added again
on every replay.  Tensors that a cache handed to a kernel during the
capture (``_build.keep_for_graph``: the int8 executor's filter codes
and scales) are held by the program as long as its graph.  Graphs are for CUDA tensors only; callers run their
programs eagerly on the CPU.  A capture or replay that fails raises.
The garbage collector is run before a capture and held off during it:
a CUDA graph freed during a capture invalidates the capture.  A program
is captured on a side stream of its static inputs' device (one per
device, ``capture_stream``): ``torch.cuda.graph``'s default is one
stream made on whichever device captured first, and a capture of
another device's kernels on it records nothing (they run eagerly, and
every replay hands back the capture call's output).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.kernels import _build


def used_on(device) -> bool:
    """Whether the served programs on ``device`` run as CUDA graphs: on
    the card; the CPU runs them eagerly."""
    return torch.device(device).type == "cuda"


_CAPTURE_STREAMS = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream graphs of ``device``'s programs are captured on."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def tensor_leaves(tree) -> List[torch.Tensor]:
    """Every tensor in nested dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out: List[torch.Tensor] = []
    for node in tree:
        out.extend(tensor_leaves(node))
    return out


def _stamp(params: Sequence[torch.Tensor],
           buffers: Sequence[torch.Tensor]) -> tuple:
    return ([(t.data_ptr(), t._version, t.shape, t.dtype) for t in params],
            [(t.data_ptr(), t.shape, t.dtype) for t in buffers])


class GraphedProgram:
    """``fn(params, buffers, *inputs)`` as one CUDA graph over the static
    ``inputs`` (CUDA tensors the program owns)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 pool=None):
        self.fn = fn
        self.inputs = tuple(inputs)
        self.pool = pool            # shared graph memory pool, or None
        self.graph = None
        self.outputs = None
        self.launches = {}          # kernel -> launches per replay
        self.captures = 0
        self.replays = 0
        self._bound = None          # (params, buffers) of the capture
        self._stamp = None
        self._keep = []             # cached tensors the graph reads

    def fresh(self, params, buffers) -> bool:
        """Whether the graph was captured on exactly these params and
        buffers, unchanged since."""
        return (self.graph is not None and self._bound is not None
                and params is self._bound[0] and buffers is self._bound[1]
                and _stamp(tensor_leaves(params), tensor_leaves(buffers))
                == self._stamp)

    def __call__(self, params, buffers, *args):
        if not self.fresh(params, buffers):
            out = self.warm(params, buffers, *args)
            self.capture(params, buffers)
            return out
        self._load(args)
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.outputs

    def _load(self, args) -> None:
        for static, a in zip(self.inputs, args):
            if not isinstance(a, torch.Tensor):
                static.fill_(a)
            elif a is not static:
                if a.shape != static.shape:
                    raise ValueError(f"graphed program: input of shape "
                                     f"{tuple(a.shape)}, captured "
                                     f"{tuple(static.shape)}")
                static.copy_(a)

    def warm(self, params, buffers, *args):
        """The eager half of a first call: ``args`` copied into the
        static inputs and ``fn`` run on them (``capture`` is the other
        half)."""
        self._load(args)
        return self.fn(params, buffers, *self.inputs)

    def capture(self, params, buffers) -> None:
        """Record ``fn`` on the static inputs (after an eager run of it:
        kernels built, caches filled, allocator warm)."""
        leaves = (tensor_leaves(params), tensor_leaves(buffers))
        if any(t.is_inference() for t in leaves[0]):
            raise ValueError("a graphed program cannot watch an inference "
                             "tensor (it keeps no version to compare)")
        # free the old graph (its memory goes back to the pool) first;
        # graph_capture collects before the capture and not during it
        self.graph = self.outputs = self._bound = None
        self._keep = []
        graph = torch.cuda.CUDAGraph()
        device = (self.inputs[0].device if self.inputs
                  else torch.device("cuda"))
        with _build.graph_capture() as rec:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=capture_stream(device)):
                outputs = self.fn(params, buffers, *self.inputs)
        self.graph, self.outputs = graph, outputs
        self.launches, self._keep = rec["launches"], rec["keep"]
        self._bound = (params, buffers)
        self._stamp = _stamp(*leaves)
        self.captures += 1
