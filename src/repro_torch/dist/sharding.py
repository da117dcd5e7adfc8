"""Data-parallel serving placements.

The serve helpers of the JAX package's ``dist/sharding.py``.  CNN param
trees carry no logical axes: inference params are replicated wholesale
and only the batch axis of each request batch is cut over the serve
mesh (``launch/mesh.py``), a tuple of devices.  So a placement here is a
device tuple, and a replicated param tree is one copy of the tree per
mesh device (``Replicated``), made once.  The logical-axis rules and the
training shardings belong to the training path, which the port does not
have yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


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
