"""Mesh definitions: the JAX package's ``launch/mesh.py`` on
``torch.distributed``.

Training.  Single pod: (16, 16) = 256 ranks, axes ('data', 'model') —
TP inside the fast dimension, FSDP over 'data'.  Multi-pod: (2, 16, 16)
= 512 ranks, axes ('pod', 'data', 'model') — only the gradient
all-reduce crosses the slow 'pod' axis.  A training mesh is a
``DeviceMesh`` over the process group's world, which the caller brings
up first (``torchrun``, or ``init_process_group`` with its own store):
nothing here starts one.  It lies on the card unless the group is
``gloo`` or ``fake`` (a test's stand-in for a pod) or the caller asks
for the CPU.

Serving.  A serve mesh is a tuple of ``torch.device``: the sharded
bucket programs (``serve/cnn.py``) cut each batch's rows over it, and
every device holds a whole copy of the params (``dist/sharding.py``).
There is deliberately no model axis: CNN inference is batch-parallel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

#: the one mesh axis the serving layer shards over (batch data-parallel)
SERVE_AXIS = "data"


def _mesh_device(device) -> str:
    """The device type a training mesh lies on."""
    if device is not None:
        dev = torch.device(device).type
    elif dist.is_initialized() and dist.get_backend() in ("gloo", "fake"):
        dev = "cpu"
    else:
        dev = "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a training mesh lies on the card by default, and CUDA is not "
            "available here; bring up a gloo process group or pass "
            "device='cpu'")
    if not dist.is_initialized():
        raise RuntimeError(
            "a training mesh spans the process group's world, and no "
            "process group is initialized: launch with torchrun or call "
            "torch.distributed.init_process_group first")
    return dev


def _mesh(shape, axes, dev: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = _mesh_device(device)
    need = 512 if multi_pod else 256
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'pod'} mesh {shape} needs "
            f"{need} ranks; this process group has {world}")
    return _mesh(shape, axes, dev)


def make_debug_mesh(n_devices: Optional[int] = None, model: int = 2,
                    device=None):
    """Small ('data', 'model') mesh over the world (tests / examples)."""
    dev = _mesh_device(device)
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    return _mesh((n // model, model), ("data", "model"), dev)


def make_serve_mesh(n_devices: Optional[int] = None
                    ) -> Tuple[torch.device, ...]:
    """The first ``n_devices`` CUDA devices of this host (all of them by
    default), as a tuple.  A caller on the CPU passes its own tuple
    instead, e.g. ``("cpu",) * 4``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the serve mesh is this host's CUDA devices, and CUDA is not "
            "available here; pass a device tuple such as ('cpu',) * 4")
    count = torch.cuda.device_count()
    n = n_devices or count
    if not 1 <= n <= count:
        raise ValueError(f"n_devices must be in [1, {count}]; got {n}")
    return tuple(torch.device("cuda", i) for i in range(n))
