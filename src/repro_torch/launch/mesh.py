"""The serving mesh: the devices one host serves over.

The JAX package's ``launch/mesh.py`` forms a 1-D ``('data',)`` mesh over
the host's addressable devices for serving (and 2-D/3-D meshes for
training, which the port does not have yet).  Here a serve mesh is a
tuple of ``torch.device``: the sharded bucket programs
(``serve/cnn.py``) cut each batch's rows over it, and every device holds
a whole copy of the params (``dist/sharding.py``).  There is
deliberately no model axis: CNN inference is batch-parallel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: the one mesh axis the serving layer shards over (batch data-parallel)
SERVE_AXIS = "data"


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
