"""Serving front-end configuration: geometries, batching policy, SLOs.

One frozen dataclass describes a serving deployment: which
``(image_shape, buckets)`` programs it owns, how long a short batch may
wait before dispatching padded, the default latency SLO, and the
dispatch pipeline depth.  ``chip_smoke.py`` serves ``SMOKE_FRONTEND``
through ``AsyncServeFrontend`` and ``DIST_SMOKE`` through
``ShardedServeDispatcher`` (as ``launch/serve.py --cnn-dist`` does), so
"the served deployment" is one named object.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: The generous default SLO (milliseconds) used by smoke traffic: wide
#: enough that no smoke run misses it, while still giving every request
#: a deadline.
DEFAULT_SLO_MS = 60_000.0


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """One serving deployment.

    ``geometries`` maps each served image shape to its bucket tuple;
    ``max_wait_ms`` is the batch-close patience for short batches;
    ``default_deadline_ms`` is the SLO applied to requests that carry
    no explicit deadline (None = no implicit deadline);
    ``pipeline_depth`` bounds how many dispatched batches may be in
    flight (2 = double buffering).
    """
    geometries: Tuple[Tuple[Tuple[int, int, int], Tuple[int, ...]], ...]
    max_wait_ms: float = 2.0
    default_deadline_ms: Optional[float] = DEFAULT_SLO_MS
    pipeline_depth: int = 2

    def geometry_map(self):
        return {tuple(shape): tuple(buckets)
                for shape, buckets in self.geometries}


#: the smoke deployment: resnet_like traffic at two image resolutions
#: through ONE frontend
SMOKE_FRONTEND = FrontendConfig(
    geometries=(((32, 32, 3), (1, 4)),
                ((16, 16, 3), (1, 2))),
    max_wait_ms=5.0,
    default_deadline_ms=DEFAULT_SLO_MS,
    pipeline_depth=2,
)


#: the multi-device smoke deployment (``launch/serve.py --cnn-dist``,
#: ``chip_smoke.py``'s sharded check), serving ``models.cnn.tiny_cnn``.
#: Buckets here are PER-SHARD capacities — a ``ShardedServeDispatcher``
#: over N devices serves global buckets N× these — and each geometry
#: carries a SINGLE bucket so every image flows through one per-shard
#: batch-shape program, the precondition for bitwise-identical outputs
#: across device counts.
DIST_SMOKE = FrontendConfig(
    geometries=(((8, 8, 3), (2,)),
                ((12, 12, 3), (2,))),
    max_wait_ms=2.0,
    default_deadline_ms=DEFAULT_SLO_MS,
    pipeline_depth=2,
)
