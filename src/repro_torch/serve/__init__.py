"""Serving: the LM engine, batch-bucketed CNN serving, the async front
end and the sharded dispatcher (the JAX package's ``repro.serve``
exports)."""
from repro_torch.serve.engine import ServeEngine, Request  # noqa: F401
from repro_torch.serve.cnn import (  # noqa: F401
    BucketPrograms, CnnServeEngine, ImageRequest)
from repro_torch.serve.frontend import (  # noqa: F401
    AsyncServeFrontend, DeadlineExceeded, ServeRequest)
from repro_torch.serve.distributed import (  # noqa: F401
    ShardedServeDispatcher, owned_geometries)
from repro_torch.serve.telemetry import Telemetry  # noqa: F401
