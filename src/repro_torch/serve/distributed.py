"""Multi-device sharded serving: a per-host dispatcher over sharded
bucket programs.

The JAX package's ``serve/distributed.py`` on PyTorch.  The
single-device serving stack multiplexes traffic onto bucket programs
(serve/cnn.py) behind a continuous-batching scheduler
(serve/frontend.py).  This module scales that stack across *devices*
and *hosts* without changing what a bucket program is:

* **Sharded bucket programs.**  ``ShardedServeDispatcher`` builds its
  ``AsyncServeFrontend`` over a serve mesh, a tuple of devices
  (``launch/mesh.make_serve_mesh``), so every bucket program is the
  per-shard-geometry ``GraphPlan`` run on each device's contiguous row
  slice of the batch (its own CUDA graphs and pinned slots), the rows
  gathered in order.  Configured buckets are per-shard capacities;
  served (global) buckets are ``bucket × mesh size``.  Because each
  shard runs at the per-shard batch shape, outputs are bit-equal to the
  single-device engine at that bucket.

* **One param replication.**  ``dist.sharding.replicate_params`` copies
  the param tree to each mesh device exactly once (a tree already on a
  device is that device's copy); every geometry's programs share the
  replicated tree by reference.

* **Logical engine partitions.**  The dispatcher exposes one logical
  partition per mesh device: ``partitions()`` reports each device's
  real-image count and slot utilization (padding concentrates in the
  trailing shards), and ``stats()["sharding"]`` carries the
  shard-imbalance counters rolled up in serve/telemetry.py.

* **Scale-out seam.**  Admission is process-index-disciplined: a
  multi-process deployment runs ONE dispatcher per host, and
  ``owned_geometries`` deterministically partitions the geometry table
  across processes (sorted round-robin) so every request geometry has
  exactly one owner (launch/serve.py ``--cnn-dist``).  The process
  index and count default to the ``RANK`` and ``WORLD_SIZE``
  environment variables (else 0 and 1), the launcher's counterpart of
  ``jax.process_index()``/``jax.process_count()``.

On one H100 the mesh has one device, and the dispatcher behaves like the
plain frontend; the CPU runs it over a tuple such as ``("cpu",) * 4``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.convspec import resolve_device
from repro_torch.dist.sharding import replicate_params, replicated
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.serve.frontend import AsyncServeFrontend, ServeRequest


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def owned_geometries(geometries: Mapping[Tuple[int, int, int],
                                         Tuple[int, ...]],
                     process_index: int, process_count: int
                     ) -> Dict[Tuple[int, int, int], Tuple[int, ...]]:
    """Deterministic per-host ownership of the geometry table.

    Geometries are sorted and dealt round-robin, so every process
    derives the same partition from the same config with no
    coordination, every geometry has exactly one owner, and adding a
    host is a config change.  A process may own nothing (more hosts
    than geometries) — its dispatcher idles.
    """
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in "
                         f"[0, {process_count})")
    items = sorted((tuple(map(int, s)), tuple(b))
                   for s, b in dict(geometries).items())
    return {shape: buckets for i, (shape, buckets) in enumerate(items)
            if i % process_count == process_index}


class ShardedServeDispatcher:
    """Per-host dispatcher: sharded bucket programs behind the async
    scheduler.

    Reuses ``AsyncServeFrontend``'s admission/EDF/SLO/telemetry
    machinery wholesale — the dispatcher owns the mesh, the one-time
    param replication, the host's geometry ownership, and the
    per-device accounting on top.  ``mesh=None`` forms the serve mesh
    over every CUDA device of the host (1 device ⇒ behaves exactly like
    the plain frontend, same scheduler states), or over ``device`` alone
    where one is given (``device="cpu"``).
    """

    def __init__(self, model, params,
                 geometries: Mapping[Tuple[int, int, int],
                                     Tuple[int, ...]], *,
                 mesh=None, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 max_wait_ms: float = 2.0,
                 default_deadline_ms: Optional[float] = None,
                 slo_close_margin_ms: float = 0.0,
                 pipeline_depth: int = 2, algorithm="auto",
                 backend: Optional[str] = None, precision=None,
                 fuse: bool = True, input_dtype=None, device=None,
                 clock: Callable[[], float] = time.perf_counter):
        if mesh is None:
            mesh = (make_serve_mesh() if device is None
                    else (resolve_device(device),))
        self.mesh = replicated(mesh)
        self.n_devices = len(self.mesh)
        self.process_index = (_env_int("RANK", 0) if process_index is None
                              else int(process_index))
        self.process_count = (_env_int("WORLD_SIZE", 1)
                              if process_count is None
                              else int(process_count))
        self.owned = owned_geometries(geometries, self.process_index,
                                      self.process_count)
        # ONE replication; every geometry's BucketPrograms sees the
        # already-replicated tree and passes it through untouched
        self.params = replicate_params(params, self.mesh)
        self.model = model
        self.frontend: Optional[AsyncServeFrontend] = None
        if self.owned:
            self.frontend = AsyncServeFrontend(
                model, self.params, self.owned,
                max_wait_ms=max_wait_ms,
                default_deadline_ms=default_deadline_ms,
                slo_close_margin_ms=slo_close_margin_ms,
                pipeline_depth=pipeline_depth, algorithm=algorithm,
                backend=backend, precision=precision, fuse=fuse,
                input_dtype=input_dtype, mesh=self.mesh, clock=clock)

    # ------------------------------------------------------------------
    @property
    def geometries(self) -> Tuple[Tuple[int, int, int], ...]:
        """The geometries THIS host owns (its admission surface)."""
        return tuple(self.owned)

    def global_buckets(self, shape) -> Tuple[int, ...]:
        """The device-count-aware (global) bucket sizes serving one
        owned geometry — per-shard config × mesh size."""
        return self.frontend.programs[tuple(map(int, shape))].buckets

    def warmup(self, *, measure: bool = False,
               tune: Optional[str] = None) -> Dict[str, Dict[int, float]]:
        if self.frontend is None:
            return {}
        return self.frontend.warmup(measure=measure, tune=tune)

    # -- serving entry points (the frontend's, ownership-checked) -------
    def submit(self, req: ServeRequest) -> None:
        """Admit a request this host owns.  A geometry owned by a
        different process is a routing error, named as such — the
        deterministic ownership rule means the caller can compute the
        right host without asking anyone."""
        if self.frontend is not None:
            shape = tuple(req.images.shape[1:])
            if shape in self.owned:
                return self.frontend.submit(req)
        raise ValueError(
            f"request {req.rid}: geometry {tuple(req.images.shape[1:])} "
            f"is not owned by process {self.process_index}/"
            f"{self.process_count} (owned: {list(self.owned)})")

    def poll(self) -> List[ServeRequest]:
        return [] if self.frontend is None else self.frontend.poll()

    def flush(self) -> List[ServeRequest]:
        return [] if self.frontend is None else self.frontend.flush()

    def run(self) -> List[ServeRequest]:
        return [] if self.frontend is None else self.frontend.run()

    # -- observability ---------------------------------------------------
    def partitions(self) -> List[Dict]:
        """One logical engine partition per mesh device: which device,
        how many real images it computed, and its slot utilization."""
        shard = (self.frontend.telemetry.shard_rollup()
                 if self.frontend is not None else None)
        out = []
        for i, dev in enumerate(self.mesh):
            units = shard["per_device_units"][i] if shard else 0
            util = shard["per_device_utilization"][i] if shard else 0.0
            out.append({"partition": i, "device": str(dev),
                        "units": units, "utilization": util})
        return out

    def stats(self) -> Dict:
        """The frontend's JSON-ready rollup plus the mesh/ownership
        view: device count, per-partition utilization, shard-imbalance
        counters, and this host's slice of the deployment."""
        st = self.frontend.stats() if self.frontend is not None else {
            "requests": 0, "served": 0, "geometries": []}
        st.update({
            "process_index": self.process_index,
            "process_count": self.process_count,
            "devices": self.n_devices,
            "partitions": self.partitions(),
            "global_buckets": {
                "x".join(map(str, s)): list(self.global_buckets(s))
                for s in self.owned},
        })
        return st
