"""Async serving front end: continuous batching, deadline-aware
admission, double-buffered dispatch, multi-resolution routing.

The JAX package's ``serve/frontend.py`` on PyTorch.
``CnnServeEngine.run()`` is a synchronous drain: every request waits for
the whole queue, the host-to-device copy serializes with compute, and
one engine serves exactly one image geometry.  ``AsyncServeFrontend``
keeps the same programs — whole-network bucket programs, CUDA graphs on
the card, built by the shared ``BucketPrograms`` component
(serve/cnn.py) — but puts a scheduler in front of them:

* **Continuous batching.**  Batches close on a *bucket-full or
  ``max_wait_ms``* policy instead of a full drain: a full largest
  bucket dispatches immediately; a short tail dispatches (zero-padded)
  once its oldest request has waited ``max_wait_ms``.  ``poll()`` is the
  streaming entry point (dispatch what the policy allows, never force);
  ``run()`` drains.

* **Deadline-aware admission.**  Requests carry an optional
  ``deadline_ms`` (relative to submit; ``default_deadline_ms`` supplies
  the SLO for requests that don't say).  Within a geometry, admission
  is earliest-deadline-first; a request whose deadline has already
  passed at admission time is rejected with a typed
  ``DeadlineExceeded`` result (``status="deadline_exceeded"``, the
  error naming its lateness) instead of silently served.  A request
  with units already in flight is committed and always completes.

* **Double-buffered dispatch.**  Dispatch is asynchronous
  (``BucketPrograms.dispatch``): the batch is packed into a pinned host
  slot, copied to the card on a side stream (the host waits on the copy
  only), the bucket's CUDA graph is replayed behind an event and its
  output copied back into pinned memory without blocking; the result is
  harvested only when the pipeline is ``pipeline_depth`` deep or at
  drain end.  In steady state batch N+1's packing and copy overlap batch
  N's compute on the card — every such batch is flagged ``overlapped``
  in telemetry.

* **SLO-aware bucket choice.**  When the tightest pending deadline has
  less slack than the close policy's remaining wait (plus
  ``slo_close_margin_ms`` headroom), the batch closes immediately into
  the best-fitting — possibly padded, smaller — bucket instead of
  waiting for a larger one to fill (``stats()["slo_closes"]``).

* **Multi-resolution serving.**  One frontend owns several
  ``(image_shape, buckets)`` programs and routes each request to its
  geometry's bucket set.

* **Sharded programs.**  ``mesh=`` (a device tuple; see
  serve/distributed.py) shards every bucket program's batch rows over
  the devices: configured buckets become per-shard capacities, params
  are copied to each device once, and per-batch ``shard_units``
  telemetry feeds the per-device utilization/imbalance rollups.

* **Telemetry.**  Every request leaves queue/transfer/compute/total
  latency (serve/telemetry.py); ``stats()`` exposes p50/p95/p99
  rollups, deadline misses, and overlap counters.  ``trace=True``
  records the serving path's spans and counters in ``telemetry.spans``
  and ``telemetry.counters``: ``batch.form`` when ``_form_batch``
  closes a batch, ``BucketPrograms``' ``dispatch`` and ``warmup`` trees,
  and ``harvest`` with children ``harvest.wait`` (the host blocked on
  the output copy), ``harvest.read`` and ``harvest.scatter`` (outputs
  scattered, requests completed).

The scheduler is single-threaded and clock-injected (``clock=``): the
card's streams provide the device-side concurrency, so behaviour is
deterministic and testable with a fake clock.  It runs on the card
unless the caller asks for the CPU (``device="cpu"``), where dispatch
runs eagerly.

One deliberate difference from the reference: a request's
``compute_ms`` is the length of the UNION of its batches' in-flight
windows (dispatch → harvest), not their sum.  Two batches of one
request are in flight together at depth 2, and the sum could exceed the
request's own wall time; the union cannot, so ``compute_ms <=
total_ms`` always holds.  For a request that one batch carried it is
the reference's value.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.serve.cnn import (BucketPrograms, Dispatched, ImageRequest,
                                  scatter_outputs)
from repro_torch.serve.telemetry import BatchTrace, RequestTrace, Telemetry

#: request lifecycle states
PENDING = "pending"
SERVED = "served"
DEADLINE_EXCEEDED = "deadline_exceeded"


@dataclasses.dataclass
class DeadlineExceeded:
    """Typed rejection result: the request missed its deadline before
    admission.  ``lateness_ms`` is how far past the deadline admission
    found it."""
    rid: int
    deadline_ms: float
    lateness_ms: float

    def __str__(self):
        return (f"request {self.rid} deadline exceeded: "
                f"{self.lateness_ms:.1f}ms past its "
                f"{self.deadline_ms:.1f}ms deadline")


@dataclasses.dataclass
class ServeRequest(ImageRequest):
    """An ``ImageRequest`` with an optional latency SLO.

    ``deadline_ms`` is relative to submit time; ``None`` defers to the
    frontend's ``default_deadline_ms`` (and if that is also None the
    request never expires).  After serving, ``status`` is ``"served"``
    (outputs in ``out``) or ``"deadline_exceeded"`` (``error`` carries
    the typed ``DeadlineExceeded``; ``out`` stays None).
    """
    deadline_ms: Optional[float] = None
    status: str = PENDING
    error: Optional[DeadlineExceeded] = None
    # -- frontend-internal accounting (stamped at submit/dispatch) -----
    _submit_t: float = 0.0
    _deadline_t: Optional[float] = None     # absolute, frontend clock
    _seq: int = -1
    _first_dispatch_t: Optional[float] = None
    _transfer_ms: float = 0.0
    # the union of the request's in-flight windows: first dispatch, the
    # latest harvest, and the gaps between windows (seconds)
    _compute_t0: Optional[float] = None
    _compute_t1: float = 0.0
    _compute_gaps: float = 0.0
    _served_units: int = 0
    _batches: List[int] = dataclasses.field(default_factory=list)

    @property
    def _compute_ms(self) -> float:
        if self._compute_t0 is None:
            return 0.0
        return ((self._compute_t1 - self._compute_t0)
                - self._compute_gaps) * 1e3

    def _add_window(self, t0: float, t1: float) -> None:
        """One more batch window; windows arrive in dispatch order, each
        harvested no earlier than the one before."""
        if self._compute_t0 is None:
            self._compute_t0, self._compute_t1 = t0, t1
            return
        if t0 > self._compute_t1:
            self._compute_gaps += t0 - self._compute_t1
        self._compute_t1 = max(self._compute_t1, t1)


@dataclasses.dataclass
class _InFlight:
    """One dispatched, not-yet-harvested batch."""
    shape: Tuple[int, int, int]
    chunk: List[Tuple[ServeRequest, int]]
    handle: Dispatched                      # BucketPrograms.dispatch's
    trace: BatchTrace


def _geom(shape: Sequence[int]) -> str:
    return "x".join(str(int(s)) for s in shape)


class AsyncServeFrontend:
    """Continuous-batching front end over shared bucket programs.

    ``geometries`` maps each served ``(H, W, C)`` image shape to its
    bucket tuple, e.g. ``{(32, 32, 3): (1, 4), (16, 16, 3): (1, 2)}`` —
    one frontend, several resolutions, each with its own
    ``BucketPrograms``.  Planning/precision/fusion knobs match
    ``CnnServeEngine`` and apply to every geometry.  ``device`` is the
    card unless the caller asks for the CPU; ``mesh`` (a device tuple)
    replaces it with sharded programs.  ``trace=True`` records spans
    and counters (see the module docstring); off, nothing is recorded.
    """

    def __init__(self, model, params,
                 geometries: Mapping[Tuple[int, int, int],
                                     Tuple[int, ...]], *,
                 max_wait_ms: float = 2.0,
                 default_deadline_ms: Optional[float] = None,
                 slo_close_margin_ms: float = 0.0,
                 pipeline_depth: int = 2, algorithm="auto",
                 backend: Optional[str] = None, precision=None,
                 fuse: bool = True, input_dtype=None, mesh=None,
                 device=None,
                 clock: Callable[[], float] = time.perf_counter,
                 trace: bool = False):
        if not geometries:
            raise ValueError("geometries must map at least one "
                             "(H, W, C) shape to a bucket tuple")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1; "
                             f"got {pipeline_depth}")
        # mesh= shards every geometry's bucket programs data-parallel
        # over a device tuple: configured buckets become per-shard
        # capacities, params are copied to each device once (see
        # BucketPrograms / serve/distributed.py)
        self.telemetry = Telemetry(trace=trace)
        self.programs: Dict[Tuple[int, int, int], BucketPrograms] = {}
        for shape, buckets in dict(geometries).items():
            shape = tuple(map(int, shape))
            self.programs[shape] = BucketPrograms(
                model, params, shape, buckets=buckets,
                algorithm=algorithm, backend=backend, precision=precision,
                fuse=fuse, input_dtype=input_dtype, mesh=mesh,
                device=device, pipeline_depth=pipeline_depth,
                telemetry=self.telemetry if trace else None)
        self.model, self.params = model, params
        self.mesh = mesh
        self.max_wait_ms = float(max_wait_ms)
        self.default_deadline_ms = default_deadline_ms
        self.slo_close_margin_ms = float(slo_close_margin_ms)
        self.pipeline_depth = int(pipeline_depth)
        self._clock = clock
        self._pending: Dict[Tuple[int, int, int],
                            List[Tuple[ServeRequest, int]]] = {
            shape: [] for shape in self.programs}
        self._inflight: collections.deque = collections.deque()
        self._completed: List[ServeRequest] = []
        self._seq = 0
        self._batch_seq = 0             # the next batch's BatchTrace.seq
        self._max_inflight = 0
        self._slo_closes = 0
        self._batch_counts: Dict[str, int] = {}

    # ------------------------------------------------------------------
    @property
    def geometries(self) -> Tuple[Tuple[int, int, int], ...]:
        return tuple(self.programs)

    def warmup(self, *, measure: bool = False, tune: Optional[str] = None
               ) -> Dict[str, Dict[int, float]]:
        """Compile every geometry's bucket programs; per-bucket compile
        milliseconds keyed by geometry string."""
        return {_geom(shape): progs.warmup(measure=measure, tune=tune,
                                           clock=self._clock)
                for shape, progs in self.programs.items()}

    # -- admission ------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        """Route a request to its geometry's pending queue."""
        shape = tuple(req.images.shape[1:])
        if shape not in self.programs:
            raise ValueError(
                f"request {req.rid}: image shape {shape} matches no "
                f"served geometry {[_geom(s) for s in self.programs]}")
        now = self._clock()
        req._submit_t = now
        req._seq, self._seq = self._seq, self._seq + 1
        deadline = (req.deadline_ms if req.deadline_ms is not None
                    else self.default_deadline_ms)
        req._deadline_t = (None if deadline is None
                           else now + float(deadline) / 1e3)
        self._pending[shape].extend(
            (req, i) for i in range(req.images.shape[0]))

    def _reject(self, req: ServeRequest, now: float) -> None:
        deadline_ms = (req._deadline_t - req._submit_t) * 1e3
        lateness_ms = (now - req._deadline_t) * 1e3
        req.status = DEADLINE_EXCEEDED
        req.error = DeadlineExceeded(req.rid, deadline_ms, lateness_ms)
        req.done = True
        queue_ms = (now - req._submit_t) * 1e3
        self.telemetry.record_request(RequestTrace(
            rid=req.rid, geometry=_geom(req.images.shape[1:]),
            images=int(req.images.shape[0]), status=DEADLINE_EXCEEDED,
            deadline_ms=deadline_ms, queue_ms=queue_ms, transfer_ms=0.0,
            compute_ms=0.0, total_ms=queue_ms))
        self._completed.append(req)

    def _purge_expired(self, shape, now: float) -> None:
        """Deadline-aware admission: requests already past their
        deadline are rejected with a typed result.  Requests with units
        in flight are committed and never purged."""
        pend = self._pending[shape]
        expired = {id(r) for r, _ in pend
                   if r._deadline_t is not None and now > r._deadline_t
                   and r._first_dispatch_t is None}
        if not expired:
            return
        self._pending[shape] = [(r, i) for r, i in pend
                                if id(r) not in expired]
        rejected = {id(r): r for r, _ in pend if id(r) in expired}
        for r in rejected.values():
            self._reject(r, now)

    # -- scheduling -----------------------------------------------------
    def _form_batch(self, shape, now: float, *, force: bool
                    ) -> Optional[Tuple[List, int]]:
        """EDF-order the geometry's pending units and close a batch if
        the policy allows: largest bucket full → dispatch now; else
        dispatch the best-fitting bucket once the oldest pending request
        has waited ``max_wait_ms`` (or unconditionally when draining).

        **SLO-aware close**: when the tightest pending deadline has less
        slack than the wait the close policy would still impose (plus
        ``slo_close_margin_ms`` of service headroom), the batch closes
        NOW into the best-fitting — possibly padded, smaller — bucket
        instead of waiting for a larger one to fill.  A lone
        tight-deadline request is served padded rather than expiring in
        the queue it was asked to wait in."""
        self._purge_expired(shape, now)
        pend = self._pending[shape]
        if not pend:
            return None
        pend.sort(key=lambda u: (
            u[0]._deadline_t if u[0]._deadline_t is not None
            else float("inf"), u[0]._seq, u[1]))
        progs = self.programs[shape]
        bmax = progs.buckets[-1]
        if len(pend) < bmax:
            oldest_wait_ms = (now - min(r._submit_t for r, _ in pend)) * 1e3
            if not force and oldest_wait_ms < self.max_wait_ms:
                remaining_wait_ms = self.max_wait_ms - oldest_wait_ms
                slacks = [(r._deadline_t - now) * 1e3 for r, _ in pend
                          if r._deadline_t is not None]
                tight = min(slacks) if slacks else None
                if (tight is None
                        or tight > remaining_wait_ms
                        + self.slo_close_margin_ms):
                    return None
                self._slo_closes += 1
        b = progs.pick_bucket(len(pend))
        chunk, self._pending[shape] = pend[:b], pend[b:]
        if self.telemetry.spans is not None:
            self.telemetry.add_span("batch.form", now, self._clock(),
                                    batch=self._batch_seq)
        return chunk, b

    def _dispatch(self, shape, chunk, bucket: int) -> None:
        progs = self.programs[shape]
        # transfer: host blocks only on the COPY — any in-flight batch
        # keeps computing on the device meanwhile (the overlap).  Params
        # ride the program's own tree (copied to each mesh device once),
        # never re-transferred.
        overlapped = bool(self._inflight)
        seq, self._batch_seq = self._batch_seq, self._batch_seq + 1
        h = progs.dispatch(bucket, chunk, clock=self._clock, seq=seq)
        trace = BatchTrace(
            geometry=_geom(shape), bucket=bucket, units=len(chunk),
            padded=bucket - len(chunk), transfer_t0=h.transfer_t0,
            transfer_t1=h.transfer_t1, dispatch_t=h.dispatch_t,
            overlapped=overlapped,
            shard_units=progs.shard_units(len(chunk), bucket),
            dtype=progs.serve_dtype(bucket), seq=seq)
        for r, _ in chunk:
            if r._first_dispatch_t is None:
                r._first_dispatch_t = h.transfer_t0
        self._inflight.append(_InFlight(shape, list(chunk), h, trace))
        self._max_inflight = max(self._max_inflight, len(self._inflight))
        key = f"{_geom(shape)}/b{bucket}"
        self._batch_counts[key] = self._batch_counts.get(key, 0) + 1

    def _harvest_one(self) -> None:
        fl = self._inflight.popleft()
        progs, tel = self.programs[fl.shape], self.telemetry
        tracing = tel.spans is not None
        if tracing:
            t0 = self._clock()
            tel.open_span("harvest", t0, batch=fl.trace.seq)
            progs.wait(fl.handle)
            t1 = self._clock()
            tel.add_span("harvest.wait", t0, t1, wait=True)
        # waits on the batch's output copy into pinned host memory (the
        # rows of every mesh device, gathered in order)
        y = progs.harvest(fl.handle)
        now = self._clock()
        if tracing:
            tel.add_span("harvest.read", t1, now)
        fl.trace.harvest_t = now
        tel.record_batch(fl.trace)
        scatter_outputs(fl.chunk, y)
        seen: Dict[int, ServeRequest] = {}
        counts: Dict[int, int] = {}
        for r, _ in fl.chunk:
            seen[id(r)] = r
            counts[id(r)] = counts.get(id(r), 0) + 1
        for rid_, r in seen.items():
            r._transfer_ms += fl.trace.transfer_ms
            r._add_window(fl.trace.dispatch_t, now)
            r._served_units += counts[rid_]
            r._batches.append(fl.trace.seq)
            if r._served_units == r.images.shape[0]:
                self._complete(r, now)
        if tracing:
            t2 = self._clock()
            tel.add_span("harvest.scatter", now, t2)
            tel.close_span(t2)

    def _complete(self, req: ServeRequest, now: float) -> None:
        req.status = SERVED
        req.done = True
        deadline_ms = (None if req._deadline_t is None else
                       (req._deadline_t - req._submit_t) * 1e3)
        self.telemetry.record_request(RequestTrace(
            rid=req.rid, geometry=_geom(req.images.shape[1:]),
            images=int(req.images.shape[0]), status=SERVED,
            deadline_ms=deadline_ms,
            queue_ms=(req._first_dispatch_t - req._submit_t) * 1e3,
            transfer_ms=req._transfer_ms, compute_ms=req._compute_ms,
            total_ms=(now - req._submit_t) * 1e3,
            batches=tuple(req._batches)))
        self._completed.append(req)

    # -- serving entry points -------------------------------------------
    def poll(self) -> List[ServeRequest]:
        """One scheduler pass: dispatch every batch the close policy
        allows, harvesting only when the pipeline is full.  Returns the
        requests that COMPLETED during this pass (served or rejected);
        work still in flight completes on a later ``poll``/``flush``."""
        start = len(self._completed)
        for shape in self.programs:
            while True:
                batch = self._form_batch(shape, self._clock(), force=False)
                if batch is None:
                    break
                self._dispatch(shape, *batch)
                while len(self._inflight) >= self.pipeline_depth:
                    self._harvest_one()
        return self._completed[start:]

    def flush(self) -> List[ServeRequest]:
        """Harvest every in-flight batch; returns newly completed."""
        start = len(self._completed)
        while self._inflight:
            self._harvest_one()
        return self._completed[start:]

    def run(self) -> List[ServeRequest]:
        """Drain everything pending (the ``CnnServeEngine.run``-shaped
        entry point): batches close regardless of ``max_wait_ms``, the
        pipeline stays ``pipeline_depth`` deep, and every submitted
        request comes back completed — served or deadline-rejected — in
        completion order."""
        start = len(self._completed)
        while any(self._pending.values()):
            for shape in self.programs:
                while True:
                    batch = self._form_batch(shape, self._clock(),
                                             force=True)
                    if batch is None:
                        break
                    self._dispatch(shape, *batch)
                    while len(self._inflight) >= self.pipeline_depth:
                        self._harvest_one()
        self.flush()
        return self._completed[start:]

    # -- observability ---------------------------------------------------
    def pending_counts(self) -> Dict[str, int]:
        return {_geom(s): len(u) for s, u in self._pending.items() if u}

    def stats(self) -> Dict:
        """JSON-ready serving summary: request/batch counters, deadline
        misses, double-buffer overlap counters, and p50/p95/p99 latency
        rollups per stage (queue/transfer/compute/total)."""
        st = self.telemetry.rollup()
        served = [t for t in self.telemetry.requests
                  if t.status == SERVED]
        st.update({
            "geometries": [_geom(s) for s in self.programs],
            "batches_by_program": dict(sorted(self._batch_counts.items())),
            # serving dtype per BUILT bucket program ("int8" /
            # "float32+int8" under a QuantPolicy) — unbuilt buckets are
            # omitted rather than force-planned here
            "serve_dtype_by_program": {
                f"{_geom(shape)}/b{b}": progs.serve_dtype(b)
                for shape, progs in self.programs.items()
                for b in progs.compiled_buckets},
            "pending": self.pending_counts(),
            "inflight": len(self._inflight),
            "max_inflight": self._max_inflight,
            # batches closed early because a pending deadline was
            # tighter than the remaining close-policy wait
            "slo_closes": self._slo_closes,
            # served past their deadline (admitted on time, finished
            # late) — distinct from admission-rejected deadline_misses
            "late_served": sum(
                1 for t in served
                if t.deadline_ms is not None and t.total_ms > t.deadline_ms),
        })
        return st
