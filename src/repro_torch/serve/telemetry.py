"""Per-request serving telemetry: latency stages and percentile rollups.

The JAX package's ``serve/telemetry.py`` for the port.  Every request
served by the async front end (serve/frontend.py) leaves a
``RequestTrace`` — how long it queued, how long its batches spent in
host-to-device transfer, how long the device computed, and the wall
total — and every dispatched batch leaves a ``BatchTrace`` (geometry,
bucket, padding, the transfer/dispatch/harvest timeline, and whether its
transfer overlapped an in-flight batch — the double-buffering signal).
``Telemetry.rollup()`` turns the traces into the machine-readable
summary ``frontend.stats()`` exposes: p50/p95/p99 per stage,
deadline-miss counts, overlap counters.

**Spans and counters**, off unless the recorder is made with
``trace=True`` (``AsyncServeFrontend(..., trace=True)``): then
``spans`` lists one ``Span`` per host step of the serving path, in the
order they opened, and ``counters`` holds per batch what its dispatch
packed, replayed, captured and read out early (``COUNTERS``), and
``placements`` per bucket where its plan put the conv nodes
(``GraphPlan.placement()``: on the port's kernels, a library or plain
PyTorch, and the pools left unfolded).  A span's ``batch`` is the
``BatchTrace.seq`` of the batch it served, and each ``RequestTrace``
names the batches that carried it, so spans, batches and requests share
identifiers.  The serving code reads the clock for a span's edges only
when tracing, and where a ``BatchTrace`` time and a span edge coincide
they are the same read.  Off, ``spans``, ``counters`` and
``placements`` are None and nothing is recorded.

The module is deliberately model-free: it imports neither torch nor
anything else of the port, so any serving layer can record into it.
All times are seconds from one injected monotonic clock; rollups
convert to milliseconds.

One deliberate difference from the reference: ``percentile``
interpolates as ``s[lo] + frac*(s[hi] - s[lo])`` clamped to
``[s[lo], s[hi]]``, which is monotone in ``q`` in floating point (the
reference's ``s[lo]*(1-frac) + s[hi]*frac`` is not when
``s[lo] == s[hi]``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

#: the latency stages every request is accounted under (ms in rollups)
STAGES = ("queue", "transfer", "compute", "total")
#: what each traced batch's dispatch counts: bytes packed into its input
#: (bucket x image bytes), CUDA graph replays and captures it ran, and
#: unharvested batches it read out of its slot first
COUNTERS = ("packed_bytes", "replays", "captures", "forced_reads")


class Span(NamedTuple):
    """One host step of the serving path, in seconds on the front end's
    clock.  ``parent`` is the index in ``Telemetry.spans`` of the span
    enclosing it (None at the top), ``batch`` the ``BatchTrace.seq`` of
    the batch it served (None for set-up), and ``wait`` marks a span in
    which the host blocked on the device."""
    name: str
    t0: float
    t1: float
    parent: Optional[int]
    batch: Optional[int]
    wait: bool


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default method), monotone
    in ``q`` in floating point — so p99 >= p95 >= p50 always holds.

    ``pos`` grows with ``q``; within one interval the rounded
    ``s[lo] + frac*(s[hi] - s[lo])`` grows with ``frac``, and the clamp
    keeps it at or below ``s[hi]``, the next interval's lower end."""
    if not xs:
        raise ValueError("percentile of empty sequence")
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return min(max(s[lo] + frac * (s[hi] - s[lo]), s[lo]), s[hi])


def rollup_percentiles(xs: Sequence[float],
                       qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` for one latency series."""
    return {f"p{int(q)}": percentile(xs, q) for q in qs}


@dataclasses.dataclass
class RequestTrace:
    """One served (or rejected) request's latency accounting.

    ``transfer_ms`` sums over every batch that carried one of the
    request's images (the host waits on each copy, so they never
    overlap).  ``compute_ms`` is the length of the UNION of those
    batches' in-flight windows (dispatch → observed completion): with
    double buffering two of them are in flight together, and their sum
    would exceed the request's own wall time, so ``compute_ms <=
    total_ms`` and ``queue_ms <= total_ms`` always hold.  For a request
    that one batch carried it equals the batch's window, as in the
    reference.  A window may include time queued behind the previous
    batch on the device, which is exactly what the request experienced.
    """
    rid: int
    geometry: str                       # "HxWxC"
    images: int
    status: str                         # "served" | "deadline_exceeded"
    deadline_ms: Optional[float]
    queue_ms: float
    transfer_ms: float
    compute_ms: float
    total_ms: float
    batches: Tuple[int, ...] = ()       # seq of each batch that carried it

    def stage_ms(self, stage: str) -> float:
        return getattr(self, f"{stage}_ms")


@dataclasses.dataclass
class BatchTrace:
    """One dispatched batch's timeline (all times: seconds on the
    frontend's clock).  ``overlapped`` is True when this batch's
    host→device transfer started while a previous batch was still in
    flight — the double-buffering overlap signal on the host's side
    (``chip_smoke.py`` checks the device's side in a profiler trace).
    ``shard_units`` (sharded serving only) is how many REAL images
    landed on each mesh device — batch padding concentrates in the
    trailing shards, so ``max - min`` per batch is the shard-imbalance
    signal ``rollup()`` counts.  ``dtype`` is the
    serving dtype of the bucket program that ran the batch (e.g.
    ``"float32"``, ``"bfloat16"``, ``"float32+int8"`` for a quantized
    graph with fp fallback nodes) — stamped by the dispatcher, opaque
    here."""
    geometry: str
    bucket: int
    units: int                          # real (non-padded) images
    padded: int
    transfer_t0: float
    transfer_t1: float
    dispatch_t: float
    harvest_t: float = 0.0
    overlapped: bool = False
    shard_units: Optional[Sequence[int]] = None    # per-device real images
    dtype: Optional[str] = None         # bucket program's serving dtype
    seq: int = -1                       # the front end's batch number

    @property
    def transfer_ms(self) -> float:
        return (self.transfer_t1 - self.transfer_t0) * 1e3

    @property
    def compute_ms(self) -> float:
        return (self.harvest_t - self.dispatch_t) * 1e3


class Telemetry:
    """Accumulates request/batch traces and rolls them up; with
    ``trace=True`` also the serving path's spans and counters."""

    def __init__(self, trace: bool = False):
        self.requests: List[RequestTrace] = []
        self.batches: List[BatchTrace] = []
        self.deadline_misses = 0
        self.spans: Optional[List[Span]] = [] if trace else None
        #: batch seq -> {counter: count} (``COUNTERS``), when tracing
        self.counters: Optional[Dict[int, Dict[str, int]]] = (
            {} if trace else None)
        #: bucket -> its plan's ``GraphPlan.placement()``, when tracing
        self.placements: Optional[Dict[int, Dict[str, object]]] = (
            {} if trace else None)
        self._open: List[int] = []      # open spans, innermost last

    def _inside(self, batch: Optional[int]) -> tuple:
        """The innermost open span, and ``batch`` or else its batch."""
        parent = self._open[-1] if self._open else None
        if batch is None and parent is not None:
            batch = self.spans[parent].batch
        return parent, batch

    def open_span(self, name: str, t0: float,
                  batch: Optional[int] = None) -> None:
        """Start a span inside the innermost open one (of its batch,
        unless ``batch`` is given); ``close_span`` ends it."""
        parent, batch = self._inside(batch)
        self._open.append(len(self.spans))
        self.spans.append(Span(name, t0, t0, parent, batch, False))

    def close_span(self, t1: float) -> None:
        i = self._open.pop()
        self.spans[i] = self.spans[i]._replace(t1=t1)

    def add_span(self, name: str, t0: float, t1: float, *,
                 wait: bool = False, batch: Optional[int] = None) -> None:
        """A finished span inside the innermost open one."""
        parent, batch = self._inside(batch)
        self.spans.append(Span(name, t0, t1, parent, batch, wait))

    def count(self, batch: int, **counts: int) -> None:
        """Add to batch ``batch``'s counters (names from ``COUNTERS``)."""
        c = self.counters.setdefault(batch, dict.fromkeys(COUNTERS, 0))
        for k, v in counts.items():
            c[k] += int(v)

    def record_request(self, trace: RequestTrace) -> None:
        self.requests.append(trace)
        if trace.status == "deadline_exceeded":
            self.deadline_misses += 1

    def record_batch(self, trace: BatchTrace) -> None:
        self.batches.append(trace)

    # ------------------------------------------------------------------
    def latency_ms(self) -> Dict[str, Dict[str, float]]:
        """p50/p95/p99 per stage over the *served* requests."""
        served = [t for t in self.requests if t.status == "served"]
        if not served:
            return {}
        return {stage: rollup_percentiles([t.stage_ms(stage)
                                           for t in served])
                for stage in STAGES}

    def shard_rollup(self) -> Optional[Dict]:
        """Per-device utilization + imbalance over the sharded batches.

        ``per_device_units`` counts real images landed per mesh device;
        ``per_device_utilization`` divides by that device's offered
        slots (its share of every dispatched bucket).  A batch is
        ``imbalanced`` when its real units don't divide evenly across
        the shards (padding rode the trailing devices); the max
        per-batch spread is reported so a pathological router shows up
        as a number, not a feeling.  None when nothing sharded ran.
        """
        sb = [b for b in self.batches if b.shard_units is not None]
        if not sb:
            return None
        n = max(len(b.shard_units) for b in sb)
        units = [0] * n
        slots = [0] * n
        for b in sb:
            per = b.bucket // len(b.shard_units)
            for i, u in enumerate(b.shard_units):
                units[i] += int(u)
                slots[i] += per
        spreads = [max(b.shard_units) - min(b.shard_units) for b in sb]
        return {
            "devices": n,
            "per_device_units": units,
            "per_device_utilization": [
                u / s if s else 0.0 for u, s in zip(units, slots)],
            "sharded_batches": len(sb),
            "imbalanced_batches": sum(1 for s in spreads if s > 0),
            "max_shard_imbalance": max(spreads),
        }

    def rollup(self) -> Dict:
        """The JSON-ready summary ``frontend.stats()`` builds on."""
        served = [t for t in self.requests if t.status == "served"]
        out = {
            "requests": len(self.requests),
            "served": len(served),
            "deadline_misses": self.deadline_misses,
            "images": sum(t.images for t in served),
            "batches": len(self.batches),
            "padded_slots": sum(b.padded for b in self.batches),
            "overlapped_batches": sum(1 for b in self.batches
                                      if b.overlapped),
            "latency_ms": self.latency_ms(),
        }
        dtypes = self.dtype_rollup()
        if dtypes:
            out["serve_dtypes"] = dtypes
        shard = self.shard_rollup()
        if shard is not None:
            out["sharding"] = shard
        return out

    def dtype_rollup(self) -> Dict[str, Dict[str, int]]:
        """Per serving-dtype batch/image counters over the dispatched
        batches — ``{"int8": {"batches": 3, "images": 12}, ...}``.
        Empty when no dispatcher stamped a dtype (older layers)."""
        out: Dict[str, Dict[str, int]] = {}
        for b in self.batches:
            if b.dtype is None:
                continue
            d = out.setdefault(b.dtype, {"batches": 0, "images": 0})
            d["batches"] += 1
            d["images"] += int(b.units)
        return out
