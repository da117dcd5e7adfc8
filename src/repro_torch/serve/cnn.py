"""Batch-bucketed CNN serving over graph-planned programs.

Incoming image requests (each carrying one image or a small batch) are
flattened into per-image units and multiplexed onto the largest bucket
that fits the remaining queue; short remainders ride the smallest
bucket with zero-padded slots.  Plans are resolved once per bucket (and
persisted via the graph-level cache), so a warm engine serves any
request mix with zero plan() resolutions and at most ``len(buckets)``
bucket programs.  Each bucket program is a call of the bucket's
``GraphPlan`` (``BucketPrograms.fn``); on the card it is captured as one
CUDA graph per bucket (``serve/graphs.py``), the counterpart of the JAX
package's per-bucket ``jax.jit``, and the CPU runs it eagerly.

Bucket-program building lives in ``BucketPrograms`` so the synchronous
drain engine here and the continuous-batching ``AsyncServeFrontend``
(serve/frontend.py) share one component.  The frontend drives it through
``dispatch``/``harvest``: on the card each geometry owns a ring of
pinned host slots, so a batch's host-to-device copy runs on a side
stream while the batch before it computes, and its output comes back by
an asynchronous copy into pinned memory (see ``BucketPrograms``).

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); its plans are made for the card's backend
(``"cuda"``) unless ``backend`` says otherwise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.convspec import backend_for, resolve_device
from repro_torch.dist import sharding
from repro_torch.serve import graphs


@dataclasses.dataclass
class ImageRequest:
    rid: int
    images: np.ndarray                  # (n, H, W, C), or (H, W, C) for one
    out: Optional[np.ndarray] = None    # (n, num_classes) once served
    done: bool = False

    def __post_init__(self):
        self.images = np.asarray(self.images)
        if self.images.ndim == 3:
            self.images = self.images[None]
        if self.images.ndim != 4:
            raise ValueError(f"images must be (n, H, W, C) or (H, W, C); "
                             f"got shape {self.images.shape}")


# ---------------------------------------------------------------------------
# packing: per-image units -> one contiguous batch array

def contiguous_blocks(chunk: Sequence[Tuple[ImageRequest, int]]
                      ) -> List[Tuple[ImageRequest, int, int]]:
    """Collapse ``(request, image_index)`` units into maximal contiguous
    ``(request, i0, i1)`` slices."""
    blocks: List[List] = []
    for r, i in chunk:
        if blocks and blocks[-1][0] is r and blocks[-1][2] == i:
            blocks[-1][2] = i + 1
        else:
            blocks.append([r, i, i + 1])
    return [tuple(b) for b in blocks]


def pack_units(chunk: Sequence[Tuple[ImageRequest, int]], bucket: int,
               image_shape: Tuple[int, int, int],
               dtype: np.dtype, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """Stack a chunk of units into a ``(bucket, H, W, C)`` batch:
    contiguous request slices are concatenated and short chunks get
    zero-padded tail slots, all cast to ``dtype``.  With ``out`` (an
    array of ``dtype`` with at least ``bucket`` rows, e.g. a view of a
    pinned host buffer) the batch is written into ``out[:bucket]`` and
    that view returned, so it is built once, where it is copied from;
    each slice goes through one (multi-threaded) tensor copy."""
    if out is None:
        parts = [np.asarray(r.images[i0:i1], dtype)
                 for r, i0, i1 in contiguous_blocks(chunk)]
        pad = bucket - len(chunk)
        if pad:
            parts.append(np.zeros((pad,) + tuple(image_shape), dtype))
        return np.concatenate(parts, axis=0)
    dst = torch.from_numpy(out)
    off = 0
    for r, i0, i1 in contiguous_blocks(chunk):
        dst[off:off + i1 - i0].copy_(
            torch.from_numpy(np.ascontiguousarray(r.images[i0:i1])))
        off += i1 - i0
    dst[off:bucket].zero_()
    return out[:bucket]


def scatter_outputs(chunk: Sequence[Tuple[ImageRequest, int]],
                    y: np.ndarray) -> None:
    """Write batch outputs back into each request's ``out`` rows (the
    inverse of ``pack_units``; padded rows ignored)."""
    off = 0
    for r, i0, i1 in contiguous_blocks(chunk):
        if r.out is None:
            r.out = np.empty((r.images.shape[0], y.shape[-1]), y.dtype)
        r.out[i0:i1] = y[off:off + (i1 - i0)]
        off += i1 - i0


# ---------------------------------------------------------------------------
# the reusable bucket-program component

@dataclasses.dataclass
class _Slot:
    """One pipelined batch's buffers on the card: a pinned host input
    and a pinned host output sized for the geometry's largest bucket,
    and per mesh device a staging tensor and two events (its input copy
    landed; its output copy to the host done).  ``owner`` is the
    dispatched batch whose output the slot holds until it is read."""
    host_in: torch.Tensor
    host_out: torch.Tensor
    staging: List[torch.Tensor]
    copied: List[torch.cuda.Event]
    done: List[torch.cuda.Event]
    owner: Optional["Dispatched"] = None


@dataclasses.dataclass
class Dispatched:
    """A batch ``BucketPrograms.dispatch`` put in flight: its bucket,
    real units, and the dispatcher's clock at the copy's issue
    (``transfer_t0``), after the host waited on the copy
    (``transfer_t1``) and after the program was launched
    (``dispatch_t``).  ``harvest`` turns it into the batch's output."""
    bucket: int
    units: int
    transfer_t0: float
    transfer_t1: float
    dispatch_t: float
    slot: Optional[_Slot] = None        # on the card, until read
    y: Optional[np.ndarray] = None      # the output, once on the host


class BucketPrograms:
    """One geometry's bucket programs: build, warm, pick, pack, dispatch.

    Owns the ``{bucket: program}`` table for one ``(image_shape,
    buckets)`` pair on one device, and on the card each bucket's CUDA
    graph.  ``input_dtype()`` is the single source of truth for the
    dtype requests are packed to AND the dtype ``warmup()`` runs.

    **Asynchronous dispatch** (``dispatch``/``harvest``, what the async
    frontend drives).  On the card the geometry owns a ring of
    ``pipeline_depth + 1`` slots (``_Slot``), all allocated by
    ``warmup()`` so the caching allocator never hands a buffer across
    streams.  ``dispatch`` packs the batch into a slot's pinned host
    input, issues a ``non_blocking`` host-to-device copy into the slot's
    staging tensor on a side copy stream and records an event; the
    compute stream (the current one) waits on that event, the host waits
    on it too (so the host blocks on the copy, never on the compute),
    then the bucket's CUDA graph replays on the staging tensor (its
    static-input copy is device to device, in stream order) and a
    ``non_blocking`` copy of the graph's static output into the slot's
    pinned host output is enqueued right behind it, with a done event.
    ``harvest`` waits on the done event and reads the pinned output.  A
    slot is reused only once its done event has completed, so no copy
    into its staging tensor can run ahead of the replay that reads it,
    and no replay can overwrite an output before it was copied out; a
    slot whose batch was never harvested is read into that batch first.
    On the CPU both run eagerly and synchronously, with no streams.

    **Sharded mode** (``mesh=`` a device tuple from
    ``launch.mesh.make_serve_mesh``, or e.g. ``("cpu",) * 4``): the
    configured ``buckets`` become PER-SHARD capacities and the served
    (global) buckets are ``bucket * len(mesh)``.  A batch is cut into
    contiguous row slices, device ``i`` runs the per-shard bucket
    program on slice ``i`` (its own CUDA graphs, staging tensors and
    events; the params copied to it once, ``dist.sharding``), and the
    rows are gathered in order.  The per-shard program runs at the
    per-shard batch shape, so outputs are bit-equal to the single-device
    program at that bucket whatever the device count.

    **Spans** (``telemetry``: a ``serve.telemetry.Telemetry`` made with
    ``trace=True``, else None): ``dispatch`` records ``dispatch`` with
    children ``dispatch.slot`` (on the card; its child
    ``dispatch.slot.wait`` when an unread batch is read out first),
    ``dispatch.pack``, ``dispatch.copy`` (the copy's issue; on the CPU the
    synchronous ``put``), ``dispatch.copy_wait`` (on the card) and
    ``dispatch.launch``, and the batch's counters; ``warmup`` records
    ``warmup`` with ``warmup.plan`` for each bucket, then its
    ``warmup.eager`` (on the CPU), or on the card ``warmup.eager`` and
    ``warmup.capture`` for each mesh device whose graph is captured
    anew, then ``warmup.slots`` (on the card).
    Spans of the copy wait and the slot's wait cover every mesh device's
    events.  ``wait`` is the harvest's blocking half, for the caller's
    span of it.
    """

    def __init__(self, model, params, image_shape: Tuple[int, int, int], *,
                 buckets: Tuple[int, ...] = (1, 4, 8), algorithm="auto",
                 backend: Optional[str] = None, precision=None,
                 fuse: bool = True, input_dtype=None, device=None,
                 mesh=None, pipeline_depth: int = 2, telemetry=None):
        self.mesh = None if mesh is None else sharding.replicated(mesh)
        if self.mesh is not None:
            if not self.mesh:
                raise ValueError("mesh must hold at least one device")
            if len({d.type for d in self.mesh}) != 1:
                raise ValueError(f"a serve mesh is one kind of device; "
                                 f"got {self.mesh}")
            device = self.mesh[0]
        self.device = resolve_device(device)
        #: the devices the batch rows are cut over (one when unsharded)
        self.devices = self.mesh or (self.device,)
        self.n_shards = len(self.devices)
        self.model = model
        self.image_shape = tuple(map(int, image_shape))     # (H, W, C)
        self.shard_buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.shard_buckets or self.shard_buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets}")
        # the buckets traffic is packed to: global batch sizes
        self.buckets = tuple(b * self.n_shards for b in self.shard_buckets)
        self.algorithm = algorithm
        self.backend = backend or backend_for(self.device)
        self.precision = precision
        self.fuse = fuse
        self.pipeline_depth = int(pipeline_depth)
        self._input_dtype = np.dtype(input_dtype or np.float32)
        self._fns: Dict[int, Callable] = {}    # global bucket -> program
        self._plans: Dict[int, object] = {}    # global bucket -> GraphPlan
        # params: as given, or one copy per mesh device (made once; a
        # tree already replicated on this mesh passes through)
        self.params = (params if self.mesh is None
                       else sharding.replicate_params(params, self.mesh))
        self._shard_params = ([params] if self.mesh is None
                              else list(self.params))
        #: on the card: per mesh device, global bucket -> its CUDA
        #: graph; one memory pool per device
        self._graphs: List[Dict[int, graphs.GraphedProgram]] = [
            {} for _ in self.devices]
        on_card = graphs.used_on(self.device)
        self._pools = [torch.cuda.graph_pool_handle() if on_card else None
                       for _ in self.devices]
        self._copy_streams = [torch.cuda.Stream(device=d) if on_card
                              else None for d in self.devices]
        self._slots: List[_Slot] = []
        self._next_slot = 0
        self.telemetry = telemetry      # the span recorder, or None

    # ------------------------------------------------------------------
    @property
    def graphs(self) -> Dict[int, graphs.GraphedProgram]:
        """The first (unsharded: the only) device's bucket graphs."""
        return self._graphs[0]

    def input_dtype(self) -> np.dtype:
        """The one packing/warmup dtype (fp32 by default whatever the
        precision policy: conv nodes cast to their spec dtype)."""
        return self._input_dtype

    def _torch_input_dtype(self) -> torch.dtype:
        return torch.from_numpy(np.empty(0, self._input_dtype)).dtype

    @property
    def compiled_buckets(self) -> Tuple[int, ...]:
        """Batch sizes with a built program — never exceeds ``buckets``."""
        return tuple(sorted(self._fns))

    def plan(self, b: int):
        """Global bucket ``b``'s per-shard GraphPlan (built on first use)."""
        if b not in self._plans:
            self.fn(b)
        return self._plans[b]

    def serve_dtype(self, b: int) -> str:
        """The compute dtype(s) bucket ``b``'s conv nodes serve in."""
        gp = self.plan(b)
        dtypes = sorted({p.spec.dtype for p in gp.conv_plans.values()})
        return "+".join(dtypes) if dtypes else str(self._input_dtype)

    def serve_dtypes(self) -> Dict[int, str]:
        return {b: self.serve_dtype(b) for b in self.buckets}

    def pick_bucket(self, pending: int) -> int:
        """Largest bucket the pending unit count fills, else the
        smallest bucket (its tail slots ride zero-padded)."""
        fits = [b for b in self.buckets if b <= pending]
        return max(fits) if fits else self.buckets[0]

    def put(self, xb: np.ndarray) -> torch.Tensor:
        """Place one packed batch on the engine's (first) device."""
        return torch.from_numpy(np.ascontiguousarray(xb)).to(self.device)

    def shard_units(self, real: int, b: int) -> Optional[List[int]]:
        """Real (non-padded) images per mesh device for a batch of
        ``real`` units packed to global bucket ``b`` — shards take
        contiguous row slices, so padding concentrates in the trailing
        devices.  None when unsharded."""
        if self.mesh is None:
            return None
        per = b // self.n_shards
        return [max(0, min(per, real - i * per))
                for i in range(self.n_shards)]

    def fn(self, b: int) -> Callable:
        """The program for global bucket ``b`` (its per-shard plan
        resolved on first use): ``fn(b)(self.params, xb)``.  Sharded, it
        runs the per-shard plan on each device's row slice and gathers
        the rows on the first device."""
        f = self._fns.get(b)
        if f is None:
            per = b // self.n_shards
            gp = self.model.graph_plan(
                (per,) + self.image_shape, backend=self.backend,
                force=None if self.algorithm == "auto" else self.algorithm,
                precision=self.precision, fuse=self.fuse)
            self._plans[b] = gp
            if self.mesh is None:
                def f(params, xb, gp=gp):
                    return self.model.apply(params, xb, graph_plan=gp)
            else:
                def f(params, xb, gp=gp, per=per):
                    return torch.cat([
                        self.model.apply(
                            p, xb[i * per:(i + 1) * per].to(d),
                            graph_plan=gp).to(self.device)
                        for i, (p, d) in enumerate(zip(params,
                                                       self.devices))])
            self._fns[b] = f
        return f

    def _graph(self, i: int, b: int) -> graphs.GraphedProgram:
        """Mesh device ``i``'s CUDA graph of global bucket ``b``'s
        per-shard program, over a static input of the shard's rows."""
        g = self._graphs[i].get(b)
        if g is None:
            gp = self.plan(b)
            static = torch.empty((b // self.n_shards,) + self.image_shape,
                                 device=self.devices[i],
                                 dtype=self._torch_input_dtype())
            g = self._graphs[i][b] = graphs.GraphedProgram(
                lambda params, _, x, gp=gp: self.model.apply(
                    params, x, graph_plan=gp), [static],
                pool=self._pools[i])
        return g

    def serve_batch(self, b: int, xb: np.ndarray) -> torch.Tensor:
        """Bucket ``b``'s program on one packed ``(b, H, W, C)`` batch,
        synchronously (``CnnServeEngine.run``).  On the card: each
        device's rows are copied into its bucket graph's static input and
        the graph replayed (captured after the bucket's first eager
        batch, and again after any parameter tensor changed); unsharded,
        the result is the graph's static output, overwritten by the
        bucket's next batch.  On the CPU: the eager program ``fn(b)``."""
        f = self.fn(b)
        if not graphs.used_on(self.device):
            return f(self.params, self.put(xb))
        per = b // self.n_shards
        ys = []
        for i, p in enumerate(self._shard_params):
            with torch.cuda.device(self.devices[i]):
                ys.append(self._graph(i, b)(p, None, torch.from_numpy(
                    np.ascontiguousarray(xb[i * per:(i + 1) * per]))))
        if self.mesh is None:
            return ys[0]
        return torch.cat([y.to(self.device) for y in ys])

    def pack(self, chunk: Sequence[Tuple[ImageRequest, int]],
             bucket: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        return pack_units(chunk, bucket, self.image_shape,
                          self.input_dtype(), out=out)

    # -- asynchronous dispatch (the async frontend's path) ---------------
    def _alloc_slots(self) -> None:
        """The ring of ``pipeline_depth + 1`` pinned host slots, sized
        for the largest bucket (on the card; after the bucket graphs
        exist, whose outputs size the host output buffers)."""
        self.sync()
        bmax = self.buckets[-1]
        out = self._graph(0, bmax).outputs
        dt = self._torch_input_dtype()
        self._slots = [
            _Slot(host_in=torch.empty((bmax,) + self.image_shape, dtype=dt,
                                      pin_memory=True),
                  host_out=torch.empty((bmax,) + tuple(out.shape[1:]),
                                       dtype=out.dtype, pin_memory=True),
                  staging=[torch.empty(
                      (bmax // self.n_shards,) + self.image_shape, dtype=dt,
                      device=d) for d in self.devices],
                  copied=[torch.cuda.Event() for _ in self.devices],
                  done=[torch.cuda.Event() for _ in self.devices])
            for _ in range(self.pipeline_depth + 1)]
        self._next_slot = 0

    def _take_slot(self, clock: Callable[[], float]
                   ) -> Tuple[_Slot, bool]:
        """The next slot of the ring, free, and whether a batch still in
        it was read to the host first (which waits on its done
        events)."""
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.owner is None:
            return slot, False
        rec = self.telemetry
        if rec is not None:
            t0 = clock()
            self.wait(slot.owner)
            rec.add_span("dispatch.slot.wait", t0, clock(), wait=True)
        self._read(slot.owner)
        return slot, True

    def wait(self, h: Dispatched) -> None:
        """Block until batch ``h``'s output is in pinned host memory (at
        once where it was read already, and on the CPU)."""
        if h.slot is not None:
            for e in h.slot.done:
                e.synchronize()

    def _read(self, h: Dispatched) -> None:
        self.wait(h)
        slot, h.slot = h.slot, None
        h.y = slot.host_out[:h.bucket].float().numpy().copy()
        slot.owner = None

    def _graph_counts(self, b: int) -> Tuple[int, int]:
        """Replays and captures of bucket ``b``'s graphs, over devices."""
        gs = [g[b] for g in self._graphs if b in g]
        return (sum(g.replays for g in gs), sum(g.captures for g in gs))

    def dispatch(self, b: int, chunk: Sequence[Tuple[ImageRequest, int]],
                 clock: Callable[[], float] = time.perf_counter,
                 seq: Optional[int] = None) -> Dispatched:
        """Put one batch of ``chunk``'s units, packed to global bucket
        ``b``, in flight without waiting for its compute (see the class
        docstring); ``clock`` is read before the copy is issued, after the
        host waited on it, and after the launch.  ``seq`` is the batch's
        number in the spans (the span edges those reads share: the
        start of ``dispatch.copy``, the end of ``dispatch.copy_wait``
        and of ``dispatch.launch``)."""
        on_card = graphs.used_on(self.device)
        if on_card and not self._slots:
            self.warmup(clock=clock)
        rec = self.telemetry
        if rec is not None:
            ts = clock()
            rec.open_span("dispatch", ts, batch=seq)
            counts = self._graph_counts(b)
        if not on_card:
            xb = self.pack(chunk, b)
            t0 = clock()
            xd = self.put(xb)
            t1 = clock()
            y = self.fn(b)(self.params, xd).float().numpy()
            h = Dispatched(b, len(chunk), t0, t1, clock(), y=y)
            if rec is not None:
                self._dispatched(rec, h, seq, ts, None, counts, False)
            return h
        if rec is not None:
            rec.open_span("dispatch.slot", ts)
        slot, forced = self._take_slot(clock)
        if rec is not None:
            ts = clock()
            rec.close_span(ts)
        self.pack(chunk, b, out=slot.host_in.numpy())
        per = b // self.n_shards
        t0 = clock()
        for i, (d, stream) in enumerate(zip(self.devices,
                                            self._copy_streams)):
            with torch.cuda.stream(stream):
                slot.staging[i][:per].copy_(
                    slot.host_in[i * per:(i + 1) * per], non_blocking=True)
                slot.copied[i].record(stream)
            torch.cuda.current_stream(d).wait_event(slot.copied[i])
        tc = clock() if rec is not None else None
        for e in slot.copied:
            e.synchronize()
        t1 = clock()
        for i, (d, p) in enumerate(zip(self.devices, self._shard_params)):
            with torch.cuda.device(d):
                y = self._graph(i, b)(p, None, slot.staging[i][:per])
                slot.host_out[i * per:(i + 1) * per].copy_(
                    y, non_blocking=True)
                slot.done[i].record()
        h = Dispatched(b, len(chunk), t0, t1, clock(), slot=slot)
        slot.owner = h
        if rec is not None:
            self._dispatched(rec, h, seq, ts, tc, counts, forced)
        return h

    def _dispatched(self, rec, h: Dispatched, seq: Optional[int],
                    packed_t: float, issued_t: Optional[float],
                    counts: Tuple[int, int], forced: bool) -> None:
        """Close batch ``h``'s ``dispatch`` span: its pack from
        ``packed_t``, the copy's issue (to ``issued_t`` and then its wait,
        on the card), the launch; and count what it did."""
        rec.add_span("dispatch.pack", packed_t, h.transfer_t0)
        if issued_t is None:
            rec.add_span("dispatch.copy", h.transfer_t0, h.transfer_t1)
        else:
            rec.add_span("dispatch.copy", h.transfer_t0, issued_t)
            rec.add_span("dispatch.copy_wait", issued_t, h.transfer_t1,
                         wait=True)
        rec.add_span("dispatch.launch", h.transfer_t1, h.dispatch_t)
        rec.close_span(h.dispatch_t)
        replays, captures = self._graph_counts(h.bucket)
        rec.count(seq, packed_bytes=h.bucket * int(np.prod(self.image_shape))
                  * self._input_dtype.itemsize,
                  replays=replays - counts[0], captures=captures - counts[1],
                  forced_reads=forced)

    def harvest(self, h: Dispatched) -> np.ndarray:
        """A dispatched batch's ``(b, classes)`` output as fp32 numpy,
        once its compute and output copy are done (waits for them)."""
        if h.y is None:
            self._read(h)
        return h.y

    def sync(self) -> None:
        if self.device.type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)

    def warmup(self, *, measure: bool = False,
               tune: Optional[str] = None,
               clock: Callable[[], float] = time.perf_counter
               ) -> Dict[int, float]:
        """Resolve every bucket's plan and run it once on zeros (which
        builds the kernels on first use), then on the card capture its
        CUDA graph (one per mesh device) and allocate the dispatch
        slots.  ``clock`` times the spans (see the class docstring).

        ``tune="algo"`` first measure-autotunes each bucket's per-shard
        GraphPlan on the engine's device (``GraphPlan.warmup``), and
        ``"full"`` also settles fusions and races launch configs; then
        the bucket's program and CUDA graphs are dropped, since a node
        that changed executor would leave them serving the old launches,
        and built again (one eager run, then a capture).  A forced
        ``algorithm`` is not tuned.  ``measure=True`` is the older
        spelling of ``tune="algo"``.  Returns per-bucket milliseconds of
        the first run (and capture), keyed by global bucket."""
        if measure and tune is None:
            tune = "algo"
        rec = self.telemetry
        on_card = graphs.used_on(self.device)
        if rec is not None:
            rec.open_span("warmup", clock())
        H, W, C = self.image_shape
        out = {}
        for b in self.buckets:
            if rec is not None:
                ts = clock()
            if tune is not None and self.algorithm == "auto":
                self.model.graph_plan(
                    (b // self.n_shards, H, W, C), backend=self.backend,
                    precision=self.precision, fuse=self.fuse).warmup(
                        tune=tune, device=self.device)
                self._fns.pop(b, None)
                self._plans.pop(b, None)
                for g in self._graphs:
                    g.pop(b, None)
            self.fn(b)
            if rec is not None:
                t1 = clock()
                rec.add_span("warmup.plan", ts, t1)
            x = np.zeros((b, H, W, C), self.input_dtype())
            t0 = time.perf_counter()
            if not on_card:
                self.serve_batch(b, x)
                if rec is not None:
                    rec.add_span("warmup.eager", t1, clock())
            per = b // self.n_shards
            for i, p in enumerate(self._shard_params if on_card else ()):
                # serve_batch's first call of each graph, in its halves;
                # the capture would sync the device before it anyway
                g, d = self._graph(i, b), self.devices[i]
                xi = torch.from_numpy(x[i * per:(i + 1) * per])
                with torch.cuda.device(d):
                    if g.fresh(p, None):
                        g(p, None, xi)
                        continue
                    g.warm(p, None, xi)
                    torch.cuda.synchronize(d)
                    t2 = clock() if rec is not None else None
                    g.capture(p, None)
                    if rec is not None:
                        rec.add_span("warmup.eager", t1, t2)
                        t1 = clock()
                        rec.add_span("warmup.capture", t2, t1)
            self.sync()
            out[b] = (time.perf_counter() - t0) * 1e3
        if on_card:
            if rec is not None:
                ts = clock()
            self._alloc_slots()
            if rec is not None:
                rec.add_span("warmup.slots", ts, clock())
        if rec is not None:
            rec.close_span(clock())
        return out


# ---------------------------------------------------------------------------
# the synchronous drain engine

class CnnServeEngine:
    """Serve image-classification traffic through batch-bucketed plans,
    on the card unless ``device="cpu"``."""

    def __init__(self, model, params, image_shape: Tuple[int, int, int], *,
                 buckets: Tuple[int, ...] = (1, 4, 8), algorithm="auto",
                 backend: Optional[str] = None, precision=None,
                 fuse: bool = True, input_dtype=None, device=None):
        self.programs = BucketPrograms(
            model, params, image_shape, buckets=buckets,
            algorithm=algorithm, backend=backend, precision=precision,
            fuse=fuse, input_dtype=input_dtype, device=device)
        self.queue: List[ImageRequest] = []
        self.stats = {"requests": 0, "images": 0, "padded_slots": 0,
                      "batches": {b: 0 for b in self.programs.buckets}}

    # -- thin views over the shared component --------------------------
    @property
    def model(self):
        return self.programs.model

    @property
    def params(self):
        return self.programs.params

    @property
    def device(self) -> torch.device:
        return self.programs.device

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return self.programs.image_shape

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self.programs.buckets

    @property
    def compiled_buckets(self) -> Tuple[int, ...]:
        return self.programs.compiled_buckets

    def serve_dtypes(self) -> Dict[int, str]:
        return self.programs.serve_dtypes()

    def warmup(self, *, measure: bool = False,
               tune: Optional[str] = None) -> Dict[int, float]:
        """Resolve (and, with ``tune``, measure-autotune) and run every
        bucket program once (see ``BucketPrograms.warmup``)."""
        return self.programs.warmup(measure=measure, tune=tune)

    # ------------------------------------------------------------------
    def submit(self, req: ImageRequest) -> None:
        if tuple(req.images.shape[1:]) != self.image_shape:
            raise ValueError(f"request {req.rid}: image shape "
                             f"{req.images.shape[1:]} != engine shape "
                             f"{self.image_shape}")
        self.queue.append(req)

    def run(self) -> List[ImageRequest]:
        """Drain the queue; returns the served requests (outputs filled).

        Requests are flattened to per-image units and packed batch by
        batch: the largest bucket that the remaining unit count fills,
        else the smallest bucket with padded (zero) slots.
        """
        served, units = list(self.queue), []
        for r in served:
            units.extend((r, i) for i in range(r.images.shape[0]))
        cursor = 0
        while cursor < len(units):
            b = self.programs.pick_bucket(len(units) - cursor)
            chunk = units[cursor:cursor + b]
            y = self.programs.serve_batch(b, self.programs.pack(chunk, b))
            scatter_outputs(chunk, y.float().cpu().numpy())
            self.stats["batches"][b] += 1
            self.stats["padded_slots"] += b - len(chunk)
            self.stats["images"] += len(chunk)
            cursor += b
        # only a fully drained queue is cleared: a failure above leaves
        # every request submitted (outputs rewrite idempotently on retry)
        self.queue = []
        self.stats["requests"] += len(served)
        for r in served:
            r.done = True
        return served
