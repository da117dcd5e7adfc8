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
               dtype: np.dtype) -> np.ndarray:
    """Stack a chunk of units into a ``(bucket, H, W, C)`` batch:
    contiguous request slices are concatenated and short chunks get
    zero-padded tail slots, all cast to ``dtype``."""
    parts = [np.asarray(r.images[i0:i1], dtype)
             for r, i0, i1 in contiguous_blocks(chunk)]
    pad = bucket - len(chunk)
    if pad:
        parts.append(np.zeros((pad,) + tuple(image_shape), dtype))
    return np.concatenate(parts, axis=0)


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

class BucketPrograms:
    """One geometry's bucket programs: build, warm, pick, pack.

    Owns the ``{bucket: program}`` table for one ``(image_shape,
    buckets)`` pair on one device, and on the card each bucket's CUDA
    graph.  ``input_dtype()`` is the single source of truth for the
    dtype requests are packed to AND the dtype ``warmup()`` runs.
    """

    def __init__(self, model, params, image_shape: Tuple[int, int, int], *,
                 buckets: Tuple[int, ...] = (1, 4, 8), algorithm="auto",
                 backend: Optional[str] = None, precision=None,
                 fuse: bool = True, input_dtype=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.image_shape = tuple(map(int, image_shape))     # (H, W, C)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets}")
        self.algorithm = algorithm
        self.backend = backend or backend_for(self.device)
        self.precision = precision
        self.fuse = fuse
        self._input_dtype = np.dtype(input_dtype or np.float32)
        self._fns: Dict[int, Callable] = {}    # bucket -> program
        self._plans: Dict[int, object] = {}    # bucket -> GraphPlan
        #: on the card: bucket -> its CUDA graph, all in one memory pool
        self.graphs: Dict[int, graphs.GraphedProgram] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if graphs.used_on(self.device) else None)

    # ------------------------------------------------------------------
    def input_dtype(self) -> np.dtype:
        """The one packing/warmup dtype (fp32 by default whatever the
        precision policy: conv nodes cast to their spec dtype)."""
        return self._input_dtype

    @property
    def compiled_buckets(self) -> Tuple[int, ...]:
        """Batch sizes with a built program — never exceeds ``buckets``."""
        return tuple(sorted(self._fns))

    def plan(self, b: int):
        """Bucket ``b``'s GraphPlan (built on first use)."""
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
        """Place one packed batch on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(xb)).to(self.device)

    def fn(self, b: int) -> Callable:
        """The program for bucket ``b`` (its plan resolved on first use)."""
        f = self._fns.get(b)
        if f is None:
            gp = self.model.graph_plan(
                (b,) + self.image_shape, backend=self.backend,
                force=None if self.algorithm == "auto" else self.algorithm,
                precision=self.precision, fuse=self.fuse)
            self._plans[b] = gp

            def f(params, xb, gp=gp):
                return self.model.apply(params, xb, graph_plan=gp)
            self._fns[b] = f
        return f

    def serve_batch(self, b: int, xb: np.ndarray) -> torch.Tensor:
        """Bucket ``b``'s program on one packed ``(b, H, W, C)`` batch.
        On the card: the batch is copied into the bucket's static input
        and its CUDA graph replayed (captured after the bucket's first
        eager batch, and again after any parameter tensor changed); the
        result is the graph's static output, overwritten by the bucket's
        next batch.  On the CPU: the eager program ``fn(b)``."""
        f = self.fn(b)
        if not graphs.used_on(self.device):
            return f(self.params, self.put(xb))
        g = self.graphs.get(b)
        if g is None:
            static = torch.empty(
                (b,) + self.image_shape, device=self.device,
                dtype=torch.from_numpy(np.empty(0, self._input_dtype)).dtype)
            g = self.graphs[b] = graphs.GraphedProgram(
                lambda params, _, x: f(params, x), [static],
                pool=self._pool)
        return g(self.params, None,
                 torch.from_numpy(np.ascontiguousarray(xb)))

    def pack(self, chunk: Sequence[Tuple[ImageRequest, int]],
             bucket: int) -> np.ndarray:
        return pack_units(chunk, bucket, self.image_shape,
                          self.input_dtype())

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, *, measure: bool = False,
               tune: Optional[str] = None) -> Dict[int, float]:
        """Resolve every bucket's plan and run it once on zeros (which
        builds the kernels on first use), then on the card capture its
        CUDA graph.

        ``tune="algo"`` first measure-autotunes each bucket's GraphPlan
        on the engine's device (``GraphPlan.warmup``), and ``"full"``
        also settles fusions and races launch configs; then the bucket's
        program and CUDA graph are dropped, since a node that changed
        executor would leave them serving the old launches, and built
        again (one eager run, then a capture).  A forced ``algorithm``
        is not tuned.  ``measure=True`` is the older spelling of
        ``tune="algo"``.  Returns per-bucket milliseconds of the first
        run (and capture)."""
        if measure and tune is None:
            tune = "algo"
        H, W, C = self.image_shape
        out = {}
        for b in self.buckets:
            if tune is not None and self.algorithm == "auto":
                self.model.graph_plan(
                    (b, H, W, C), backend=self.backend,
                    precision=self.precision, fuse=self.fuse).warmup(
                        tune=tune, device=self.device)
                self._fns.pop(b, None)
                self._plans.pop(b, None)
                self.graphs.pop(b, None)
            self.fn(b)
            x = np.zeros((b, H, W, C), self.input_dtype())
            t0 = time.perf_counter()
            self.serve_batch(b, x)
            self.sync()
            out[b] = (time.perf_counter() - t0) * 1e3
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
