"""Reading the device from a ``torch.profiler`` trace of the window.

``traced(devices)`` wraps the window in a profiler of the host and the
cards, after a warm-up step whose records are dropped, held open
``PAD_S`` on both sides (a trace closed right after the work can lose
its last kernels).  ``Trace`` then holds each card's kernel, memcpy and
memset records, their union (busy time), the traced window's length,
the kernels that took most time, and the longest idle gaps labelled by
what the harness's loop was doing then.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Sequence, Tuple

PAD_S = 0.25
WARM_LAUNCHES = 50
WINDOW_SPAN = "bench.window"


@contextlib.contextmanager
def traced(devices: Sequence):
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for d in devices:
            warm = torch.zeros(256, device=d)
            for _ in range(WARM_LAUNCHES):
                warm.add_(1)
        _sync(devices)
        prof.step()
        time.sleep(PAD_S)
        yield prof
        _sync(devices)
        time.sleep(PAD_S)


def _sync(devices) -> None:
    import torch
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged intervals of ``(start, end)`` pairs."""
    out: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [tuple(i) for i in out]


class Trace:
    """The device's side of one traced window; times in seconds.

    ``records[d]`` are card ``d``'s ``(name, start, end)``;  ``window``
    is the harness's ``bench.window`` span, widened to the first and
    last record where the card's clock put one outside it."""

    def __init__(self, prof, spans: Sequence[Tuple[str, float, float]],
                 window_clock: Tuple[float, float]):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.records: Dict[int, List[Tuple[str, float, float]]] = (
            collections.defaultdict(list))
        anchor = None
        # the profiler's raw records: building its FunctionEvent tree
        # over a window's million records takes minutes
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                name = e.name()
                if e.is_user_annotation() or name.startswith("ProfilerStep"):
                    continue
                self.records[int(e.device_index())].append(
                    (name, e.start_ns() / 1e9, e.end_ns() / 1e9))
            elif anchor is None and e.name() == WINDOW_SPAN:
                anchor = (e.start_ns() / 1e9, e.end_ns() / 1e9)
        if anchor is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        # the host clock's window maps onto the trace's by its start
        shift = anchor[0] - window_clock[0]
        self.spans = [(n, t0 + shift, t1 + shift) for n, t0, t1 in spans]
        starts = [r[1] for rs in self.records.values() for r in rs]
        ends = [r[2] for rs in self.records.values() for r in rs]
        self.t0 = min([anchor[0]] + starts)
        self.t1 = max([anchor[1]] + ends)
        self.busy = {d: union([(r[1], r[2]) for r in rs])
                     for d, rs in self.records.items()}

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self, device: int) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy.get(device, []))

    def kernel_s(self, match) -> float:
        """Seconds of the records whose name ``match`` accepts, over
        every card (a record's own length: records of one card do not
        overlap on its one compute stream)."""
        return sum(t1 - t0 for rs in self.records.values()
                   for name, t0, t1 in rs if match(name))

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = collections.defaultdict(float)
        for rs in self.records.values():
            for name, t0, t1 in rs:
                total[name[:160]] += t1 - t0
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, device: int, n: int = 10) -> List[List]:
        """The ``n`` longest gaps with nothing on card ``device``, each
        labelled by the loop's call that covered most of it (``loop``:
        none of the recorded calls, so the loop was waiting for work),
        or by a garbage collection (``gc<generation>``) that covered half
        of it, inside whichever call."""
        edges = [self.t0]
        for t0, t1 in self.busy.get(device, []):
            edges += [t0, t1]
        edges.append(self.t1)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, g0, g1 in gaps:
            cover: Dict[str, float] = collections.defaultdict(float)
            for name, s0, s1 in self.spans:
                if s1 > g0 and s0 < g1:
                    cover[name] += min(s1, g1) - max(s0, g0)
            gcs = {k: v for k, v in cover.items() if k.startswith("gc")}
            if gcs and max(gcs.values()) >= length / 2:
                cover = gcs
            label = max(cover, key=cover.get) if cover else "loop"
            out.append([label, length])
        return out
