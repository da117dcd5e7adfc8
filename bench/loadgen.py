"""Traffic: one generator for every mix, and the one serving loop.

A mix is a data file (``traffic/<name>.json``):

  loop            ``closed``: ``clients`` callers, each with one request
                  of ``images`` images outstanding, sending the next as
                  soon as the last comes back
  buckets, max_wait_ms, pipeline_depth
                  the front end's knobs for the cell
  pool            images drawn from the seed; a request takes
                  ``images`` consecutive ones from a seeded offset

Every seed gives the same work: a request's images change with the
seed, never their number.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np


class Request:
    """One request as the client sees it: its pool offset, when it was
    due (its client saw its last reply then) and when its logits were
    back."""
    __slots__ = ("rid", "offset", "images", "due", "done", "served")

    def __init__(self, rid: int, offset: int, images: int, due: float):
        self.rid, self.offset, self.images = rid, offset, images
        self.due, self.done, self.served = due, None, None


class Source:
    """The arrivals of one mix from ``t0``: ``due(now)`` hands out every
    request due by ``now``; ``complete(served, t)`` records replies (a
    closed loop's client is due again at ``t``)."""

    def __init__(self, traffic: dict, rng: np.random.Generator, t0: float,
                 pool: int):
        if traffic["loop"] != "closed":
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        self.rng, self.pool = rng, pool
        self.images = int(traffic["images"])
        self.requests: List[Request] = []
        self._rid = 0
        self._by_rid = {}
        self._times = [t0] * int(traffic["clients"])
        self._next = 0

    def next_due(self) -> float:
        return (self._times[self._next] if self._next < len(self._times)
                else float("inf"))

    def due(self, now: float) -> List[Request]:
        out = []
        while self._next < len(self._times) and self._times[self._next] <= now:
            offset = int(self.rng.integers(0, self.pool - self.images + 1))
            r = Request(self._rid, offset, self.images,
                        self._times[self._next])
            self._by_rid[self._rid] = r
            self._rid += 1
            self._next += 1
            self.requests.append(r)
            out.append(r)
        return out

    def complete(self, served, t: float) -> None:
        for s in served:
            r = self._by_rid.pop(s.rid)
            r.done, r.served = t, s
            self._times.append(t)


def drive(server, pending: Callable[[], bool], make, source: Source,
          t_end: float, clock: Callable[[], float] = time.perf_counter,
          spans: Optional[list] = None) -> None:
    """The serving loop, until ``t_end``: submit every request that is
    due, ``poll()``, and ``flush()`` when nothing is pending or due.
    ``make(request)`` builds the server's request object.  With
    ``spans`` (a list), each call that took 20 us or more is recorded
    there as ``(name, start, end)`` on ``clock``."""
    def call(name, fn, *args):
        if spans is None:
            return fn(*args)
        t0 = clock()
        out = fn(*args)
        t1 = clock()
        if t1 - t0 >= 20e-6:
            spans.append((name, t0, t1))
        return out

    while True:
        now = clock()
        if now >= t_end:
            return
        for r in source.due(now):
            call("submit", server.submit, make(r))
        source.complete(call("poll", server.poll), clock())
        if not pending() and source.next_due() > clock():
            source.complete(call("flush", server.flush), clock())


def drain(server, source: Source, clock=time.perf_counter,
          spans: Optional[list] = None) -> None:
    """After the window: serve everything submitted (``run()``)."""
    t0 = clock()
    source.complete(server.run(), clock())
    if spans is not None:
        spans.append(("drain", t0, clock()))
