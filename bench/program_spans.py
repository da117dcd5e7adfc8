#!/usr/bin/env python3
"""The program's own spans (``AsyncServeFrontend(trace=True)``, see
``src/repro_torch/serve/telemetry.py``) beside the device trace, for one
run of a cell.

    python3 bench/program_spans.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> --spans <0|1>

It runs ``harness.run_cell`` as ``bench/run.py`` does, with the front
end made with ``trace=--spans``, and prints one JSON line.  Untraced it
holds the end-to-end metrics, so ``--spans 1`` against ``--spans 0`` is
what the spans cost.  Traced it adds the three readers below, the
``--trace 1`` per-layer metrics, where the card's ten longest idle gaps
fall among the program's spans, how the host's copies line up with the
card's memcpy records, the batches' counters, and how set-up splits
around the program's ``warmup`` span.  The benchmark's own runs never
run this; no metric of ``BENCHMARK.json`` reads these spans yet.

Each reader takes a window ``w`` as the per-layer readers do, with
``w.spans`` (the program's spans on its clock, or None) and on
``w.trace`` the shift of the program's clock onto the trace's at the
start of the ``bench.window`` span (``to_trace``), and returns None
where there are no spans:
- ``host_ms_per_image``: host milliseconds an image inside the window's
  batches' ``batch.form``, ``dispatch`` and ``harvest`` spans, less
  their wait spans;
- ``idle_in_dispatch``: the share (%) of the traced region in which a
  card is idle while the host is in that work, the mean over cards;
  None too where the shift does not hold the card's memcpy records to
  their spans (``clock_ok``), since it lays the spans on the trace;
- ``warmup_s``: the length of the program's ``warmup`` spans.

The gaps are put down to the program's spans only where ``clock_ok``
holds, for the same reason.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BATCH_SPANS = ("batch.form", "dispatch", "harvest")
#: the card's records of a batch's input and output copies
H2D, D2H = "Memcpy HtoD", "Memcpy DtoH"
#: how far a memcpy record may lie outside its host span (s), and the
#: share of a window's batches whose records must lie within it
CLOCK_SLACK, CLOCK_SHARE = 100e-6, 0.99


def _union(intervals):
    from bench.tracing import union
    return union(list(intervals))


def _minus(a, b) -> List[Tuple[float, float]]:
    """Sorted disjoint intervals ``a`` less sorted disjoint ``b``."""
    out, j = [], 0
    for t0, t1 in a:
        while j < len(b) and b[j][1] <= t0:
            j += 1
        k, s = j, t0
        while k < len(b) and b[k][0] < t1:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < t1:
            out.append((s, t1))
    return out


def _overlap_s(a, b) -> float:
    """Seconds in both of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _batch_spans(w):
    """The window's batches' spans: ``(tops, waits)``, each a list of
    the spans of a ``w.batches`` seq."""
    seqs = {b.seq for b in w.batches}
    mine = [s for s in w.spans if s[4] in seqs]
    return ([s for s in mine if s[3] is None and s[0] in BATCH_SPANS],
            [s for s in mine if s[5]])


def to_trace(tr, t: float) -> float:
    """Program-clock time ``t`` on the trace's clock: shifted by the
    start of the ``bench.window`` span (``tr.shift``)."""
    return t + tr.shift


def _work(w, tr=None) -> List[Tuple[float, float]]:
    """The host's own work for the window's batches, on ``tr``'s clock
    (the program's without it)."""
    tops, waits = _batch_spans(w)

    def on(spans):
        if tr is None:
            return _union((s[1], s[2]) for s in spans)
        return _union((to_trace(tr, s[1]), to_trace(tr, s[2]))
                      for s in spans)
    return _minus(on(tops), on(waits))


def host_ms_per_image(w) -> Optional[float]:
    images = sum(b.units for b in w.batches)
    if not w.spans or not images:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in _work(w)) / images


def idle_in_dispatch(w) -> Optional[float]:
    if not w.spans or w.trace is None or not all(
            clock_ok(clock_check(w, d)) for d in range(w.cards)):
        return None
    tr = w.trace
    work = _work(w, tr)
    share = 0.0
    for d in range(w.cards):
        idle = _minus([(tr.t0, tr.t1)], tr.busy.get(d, []))
        share += _overlap_s(idle, work) / tr.window_s
    return 100.0 * share / w.cards


def warmup_s(w) -> Optional[float]:
    if not w.spans:
        return None
    lengths = [s[2] - s[1] for s in w.spans
               if s[0] == "warmup" and s[3] is None]
    return sum(lengths) if lengths else None


# -- what a traced run shows beyond the readers ---------------------------

def idle_gaps(tr, device: int, n: int = 10):
    """The ``n`` longest ``(start, end)`` gaps with nothing on card
    ``device`` in the traced region (``Trace.idle_gaps``' gaps)."""
    idle = _minus([(tr.t0, tr.t1)], tr.busy.get(device, []))
    return sorted(idle, key=lambda g: g[0] - g[1])[:n]


def innermost(spans, tr, g0: float, g1: float):
    """The program's innermost span holding at least half of the gap
    ``(g0, g1)`` on ``tr``'s clock, from the top: its path of names and
    its share of the gap; an empty path where no top-level span holds
    half of it."""
    path, share, parent = [], 0.0, None
    while True:
        best, cover = None, 0.0
        for i, s in enumerate(spans):
            if s[3] != parent:
                continue
            c = min(to_trace(tr, s[2]), g1) - max(to_trace(tr, s[1]), g0)
            if c > cover:
                best, cover = i, c
        if best is None or cover < (g1 - g0) / 2:
            return path, share
        path.append(spans[best][0])
        share, parent = cover / (g1 - g0), best


def harness_label(tr, g0: float, g1: float) -> str:
    """The harness's span (its loop's calls, ``gc<n>``) that holds most
    of the gap, or ``loop``."""
    cover = collections.defaultdict(float)
    for name, s0, s1 in tr.spans:
        if s1 > g0 and s0 < g1:
            cover[name] += min(s1, g1) - max(s0, g0)
    return max(cover, key=cover.get) if cover else "loop"


def clock_check(w, device: int = 0) -> dict:
    """Each batch's input copy (``dispatch.copy`` to the end of
    ``dispatch.copy_wait``) and output wait (``harvest.wait``), mapped
    by ``to_trace``, against card ``device``'s memcpy records, matched in
    order: the share of batches within ``CLOCK_SLACK`` and the worst
    overshoot (s) of each edge, and the median of how far each H2D
    record starts after its ``dispatch.copy``."""
    tr = w.trace

    def on(t):
        return to_trace(tr, t)
    recs = sorted(tr.records.get(device, []), key=lambda r: r[1])
    h2d = [r for r in recs if r[0].startswith(H2D)]
    d2h = [r for r in recs if r[0].startswith(D2H)]
    by = collections.defaultdict(dict)
    for s in w.spans:
        by[s[4]][s[0]] = s
    rows = [by[b.seq] for b in w.batches]
    out = {"batches": len(rows), "h2d": len(h2d), "d2h": len(d2h)}
    if not rows or len(h2d) != len(rows) or len(d2h) != len(rows):
        return out
    worst = {"h2d_start": [], "h2d_end": [], "d2h_end": []}
    for sp, hi, lo in zip(rows, h2d, d2h):
        wait = sp.get("dispatch.copy_wait", sp["dispatch.copy"])
        worst["h2d_start"].append(on(sp["dispatch.copy"][1]) - hi[1])
        worst["h2d_end"].append(hi[2] - on(wait[2]))
        worst["d2h_end"].append(lo[2] - on(sp["harvest.wait"][2]))
    for k, xs in worst.items():
        out[k] = {"within": sum(x <= CLOCK_SLACK for x in xs) / len(xs),
                  "worst_s": max(xs)}
    lead = [hi[1] - on(sp["dispatch.copy"][1]) for sp, hi in zip(rows, h2d)]
    out["h2d_lead_median_s"] = sorted(lead)[len(lead) // 2]
    return out


def clock_ok(check: dict) -> bool:
    """Whether ``clock_check``'s three edges each lie within
    ``CLOCK_SLACK`` in at least ``CLOCK_SHARE`` of the batches (False
    where the records and batches could not be matched)."""
    return all(k in check and check[k]["within"] >= CLOCK_SHARE
               for k in ("h2d_start", "h2d_end", "d2h_end"))


def counters(w, tel) -> dict:
    """The window's batches' counters summed, and the pack's rate."""
    total = collections.Counter()
    for b in w.batches:
        total.update(tel.counters.get(b.seq, {}))
    pack = sum(s[2] - s[1] for s in w.spans if s[0] == "dispatch.pack"
               and s[4] in {b.seq for b in w.batches})
    out = dict(total)
    if pack:
        out["pack_GB_per_s"] = total["packed_bytes"] / pack / 1e9
    return out


def span_totals(w) -> dict:
    """Per span name, over the window's batches and the ``warmup`` tree:
    total seconds, and the median and longest span in ms."""
    seqs = {b.seq for b in w.batches}
    by = collections.defaultdict(list)
    for s in w.spans:
        if s[4] in seqs or s[0].startswith("warmup"):
            by[s[0]].append(s[2] - s[1])
    return {k: {"s": sum(v), "p50_ms": 1e3 * sorted(v)[len(v) // 2],
                "max_ms": 1e3 * max(v)} for k, v in by.items()}


# -- the run ---------------------------------------------------------------

@contextlib.contextmanager
def _spied(spans_on: bool):
    """``run_cell`` with the front end made with ``trace=spans_on``, its
    window, trace and set-up's steps kept in the dict yielded."""
    from unittest import mock

    from bench import harness, tracing
    from bench.systems import cnn as system
    got = {}
    frontend = system.AsyncServeFrontend

    def make_frontend(*a, **kw):
        if spans_on:
            kw["trace"] = True
        got["server"] = frontend(*a, **kw)
        return got["server"]

    class Window(harness.Window):
        def __init__(self, **kw):
            super().__init__(**kw)
            got["window"] = self

    class Trace(tracing.Trace):
        def __init__(self, prof, spans, window_clock):
            super().__init__(prof, spans, window_clock)
            a0 = next(e.start_ns() / 1e9
                      for e in prof.profiler.kineto_results.events()
                      if e.name() == tracing.WINDOW_SPAN)
            self.shift = a0 - window_clock[0]
            got["trace"] = self

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                got[name] = (t0, time.perf_counter())
        return call

    with contextlib.ExitStack() as stack:
        for obj, name, new in (
                (system, "AsyncServeFrontend", make_frontend),
                (harness, "Window", Window), (tracing, "Trace", Trace),
                (harness.netlist, "draw_params",
                 timed("draw_params", harness.netlist.draw_params)),
                (harness.netlist, "draw_images",
                 timed("draw_images", harness.netlist.draw_images)),
                (system.Served, "__init__",
                 timed("served_init", system.Served.__init__)),
                (system.Served, "warmup",
                 timed("served_warmup", system.Served.warmup))):
            stack.enter_context(mock.patch.object(obj, name, new))
        yield got


def setup_split(got, setup_s: float) -> dict:
    """Set-up, from the process's start, around the program's warmup:
    imports, then to the weights' draw (the card's start), the weights,
    the images (and their copy to the host), the served program's
    construction, the plans and kernel builds (``Served.warmup`` less the
    program's ``warmup``; all of it without spans), the program's
    ``warmup``, and the warm round and collection after it."""
    warm = warmup_s(got["window"]) or 0.0
    p0, p1 = got["draw_params"]
    m0, _ = got["draw_images"]
    i0, i1 = got["served_init"]
    w0, w1 = got["served_warmup"]
    return {"setup_s": setup_s,
            "imports": got["imported"] - T_START,
            "to_draw": p0 - got["imported"],
            "draw_params": p1 - p0,
            "draw_images": i0 - m0,
            "served_init": i1 - i0,
            "plans_and_builds": (w1 - w0) - warm,
            "program_warmup": warm,
            "after_warmup": T_START + setup_s - w1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["REPRO_CACHE_DIR"] = str(ROOT / "build" / "bench_cache")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import harness
    logged = []

    def log(msg):
        logged.append(msg)
        print(msg, file=sys.stderr, flush=True)
    with _spied(bool(args.spans)) as got:
        got["imported"] = time.perf_counter()
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START, log=log)
    setup_s = float(next(re.search(r"set-up ([0-9.]+) s", m).group(1)
                         for m in logged if "set-up" in m))
    w = got["window"]
    w.spans = getattr(got["server"].telemetry, "spans", None)
    line = {"workload": args.workload, "seed": args.seed,
            "spans": args.spans, "trace": args.trace,
            "correct": result["correct"], "metrics": {
                k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"]}
    line["setup"] = setup_split(got, setup_s)
    if w.spans is not None:
        line["span_s"] = span_totals(w)
    if args.trace and w.spans is not None:
        line["readers"] = {"host_ms_per_image": host_ms_per_image(w),
                           "idle_in_dispatch": idle_in_dispatch(w),
                           "warmup_s": warmup_s(w)}
        tr = w.trace
        line["clock"] = clock_check(w)
        line["clock_ok"] = clock_ok(line["clock"])
        line["gaps"] = []
        for g0, g1 in idle_gaps(tr, 0):
            gap = {"ms": 1e3 * (g1 - g0), "at_s": g0 - tr.t0,
                   "harness": harness_label(tr, g0, g1)}
            if line["clock_ok"]:
                path, gap["share"] = innermost(w.spans, tr, g0, g1)
                gap["program"] = "/".join(path) or "outside the program"
            line["gaps"].append(gap)
        line["counters"] = counters(w, got["server"].telemetry)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
