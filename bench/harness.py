"""One run of one cell: set-up, the measured window, the check.

``run_cell`` reads the cell from ``BENCHMARK.json``, its configuration
from ``configs/`` and its traffic mix from ``traffic/``, both by name;
the configuration's ``system`` names the adapter in ``systems/`` (its
``check`` refuses a node list the program cannot run, its ``Served``
serves one) and its ``reference`` the plain reference in
``reference/``; each per-layer metric is the ``read`` function of
``metrics/<name>.py``.

Set-up (``setup_s``, from the process's start): weights and an image
pool drawn from the seed on the first card, the program planned (its
plans persisted in the checkout), the kernels its plans launch built
where missing, every bucket warmed and captured, then one round of the
cell's own traffic (each client's first request, served).
The window is ``seconds`` of the traffic, then ``run()`` serves what is
still queued.  After it the peak memory is read, the program freed, and
the reference run over the image pool; every request due in the window
is compared with it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from bench import loadgen, netlist

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
REFERENCE_BLOCK = 64


class NoDevice(RuntimeError):
    """The cell asks for more cards than this machine has."""


def load_cell(workload: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    cfg = netlist.load(cell["config"])
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def cell_metrics(bench: dict, cell: dict, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end``/``per_layer``) that
    ``cell`` reports: those listing it, and those with no list whose
    ``moves`` metric it reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and (kind == "end_to_end" or m["moves"] in e2e)]


def reader(name: str) -> Callable:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Window:
    """What the per-layer readers read: the cell, the requests due in
    the window (``loadgen.Request``), the front end's batch records of
    the traced region, each bucket's nodes on the port's conv kernels
    (``kernel_nodes``) and each conv node's executor's kernels
    (``node_kernels``, by launch name; none where a window is made
    without them), and the trace (``tracing.Trace``; None untraced)."""

    node_kernels: Dict[int, Dict[str, tuple]] = {}

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(devices) -> None:
    import torch
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: Optional[float] = None, devices=None, image=None,
             pool: Optional[int] = None, fault: Optional[Callable] = None,
             log=print) -> dict:
    """One run; returns the result line's object.  ``devices``,
    ``image``, ``pool`` and ``fault`` are for tests on the CPU: the
    devices to serve on (skipping the look for cards), a smaller image,
    a smaller pool, and a function that breaks the served program before
    the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, traffic = load_cell(workload)
    import torch
    chips = int(cell["chips"])
    on_card = devices is None
    if on_card:
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if found < chips:
            raise NoDevice(f"{workload} needs {chips} CUDA device(s); "
                           f"this machine has {found}")
        devices = [torch.device("cuda", i) for i in range(chips)]
    devices = [torch.device(d) for d in devices]
    dev0 = devices[0]
    system = importlib.import_module(f"bench.systems.{cfg['system']}")
    reference = importlib.import_module(f"bench.reference.{cfg['reference']}")
    system.check(cfg)
    pool_n = int(pool or traffic["pool"])

    gen = torch.Generator(device=dev0).manual_seed(int(seed))
    params = netlist.draw_params(cfg, gen, dev0)
    images_dev = netlist.draw_images(cfg, gen, dev0, pool_n, image)
    images = images_dev.cpu().numpy()
    del images_dev
    if on_card:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    served = system.Served(cfg, traffic, params, devices, image)
    served.warmup()
    if fault is not None:
        fault(served)
    rng = np.random.default_rng(int(seed))

    def make(r):
        return served.request(r.rid, images[r.offset:r.offset + r.images])

    clock = time.perf_counter
    warm = loadgen.Source(traffic, np.random.default_rng(int(seed) + 1),
                          clock(), pool_n)
    for r in warm.due(clock()):
        served.server.submit(make(r))
    loadgen.drain(served.server, warm)
    _sync(devices)
    n_batch0 = len(served.batches)
    # the start-up heap (torch's modules, the image pool) is frozen, as
    # long-running Python servers do after start-up, so the collector's
    # full passes in the window walk what serving made, not it
    gc.collect()
    gc.freeze()
    setup_s = clock() - t_start
    log(f"[bench] set-up {setup_s:.2f} s")

    spans = [] if trace else None
    if trace:
        gc.callbacks.append(_gc_spans(spans, clock))
    prof_ctx = contextlib.nullcontext()
    if trace:
        from bench import tracing
        prof_ctx = tracing.traced(devices)
    with prof_ctx as prof:
        span = contextlib.nullcontext()
        if trace:
            span = torch.profiler.record_function(tracing.WINDOW_SPAN)
        with span:
            t0 = clock()
            source = loadgen.Source(traffic, rng, t0, pool_n)
            loadgen.drive(served.server, served.pending, make, source,
                          t0 + seconds, spans=spans)
            t_close = t0 + seconds
            loadgen.drain(served.server, source, spans=spans)
            _sync(devices)
            t_region = clock()
    if trace:
        gc.callbacks.pop()
    log(f"[bench] window {seconds} s, drained {t_region - t_close:.3f} s")
    memory_peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
                   if on_card else 0)

    requests = source.requests
    win = Window(cfg=cfg, traffic=traffic, cell=cell, cards=len(devices),
                 image=tuple(image or cfg["image"]), requests=requests,
                 t0=t0, t_close=t_close, t_region=t_region,
                 batches=served.batches[n_batch0:],
                 kernel_nodes=served.kernel_nodes(),
                 node_kernels=served.node_kernels(), trace=None)
    if trace:
        t_parse = clock()
        win.trace = tracing.Trace(prof, spans, (t0, t_region))
        log(f"[bench] trace read in {clock() - t_parse:.2f} s")

    # the check: the program freed first, then the reference
    outputs = [(r, None if r.served is None else r.served.out)
               for r in requests]
    del served, prof
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = clock()
    ref = reference.logits_in_blocks(
        cfg, params, torch.from_numpy(images).to(dev0), REFERENCE_BLOCK)
    ref = ref.numpy()
    scale = float(np.sqrt(np.mean(np.square(ref, dtype=np.float64))))
    limit = float(cfg["check"]["logit_err"])
    worst, failed = 0.0, 0
    for r, out in outputs:
        if out is None or not np.all(np.isfinite(out)):
            failed += 1
            continue
        err = float(np.max(np.abs(out - ref[r.offset:r.offset + r.images]))
                    ) / scale
        worst = max(worst, err)
        failed += err > limit
    log(f"[bench] reference over {len(images)} images in "
        f"{clock() - t_ref:.2f} s; logit rms {scale:.6g}")

    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell_metrics(bench, cell, "end_to_end"):
            value = end_to_end(m["name"], win, setup_s, seconds)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "per_layer"):
            value = reader(m["name"])(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else dev0.type,
              "kind": (torch.cuda.get_device_name(dev0) if on_card
                       else dev0.type),
              "count": len(devices), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": failed == 0 and bool(requests),
              "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": device}
    if trace:
        tr = win.trace
        device["busy_s"] = (sum(tr.busy_s(d.index or 0) for d in devices)
                            / len(devices))
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps(dev0.index or 0)}
    result["check"] = {"logit_err": {"value": worst, "limit": limit},
                       "failed": {"value": failed, "limit": 0}}
    return result


def _gc_spans(spans: list, clock):
    """A ``gc.callbacks`` entry that records each collection as a
    ``gc<generation>`` span."""
    start = [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = clock()
        else:
            spans.append((f"gc{info['generation']}", start[0], clock()))
    return cb


def end_to_end(name: str, win: Window, setup_s: float, seconds: float):
    """The host clock's metrics: ``images_per_s`` counts the images of
    the requests whose logits were back on the host by the window's
    close, over the window."""
    if name == "setup_s":
        return setup_s
    if name == "images_per_s":
        return sum(r.images for r in win.requests
                   if r.done is not None and r.done <= win.t_close) / seconds
    raise KeyError(f"no end-to-end metric {name!r}")
