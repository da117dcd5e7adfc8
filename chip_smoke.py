"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card (fp32 and bf16) at the
shapes the main path gives it, drives the main path through the entry
points a user calls — the paper's profiled conv rows through
``repro_torch.conv2d`` and ``resnet_like`` served by ``CnnServeEngine``
at 32x32 (buckets 1 and 4) and 224x224 (bucket 1) — and shows from the
launch counters that the path ran the kernels.  It then times served
latency over windows of a few hundred requests per geometry, times each
kernel (CUDA graph replays between CUDA events, so host dispatch is
left out; eager times and the host's time per call are kept beside)
with its plain version, one library call and its bound, and prints one
``{"kernels": [...]}`` line, the card's name
and power limit, and as its last line the device record.  Details go
to ``chiprun_out/chip_smoke.json``.  Any failed phase exits non-zero.
Without CUDA, or without the repository beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

FP32_TOL, BF16_TOL = 2e-5, 3e-2  # kernel vs plain: x * max(1, max|plain|)
SERVE_TOL = 3e-4                 # card vs CPU engine: x * max|cpu output|

WINDOWS, WINDOW_REQUESTS = 3, 300   # served-latency windows per geometry
GRAPH_CALLS, GRAPH_REPLAYS = 20, 10  # calls captured per graph, replays


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs the card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port pulled in jax or the JAX package")
    os.environ["REPRO_CACHE_DIR"] = str(ROOT / "build" / "chip_smoke_cache")
    import shutil
    shutil.rmtree(os.environ["REPRO_CACHE_DIR"], ignore_errors=True)

    import numpy as np
    import repro_torch as rt
    from repro_torch.configs.cnn_paper import PROFILED
    from repro_torch.configs.serve import SMOKE_FRONTEND
    from repro_torch.core import convspec, cuconv, executors
    from repro_torch.kernels import (_build, conv1x1, cuconv_fused,
                                     cuconv_stage1, cuconv_stage2)
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve.cnn import CnnServeEngine, ImageRequest

    dev = torch.device("cuda")
    report = {"kernels": {}, "shapes": [], "serve": {}}

    # -- 1. card ---------------------------------------------------------
    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi unavailable"
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report["card"] = card
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: fp32 "
             "references must run without TF32")

    # -- 2. build ----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- the main path's shapes, from the port's own plans ------------------
    gen = torch.Generator().manual_seed(0)

    def randn(shape, dtype=torch.float32):
        return torch.randn(tuple(shape), generator=gen).to(dev, dtype)

    model = resnet_like(num_classes=10)
    geometries = [((32, 32, 3), SMOKE_FRONTEND.geometry_map()[(32, 32, 3)]),
                  ((224, 224, 3), (1,))]
    node_plans = []        # (label, ConvPlan) of every served conv node
    for shape, buckets in geometries:
        for b in buckets:
            gp = model.graph_plan((b,) + shape, backend="cuda")
            for name, p in gp.conv_plans.items():
                node_plans.append((f"resnet{shape[0]}b{b}:{name}", p))
    paper_plans = []       # (label, ConvPlan, forced) of the profiled rows
    for label, (hw, n, k, m, c) in PROFILED.items():
        spec = convspec.ConvSpec((n, hw, hw, c), (k, k, c, m),
                                 padding=((k - 1) // 2, (k - 1) // 2))
        paper_plans.append((label, convspec.plan(spec, backend="cuda"),
                            None))
        if label in ("t4_A", "t5_A"):
            paper_plans.append((f"{label}:two_stage", convspec.plan(
                spec, force="cuconv_two_stage_pallas", backend="cuda"),
                "cuconv_two_stage_pallas"))
    for label, p, _ in paper_plans:
        print(f"  {label}: {p.explain()}")

    def fused_args(p, dtype):
        s = p.spec
        cfg = p.config
        kw = dict(stride=s.stride, padding=s.padding,
                  tm=cfg.get("tm", 128), rows=cfg.get("rows", 1))
        relu = (s.fused_add == "add_relu" if s.fused_add != "none"
                else s.wants_relu)
        kw["activation"] = "relu" if relu else None
        kw["bias"] = randn((s.filter_shape[3],), dtype) if s.has_bias \
            else None
        kw["addend"] = (randn(s.out_shape, dtype)
                        if s.fused_add != "none" else None)
        kw["pool"] = ((s.fused_pool[0], s.fused_pool[3], s.fused_pool[4])
                      if s.fused_pool else None)
        return (randn(s.in_shape, dtype), randn(s.filter_shape, dtype)), kw

    def gemm_tiles(p):
        c = p.config
        return dict(tp=c.get("tp", 256), tm=c.get("tm", 128),
                    tc=c.get("tc", 512))

    def two_stage_inputs(p, dtype):
        s = p.spec
        kh, kw_, c, m = s.filter_shape
        n, oh, ow, _ = s.out_shape
        xp = cuconv._pad_input(randn(s.in_shape, dtype), *s.padding)
        views = cuconv._tap_views(xp, kh, kw_, oh, ow, 1)
        xs = torch.stack([v.reshape(n * oh * ow, c) for v in views],
                         0).contiguous()
        return xs, randn((kh * kw_, c, m), dtype)

    # every kernel call of the main path: (kernel, label, kernel fn,
    # plain fn, args, kernel kwargs, plain kwargs, flops)
    def cases(dtype):
        out = []
        for label, p in node_plans + [(lb, p) for lb, p, _ in paper_plans]:
            s = p.spec
            n, oh, ow, m = s.out_shape
            kh, kw_, c, _ = s.filter_shape
            if p.algorithm == "cuconv_pallas":
                args, kw = fused_args(p, dtype)
                out.append(("cuconv_fused", label, cuconv_fused.cuconv_fused,
                            cuconv_fused.cuconv_fused_plain, args, kw,
                            {k: v for k, v in kw.items()
                             if k not in ("tm", "rows")},
                            2 * n * oh * ow * m * kh * kw_ * c))
            elif p.algorithm == "conv1x1_pallas":
                args = (randn((n * oh * ow, c), dtype), randn((c, m), dtype))
                out.append(("conv1x1_gemm", label, conv1x1.conv1x1_gemm,
                            conv1x1.conv1x1_gemm_plain, args, gemm_tiles(p),
                            {}, 2 * n * oh * ow * m * c))
            elif p.algorithm == "cuconv_two_stage_pallas":
                xs, wt = two_stage_inputs(p, dtype)
                out.append(("stage1_tap_gemm", label,
                            cuconv_stage1.stage1_tap_gemm,
                            cuconv_stage1.stage1_tap_gemm_plain, (xs, wt),
                            gemm_tiles(p), {},
                            2 * kh * kw_ * n * oh * ow * m * c))
                temps = randn((kh * kw_, n * oh * ow, m))
                out.append(("stage2_tap_sum", label,
                            cuconv_stage2.stage2_tap_sum,
                            cuconv_stage2.stage2_tap_sum_plain, (temps,),
                            {"out_dtype": dtype}, {"out_dtype": dtype},
                            (kh * kw_ - 1) * n * oh * ow * m))
        return out

    # -- 3. kernel vs plain --------------------------------------------------
    phase("kernel vs plain")
    max_err = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for kname, label, kfn, pfn, args, kw, pkw, _ in cases(dtype):
            got = kfn(*args, **kw)
            want = pfn(*args, **pkw)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{kname} {label}: {tuple(got.shape)}/{got.dtype} vs "
                     f"plain {tuple(want.shape)}/{want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            bound = tol * max(1.0, want.float().abs().max().item())
            ok = bool(torch.isfinite(got.float()).all()) and err <= bound
            print(f"  {kname:16s} {label:28s} {str(dtype)[6:]:8s} "
                  f"max|k-p|={err:.3e} bound={bound:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{kname} {label} {dtype}: kernel disagrees with its "
                     f"plain version ({err:.3e} > {bound:.3e})")
            if dtype == torch.float32:
                max_err[kname] = max(max_err.get(kname, 0.0), err)

    # -- 4a. the per-call conv path: the paper's profiled rows ---------------
    phase("main path: paper rows through repro_torch.conv2d")
    launches = {k: 0 for k in _build.LAUNCHES}
    rows_in = {}
    for label, p, forced in paper_plans:
        s = p.spec
        rows_in[label] = (randn(s.in_shape), randn(s.filter_shape))
    torch.cuda.synchronize()
    _build.reset_launches()
    rows_out = {label: rt.conv2d(*rows_in[label], padding="same",
                                 algorithm=forced or "auto")
                for label, p, forced in paper_plans}
    torch.cuda.synchronize()
    path_counts = dict(_build.LAUNCHES)
    for k, v in path_counts.items():
        launches[k] += v
    print(f"  launches: {path_counts}")
    for label, y in rows_out.items():
        want = cuconv.conv_lax(*rows_in[label], padding="same")
        err = (y - want).abs().max().item()
        bound = 3e-4 * max(1.0, want.abs().max().item())
        if y.shape != want.shape or not err <= bound:
            fail(f"conv2d {label}: {err:.3e} from F.conv2d > {bound:.3e}")
        print(f"  {label:16s} out {tuple(y.shape)} max|y-F.conv2d|="
              f"{err:.3e} ok")
    need = {"conv1x1_gemm": 3, "cuconv_fused": 4, "stage1_tap_gemm": 2,
            "stage2_tap_sum": 2}
    for k, n in need.items():
        if path_counts[k] < n:
            fail(f"paper rows: {k} launched {path_counts[k]} times, "
                 f"expected >= {n}")

    # -- 4b. serving resnet_like ----------------------------------------------
    phase("main path: resnet_like served by CnnServeEngine")
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    params_cpu = {n: {k: v.cpu() for k, v in p.items()}
                  for n, p in params.items()}
    rng = np.random.default_rng(0)
    traffic = {(32, 32, 3): [1, 3, 2, 4, 1], (224, 224, 3): [1, 2]}
    kernel_executors = ("cuconv_pallas", "conv1x1_pallas",
                        "cuconv_two_stage_pallas")
    engines = {}
    for shape, buckets in geometries:
        eng = CnnServeEngine(model, params, shape, buckets=buckets)
        ref = CnnServeEngine(model, params_cpu, shape, buckets=buckets,
                             device="cpu", backend="cuda")
        engines[shape] = eng
        eng.warmup()
        library_nodes = {}
        for b in eng.buckets:
            gp = eng.programs.plan(b)
            print(gp.explain())
            library_nodes[str(b)] = {
                n: p.algorithm for n, p in gp.conv_plans.items()
                if p.algorithm not in kernel_executors}
            print(f"  {shape} bucket {b}: nodes on a library executor: "
                  f"{library_nodes[str(b)] or 'none'}")
        reqs = [rng.normal(size=(n,) + shape).astype(np.float32)
                for n in traffic[shape]]
        for i, im in enumerate(reqs):
            eng.submit(ImageRequest(i, im))
            ref.submit(ImageRequest(i, im))
        torch.cuda.synchronize()
        convspec.reset_plan_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        want_fused = sum(
            n_batches * sum(p.algorithm == "cuconv_pallas"
                            for p in eng.programs.plan(b).conv_plans.values())
            for b, n_batches in eng.stats["batches"].items())
        print(f"  {shape}: {eng.stats['images']} images in "
              f"{sum(eng.stats['batches'].values())} batches "
              f"{eng.stats['batches']}, {secs * 1e3:.2f} ms; launches "
              f"{counts}; cuconv_fused expected >= {want_fused}; "
              f"plan() resolutions {convspec.PLAN_STATS['resolutions']}")
        if counts["cuconv_fused"] < want_fused or want_fused == 0:
            fail(f"serving {shape}: cuconv_fused launched "
                 f"{counts['cuconv_fused']} < {want_fused} planned")
        ref_done = ref.run()
        for a, r in zip(done, ref_done):
            if a.out.shape != r.out.shape or not np.isfinite(a.out).all():
                fail(f"serving {shape} request {a.rid}: bad output")
            err = float(np.abs(a.out - r.out).max())
            bound = SERVE_TOL * float(np.abs(r.out).max())
            if not err <= bound:
                fail(f"serving {shape} request {a.rid}: card vs CPU "
                     f"{err:.3e} > {bound:.3e}")
        print(f"  {shape}: outputs match the CPU engine within "
              f"{SERVE_TOL} of their abs max")
        report["serve"][str(shape)] = {
            "batches": {str(k): v for k, v in eng.stats["batches"].items()},
            "images": eng.stats["images"], "run_ms": secs * 1e3,
            "launches": counts, "library_nodes": library_nodes}
    for k, v in launches.items():
        if v < 1:
            fail(f"{k} was not launched on the main path")

    # -- 4c. served latency over a window of requests -------------------------
    # A few requests prove the outputs; latency needs hundreds.  Each
    # window drains WINDOW_REQUESTS requests of 1..max(bucket) images
    # through the warm engine; ms per batch is the window's wall time
    # over its batches (every batch ends in a copy to the host).
    phase(f"served latency: {WINDOWS} windows of {WINDOW_REQUESTS} requests")
    for shape, buckets in geometries:
        eng = engines[shape]
        sizes = rng.integers(1, max(buckets) + 1, size=WINDOW_REQUESTS)
        pool = rng.standard_normal((int(sizes.max()),) + shape,
                                   dtype=np.float32)
        windows = []
        for _ in range(WINDOWS):
            before = dict(eng.stats["batches"])
            for i, n in enumerate(sizes):
                eng.submit(ImageRequest(i, pool[:n]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            batches = {b: eng.stats["batches"][b] - before[b]
                       for b in eng.buckets}
            n_b = sum(batches.values())
            windows.append({"images": int(sizes.sum()), "batches":
                            {str(b): v for b, v in batches.items()},
                            "wall_ms": ms, "ms_per_batch": ms / n_b,
                            "images_per_s": sizes.sum() / ms * 1e3})
            print(f"  {shape}: {WINDOW_REQUESTS} requests, {sizes.sum()} "
                  f"images in {n_b} batches {batches}: {ms:.4f} ms, "
                  f"{ms / n_b:.6f} ms per batch, "
                  f"{sizes.sum() / ms * 1e3:.1f} images/s")
        report["serve"][str(shape)]["windows"] = windows

    # -- 5. timing -------------------------------------------------------------
    phase("timing (fp32, CUDA graph replays between CUDA events)")
    assert not torch.backends.cuda.matmul.allow_tf32

    def time_ms(fn):
        """Device ms of one ``fn()``: GRAPH_CALLS calls captured in one
        CUDA graph and replayed GRAPH_REPLAYS times between two events,
        so the wrapper's host work is not in the interval."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm: build, allocator, cuDNN
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_CALLS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (GRAPH_REPLAYS * GRAPH_CALLS)

    def eager_ms(fn, reps=50):
        """``(ms, host_ms)`` of one eager ``fn()`` called back to back:
        events around the calls, and the host's time to issue one call
        (the floor under any eager time)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, host

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def library_call(kname, args, kw):
        if kname == "cuconv_fused":
            x, w = args
            xn = x.permute(0, 3, 1, 2)
            wn = w.permute(3, 2, 0, 1).contiguous()
            s, pd, b = kw["stride"], kw["padding"], kw["bias"]

            def conv():
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=False):
                    return torch.nn.functional.conv2d(xn, wn, b, s, pd)
            return conv
        if kname in ("conv1x1_gemm", "stage1_tap_gemm"):
            return lambda: torch.matmul(*args)
        return lambda: torch.sum(args[0], dim=0)

    timed = [c for c in cases(torch.float32)
             if not c[1].startswith("resnet32")]
    totals = {}
    for kname, label, kfn, pfn, args, kw, pkw, flops in timed:
        out = kfn(*args, **kw)
        moved = nbytes(*args, out, kw.get("bias"), kw.get("addend"))
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        eager, host = eager_ms(lambda: kfn(*args, **kw))
        row = {"kernel": kname, "shape": label,
               "ms": time_ms(lambda: kfn(*args, **kw)),
               "eager_ms": eager, "host_ms_per_call": host,
               "plain_ms": time_ms(lambda: pfn(*args, **pkw)),
               "library_ms": time_ms(library_call(kname, args, kw)),
               "bytes": moved, "flops": flops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        report["shapes"].append(row)
        print(f"  {kname:16s} {label:28s} {row['ms']:.6f} ms  eager "
              f"{eager:.6f} (host {host:.6f})  plain {row['plain_ms']:.6f}"
              f"  library {row['library_ms']:.6f}  bound "
              f"{row['bound_ms']:.6f} ({row['bound_by']})")
        tot = totals.setdefault(kname, {"ms": 0.0, "plain_ms": 0.0,
                                        "library_ms": 0.0, "bytes": 0,
                                        "flops": 0, "n": 0})
        for k in ("ms", "plain_ms", "library_ms", "bytes", "flops"):
            tot[k] += row[k]
        tot["n"] += 1

    sources = {"cuconv_fused": ("src/repro_torch/csrc/cuconv_fused.cu",
                                "src/repro/kernels/cuconv_fused.py:216"),
               "conv1x1_gemm": ("src/repro_torch/csrc/conv1x1.cu",
                                "src/repro/kernels/conv1x1.py:39"),
               "stage1_tap_gemm": ("src/repro_torch/csrc/cuconv_stage1.cu",
                                   "src/repro/kernels/cuconv_stage1.py:42"),
               "stage2_tap_sum": ("src/repro_torch/csrc/cuconv_stage2.cu",
                                  "src/repro/kernels/cuconv_stage2.py:28")}
    line = []
    for kname, (src, replaces) in sources.items():
        tot = totals[kname]
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tot["flops"] / FP32_FLOP_PER_S * 1e3
        line.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": max_err[kname], "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], "bound_ms":
                     max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": tot["library_ms"],
                     "work": f"fp32, sum over {tot['n']} main-path shapes"})
    report["kernels"] = line

    # -- 6. launch-config probe: the fused kernel under every feasible
    # candidate of its executor (the default picks the fewest blocks)
    phase("cuconv_fused launch-config probe (fp32)")
    ex = executors.get("cuconv_pallas")
    probe = dict(node_plans + [(lb, p) for lb, p, _ in paper_plans])
    report["config_probe"] = []
    for label in ("t4_A", "t4_B", "resnet224b1:stem", "resnet224b1:b1c1"):
        p = probe[label]
        args, kw = fused_args(p, torch.float32)
        n, oh, _, m = p.spec.out_shape
        for cfg in ex.configs(p.spec):
            if not ex.config_supports(p.spec, cfg)[0]:
                continue
            tm, rows = min(cfg["tm"], m), min(cfg["rows"], oh)
            kw.update(tm=tm, rows=rows)
            blocks = n * -(-oh // rows) * -(-m // tm)
            ms = time_ms(lambda: cuconv_fused.cuconv_fused(*args, **kw))
            default = cfg == p.config
            report["config_probe"].append({
                "shape": label, "tm": tm, "rows": rows, "blocks": blocks,
                "ms": ms, "default": default})
            print(f"  {label:20s} tm={tm:<4d} rows={rows:<3d} "
                  f"blocks={blocks:<5d} {ms:.6f} ms"
                  f"{'  <- default' if default else ''}")

    out_dir = ROOT / "chiprun_out"
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError as e:
        print(f"(could not write {out_dir}: {e})")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
