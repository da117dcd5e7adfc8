"""End-to-end CNN inference through the typed operator-IR graph API, on
the PyTorch/CUDA port.

Builds a SqueezeNet-flavoured stack (1x1-heavy: the paper's best region),
plans the WHOLE network once as a GraphPlan (per-node explain table,
one warmup pass that builds and runs every node's CUDA kernel), compares
the planned program against the library convolution (``F.conv2d``,
TF32 off), serves a mixed-size request stream through the
batch-bucketed CnnServeEngine (each bucket's program one CUDA graph on
the card) — and then does the same for a ResNet-flavoured network whose
residual adds, maxpool and dense head all execute inside the one
planned program, including a full bf16 pass under a graph-wide
PrecisionPolicy (fp32 master params, fp32 accumulation,
precision-distinct plan caches).

  PYTHONPATH=src python examples_torch/cnn_inference.py [--device cpu]

Times are device times of CUDA-graph replays between synchronizes on
the card (``serve/graphs.py``), eager calls on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.convspec import (PLAN_STATS, reset_plan_stats,
                                       resolve_device)
from repro_torch.models.cnn import resnet_like, squeezenet_like
from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
from repro_torch.serve.graphs import GraphedProgram, used_on


def timed_ms(fn, params, x, calls=5):
    """ms a call of ``fn(params, x)``: replays of its CUDA graph on the
    card (captured after one eager call), eager calls on the CPU; each
    call between synchronizes."""
    run = fn
    if used_on(x.device):
        prog = GraphedProgram(lambda p, _, xs: fn(p, xs), [x.clone()])
        run = lambda p, xs: prog(p, None, xs)          # noqa: E731
    for _ in range(2):                # the eager call, then the capture
        run(params, x)
    sync = torch.cuda.synchronize if x.device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        run(params, x)
        sync()
    return (time.perf_counter() - t0) / calls * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    model = squeezenet_like()
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(
        np.float32)).to(dev)

    # one planned program for the whole network (resolved once, persisted
    # in the graph-level cache keyed by signature + backend)
    gp = model.graph_plan((1, 64, 64, 3))
    print(gp.explain())
    stats = gp.warmup(device=dev)
    print(f"warmup: ran {len(stats['nodes'])} nodes "
          f"in {stats['total_ms']:.0f} ms\n")

    def lib(p, xs):
        return model.apply(p, xs, algorithm="lax")

    def auto(p, xs):
        return model.apply(p, xs)

    y_lib, y_auto = lib(params, x), auto(params, x)
    err = float((y_lib - y_auto).abs().max())
    out["squeezenet_logits"] = {"max_err": err,
                                "ref_abs_max": float(y_lib.abs().max())}
    print(f"logits agree: max_err = {err:.2e}")

    out["ms"] = {}
    for name, fn in (("library", lib), ("graph-planned", auto)):
        ms = out["ms"][name] = timed_ms(fn, params, x)
        print(f"{name:14s}: {ms:.2f} ms/inference")

    # batch-bucketed serving: mixed-size requests, two planned programs
    eng = CnnServeEngine(model, params, (64, 64, 3), buckets=(1, 4),
                         device=dev)
    eng.warmup()
    for i, n in enumerate([1, 3, 2, 1]):
        eng.submit(ImageRequest(
            rid=i, images=rng.normal(size=(n, 64, 64, 3)).astype(
                np.float32)))
    done = eng.run()
    used = {b: n for b, n in eng.stats["batches"].items() if n}
    out["squeezenet_served"] = len(done)
    print(f"served {len(done)} requests / {eng.stats['images']} images in "
          f"{sum(used.values())} batches (buckets used: {used}, "
          f"padded slots: {eng.stats['padded_slots']})")

    # -----------------------------------------------------------------------
    # a real network shape: residual adds + pooling + head, ONE program
    resnet = resnet_like()
    rparams = resnet.init(1, device=dev)
    rgp = resnet.graph_plan((1, 32, 32, 3))
    print("\n" + rgp.explain())
    rgp.warmup(device=dev)
    eng = CnnServeEngine(resnet, rparams, (32, 32, 3), buckets=(1, 4),
                         device=dev)
    eng.warmup()
    reset_plan_stats()
    for i, n in enumerate([2, 1, 3]):
        eng.submit(ImageRequest(
            rid=i, images=rng.normal(size=(n, 32, 32, 3)).astype(
                np.float32)))
    done = eng.run()
    out["resnet_resolutions"] = PLAN_STATS["resolutions"]
    assert PLAN_STATS["resolutions"] == 0, "warm engine must never re-plan"
    print(f"resnet_like: served {eng.stats['images']} images through "
          f"{len(eng.compiled_buckets)} planned programs with zero plan() "
          f"resolutions")

    # -----------------------------------------------------------------------
    # the same network under a graph-wide bf16 precision policy: every conv
    # node plans in bfloat16 (fp32 accumulation per the executors' declared
    # behavior), cache keys are dtype-distinct, params stay fp32
    bf_gp = resnet.graph_plan((1, 32, 32, 3), precision="bf16")
    assert bf_gp.graph.signature() != rgp.graph.signature()
    print("\n" + bf_gp.explain())
    bf_gp.warmup(device=dev)
    x32 = torch.from_numpy(rng.normal(size=(1, 32, 32, 3)).astype(
        np.float32)).to(dev)
    y32 = resnet.apply(rparams, x32)
    ybf = resnet.apply(rparams, x32, precision="bf16")
    err = float((y32 - ybf.float()).abs().max())
    out["bf16_err"] = err
    print(f"bf16 vs fp32 logits: max_err = {err:.2e} (bf16 tolerance)")
    assert err < 0.05, "bf16 path must stay within bf16 tolerance of fp32"

    bf_eng = CnnServeEngine(resnet, rparams, (32, 32, 3), buckets=(1, 4),
                            precision="bf16", device=dev)
    bf_eng.warmup()
    for i, n in enumerate([2, 1, 3]):
        bf_eng.submit(ImageRequest(
            rid=i, images=rng.normal(size=(n, 32, 32, 3)).astype(
                np.float32)))
    reset_plan_stats()
    bf_eng.run()
    out["bf16_resolutions"] = PLAN_STATS["resolutions"]
    assert PLAN_STATS["resolutions"] == 0
    print(f"resnet_like[bf16]: served {bf_eng.stats['images']} images "
          f"through {len(bf_eng.compiled_buckets)} planned bf16 programs "
          f"with zero plan() resolutions")
    return out


if __name__ == "__main__":
    main()
