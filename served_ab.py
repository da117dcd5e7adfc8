"""A/B of served latency between checkouts of this repository, on one card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 served_ab.py --tree new=. --tree old=/path/to/other/checkout

Each tree is measured in its own process (its own ``repro_torch`` and its
own kernel build), in the order new, old, old, new, so drift of the card
or the host shows as a difference between the two runs of one tree.  A
run measures, with seed-0 weights:

- ``resnet_like`` served by ``CnnServeEngine`` at 224x224, bucket 1, fp32:
  ms per batch over 3 windows of 300 one-image requests (host clock
  around ``run()``, which ends in a copy to the host);
- ``resnet_like`` served in int8 (``QuantPolicy()``, calibrated through
  ``GraphPlan.warmup`` on one seeded batch of 4) at 32x32, buckets 1 and
  4: ms per batch over 3 windows of 300 requests of 1-4 images;
- qwen2-1.5b at full width and depth in bf16: one prefill wave of 4 x 512
  tokens through ``ServeEngine._prefill`` (host clock between
  synchronizes, median of 5), and the device ms of its
  ``flash_attention`` kernels and of all kernels under ``torch.profiler``;
- qwen2-1.5b and mamba2-1.3b at full width and depth in bf16: ms per
  decode step of 4 slots after a 512-token prefill, as the engine's loop
  runs it (``ServeEngine._decode``, then the greedy sample to the host
  fed back as the next tokens): 16 steps a repetition, host clock
  between synchronizes, median of 5 repetitions after 2 warm ones.

One JSON line per run goes to standard output, then the card's name and
power limit; the last line is a JSON summary of medians per tree.
Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

WINDOWS, WINDOW_REQUESTS = 3, 300
LM_ARCH, LM_SLOTS, LM_PROMPT, LM_REPS = "qwen2-1.5b", 4, 512, 5
DECODE_ARCHS, DECODE_STEPS = ("qwen2-1.5b", "mamba2-1.3b"), 16


def windows(eng, requests, torch) -> list:
    """ms per batch of each of WINDOWS drains of ``requests`` (arrays of
    images) through the warm engine."""
    from repro_torch.serve.cnn import ImageRequest
    per_batch = []
    for _ in range(WINDOWS):
        before = sum(eng.stats["batches"].values())
        for i, im in enumerate(requests):
            eng.submit(ImageRequest(i, im))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        batches = sum(eng.stats["batches"].values()) - before
        per_batch.append((time.perf_counter() - t0) * 1e3 / batches)
    return per_batch


def measure(src: str) -> dict:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("served_ab: no CUDA device")
    sys.path.insert(0, src)
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.models.cnn import resnet_like
    from repro_torch.quant import Calibrator, QuantPolicy
    from repro_torch.serve.cnn import CnnServeEngine
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"src": src}

    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    eng = CnnServeEngine(model, params, (224, 224, 3), buckets=(1,))
    eng.warmup()
    img = rng.standard_normal((1, 224, 224, 3), dtype=np.float32)
    out["cnn224_ms_per_batch"] = windows(eng, [img] * WINDOW_REQUESTS,
                                         torch)

    calib = rng.standard_normal((4, 32, 32, 3), dtype=np.float32)
    model.graph_plan(calib.shape, backend="cuda").warmup(
        calibrate=Calibrator(calib, params))
    eng = CnnServeEngine(model, params, (32, 32, 3), buckets=(1, 4),
                         precision=QuantPolicy())
    eng.warmup()
    sizes = rng.integers(1, 5, size=WINDOW_REQUESTS)
    pool = rng.standard_normal((4, 32, 32, 3), dtype=np.float32)
    out["int8_32_ms_per_batch"] = windows(eng, [pool[:n] for n in sizes],
                                          torch)

    cfg = get_config(LM_ARCH)
    lparams = lm.init_lm(cfg, seed=0, device=dev)
    seng = ServeEngine(cfg, lparams, slots=LM_SLOTS, max_len=2 * LM_PROMPT,
                       device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (LM_SLOTS, LM_PROMPT))
                            .astype(np.int32)).to(dev)

    def wave():
        return seng._prefill(seng.params, {"tokens": toks}, seng.cache)
    for _ in range(2):
        wave()
    walls = []
    for _ in range(LM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["qwen2_prefill_wave_ms"] = walls
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wave()
        torch.cuda.synchronize()
    flash = busy = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            busy += us / 1e3
            if "flash_attention" in e.key:
                flash += us / 1e3
    out["qwen2_wave_device_ms"] = busy
    out["qwen2_wave_flash_ms"] = flash
    del seng, lparams

    for arch in DECODE_ARCHS:
        cfg = get_config(arch)
        lparams = lm.init_lm(cfg, seed=0, device=dev)
        seng = ServeEngine(cfg, lparams, slots=LM_SLOTS,
                           max_len=LM_PROMPT + DECODE_STEPS, device=dev)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (LM_SLOTS, LM_PROMPT))
                                .astype(np.int32)).to(dev)
        logits, _ = seng._prefill(seng.params, {"tokens": toks}, seng.cache)
        first = seng._sample(logits)

        def steps():
            cur = first
            for t in range(DECODE_STEPS):
                step = torch.from_numpy(cur[:, None].astype(np.int32)).to(dev)
                logits, _ = seng._decode(seng.params, {"tokens": step},
                                         seng.cache, LM_PROMPT + t)
                cur = seng._sample(logits)
        for _ in range(2):
            steps()
        per_step = []
        for _ in range(LM_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            per_step.append((time.perf_counter() - t0) * 1e3 / DECODE_STEPS)
        out[f"{arch.split('-')[0]}_decode_ms_per_step"] = per_step
        del seng, lparams
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a checkout (two of them)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return
    import torch
    if not torch.cuda.is_available() or len(args.tree) != 2:
        sys.exit("served_ab: needs CUDA and two --tree name=path")
    trees = dict(t.split("=", 1) for t in args.tree)
    a, b = list(trees)
    runs = {a: [], b: []}
    for name in (a, b, b, a):
        # each run calibrates into its own store inside its tree
        env = dict(os.environ,
                   REPRO_CACHE_DIR=f"{trees[name]}/build/served_ab_cache")
        proc = subprocess.run(
            [sys.executable, __file__, "--measure", f"{trees[name]}/src"],
            capture_output=True, text=True, timeout=900, env=env)
        if proc.returncode != 0:
            sys.exit(f"served_ab: run of {name} failed:\n{proc.stderr[-3000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["tree"] = name
        runs[name].append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    summary = {}
    for name, rows in runs.items():
        summary[name] = {
            key: statistics.median(v for r in rows for v in (
                r[key] if isinstance(r[key], list) else [r[key]]))
            for key in ("cnn224_ms_per_batch", "int8_32_ms_per_batch",
                        "qwen2_prefill_wave_ms", "qwen2_wave_device_ms",
                        "qwen2_wave_flash_ms", "qwen2_decode_ms_per_step",
                        "mamba2_decode_ms_per_step")}
    print(json.dumps({"card": smi, "median": summary}))


if __name__ == "__main__":
    main()
