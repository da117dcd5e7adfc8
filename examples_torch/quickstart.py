"""Quickstart: the cuConv public API of the PyTorch/CUDA port.

Runs one convolution through every registered executor (the library
baseline ``F.conv2d`` with TF32 off, explicit GEMM, the paper's
two-stage cuConv, the fused beyond-paper variant, and the hand-written
CUDA kernels for Hopper) and checks they agree; then uses the
cuDNN-style per-layer autotuner — both the algorithm sweep and the
per-configuration *launch-config* sweep (tile geometry per convolution
configuration within Hopper's 227 KB of shared memory a block, the
paper's own config-selection lever; on the card it changes the launch
of the Winograd kernel, so that is the race shown).

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

On the card (the default) every kernel executor launches its CUDA
kernel or raises; ``--device cpu`` runs each kernel's plain PyTorch
version instead.  An executor that cannot run this 1x1 conv (the
Winograd ones, int8 on fp32 input) takes its declared fallback, named
beside its row.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import conv2d
from repro_torch.core import executors
from repro_torch.core.autotune import (measure_algorithm, reset_measure_stats,
                                      select_algorithm)
from repro_torch.core.convspec import (ConvSpec, backend_for, plan,
                                       resolve_device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = backend_for(dev)

    rng = np.random.default_rng(0)
    # the paper's headline configuration: 7x7x832 input, 256 1x1 filters,
    # batch 1 (GoogleNet inception 5a) — cuConv's 2.29x region on V100
    x = torch.from_numpy(rng.normal(size=(1, 7, 7, 832)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(1, 1, 832, 256)).astype(
        np.float32)).to(dev)
    spec = ConvSpec.for_conv(x, w)

    ref = conv2d(x, w, algorithm="lax")
    print(f"output shape: {tuple(ref.shape)}")
    rows = {}
    for name in executors.names():      # the registered executor menu
        ran = plan(spec, force=name, backend=backend).algorithm
        out = conv2d(x, w, algorithm=name)
        err = float((out - ref).abs().max())
        rows[name] = {"ran": ran, "max_err": err}
        note = "" if ran == name else f"   (fallback: {ran})"
        print(f"  {name:24s} max_err_vs_library = {err:.2e}{note}")

    heur = select_algorithm(x.shape, w.shape, backend=backend)
    best = measure_algorithm(x, w)
    print(f"autotune heuristic: {heur}   measured best on this machine: "
          f"{best}")

    # launch-config tuning: the reference sweeps the 1x1 kernel's tile
    # geometries here.  The port's 1x1 CUDA kernel picks its own geometry
    # (block tile and split-K from the shape), so its configs are one
    # launch and tune="full" races none of them: the plan keeps its
    # default config, and a later plan() replays it with zero
    # re-measurement
    tuned = plan(spec, force="conv1x1_pallas", tune="full", device=dev)
    print(f"tuned launch config: {tuned.algorithm} "
          f"cfg[{tuned.config_source}]={tuned.config.key()}")
    reset_measure_stats()
    replay = plan(spec, force="conv1x1_pallas", backend=backend)
    assert replay.config == tuned.config
    assert not any(reset_measure_stats().values())
    # the config race that does change the launch on the card: Winograd's
    # F(2,3) against F(4,3) on a 3x3 conv, whose winner persists — a
    # later plan() replays it from cache with zero re-measurement
    spec3 = ConvSpec((1, 14, 14, 32), (3, 3, 32, 64), (1, 1), (1, 1))
    tuned3 = plan(spec3, force="winograd_pallas", tune="full", device=dev)
    print(f"tuned launch config: {tuned3.algorithm} "
          f"cfg[{tuned3.config_source}]={tuned3.config.key()}")
    reset_measure_stats()
    replay3 = plan(spec3, force="winograd_pallas", backend=backend)
    assert replay3.config == tuned3.config and replay3.config_source == \
        "measured"
    assert not any(reset_measure_stats().values())
    return {"executors": rows, "ref_abs_max": float(ref.abs().max()),
            "heuristic": heur, "measured": best,
            "tuned": {p.algorithm: {"config": p.config.key(),
                                    "config_source": p.config_source}
                      for p in (tuned, tuned3)},
            "replay_source": replay3.config_source}


if __name__ == "__main__":
    main()
