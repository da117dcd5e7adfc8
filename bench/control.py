#!/usr/bin/env python3
"""The check's control on the card, at a cell's own size: the number the
check compares (the widest logit gap over the image pool, over the
reference's logit rms) for the reference one precision step down, in
place of the program, on several seeds.

    python3 bench/control.py --config resnet50-fp32 --seeds 1,2,3 \
        --batch 64

``tf32``: the reference with every conv and dense operand rounded to
TF32 (the step below fp32 with TF32 off); ``bf16_program``: the port's
own bf16 path (``PrecisionPolicy("bfloat16")``) at ``--batch``.  One
JSON line a seed; the benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--pool", type=int, default=512)
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["REPRO_CACHE_DIR"] = str(ROOT / "build" / "bench_cache")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import netlist
    from bench.reference import cnn as reference
    from bench.systems import cnn as system
    cfg = netlist.load(args.config)
    dev = torch.device("cuda", 0)
    model = system.graph_model(cfg, precision="bfloat16")
    gp = model.graph_plan((args.batch,) + tuple(cfg["image"]),
                          backend="cuda")
    for seed in [int(s) for s in args.seeds.split(",")]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = netlist.draw_params(cfg, gen, dev)
        images = netlist.draw_images(cfg, gen, dev, args.pool)
        ref = reference.logits_in_blocks(cfg, params, images, 64)
        scale = float(ref.pow(2).mean().sqrt())

        def gap(got):
            return float((got.float().cpu() - ref).abs().max()) / scale
        out = {"config": args.config, "seed": seed, "logit_rms": scale,
               "tf32": gap(reference.logits_in_blocks(
                   cfg, params, images, 64, "tf32")),
               "bf16_program": gap(torch.cat([
                   model.apply(params, images[i:i + args.batch],
                               graph_plan=gp).float().cpu()
                   for i in range(0, args.pool, args.batch)])),
               "device": torch.cuda.get_device_name(dev)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
