"""Batched serving example on the PyTorch/CUDA port: continuous-batching
engine over a small LM.

  PYTHONPATH=src python examples_torch/serve_lm.py [--arch mamba2-1.3b] \\
      [--device cpu]

Submits 10 requests onto 4 slots (wave-based continuous batching),
decodes greedily, prints per-request outputs and throughput.  On the
card each prefill attention runs the ``flash_attention`` CUDA kernel
and each Mamba2 prefill conv the ``conv1d_tap`` kernel, and the prefill
and decode programs run as CUDA graphs after their first eager call;
``--device cpu`` runs the kernels' plain versions eagerly.
"""
import argparse
import time

import numpy as np

from repro_torch.configs.base import get_config, list_archs, smoke_variant
from repro_torch.core.convspec import resolve_device
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_variant(get_config(args.arch))
    params = lm.init_lm(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, slots=4, max_len=64, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               16).astype(np.int32),
                           max_new_tokens=12))
    t0 = time.perf_counter()
    done = eng.run(prompt_len=16)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, first calls included)")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: {r.out_tokens}")
    return {"arch": args.arch, "requests": len(done), "tokens": toks,
            "s": dt, "out_tokens": {r.rid: r.out_tokens for r in done}}


if __name__ == "__main__":
    main()
