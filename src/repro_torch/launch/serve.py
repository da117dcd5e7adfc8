"""Serving launcher: batched greedy decoding over the LM ServeEngine,
plus the process-index-disciplined multi-device CNN entry
(``--cnn-dist``).

    python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke
    python -m repro_torch.launch.serve --arch deepseek-moe-16b
    python -m repro_torch.launch.serve --cnn-dist --requests 16

Both run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.base import get_config, list_archs, smoke_variant
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


def cnn_dist_main(args) -> None:
    """One ``ShardedServeDispatcher`` per host.

    Every process derives the same geometry partition from the same
    config (``owned_geometries``: sorted round-robin by process index),
    so which host admits which image shape is decided with no
    coordination — a request router needs only the config and the
    ownership rule.  This process admits traffic ONLY for the geometries
    it owns; on a single-process deployment that is all of them.
    """
    from repro_torch.configs.serve import DIST_SMOKE
    from repro_torch.models.cnn import tiny_cnn
    from repro_torch.serve import ServeRequest, ShardedServeDispatcher

    model = tiny_cnn()
    params = model.init(0, device=args.device)
    disp = ShardedServeDispatcher(
        model, params, DIST_SMOKE.geometry_map(),
        process_index=args.process_index,
        process_count=args.process_count,
        max_wait_ms=DIST_SMOKE.max_wait_ms,
        default_deadline_ms=DIST_SMOKE.default_deadline_ms,
        pipeline_depth=DIST_SMOKE.pipeline_depth, device=args.device)
    print(f"[serve-dist] process {disp.process_index}/"
          f"{disp.process_count}, {disp.n_devices} device(s), owns "
          f"{['x'.join(map(str, s)) for s in disp.geometries] or 'nothing'}")
    if not disp.geometries:
        return
    disp.warmup()
    rng = np.random.default_rng(disp.process_index)
    t0 = time.perf_counter()
    rid = 0
    for _ in range(args.requests):
        shape = disp.geometries[rid % len(disp.geometries)]
        n = int(rng.integers(1, max(disp.global_buckets(shape)) + 1))
        disp.submit(ServeRequest(
            rid=rid, images=rng.standard_normal((n,) + shape,
                                                dtype=np.float32)))
        rid += 1
    done = disp.run()
    dt = time.perf_counter() - t0
    images = sum(len(r.images) for r in done)
    print(f"[serve-dist] {len(done)} requests, {images} images in "
          f"{dt*1e3:.1f}ms ({images/dt:.0f} img/s post-warmup)")
    print(json.dumps(disp.stats(), indent=2, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cnn-dist", action="store_true",
                    help="serve the DIST_SMOKE CNN deployment through "
                         "one per-host ShardedServeDispatcher")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--process-index", type=int, default=None,
                    help="override $RANK (cnn-dist)")
    ap.add_argument("--process-count", type=int, default=None,
                    help="override $WORLD_SIZE (cnn-dist)")
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the card; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    if args.cnn_dist:
        return cnn_dist_main(args)
    if args.arch is None:
        ap.error("--arch is required unless --cnn-dist is given")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    params = lm.init_lm(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new))
    done = eng.run(prompt_len=args.prompt_len)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, first calls included)")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
