#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``check``:
each number compared with its limit, which also ends standard error.
Exits non-zero, printing no result, where the cell's cards are missing
or where the process loaded JAX or the JAX package.  Kernels build into
``build/repro_torch`` and plans persist under ``build/bench_cache``,
both in the checkout, so only a checkout's first run builds.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules no run may load (compared whole: the port's name
#: begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["REPRO_CACHE_DIR"] = str(ROOT / "build" / "bench_cache")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START, log=log)
    except harness.NoDevice as e:
        log(f"[bench] {e}")
        return 2
    loaded = sorted({m.partition(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        log(f"[bench] the run loaded {loaded}: no result")
        return 3
    for name, c in result["check"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
