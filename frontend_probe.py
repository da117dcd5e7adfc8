"""Where the host time of an async-frontend batch goes, against the
device time of the batch before it (one NVIDIA card).

    python3 frontend_probe.py

Serves 100 requests through ``AsyncServeFrontend`` (``resnet_like``,
seed-0 params, pipeline depth 2, bursts of 8 with a ``poll()`` after
each) in three streams: 224x224 requests of 4 images, 224x224 requests
of 1-4 images, and 32x32 requests of 4 images; each once untraced and
once under ``torch.profiler`` (the card alone).  It prints the host
microseconds of each scheduling and dispatch method (wrapped in timers),
and from the trace the device compute of a batch (first kernel to the
end of its output copy) and how long after a batch's first kernel the
host issued the next batch's input copy.  A copy can overlap the batch
before it only where that reach is shorter than the compute.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

T = {}


def timed(cls, name):
    f = getattr(cls, name)

    def w(*a, **k):
        t0 = time.perf_counter()
        r = f(*a, **k)
        T.setdefault(name, []).append(time.perf_counter() - t0)
        return r
    setattr(cls, name, w)


def main():
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.cnn import resnet_like
    from repro_torch.serve import AsyncServeFrontend, ServeRequest
    from repro_torch.serve import cnn as scnn, frontend as sfe, graphs
    if not torch.cuda.is_available():
        sys.exit("frontend_probe.py needs the card")
    for n in ("pack", "dispatch", "harvest", "_take_slot", "_graph",
              "serve_dtype", "shard_units"):
        timed(scnn.BucketPrograms, n)
    for n in ("_form_batch", "_harvest_one", "_dispatch", "submit"):
        timed(sfe.AsyncServeFrontend, n)
    timed(graphs.GraphedProgram, "__call__")
    timed(graphs.GraphedProgram, "fresh")
    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    print(torch.cuda.get_device_name(0), torch.get_num_threads(),
          "host threads")
    for geoms, label, n_img in (
            ({(224, 224, 3): (1, 4)}, "224 b4 stream", 4),
            ({(224, 224, 3): (1, 4)}, "224 mixed 1-4", None),
            ({(32, 32, 3): (1, 4)}, "32 b4 stream", 4)):
        rng = np.random.default_rng(0)
        shape = list(geoms)[0]
        imgs = [rng.standard_normal(
            ((n_img or int(rng.integers(1, 5))),) + shape, dtype=np.float32)
            for _ in range(100)]
        for traced in (False, True):
            fe = AsyncServeFrontend(model, params, geoms, max_wait_ms=5.0,
                                    default_deadline_ms=60000.0,
                                    pipeline_depth=2)
            fe.warmup()
            T.clear()
            torch.cuda.synchronize()
            prof = (profile(activities=[ProfilerActivity.CUDA])
                    if traced else None)
            if prof:
                prof.__enter__()
            t0 = time.perf_counter()
            for i, x in enumerate(imgs):
                fe.submit(ServeRequest(rid=i, images=x))
                if (i + 1) % 8 == 0:
                    fe.poll()
            fe.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof:
                time.sleep(0.05)
                prof.__exit__(None, None, None)
            nb = len(fe.telemetry.batches)
            print(f"== {label} traced={traced}: {nb} batches, "
                  f"{wall*1e3:.2f} ms, {wall/nb*1e3:.4f} ms/batch")
            for k, v in sorted(T.items()):
                print(f"   {k:14s} n={len(v):4d} mean {np.mean(v)*1e6:8.1f} "
                      f"us  median {np.median(v)*1e6:8.1f} us")
            if not prof:
                continue
            recs = sorted(
                ((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith("ProfilerStep")
                 and not getattr(e, "is_user_annotation", False)),
                key=lambda r: r[1])
            h2d = [r for r in recs if r[0].startswith("Memcpy HtoD")]
            d2h = [r for r in recs if r[0].startswith("Memcpy DtoH")]
            kern = [r for r in recs
                    if not r[0].startswith(("Memcpy", "Memset"))]
            C, G, W = [], [], []
            for j in range(len(d2h)):
                ks = [k for k in kern if h2d[j][2] <= k[1] <= d2h[j][1]]
                if ks:
                    C.append(d2h[j][2] - ks[0][1])
                if j + 1 < len(h2d):
                    G.append(h2d[j + 1][1] - d2h[j][2])
                    if ks:
                        W.append(h2d[j + 1][1] - ks[0][1])
            print(f"   device compute per batch (first kernel -> output "
                  f"copy end) median {np.median(C):.1f} us; next input copy "
                  f"start - this output copy end: median {np.median(G):.1f} "
                  f"us (min {min(G):.1f}); next copy start - this first "
                  f"kernel: median {np.median(W):.1f} us")
            print(f"   h2d us median {np.median([r[2]-r[1] for r in h2d]):.1f}"
                  f"; d2h us {np.median([r[2]-r[1] for r in d2h]):.1f}")


if __name__ == "__main__":
    main()
