"""Training launcher: the JAX package's ``launch/train.py`` (on the card
unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 6 --device cpu

``--mesh debug|pod|multipod`` trains on a mesh (``launch/mesh.py``)
over a process group: ``torchrun``'s, where its environment is set
(one process per card; NCCL on the card, gloo with ``--device cpu``),
else a world of one rank on a ``FileStore`` under ``build/``.  The
group is destroyed on exit.  Four CPU ranks:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --mesh debug --device cpu

The data pipeline is a pure function of (seed, step), so every rank
computes the same global batch and keeps its rows, and checkpoints are
the reference's unsharded format: a preempted job resumes where it
stopped, onto whatever mesh comes up (and a run either package started
resumes in the other).  SIGTERM stops the run at the next step boundary
with a sync checkpoint there, and the launcher exits 0.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import signal
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, list_archs, smoke_variant
from repro_torch.data import SyntheticLMData
from repro_torch.train.trainer import Trainer, TrainConfig

#: how long a rank waits at a collective: a sync checkpoint holds the
#: other ranks at a barrier while rank 0 writes (minutes at full size)
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


@contextlib.contextmanager
def process_group(device=None):
    """A process group for the run's mesh: the caller's where one is up
    (left up), else ``torchrun``'s environment, else a world of one rank
    on a ``FileStore`` under ``build/``; destroyed on exit when made
    here.  The backend is NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        yield
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "training on a mesh runs on the card by default, and CUDA is "
            "not available here; pass --device cpu")
    backend = "gloo" if cpu else "nccl"
    store_path = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
    else:
        from repro_torch.kernels._build import build_dir
        root = build_dir().parent / "process_groups"
        root.mkdir(parents=True, exist_ok=True)
        store_path = root / f"store-{os.getpid()}-{time.time_ns()}"
        dist.init_process_group(
            backend, store=dist.FileStore(str(store_path), 1), rank=0,
            world_size=1, timeout=GROUP_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if store_path is not None:
            store_path.unlink(missing_ok=True)


def _mesh(kind: str, device):
    from repro_torch.launch import mesh as M
    if kind == "debug":
        return M.make_debug_mesh(device=device)
    if kind in ("pod", "multipod"):
        return M.make_production_mesh(multi_pod=kind == "multipod",
                                      device=device)
    raise ValueError(f"--mesh {kind!r}: debug | pod | multipod")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    choices=("debug", "pod", "multipod"),
                    help="'debug' for a small mesh over the process group's "
                         "world, 'pod'/'multipod' for production (256/512 "
                         "ranks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
        cfg = dataclasses.replace(cfg, grad_accum=1)

    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, peak_lr=args.lr)
    with (process_group(args.device) if args.mesh is not None
          else contextlib.nullcontext()):
        mesh = _mesh(args.mesh, args.device) if args.mesh else None
        trainer = Trainer(cfg, tcfg, data, mesh=mesh, device=args.device)

        # preemption: checkpoint at the next step boundary, then exit 0
        prev = signal.signal(signal.SIGTERM,
                             lambda sig, frame: trainer.request_stop())
        try:
            final = trainer.run()
        finally:
            signal.signal(signal.SIGTERM, prev)
    print(f"[train] done: {final}")


if __name__ == "__main__":
    main()
