"""Training launcher: the JAX package's ``launch/train.py`` on one
device (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 6 --device cpu

The data pipeline is a pure function of (seed, step) and checkpoints
are the reference's format, so a preempted job resumes where it stopped
(and a run either package started resumes in the other).  SIGTERM
stops the run at the next step boundary with a sync checkpoint there,
and the launcher exits 0.  ``--mesh`` waits for
training across cards (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal

from repro_torch.configs.base import get_config, list_archs, smoke_variant
from repro_torch.data import SyntheticLMData
from repro_torch.train.trainer import Trainer, TrainConfig


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
                    help="'debug', 'pod' or 'multipod': needs training "
                         "across cards, not in the port yet")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.mesh is not None:
        raise NotImplementedError(
            f"--mesh {args.mesh} needs training across cards, which the "
            f"port does not have yet (ROADMAP queue 1)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
        cfg = dataclasses.replace(cfg, grad_accum=1)

    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, peak_lr=args.lr)
    trainer = Trainer(cfg, tcfg, data, device=args.device)

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
