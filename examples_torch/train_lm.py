"""End-to-end run on the PyTorch/CUDA port: train a ~100M-param
qwen2-family model for a few hundred steps on synthetic Markov data,
with checkpoints + auto-resume.

  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--tiny] \\
      [--device cpu]

``--tiny`` drops to the smoke config for fast CI runs; the default builds
a real ~100M-parameter model.  The step runs eagerly on the card (the
default) in bf16 with fp32 master state; train mode runs no hand-written
kernel (the plain versions, which autograd differentiates), as the
reference's train step reaches no Pallas kernel.
"""
import argparse
import dataclasses

from repro_torch.configs.base import ModelConfig, get_config, smoke_variant
from repro_torch.core.convspec import resolve_device
from repro_torch.data import SyntheticLMData
from repro_torch.train.trainer import Trainer, TrainConfig


def hundred_m() -> ModelConfig:
    # ~100M params: 12L, d_model 768, GQA 12/4 heads, vocab 32k
    return ModelConfig(
        name="qwen2-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32_000, qkv_bias=True, rope_theta=1e6, grad_accum=1,
        tie_embeddings=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = (dataclasses.replace(smoke_variant(get_config("qwen2-1.5b")),
                               grad_accum=1)
           if args.tiny else hundred_m())
    print(f"model: {cfg.name}  params ~{cfg.num_params()/1e6:.1f}M")
    data = SyntheticLMData(cfg.vocab_size, args.batch,
                           args.seq if not args.tiny else 64, seed=1)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=100,
                       ckpt_dir=args.ckpt_dir, peak_lr=6e-4, log_every=10)
    trainer = Trainer(cfg, tcfg, data, device=dev)
    trainer.run()
    losses = [m["loss"] for m in trainer.metrics_log]
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"loss: first10={first:.3f} last10={last:.3f}")
    return {"params": cfg.num_params(), "losses": losses,
            "first10": first, "last10": last,
            "step_s": [m["step_time_s"] for m in trainer.metrics_log]}


if __name__ == "__main__":
    main()
