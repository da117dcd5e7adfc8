"""Training loop: checkpoint/restart, straggler deadline (the JAX
package's ``train/trainer.py``), on one device.

The step runs eagerly (``launch/steps.make_train_step`` with the state
donated: updated in place).  Checkpoints are the reference's format, so
a run either package started resumes in the other.  Meshes and sharding
rules wait for training across cards (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convspec import resolve_device
from repro_torch.launch import steps as St
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_async: bool = True
    peak_lr: float = 3e-4
    log_every: int = 10
    seed: int = 0
    # straggler mitigation: if a step exceeds deadline x median, log and
    # (on a real pod) trigger the rejoin protocol; here we record it.
    straggler_factor: float = 3.0
    grad_compression: bool = False     # int8 + error feedback (dist.compress)


class Trainer:
    """``device``: where the state lives and the steps run (default: the
    card)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data,
                 mesh=None, rules=None, device=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "a mesh or sharding rules need training across cards, which "
                "the port does not have yet (ROADMAP queue 1)")
        self.cfg, self.tcfg, self.data = cfg, tcfg, data
        self.device = resolve_device(device)
        self.metrics_log = []
        self._step_times = []
        self.step_fn = St.make_train_step(
            cfg, peak_lr=tcfg.peak_lr,
            grad_compression=tcfg.grad_compression, donate=True)
        self.state = None
        self._stop = False

    def request_stop(self):
        """Ask ``run`` to stop at the next step boundary, with a sync
        checkpoint of the state there.  Safe from a signal handler: the
        donated step rewrites the state leaf by leaf, so a state saved in
        the middle of a step would mix two steps."""
        self._stop = True

    # ------------------------------------------------------------------
    def init_state(self, device=None):
        """The state from ``tcfg.seed`` (on "meta": its shapes alone)."""
        dev = self.device if device is None else torch.device(device)
        params = lm.init_lm(self.cfg, seed=self.tcfg.seed, device=dev)
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.tcfg.grad_compression:
            from repro_torch.dist import compress as C
            state["ef"] = C.init_feedback(params)
        return state

    def resume_or_init(self):
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            # the reference's jax.eval_shape(self.init_state)
            like = self.init_state(device="meta")
            self.state = ckpt.restore_checkpoint(
                self.tcfg.ckpt_dir, last, like, device=self.device)
            print(f"[trainer] resumed from step {last}")
        else:
            self.state = self.init_state()
        return int(self.state["step"])

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        start = self.resume_or_init()
        pending = None
        for step in range(start, self.tcfg.steps):
            if self._stop:
                break
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in self.data.batch_at(step).items()}
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._step_times.append(dt)
            med = float(np.median(self._step_times[-20:]))
            if dt > self.tcfg.straggler_factor * med and len(
                    self._step_times) > 5:
                metrics["straggler_detected"] = dt / med
            metrics["step"], metrics["step_time_s"] = step, dt
            self.metrics_log.append(metrics)
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss {metrics['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if (step + 1) % self.tcfg.ckpt_every == 0 or \
                    step + 1 == self.tcfg.steps:
                if pending is not None and hasattr(pending, "join"):
                    pending.join()                      # one in flight max
                pending = ckpt.save_checkpoint(
                    self.tcfg.ckpt_dir, step + 1, self.state,
                    async_=self.tcfg.ckpt_async)
        if pending is not None and hasattr(pending, "join"):
            pending.join()
        if self._stop:
            now = int(self.state["step"])
            if ckpt.latest_step(self.tcfg.ckpt_dir) != now:
                ckpt.save_checkpoint(self.tcfg.ckpt_dir, now, self.state)
        return self.metrics_log[-1] if self.metrics_log else {}
