"""Training loop: checkpoint/restart, straggler deadline, elastic
re-mesh (the JAX package's ``train/trainer.py``).

The step runs eagerly (``launch/steps.make_train_step`` with the state
donated: updated in place).  Checkpoints are the reference's format, so
a run either package started resumes in the other.

With a ``mesh`` (a ``DeviceMesh``, ``launch/mesh.py``) the state lives
as DTensors placed by ``dist.sharding.param_specs`` under ``rules``
(default ``make_rules("train")``), each rank holding its shards; every
rank computes the same global batch from ``(seed, step)`` and keeps its
rows; activations are pinned to the batch sharding at every layer
boundary.  Checkpoints are gathered and mesh-independent, so a run
resumes onto whatever mesh comes up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convspec import resolve_device
from repro_torch.dist import sharding as shd
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
    """``device``: where the state lives and the steps run without a mesh
    (default: the card); a mesh lies on its own device."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data,
                 mesh=None, rules=None, device=None):
        self.cfg, self.tcfg, self.data = cfg, tcfg, data
        self.mesh = mesh
        self.metrics_log = []
        self._step_times = []
        act_spec = None
        self.shardings = None
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh "
                                f"(launch/mesh.py); got {type(mesh).__name__}")
            self.device = shd.device_of(mesh)
            rules = rules or shd.make_rules(
                "train", "pod" in mesh.mesh_dim_names)
            self.rules = rules
            pspecs = shd.param_specs(St.state_specs(cfg)["params"], rules)
            self.sspecs = {"params": pspecs, "opt": shd.opt_specs(pspecs),
                           "step": shd.P()}
            if tcfg.grad_compression:
                self.sspecs["ef"] = pspecs
            self.shardings = shd.named(mesh, self.sspecs)
            act_spec = shd.named(mesh, shd.P(rules["batch"], None, None))
        elif rules is not None:
            raise ValueError("sharding rules need a mesh")
        else:
            self.device = resolve_device(device)
            self.sspecs = None
        self.step_fn = St.make_train_step(
            cfg, peak_lr=tcfg.peak_lr, act_spec=act_spec,
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
        """The state from ``tcfg.seed`` (on "meta": its shapes alone).  On
        a mesh each piece of the params is placed as it is drawn
        (``lm.init_lm(place=...)``) and the optimizer state is built from
        the placed params, so every rank holds its shards and at most one
        layer whole; the values are those of the state drawn whole and
        placed."""
        dev = self.device if device is None else torch.device(device)
        on_mesh = self.mesh is not None and dev.type != "meta"
        params = lm.init_lm(
            self.cfg, seed=self.tcfg.seed, device=dev,
            place=shd.placer(self.shardings["params"]) if on_mesh else None)
        step = torch.zeros((), dtype=torch.int32, device=dev)
        state = {"params": params, "opt": adamw_init(params),
                 "step": (shd.place(step, self.shardings["step"]) if on_mesh
                          else step)}
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
                self.tcfg.ckpt_dir, last, like, shardings=self.shardings,
                device=self.device)
            print(f"[trainer] resumed from step {last}")
        else:
            self.state = self.init_state()
        return int(self.state["step"])

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        start = self.resume_or_init()
        pending = None
        for step in range(start, self.tcfg.steps):
            if self._should_stop():
                break
            batch = self.batch_at(step)
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
                # the last save is joined at once: written sync, it
                # streams, where an async one copies the whole state to
                # the host first
                pending = ckpt.save_checkpoint(
                    self.tcfg.ckpt_dir, step + 1, self.state,
                    async_=self.tcfg.ckpt_async and
                    step + 1 != self.tcfg.steps)
        if pending is not None and hasattr(pending, "join"):
            pending.join()
        if self.mesh is not None:
            dist.barrier()        # rank 0's last write is published
        if self._should_stop():
            now = int(self.state["step"])
            if ckpt.latest_step(self.tcfg.ckpt_dir) != now:
                ckpt.save_checkpoint(self.tcfg.ckpt_dir, now, self.state)
        return self.metrics_log[-1] if self.metrics_log else {}

    def batch_at(self, step):
        """The global batch of ``step`` on the device; on a mesh, each
        rank keeps its rows of the batch every rank computed alike."""
        host = self.data.batch_at(step)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in host.items()}
        if self.mesh is None:
            return batch
        specs = shd.named(self.mesh, shd.batch_specs(batch, self.rules))
        return {k: shd.place(v, specs[k]) for k, v in batch.items()}

    def _should_stop(self) -> bool:
        """``request_stop`` was called; on a mesh, on any rank (the ranks
        agree, so every rank stops at the same step)."""
        if self.mesh is None:
            return self._stop
        flag = torch.tensor([int(self._stop)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._stop = bool(flag.item())
        return self._stop
