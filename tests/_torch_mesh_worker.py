"""Ranks of the port's multi-process tests: ``gloo`` process groups on a
FileStore, four ranks by default, each one process of

    python tests/_torch_mesh_worker.py <case> <dir> <rank> <world>

The tests write the inputs (checkpoints and numpy arrays the JAX package
made) into ``dir`` and read back what rank 0 writes there; a rank that
fails a check exits non-zero.  This module imports no JAX: the ranks run
the port alone, as a pod's processes would.  ``run_ranks`` starts the
ranks and waits for them.  On four cards, one process a card (NCCL):

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 tests/_torch_mesh_worker.py cards <dir>

(``full`` in place of ``cards``: qwen2-1.5b at full size on the mesh;
``serve_cards``: every arch of ``SERVE_ARCHS`` through the sharded
prefill and decode steps on (2, 2) and (1, 4); ``serve_full``:
jamba-v0.1-52b whole on both meshes, to ``serve_full.json``;
``serve_period``: its one-period bf16 check alone; ``train_full``:
qwen3-14b trained at full size on (2, 2), its checkpoint restored onto
(1, 4); ``train_cuts``: full-width 2-layer fp32 cuts against one card.)
The collectives of these serving and train steps, counted on meta over
a ``fake`` group of four ranks (no card, no group needed), and the
launcher's preemption round trip on four cards (``torchrun`` started
from here):

    PYTHONPATH=src python tests/_torch_mesh_worker.py serve_counts <dir>
    PYTHONPATH=src python tests/_torch_mesh_worker.py train_counts <dir>
    PYTHONPATH=src python tests/_torch_mesh_worker.py train_cli <dir>
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

#: the archs of the sharded-step parity: dense (QKV biases), SSM, MoE
#: under GQA and MoE under MLA
STEP_ARCHS = ["qwen2-1.5b", "mamba2-1.3b", "deepseek-moe-16b",
              "deepseek-v2-lite-16b"]
#: the archs whose sharded loss and gradients are held to the port's
#: unsharded ones on the ranks: hybrid, M-RoPE positions (batch at dim
#: 1), embeds input
GRAD_ARCHS = ["jamba-v0.1-52b", "qwen2-vl-2b", "musicgen-large"]
#: the parity batch and peak lr (tests/test_torch_train.py's)
STEP_BATCH, STEP_SEQ, STEP_LR, STEP_ACCUM = 8, 16, 3e-3, 2
#: micro-batches of fewer rows than the batch ranks: a batch of 2 rows at
#: grad_accum 2, so each micro-batch's one row spans 'data' = 2 (dense,
#: and MoE whose capacity routing competes across the tokens)
SMALL_ARCHS, SMALL_BATCH = ["qwen2-1.5b", "deepseek-moe-16b"], 2


def step_runs():
    """(tag, arch) of every sharded step of the ``steps`` case: the
    parity batch per arch, then the small batch (``<arch>-b2``)."""
    return ([(arch, arch) for arch in STEP_ARCHS]
            + [(f"{arch}-b{SMALL_BATCH}", arch) for arch in SMALL_ARCHS])


def run_ranks(case: str, d: Path, world: int = 4, timeout: float = 300):
    """Run ``case`` on ``world`` ranks; raise with their output if any
    fails or the time runs out (every rank is killed then)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(d), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"ranks failed {bad}:\n" + "\n".join(
            f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs


# ---------------------------------------------------------------------------
# the ranks

def _cfg(arch, **kw):
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_variant
    return dataclasses.replace(smoke_variant(get_config(arch)), **kw)


def _shard_numel(t):
    """The numel of a DTensor's shard on an even cut."""
    n = t.numel()
    for p, size in zip(t.placements, t.device_mesh.shape):
        if p.is_shard():
            assert t.shape[p.dim] % size == 0, (t.shape, t.placements)
            n //= size
    return n


def _check_local_shards(state):
    """Every DTensor leaf holds its shard only; returns (local numel,
    global numel) over the tree."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import leaves
    local = whole = 0
    for t in leaves(state):
        assert isinstance(t, DTensor), type(t)
        assert t.to_local().numel() == _shard_numel(t), (
            t.shape, t.placements, t.to_local().shape)
        local += t.to_local().numel()
        whole += t.numel()
    return local, whole


def _nbytes(x):
    """Bytes of a tensor's (a DTensor's whole) or an array's elements."""
    import numpy as np
    return (x.nbytes if isinstance(x, np.ndarray)
            else x.numel() * x.element_size())


def _base(a):
    """The array whose memory ``a`` views (``a`` itself if it owns it)."""
    import numpy as np
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


class HighWater:
    """The bytes held whole at once, by weakref: ``add`` registers an
    object (a tensor or array, once) until it is freed; ``peak`` is the
    most the live ones held together when one was added."""

    def __init__(self):
        self.live, self.peak, self.count = {}, 0, 0

    def add(self, x):
        import weakref
        if id(x) in self.live:
            return
        self.live[id(x)] = _nbytes(x)
        weakref.finalize(x, self.live.pop, id(x), None)
        self.peak = max(self.peak, sum(self.live.values()))
        self.count += 1


class Watched:
    """While entered, ``module.name`` is wrapped by ``hook(result, *args)``
    (called after the real function; returns nothing).  Wraps only the
    port's modules."""

    def __init__(self, module, name, hook):
        self.module, self.name, self.hook = module, name, hook

    def __enter__(self):
        self.real = real = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            out = real(*a, **kw)
            self.hook(out, *a, **kw)
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def watch_place(tracker):
    """``sharding.place`` watched: each whole tensor it cuts (a result
    with a ``Shard`` placement; a replicated result is the whole itself)
    goes into ``tracker``."""
    from repro_torch.dist import sharding as sh

    def hook(out, t, *_):
        if any(p.is_shard() for p in out.placements):
            tracker.add(t)
    return Watched(sh, "place", hook)


def owned(tree):
    """Every DTensor leaf's local shard owns its storage (no whole tensor
    it was cut from lives on behind it)."""
    from repro_torch.dist import sharding as sh
    return all(sh.local_shard(t).untyped_storage().nbytes()
               == sh.local_shard(t).numel() * t.element_size()
               for t in leaves_of(tree))


def per_rank(row):
    """Every rank's ``row``, in rank order (a collective)."""
    import torch.distributed as dist
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, row)
    return rows


def case_steps(d: Path, mesh):
    """Per run of ``step_runs``: the state from ``<arch>_in`` (a port
    checkpoint of the reference's fp32 params) restored onto the mesh,
    one sharded step at grad_accum 2 on ``<tag>_batch.npz``, the metrics
    to ``<tag>_metrics.json`` and the state to ``<tag>_out``."""
    import numpy as np
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import steps as St
    from repro_torch.train import checkpoint as ckpt
    rules = sh.make_rules("train")
    for tag, arch in step_runs():
        cfg = _cfg(arch, grad_accum=STEP_ACCUM)
        like = St.state_specs(cfg)
        like = {"params": _fp32(like["params"]),
                "opt": like["opt"], "step": like["step"]}
        pspecs = sh.param_specs(like["params"], rules)
        specs = {"params": pspecs, "opt": sh.opt_specs(pspecs),
                 "step": sh.P()}
        state = ckpt.restore_checkpoint(d / f"{arch}_in", 0, like,
                                        shardings=sh.named(mesh, specs))
        local, whole = _check_local_shards(state)
        assert local < whole, (local, whole)
        host = dict(np.load(d / f"{tag}_batch.npz"))
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        bspecs = sh.named(mesh, sh.batch_specs(batch, rules))
        batch = {k: sh.place(v, bspecs[k]) for k, v in batch.items()}
        act = sh.named(mesh, sh.P(rules["batch"], None, None))
        step = St.make_train_step(cfg, peak_lr=STEP_LR, act_spec=act,
                                  donate=True)
        state, m = step(state, batch)
        assert not any(hasattr(v, "placements") for v in m.values())
        metrics = {k: float(v) for k, v in m.items()}
        metrics["local_numel"], metrics["numel"] = _check_local_shards(
            state)
        ckpt.save_checkpoint(d / f"{tag}_out", 1, state)
        if torch.distributed.get_rank() == 0:
            (d / f"{tag}_metrics.json").write_text(json.dumps(metrics))


def _grad_batch(cfg, rng):
    import numpy as np
    B, S = STEP_BATCH, STEP_SEQ
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.input_mode == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    else:
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model))
    if cfg.mrope_sections:
        batch["positions"] = (np.arange(S)[None, None]
                              + 3 * np.arange(B)[None, :, None]
                              + np.arange(3)[:, None, None])
    return {k: v.astype(np.float32 if k == "embeds" else np.int32)
            for k, v in batch.items()}


def case_grads(d: Path, mesh, archs=GRAD_ARCHS):
    """Per arch: train_loss and its gradients on the mesh against the
    same unsharded on every rank; the worst relative differences to
    ``<arch>_grads.json``."""
    import numpy as np
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm
    from repro_torch.tree import leaves, unflatten
    rules = sh.make_rules("train")
    act = sh.named(mesh, sh.P(rules["batch"], None, None))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    for arch in archs:
        cfg = _cfg(arch)
        params = lm.init_lm(cfg, seed=0, device=dev, dtype=torch.float32)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in _grad_batch(
            cfg, np.random.default_rng(1)).items()}
        specs = sh.named(mesh, sh.batch_specs(batch, rules))
        sharded = (sh.place_tree(params, sh.named(
            mesh, sh.param_specs(params, rules))),
            {k: sh.place(v, specs[k]) for k, v in batch.items()}, act)
        got = []
        for p, b, a in (sharded, (params, batch, None)):
            req = [x.detach().requires_grad_(True) for x in leaves(p)]
            loss, _ = lm.train_loss(unflatten(p, req), cfg, b, act_spec=a)
            grads = torch.autograd.grad(loss, req)
            if a is not None:
                loss = loss.full_tensor()
                grads = [g.full_tensor() for g in grads]
            got.append((float(loss), grads))
        (ls, gs), (lo, go) = got
        worst = max(float((x - y).norm() / y.norm().clamp_min(1e-30))
                    for x, y in zip(gs, go))
        if torch.distributed.get_rank() == 0:
            (d / f"{arch}_grads.json").write_text(json.dumps(
                {"loss": [ls, lo], "max_rel_grad_l2": worst}))


def _fp32(tree):
    import torch
    from repro_torch.tree import map_tree
    return map_tree(lambda a: a.to(torch.float32), tree)


def case_ckpt(d: Path, mesh):
    """compressed_psum over a 1-D mesh of the world; a (2, 2) trainer's
    checkpoint, saved sync and async (the bytes each rank copied to the
    host, and the most held there at once), restored onto (4, 1), (1, 4)
    and no mesh (the most held whole at once: keys read to the host,
    leaves on the device; the keys each rank read); a checkpoint the
    JAX package wrote, restored onto the mesh; the JAX package's
    init_state drawn through the placed init and saved from the mesh.  Per-rank records to
    ``ckpt_rows.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import compress as C
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.tree import leaves
    rank, world = dist.get_rank(), dist.get_world_size()

    # compressed_psum: rank r sums row r of x with its residual row r
    src = dict(np.load(d / "psum_in.npz"))
    pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    out, new_err = C.compressed_psum(torch.from_numpy(src["x"][rank]),
                                     pod["pod"],
                                     torch.from_numpy(src["err"][rank]))
    outs = [torch.empty_like(new_err) for _ in range(world)]
    dist.all_gather(outs, new_err)
    if rank == 0:
        np.savez(d / "psum_out.npz", sum=out.numpy(),
                 err=torch.stack(outs).numpy())

    # elastic: a (2, 2) trainer's checkpoint (sync, streamed), then the
    # same state saved async; who copied what to the host
    cfg = _cfg("qwen2-1.5b", grad_accum=1)
    data = SyntheticLMData(cfg.vocab_size, 4, 16)
    tcfg = TrainConfig(steps=1, ckpt_every=1, ckpt_dir=str(d / "elastic"),
                       ckpt_async=False, log_every=100)
    t = Trainer(cfg, tcfg, data, mesh=mesh)
    row = {"rank": rank}
    for name in ("sync", "async"):
        copied, host = [0], HighWater()

        def to_host(out, t_, *_):
            copied[0] += _nbytes(t_)
            host.add(_base(out[0]))
        with Watched(ckpt, "_to_host", to_host):
            if name == "sync":
                t.run()
            else:
                th = ckpt.save_checkpoint(d / "async", 1, t.state,
                                          async_=True)
                if th is not None:
                    th.join()
                dist.barrier()
        row[name] = {"copied": copied[0], "host_peak": host.peak}
    saved = [x.full_tensor() for x in leaves(t.state)]
    like = t.init_state(device="meta")
    manifest = json.loads((d / "elastic" / "step_1" / "manifest.json")
                          .read_text())["arrays"]
    row["largest_key"] = max(
        int(np.prod(m["shape"])) * (2 if m["dtype"] == "bfloat16"
                                    else np.dtype(m["dtype"]).itemsize)
        for m in manifest.values())
    row["largest_leaf"] = max(_nbytes(x) for x in leaves(like))
    row["state"] = sum(_nbytes(x) for x in leaves(like))
    row["keys"] = len(manifest)
    for name, model in (("4x1", 1), ("1x4", 4), ("none", None)):
        host, whole, reads = HighWater(), HighWater(), []

        def load(out, d_, k, *_):
            host.add(out)
            reads.append(k)
        with Watched(ckpt, "_load", load), watch_place(whole):
            if model is None:
                got = ckpt.restore_checkpoint(d / "elastic", 1, like,
                                              device="cpu")
            else:
                m = make_debug_mesh(model=model)
                assert tuple(m.shape) == (world // model, model)
                got = ckpt.restore_checkpoint(
                    d / "elastic", 1, like,
                    shardings=Trainer(cfg, tcfg, data, mesh=m).shardings)
        row[name] = {
            "equal": all(torch.equal(a, sh.whole(b)) and a.dtype == b.dtype
                         for a, b in zip(saved, leaves(got), strict=True)),
            "on_mesh": model is None or all(
                b.device_mesh is m for b in leaves(got)),
            "owned": owned(got), "host_peak": host.peak,
            "device_peak": whole.peak, "reads": reads}
        del got

    # a JAX package's checkpoint onto the mesh
    jlike = Trainer(cfg, TrainConfig(ckpt_dir=str(d / "jax")), data,
                    mesh=mesh)
    jstate = ckpt.restore_checkpoint(d / "jax", 2, like,
                                     shardings=jlike.shardings)
    jplain = ckpt.restore_checkpoint(d / "jax", 2, like, device="cpu")
    _check_local_shards(jstate)
    for b, c in zip(leaves(jstate), leaves(jplain), strict=True):
        assert torch.equal(b.full_tensor(), c)

    # the JAX package's init_state drawn through the trainer's placed
    # init (its params, from the checkpoint it wrote, handed piece by
    # piece to the placing callback), saved streamed from the mesh
    from repro_torch.models import lm
    jparams = ckpt.load_numpy(d / "jinit", 0, prefix="params")["params"]

    def jax_init(cfg, seed=0, device=None, dtype=None, place=None):
        p = lm.params_from_numpy(jparams, cfg, device=device)
        put = place or (lambda path, piece: piece)
        out = {k: put((k,), v) for k, v in p.items() if k != "segments"}
        out["segments"] = [[{pos: put(("segments", si, r, pos), layer)
                             for pos, layer in rep.items()}
                            for r, rep in enumerate(seg)]
                           for si, seg in enumerate(p["segments"])]
        return out
    real_init, lm.init_lm = lm.init_lm, jax_init
    try:
        jinit = Trainer(cfg, tcfg, data, mesh=mesh).init_state()
    finally:
        lm.init_lm = real_init
    row["jinit_local"] = _check_local_shards(jinit)
    ckpt.save_checkpoint(d / "jinit_port", 0, jinit)
    rows = per_rank(row)
    if rank == 0:
        (d / "ckpt_rows.json").write_text(json.dumps(rows, indent=1))
        (d / "ckpt_ok").write_text("ok")


def trainer_setup(rows=8):
    """(config, data, trainer class) of the mesh trainer's case: qwen2
    at grad_accum 2 on fp32 params, ``rows`` rows a batch."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import Trainer

    class Fp32Trainer(Trainer):
        def init_state(self, device=None):
            s = super().init_state(device)
            p = _fp32(s["params"])
            return dict(s, params=p, opt=adamw_init(p))

    cfg = _cfg("qwen2-1.5b", grad_accum=2)
    return cfg, SyntheticLMData(cfg.vocab_size, rows, 16), Fp32Trainer


def case_trainer(d: Path, mesh):
    """The mesh trainer: 2 steps with a checkpoint each, then a second
    trainer resumes onto the mesh and takes step 3; its losses to
    ``trainer.json``.  Then one step on batches of ``SMALL_BATCH`` rows
    (``small.json``), a stop, and grad compression.  First the placed
    init against the state drawn whole and placed, with and without the
    feedback residuals, and the most held whole at once while placing
    (``init.json``)."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves
    cfg, data, make = trainer_setup()

    icfg = _cfg("qwen2-1.5b", grad_accum=1)
    meta = lm.init_lm(icfg, device="meta")
    pieces = [meta[k] for k in ("embed", "final_norm", "lm_head")
              if k in meta] + [layer for seg in meta["segments"]
                               for rep in seg for layer in rep.values()]
    row = {"largest_piece": max(sum(_nbytes(x) for x in leaves_of(p))
                                for p in pieces)}
    for comp in (False, True):
        tc = TrainConfig(ckpt_dir=str(d / "unused"), grad_compression=comp)
        t = Trainer(icfg, tc, data, mesh=mesh)
        whole = HighWater()
        with watch_place(whole):
            placed = t.init_state()
        ref = sh.place_tree(Trainer(icfg, tc, data, device="cpu")
                            .init_state(), t.shardings)
        pairs = list(zip(leaves(placed), leaves(ref), strict=True))
        row[f"ef={comp}"] = {
            "equal": all(a.placements == b.placements and a.dtype == b.dtype
                         and torch.equal(a.to_local(), b.to_local())
                         for a, b in pairs),
            "owned": owned(placed), "peak": whole.peak,
            "whole": sum(_nbytes(a) for a, _ in pairs)}
        del placed, ref, pairs
    rows = per_rank(row)
    if torch.distributed.get_rank() == 0:
        (d / "init.json").write_text(json.dumps(rows, indent=1))

    losses = []
    for steps in (2, 3):
        tcfg = TrainConfig(steps=steps, ckpt_every=1,
                           ckpt_dir=str(d / "trainer"), log_every=100)
        t = make(cfg, tcfg, data, mesh=mesh)
        t.run()
        losses += [m["loss"] for m in t.metrics_log]
        _check_local_shards(t.state)
    if torch.distributed.get_rank() == 0:
        (d / "trainer.json").write_text(json.dumps(losses))

    # a batch of SMALL_BATCH rows at grad_accum 2: micro-batches of one
    # row, fewer than the 'data' ranks
    cfg, data, make = trainer_setup(rows=SMALL_BATCH)
    t = make(cfg, TrainConfig(steps=1, ckpt_every=100,
                              ckpt_dir=str(d / "small"), log_every=100),
             data, mesh=mesh)
    t.run()
    _check_local_shards(t.state)
    if torch.distributed.get_rank() == 0:
        (d / "small.json").write_text(json.dumps(
            {k: t.metrics_log[0][k] for k in ("loss", "grad_norm")}))
    cfg, data, make = trainer_setup()

    # a stop requested on rank 0 alone (its SIGTERM) inside step 2: every
    # rank stops at the next step boundary, with one checkpoint there
    from repro_torch.train import checkpoint as ckpt
    tcfg = TrainConfig(steps=6, ckpt_every=100, ckpt_dir=str(d / "stop"),
                       log_every=100)
    t = make(cfg, tcfg, data, mesh=mesh)
    step_fn = t.step_fn

    def step_then_stop(state, batch):
        out = step_fn(state, batch)
        if torch.distributed.get_rank() == 0 and len(t.metrics_log) == 1:
            t.request_stop()
        return out
    t.step_fn = step_then_stop
    t.run()
    if torch.distributed.get_rank() == 0:
        (d / "stop.json").write_text(json.dumps({
            "steps_run": len(t.metrics_log),
            "state_step": int(t.state["step"]),
            "checkpoints": ckpt.latest_steps(d / "stop")}))
    elif len(t.metrics_log) != 2:
        raise AssertionError(f"rank ran {len(t.metrics_log)} steps")

    # grad compression: one step on the mesh and one unsharded (every
    # rank), the params' updates and the feedback residuals compared
    from repro_torch.tree import leaves
    cfg = _cfg("qwen2-1.5b", grad_accum=1)
    tcfg = TrainConfig(grad_compression=True, peak_lr=STEP_LR,
                       ckpt_dir=str(d / "unused"))
    runs = []
    for kw in ({"mesh": mesh}, {"device": "cpu"}):
        t = make(cfg, tcfg, data, **kw)
        st = t.init_state()
        p0 = [x.full_tensor().clone() if "mesh" in kw else x.clone()
              for x in leaves(st["params"])]
        st, m = t.step_fn(st, t.batch_at(0))
        whole = ((lambda x: x.full_tensor()) if "mesh" in kw
                 else (lambda x: x))
        runs.append((float(m["loss"]), p0,
                     [whole(x) for x in leaves(st["params"])],
                     [whole(x) for x in leaves(st["ef"])]))
    (lm_, a0, a1, ae), (lo, b0, b1, be) = runs
    upd = max(float(((x1 - x0) - (y1 - y0)).norm()
                    / (y1 - y0).norm().clamp_min(1e-30))
              for x0, x1, y0, y1 in zip(a0, a1, b0, b1))
    off = sum(int(((x - y).abs() > 1e-6).sum()) for x, y in zip(ae, be))
    total = sum(y.numel() for y in be)
    if torch.distributed.get_rank() == 0:
        (d / "compressed.json").write_text(json.dumps({
            "loss": [lm_, lo], "max_rel_update_l2": upd,
            "ef_off": off, "ef_total": total,
            "ef_max": max(float(y.abs().max()) for y in be)}))


#: the repairs' archs: heads that a model axis of 4 does not divide (the
#: smoke qwen2's 2 kv heads; 6 query heads), and the prefill/decode
#: parity's dense, MoE (GQA and MLA), SSM and hybrid (attention + Mamba +
#: MoE) smoke variants
HEAD_ARCHS = {"qwen2-1.5b": {}, "qwen2-1.5b-h6": {"num_heads": 6}}
SERVE_ARCHS = ["qwen2-1.5b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
               "mamba2-1.3b", "jamba-v0.1-52b"]
#: the archs the gloo repairs serve for SERVE_STEPS decode steps on every
#: mesh of SERVE_MESHES (the others: one decode step on (2, 2))
SERVE_LOOP_ARCHS = ["jamba-v0.1-52b"]
#: the serve parity's rows, prompt and decode steps; the meshes by name,
#: each make_debug_mesh's 'model' axis over four ranks
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 16, 8
#: a prompt that the SSD scan's chunk (16 at this length) does not divide
SERVE_PAD_PROMPT = 12
SERVE_MESHES = {"2x2": 2, "1x4": 4}
#: sharded against unsharded serving, fp32: the logits and every cache
#: leaf (fp32 rounding of the partial sums the ranks add)
SERVE_LOGITS_TOL, SERVE_CACHE_TOL = 2e-4, 1e-5
#: jamba-v0.1-52b whole on four cards (case_serve_full): the timed run's
#: rows, prompt and greedy decode steps, in bf16; its runs (the first
#: warms, the others are timed)
FULL_ARCH = "jamba-v0.1-52b"
FULL_BATCH, FULL_PROMPT, FULL_STEPS, FULL_RUNS = 4, 512, 16, 3
#: one 8-layer period sharded against the same layers unsharded on one
#: card, bf16, teacher-forced: every step's logits within this much of
#: the unsharded run's max |logits|.  Each layer's row-parallel products
#: (the mixer's wo or out_proj, the MLP's or experts' wo) are summed over
#: the ranks from per-rank partial sums, each rounded to bf16 (a relative
#: 2**-8 = 3.9e-3 each), against one sum on one card: 16 such products
#: in a period, their errors adding as a random walk (4 x 3.9e-3 =
#: 1.6e-2), with a factor of three for a router that picks another
#: expert on a near tie
FULL_PERIOD_TOL = 5e-2
#: the period's gate: FULL_PERIOD_TOL was wrong about bf16, not sharding
#: (bf16 alone, unsharded, is as far from the same layers in fp32 as the
#: sharded runs are), so the sharded bf16 run's worst logits distance
#: from the fp32 run, fed the same tokens, must be at most this many
#: times the unsharded bf16 run's own worst distance from it; the old
#: figure is still recorded beside it
FULL_PERIOD_FP32_RATIO = 1.10


def _metrics(step, state, batch):
    _, m = step(state, batch)
    return {k: float(v) for k, v in m.items()}


def _tree_leaves(tree):
    import torch
    return torch.utils._pytree.tree_leaves(tree)


def check_cache(cache, shardings):
    """Every cache leaf is a DTensor placed as its ``cache_specs``
    sharding says for its shape, holding its share of the elements and
    no more (a step that handed back a ``Replicate`` or ``Partial`` cache
    would grow each rank's memory without failing)."""
    from torch.distributed.tensor import DTensor
    ts, ss = leaves_of(cache), _tree_leaves(shardings)
    assert len(ts) == len(ss), (len(ts), len(ss))
    for t, s in zip(ts, ss):
        assert isinstance(t, DTensor), type(t)
        want = tuple(s.placements_for(t.shape))
        if tuple(t.placements) != want:
            raise AssertionError(f"cache leaf {tuple(t.shape)} placed "
                                 f"{t.placements}, not {want}")
        if t.to_local().numel() != _shard_numel(t):
            raise AssertionError(f"cache leaf {tuple(t.shape)}: "
                                 f"{t.to_local().numel()} local elements, "
                                 f"its share is {_shard_numel(t)}")


def place_params(params, mesh, mode="prefill"):
    """``params`` (whole on every rank) placed by ``param_specs`` under
    ``make_rules(mode)``."""
    from repro_torch.dist import sharding as sh
    return sh.place_tree(params, sh.named(mesh, sh.param_specs(
        params, sh.make_rules(mode))))


def serve_loop(cfg, params, prompt, steps, max_len, mesh=None, *,
               moe_groups=1, kv_dtype=None, feed=None, step_ctx=None):
    """Greedy serving through ``launch/steps.py``'s prefill and decode
    steps, as the reference's serve cells place them: a prefill of
    ``prompt`` ((B, S) int32 tokens, whole on every rank), then
    ``steps`` decode steps, step ``i`` (from 0) fed at offset ``S + i``
    the argmax over ``[:vocab_size]`` of the logits before it, or
    ``feed[:, i]`` where ``feed`` ((B, steps) tokens) is given: a run
    teacher-forced with another run's tokens is held to it step by step.

    On ``mesh`` the params are DTensors already (``place_params``); the
    cache (``kv_dtype``, fp32 by default) is placed by ``cache_specs``
    under ``make_rules("prefill")``, the activations by ``P(batch, None,
    None)`` and the tokens by ``P(batch, None)`` under each step's rules
    (``"prefill"``, ``"decode"``), and after every step each cache leaf
    must still be placed so (``check_cache``).  ``step_ctx(i)`` is a
    context entered around step ``i`` (0: the prefill).

    Returns ``{"logits": [(B, Vpad)] per step, whole on every rank;
    "tokens": (B, steps + 1) argmaxes; "ms": host ms per step between
    synchronizes; "cache": the cache}``."""
    import contextlib
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import steps as St
    from repro_torch.models import lm
    dev = prompt.device
    B, S = prompt.shape
    cache = lm.init_cache(cfg, B, max_len, device=dev,
                          kv_dtype=kv_dtype or torch.float32)
    placed = {}
    if mesh is not None:
        for mode in ("prefill", "decode"):
            rules = sh.make_rules(mode)
            placed[mode] = (
                sh.named(mesh, sh.cache_specs(cache, cfg, rules)),
                sh.named(mesh, sh.P(rules["batch"], None, None)),
                sh.named(mesh, sh.P(rules["batch"], None)))
        cache = sh.place_tree(cache, placed["prefill"][0])

    def act(mode):
        return placed[mode][1] if placed else None

    def tokens(mode, t):
        return {"tokens": sh.place(t, placed[mode][2]) if placed else t}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prefill = St.make_prefill_step(cfg, max_len, act_spec=act("prefill"),
                                   moe_groups=moe_groups)
    decode = St.make_decode_step(cfg, act_spec=act("decode"))
    out = {"logits": [], "tokens": [], "ms": []}
    batch = tokens("prefill", prompt)
    for i in range(steps + 1):
        mode = "prefill" if i == 0 else "decode"
        with (step_ctx(i) if step_ctx else contextlib.nullcontext()):
            sync()
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = prefill(params, batch, cache)
            else:
                logits, cache = decode(params, batch, cache, S + i - 1)
            logits = sh.whole(logits).detach()
            nxt = logits[:, :cfg.vocab_size].float().argmax(-1)
            sync()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        if placed:
            check_cache(cache, placed[mode][0])
        out["logits"].append(logits)
        out["tokens"].append(nxt)
        if i < steps:
            fed = nxt if feed is None else feed[:, i].to(dev)
            batch = tokens("decode", fed[:, None].to(torch.int32))
    out["tokens"] = torch.stack(out["tokens"], 1)
    out["cache"] = cache
    return out


def serve_parity(cfg, params, prompt, steps, mesh, moe_groups=1):
    """``serve_loop`` unsharded (greedy), then on ``mesh`` teacher-forced
    with its tokens: the worst logits and cache differences over the
    steps, and whether the sharded run's own argmaxes equal them."""
    import torch
    from repro_torch.dist import sharding as sh
    max_len = prompt.shape[1] + steps + 1
    plain = serve_loop(cfg, params, prompt, steps, max_len,
                       moe_groups=moe_groups)
    got = serve_loop(cfg, place_params(params, mesh), prompt, steps,
                     max_len, mesh, moe_groups=moe_groups,
                     feed=plain["tokens"][:, :steps])
    cache = [sh.whole(t) for t in leaves_of(got["cache"])]
    logits = [float((a - b).abs().max())
              for a, b in zip(got["logits"], plain["logits"])]
    return {
        "logits": logits, "prefill_logits": logits[0],
        "decode_logits": max(logits[1:]),
        "cache": max(float((x - y).abs().max()) for x, y in
                     zip(cache, leaves_of(plain["cache"]))),
        "cache_leaves": len(cache), "steps": steps,
        "tokens_equal": bool(torch.equal(got["tokens"], plain["tokens"])),
        "mesh": list(mesh.shape)}


def case_repairs(d: Path, mesh):
    """The sharded step's repairs, each against the unsharded function:
    a train step on a (1, 4) mesh whose 'model' axis does not divide the
    heads; ``shard_local`` with a first argument placed (Shard(0),
    Shard(0)) and a second (Shard(0), Replicate()); ``serve_parity`` of
    every arch of ``SERVE_ARCHS``, a prefill and one decode step on the
    (2, 2) mesh, and for ``SERVE_LOOP_ARCHS`` SERVE_STEPS decode steps on
    (2, 2) and (1, 4); jamba's prefill of SERVE_PAD_PROMPT tokens and
    one decode step on (2, 2).  Results to ``repairs.json``."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.nn import layers as L
    from repro_torch.optim import adamw_init
    out = {"heads": {}, "serve": {}}

    # uneven heads: one train step on (1, 4), fp32, against unsharded
    tall = make_debug_mesh(model=4)
    rules = sh.make_rules("train")
    for name, kw in HEAD_ARCHS.items():
        cfg = _cfg("qwen2-1.5b", grad_accum=STEP_ACCUM, **kw)
        params = lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        batch = {k: torch.from_numpy(v) for k, v in _grad_batch(
            cfg, np.random.default_rng(2)).items()}
        step = St.make_train_step(cfg, peak_lr=STEP_LR)
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        want = _metrics(step, state, batch)
        ps = sh.param_specs(params, rules)
        placed = {"params": sh.place_tree(params, sh.named(tall, ps)),
                  "opt": sh.place_tree(adamw_init(params), sh.named(
                      tall, sh.opt_specs(ps))),
                  "step": torch.zeros((), dtype=torch.int32)}
        bs = sh.named(tall, sh.batch_specs(batch, rules))
        act = sh.named(tall, sh.P(rules["batch"], None, None))
        got = _metrics(St.make_train_step(cfg, peak_lr=STEP_LR,
                                          act_spec=act), placed,
                       {k: sh.place(v, bs[k]) for k, v in batch.items()})
        out["heads"][name] = {"sharded": got, "unsharded": want,
                              "heads": [cfg.num_heads, cfg.num_kv_heads]}

    # shard_local with mismatched placements, as _gold met them
    g = torch.Generator().manual_seed(3)
    a = torch.randn((8, 4, 16), generator=g, dtype=torch.float64)
    b = torch.randn((8, 4), generator=g, dtype=torch.float64)
    fn = lambda x, y: (x * y[..., None]).sum(-1) + x[..., 0] * y
    a_, b_ = (t.clone().requires_grad_(True) for t in (a, b))
    whole = fn(a_, b_)
    whole.sum().backward()
    da = distribute_tensor(a, mesh, [Shard(0), Shard(0)]).requires_grad_()
    db = distribute_tensor(b, mesh, [Shard(0), Replicate()]).requires_grad_()
    got = L.shard_local(fn, da, db, dims=(0, 1))
    got.sum().backward()
    out["shard_local"] = {
        "out": float((got.full_tensor() - whole).abs().max()),
        "grad_a": float((da.grad.full_tensor() - a_.grad).abs().max()),
        "grad_b": float((db.grad.full_tensor() - b_.grad).abs().max()),
        "placements": [str(da.grad.placements), str(db.grad.placements)]}

    # prefill and decode steps against unsharded: one step on (2, 2), and
    # SERVE_STEPS steps on every mesh of SERVE_MESHES for SERVE_LOOP_ARCHS
    out["serve_loop"] = {}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch, capacity_factor=8.0)
        params = lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        prompt = _serve_prompt(cfg)
        if arch not in SERVE_LOOP_ARCHS:
            out["serve"][arch] = serve_parity(cfg, params, prompt, 1, mesh)
            continue
        for name, model in SERVE_MESHES.items():
            m = make_debug_mesh(model=model)
            out["serve_loop"].setdefault(arch, {})[name] = serve_parity(
                cfg, params, prompt, SERVE_STEPS, m,
                moe_groups=m.shape[0])
        out["serve"][arch] = out["serve_loop"][arch]["2x2"]
    # a prompt the SSD scan's chunk does not divide (12 tokens, chunk
    # 16): the scan pads the sequence and cuts it back on (2, 2)
    cfg = _cfg("jamba-v0.1-52b", capacity_factor=8.0)
    out["serve_pad"] = serve_parity(
        cfg, lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32),
        _serve_prompt(cfg)[:, :SERVE_PAD_PROMPT].contiguous(), 1, mesh,
        moe_groups=mesh.shape[0])
    if torch.distributed.get_rank() == 0:
        (d / "repairs.json").write_text(json.dumps(out))


def _serve_prompt(cfg, dev="cpu"):
    import numpy as np
    import torch
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(
            np.int32)).to(dev)


def case_serve_one(d: Path, mesh):
    """On one rank's (1, 1) mesh: ``serve_loop`` for SERVE_STEPS greedy
    steps of the smoke jamba, fp32, on the mesh and unsharded, each
    greedy on its own argmaxes; tokens and worst logits difference to
    ``serve_one.json``."""
    import torch
    from repro_torch.models import lm
    assert tuple(mesh.shape) == (1, 1), mesh
    cfg = _cfg("jamba-v0.1-52b", capacity_factor=8.0)
    params = lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
    prompt = _serve_prompt(cfg)
    max_len = SERVE_PROMPT + SERVE_STEPS + 1
    plain = serve_loop(cfg, params, prompt, SERVE_STEPS, max_len)
    got = serve_loop(cfg, place_params(params, mesh), prompt, SERVE_STEPS,
                     max_len, mesh)
    (d / "serve_one.json").write_text(json.dumps({
        "tokens": [got["tokens"].tolist(), plain["tokens"].tolist()],
        "logits": max(float((a - b).abs().max()) for a, b in
                      zip(got["logits"], plain["logits"]))}))


def case_pin(d: Path, mesh):
    """The residual pinned after the mixer, on the (2, 2) mesh: a layer
    forward that redistributes a ``Partial`` residual (``x + out``, the
    mixer's row-parallel output added) to ``Replicate`` before the MLP,
    against the same step without the pin and unsharded, fp32, per arch
    of ``STEP_ARCHS``.  Gradients are tapped at the mixer's output, the
    residual before the pin, the MLP's output and the layer's output
    (relative L2 against the unsharded step's, with each tap's
    placements), and at every param; then one train step at grad_accum
    2 (the config's remat).  The forward is a tapped copy of
    ``models/lm.py::_layer_fwd``; its unsharded loss and gradients are
    checked bit for bit against the real function's.  Results to
    ``pin.json``."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import steps as St
    from repro_torch.models import lm
    from repro_torch.nn import attention as A, layers as L, mamba as S
    from repro_torch.nn import moe as M
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves, map_tree, unflatten
    rules = sh.make_rules("train")
    act = sh.named(mesh, sh.P(rules["batch"], None, None))
    pin, taps = {"on": False}, {"on": False, "rows": []}

    def tap(name, t):
        if taps["on"] and t.requires_grad:
            row = [name, str(getattr(t, "placements", None)), None]
            taps["rows"].append(row)
            t.register_hook(lambda g, row=row: row.__setitem__(2, g))

    def layer_fwd(p, cfg, mixer, mlp, x, positions, cache, offset, mode,
                  moe_groups=1):
        # models/lm.py::_layer_fwd, tapped, with the pin
        h = L.rmsnorm_fwd(p["ln1"], x, cfg.rms_norm_eps, cfg.norm_impl)
        aux = {}
        if mixer == lm.ATTN:
            fwd = A.mla_fwd if cfg.mla else A.gqa_fwd
            out, cache = fwd(p["attn"], cfg, h, positions, cache, offset,
                             mode)
        else:
            out, cache = S.mamba_fwd(p["ssm"], cfg, h, cache, mode)
        tap("mixer_out", out)
        x = x + out
        tap("before_pin", x)
        if pin["on"] and isinstance(x, DTensor) and any(
                q.is_partial() for q in x.placements):
            x = x.redistribute(x.device_mesh, [
                Replicate() if q.is_partial() else q for q in x.placements])
        if mlp != "none":
            h2 = L.rmsnorm_fwd(p["ln2"], x, cfg.rms_norm_eps, cfg.norm_impl)
            if mlp == lm.MOE:
                mo, aux = M.moe_fwd(p["moe"], cfg, h2,
                                    dropless=(mode == "decode"),
                                    n_groups=moe_groups)
            else:
                mo = L.mlp_fwd(p["mlp"], h2)
            tap("mlp_out", mo)
            x = x + mo
        tap("layer_out", x)
        return x, cache, aux

    def paths(tree, pre=""):
        if isinstance(tree, dict):
            return [q for k, v in tree.items() for q in paths(v, f"{pre}/{k}")]
        if isinstance(tree, list):
            return [q for i, v in enumerate(tree)
                    for q in paths(v, f"{pre}/{i}")]
        return [pre]

    def rel(a, b):
        return float((a - b).double().norm()
                     / b.double().norm().clamp_min(1e-30))

    lm._layer_fwd, plain_fwd = layer_fwd, lm._layer_fwd
    out = {"torch": torch.__version__}
    try:
        for arch in STEP_ARCHS:
            base = _cfg(arch, grad_accum=STEP_ACCUM)
            params = lm.init_lm(base, seed=0, device="cpu",
                                dtype=torch.float32)
            names = paths(params)
            host = {k: torch.from_numpy(v) for k, v in _grad_batch(
                base, np.random.default_rng(5)).items()}
            pspec = sh.named(mesh, sh.param_specs(params, rules))
            bspec = sh.named(mesh, sh.batch_specs(host, rules))
            runs = {}
            for variant in ("unsharded", "unpinned", "pinned"):
                pin["on"] = variant == "pinned"
                p, b, a = map_tree(torch.clone, params), host, None
                if variant != "unsharded":
                    p = sh.place_tree(p, pspec)
                    b = {k: sh.place(v, bspec[k]) for k, v in b.items()}
                    a = act
                # the loss's gradients, no remat (a tap needs the forward
                # that autograd differentiates), grad_accum 1
                cfg = dataclasses.replace(base, remat="none", grad_accum=1)
                req = [x.detach().requires_grad_(True) for x in leaves(p)]
                taps["on"], taps["rows"] = True, []
                loss, _ = lm.train_loss(unflatten(p, req), cfg, b,
                                        act_spec=a)
                grads = torch.autograd.grad(loss, req)
                taps["on"] = False
                rows = [(n, pl, sh.whole(g)) for n, pl, g in taps["rows"]]
                grads = [sh.whole(g) for g in grads]
                st = {"params": map_tree(torch.clone, p),
                      "opt": adamw_init(p),
                      "step": torch.zeros((), dtype=torch.int32)}
                _, m = St.make_train_step(base, peak_lr=STEP_LR,
                                          act_spec=a)(st, b)
                runs[variant] = (float(sh.whole(loss)), grads, rows,
                                 {k: float(v) for k, v in m.items()})
            lo, go, to, mo = runs["unsharded"]
            # the copy above against models/lm.py::_layer_fwd itself,
            # unsharded, bit for bit: a drift of either fails the test
            lm._layer_fwd = plain_fwd
            try:
                cfg = dataclasses.replace(base, remat="none", grad_accum=1)
                req = [x.detach().requires_grad_(True)
                       for x in leaves(params)]
                loss, _ = lm.train_loss(unflatten(params, req), cfg, host)
                grads = torch.autograd.grad(loss, req)
            finally:
                lm._layer_fwd = layer_fwd
            row = {"copy_is_real": float(loss) == lo and all(
                torch.equal(g, g0) for g, g0 in zip(grads, go))}
            for variant in ("unpinned", "pinned"):
                ls, gs, ts, ms = runs[variant]
                assert [t[0] for t in ts] == [t[0] for t in to]
                by_tap = {}
                for (n, pl, g), (_, _, g0) in zip(ts, to):
                    worst, places = by_tap.get(n, (0.0, []))
                    by_tap[n] = (max(worst, rel(g, g0)),
                                 sorted(set(places) | {pl}))
                leaf = max((rel(x, y), n) for x, y, n in zip(gs, go, names))
                row[variant] = {
                    "loss_rel": abs(ls - lo) / abs(lo),
                    "taps": by_tap, "worst_param_grad": list(leaf),
                    "step_rel": {k: abs(ms[k] - mo[k]) / abs(mo[k])
                                 for k in ("loss", "grad_norm")}}
            out[arch] = row
    finally:
        lm._layer_fwd = plain_fwd
    if torch.distributed.get_rank() == 0:
        (d / "pin.json").write_text(json.dumps(out))


def leaves_of(tree):
    import torch
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def case_cards(d: Path, mesh):
    """Under ``torchrun`` on cards (NCCL): every arch's sharded loss and
    gradients against unsharded, and compressed_psum over the mesh's
    'data' axis against the sum of each rank's codec output."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import compress as C
    case_grads(d, mesh, STEP_ARCHS + GRAD_ARCHS)
    dev = mesh.device_type
    g = torch.Generator(device=dev).manual_seed(dist.get_rank())
    x = torch.randn(4, 1 << 16, generator=g, device=dev)
    e = torch.randn(4, 1 << 16, generator=g, device=dev) * 1e-2
    got, ne = C.compressed_psum(x, mesh["data"], e)
    (q, sc, shape), want_e = C.quantize_with_feedback(x, e)
    mine = C.dequantize(q, sc, shape).contiguous()
    group = mesh["data"].get_group()
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    want = torch.stack(parts).sum(0)
    rel = float((got - want).abs().max() / want.abs().max())
    if not (rel <= 1e-6 and torch.equal(ne, want_e)):
        raise AssertionError(f"compressed_psum on cards: {rel}")
    if dist.get_rank() == 0:
        (d / "cards.json").write_text(json.dumps({
            "psum_max_rel": rel, "mesh": list(mesh.shape),
            "device": (torch.cuda.get_device_name(0) if dev == "cuda"
                       else dev)}))


def case_full(d: Path, mesh):
    """Under ``torchrun`` on cards: qwen2-1.5b at full size in bf16, three
    steps of 8x512 tokens through ``Trainer(mesh=...)``; step ms, tokens/s
    and the largest rank's peak memory and state to ``full.json``."""
    import dataclasses
    import statistics
    import time
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.train.trainer import Trainer, TrainConfig
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), remat="full")
    torch.cuda.reset_peak_memory_stats()
    t = Trainer(cfg, TrainConfig(ckpt_dir=str(d / "unused")),
                SyntheticLMData(cfg.vocab_size, 8, 512), mesh=mesh)
    t.state = t.init_state()
    ms, losses = [], []
    for step in range(3):
        batch = t.batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.state, m = t.step_fn(t.state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 2 ** 30],
                        device="cuda")
    local = torch.tensor([float(sum(x.to_local().numel()
                                    for x in leaves(t.state)))],
                         device="cuda")
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    dist.all_reduce(local, op=dist.ReduceOp.MAX)
    if dist.get_rank() == 0:
        (d / "full.json").write_text(json.dumps({
            "mesh": list(mesh.shape), "step_ms": ms, "losses": losses,
            "step_ms_median": statistics.median(ms[1:]),
            "tokens_per_s": 8 * 512 / (statistics.median(ms[1:]) / 1e3),
            "max_peak_gib": float(peak), "max_local_state": float(local),
            "state": sum(x.numel() for x in leaves(t.state)),
            "device": torch.cuda.get_device_name(0)}))


def case_serve_cards(d: Path, mesh):
    """On four cards under ``torchrun`` (NCCL; four gloo ranks run it
    too): every arch of ``SERVE_ARCHS``, smoke fp32 at capacity factor
    8, through ``serve_parity`` (a prefill of SERVE_PROMPT tokens and
    SERVE_STEPS decode steps) on every mesh of SERVE_MESHES against the
    unsharded loop on the same device, MoE routed in the 'data' axis's
    groups; each run's worst differences and the kernels it launched to
    ``serve_cards.json``.  Fails where a difference breaks its bound."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    dev = sh.device_of(mesh)
    meshes = {name: make_debug_mesh(model=model)
              for name, model in SERVE_MESHES.items()}
    out = {"torch": torch.__version__, "device": _device_name(dev),
           "archs": {}}
    bad = []
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch, capacity_factor=8.0)
        params = lm.init_lm(cfg, seed=0, device=dev, dtype=torch.float32)
        prompt = _serve_prompt(cfg, dev)
        for name, m in meshes.items():
            t0 = time.perf_counter()
            _build.reset_launches()
            r = serve_parity(cfg, params, prompt, SERVE_STEPS, m,
                             moe_groups=m.shape[0])
            r["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
            r["s"] = time.perf_counter() - t0
            out["archs"].setdefault(arch, {})[name] = r
            if not (max(r["logits"]) <= SERVE_LOGITS_TOL
                    and r["cache"] <= SERVE_CACHE_TOL):
                bad.append((arch, name, max(r["logits"]), r["cache"]))
    out["bad"] = bad
    if dist.get_rank() == 0:
        (d / "serve_cards.json").write_text(json.dumps(out, indent=1))
    if bad:
        raise AssertionError(f"sharded serving off unsharded: {bad}")


def _device_name(dev):
    import torch
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (its helpers and
    bounds; its ``main`` is not run)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def placed_init(cfg, mesh, dtype=None, mode="prefill"):
    """``lm.init_lm(cfg, seed=0)``'s params on ``mesh``, placed by
    ``param_specs`` under ``make_rules(mode)`` one piece at a time as
    they are drawn on this rank's device (``sharding.placer``, the mesh
    trainer's own init): each rank keeps its shards only, and no device
    holds more than the model's largest layer beside them."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm
    specs = sh.named(mesh, sh.param_specs(lm.init_lm(cfg, device="meta"),
                                          sh.make_rules(mode)))
    return lm.init_lm(cfg, seed=0, device=sh.device_of(mesh),
                      dtype=dtype or torch.bfloat16, place=sh.placer(specs))


def _gib(n):
    return n / 2 ** 30


def _local_gib(tree):
    from repro_torch.dist import sharding as sh
    return _gib(sum(sh.local_shard(t).numel() * t.element_size()
                    for t in leaves_of(tree)))


class _MoeAux:
    """While entered, records the aux statistics (``dropped_frac``,
    ``load_balance_loss``) of every prefill MoE call, whole."""

    def __enter__(self):
        from repro_torch.nn import moe
        self._moe, self._fwd, self.calls = moe, moe.moe_fwd, []
        moe.moe_fwd = self._record
        return self

    def __exit__(self, *exc):
        self._moe.moe_fwd = self._fwd

    def _record(self, p, cfg, x, dropless=False, n_groups=1):
        from repro_torch.dist import sharding as sh
        out, aux = self._fwd(p, cfg, x, dropless, n_groups)
        if not dropless:
            self.calls.append({k: sh.whole(v) for k, v in aux.items()})
        return out, aux


_DTYPE_BYTES = {"Float": 4, "BFloat16": 2, "Half": 2, "Double": 8,
                "Long": 8, "Int": 4, "Short": 2, "Char": 1, "Byte": 1,
                "Bool": 1}


def nccl_records(trace: Path, events=None) -> dict:
    """The collectives of a ``torch.profiler`` chrome trace (``events``:
    its ``traceEvents``, already read): the NCCL kernels by name (count,
    device us), and the c10d calls by their ``Collective name`` (count,
    output bytes: ``Out msg nelems`` times the dtype's size)."""
    if events is None:
        events = json.loads(trace.read_text())["traceEvents"]
    kernels, calls = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower():
            k = kernels.setdefault(e["name"].split("(")[0],
                                   {"count": 0, "us": 0.0})
            k["count"] += 1
            k["us"] += float(e.get("dur", 0.0))
        if e.get("cat") == "cpu_op" and "Collective name" in args:
            c = calls.setdefault(args["Collective name"],
                                 {"count": 0, "bytes": 0, "group": set()})
            c["count"] += 1
            c["bytes"] += int(args.get("Out msg nelems", 0)) * \
                _DTYPE_BYTES.get(args.get("dtype"), 0)
            c["group"].add(args.get("Group size"))
    for c in calls.values():
        c["group"] = sorted(map(str, c["group"]))
    return {"nccl_kernels": kernels, "nccl_calls": calls}


def _traced(cs, dev, box, trace: Path, host=True):
    """A ``torch.profiler`` context (CPU and CUDA, shapes recorded; the
    card alone where not ``host``) as chip_smoke's ``profiled`` opens
    one: a warm-up step whose records are dropped, the region held open
    TRACE_PAD_S on both sides.  On exit ``box`` holds the profile and
    ``trace`` its chrome trace."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    @contextlib.contextmanager
    def ctx():
        with profile(activities=[ProfilerActivity.CPU] * host
                     + [ProfilerActivity.CUDA],
                     record_shapes=host,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            warm = torch.zeros(256, device=dev)
            for _ in range(cs.TRACE_WARM_LAUNCHES):
                warm.add_(1)
            torch.cuda.synchronize(dev)
            prof.step()
            time.sleep(cs.TRACE_PAD_S)
            yield
            torch.cuda.synchronize(dev)
            time.sleep(cs.TRACE_PAD_S)
        prof.export_chrome_trace(str(trace))
        box["prof"] = prof
    return ctx()


def _serve_full_timed(d, cs, mesh, name):
    """jamba-v0.1-52b whole in bf16 on ``mesh``: FULL_RUNS runs of
    ``serve_loop`` (FULL_BATCH x FULL_PROMPT, FULL_STEPS greedy decode
    steps, the config's capacity factor, MoE groups the 'data' axis's
    size as the reference's dry-run passes them), the first warming, then
    one more with its last decode step traced on rank 0."""
    import contextlib
    import statistics
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import _build
    rank, dev = dist.get_rank(), sh.device_of(mesh)
    cfg = get_config(FULL_ARCH)
    dp = mesh.shape[mesh.mesh_dim_names.index("data")]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = placed_init(cfg, mesh)
    torch.cuda.synchronize(dev)
    row = {"mesh": list(mesh.shape), "cards": dist.get_world_size(),
           "init_s": time.perf_counter() - t0,
           "init_peak_gib": _gib(torch.cuda.max_memory_allocated(dev)),
           "moe_groups": dp, "capacity_factor": cfg.capacity_factor}
    param_gib = _local_gib(params)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (FULL_BATCH, FULL_PROMPT)).astype(
            np.int32)).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    runs, aux, launches, box = [], None, [], {}
    trace = d / f"serve_full_{name}_decode_rank0.json"
    for run in range(FULL_RUNS + 1):
        last = run == FULL_RUNS

        def step_ctx(i, last=last):
            if last and rank == 0 and i == FULL_STEPS:
                return _traced(cs, dev, box, trace)
            return contextlib.nullcontext()
        _build.reset_launches()
        with (_MoeAux() if run == 0 else contextlib.nullcontext()) as log:
            r = serve_loop(cfg, params, prompt, FULL_STEPS,
                           FULL_PROMPT + FULL_STEPS, mesh, moe_groups=dp,
                           kv_dtype=torch.bfloat16, step_ctx=step_ctx)
        launches.append({k: v for k, v in _build.LAUNCHES.items() if v})
        if run == 0:
            aux = [{k: float(v) for k, v in c.items()} for c in log.calls]
        runs.append({"ms": r["ms"], "tokens": r["tokens"].tolist()})
        del r
    timed = runs[1:FULL_RUNS]
    pre = statistics.median(x["ms"][0] for x in timed)
    dec = statistics.median(m for x in timed for m in x["ms"][1:])
    peak = _gib(torch.cuda.max_memory_allocated(dev))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, {"rank": rank, "param_gib": param_gib,
                                   "peak_gib": peak,
                                   "launches": launches[1]})
    row.update({
        "prefill_ms": pre, "decode_ms": dec,
        "prefill_tokens_per_s": FULL_BATCH * FULL_PROMPT / pre * 1e3,
        "decode_tokens_per_s": FULL_BATCH / dec * 1e3,
        "tokens_per_s": FULL_BATCH * (FULL_PROMPT + FULL_STEPS) / (
            pre + FULL_STEPS * dec) * 1e3,
        "runs_ms": [x["ms"] for x in runs],
        "tokens_equal_over_runs": all(x["tokens"] == runs[0]["tokens"]
                                      for x in runs),
        "tokens": runs[0]["tokens"], "ranks": ranks,
        "max_param_gib": max(x["param_gib"] for x in ranks),
        "max_peak_gib": max(x["peak_gib"] for x in ranks),
        "prefill_moe": {
            "calls": len(aux),
            "dropped_frac": [a["dropped_frac"] for a in aux],
            "load_balance_loss": [a["load_balance_loss"] for a in aux]}})
    # the kernels each rank launched in one run: flash_attention once an
    # attention layer of the prefill, conv1d_tap three times (x, B, C) a
    # Mamba layer of the prefill; decode launches neither
    from repro_torch.configs.base import ATTN
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for mixer, _ in kinds if mixer == ATTN)
    row["planned_launches"] = {"flash_attention": n_attn,
                               "conv1d_tap": 3 * (len(kinds) - n_attn)}
    if rank == 0:
        prof = box.pop("prof")
        records = cs.device_records(prof)
        busy = cs.busy_ms(records)
        step_ms = runs[-1]["ms"][-1]
        row["traced_decode"] = {
            "step_ms": step_ms, "kernels": sum(
                1 for rec in records if cs.is_kernel(rec[0])),
            "busy_ms": busy, "busy_share": busy / step_ms,
            "idle_share": 1 - busy / step_ms,
            "idle_share_untraced": 1 - busy / dec,
            "ours": cs.traced_launches(prof), **nccl_records(trace)}
        del prof
    del params
    cs._clear(dev)
    return row


def _serve_full_period(cs, mesh):
    """One period (8 layers) of jamba in bf16: on rank 0's card alone,
    greedy, then on ``mesh`` teacher-forced with its tokens, and the same
    layers in fp32 on rank 0's card, fed the same tokens.  Gated by each
    bf16 run's worst distance from the fp32 one (FULL_PERIOD_FP32_RATIO);
    every step's worst difference between the two bf16 runs is recorded
    beside FULL_PERIOD_TOL x the unsharded max |logits|."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm
    rank, dev = dist.get_rank(), sh.device_of(mesh)
    base = get_config(FULL_ARCH)
    cfg = dataclasses.replace(base, num_layers=base.pattern_period)
    dp = mesh.shape[mesh.mesh_dim_names.index("data")]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (FULL_BATCH, FULL_PROMPT)).astype(
            np.int32)).to(dev)
    max_len = FULL_PROMPT + FULL_STEPS
    feed = torch.zeros((FULL_BATCH, FULL_STEPS + 1), dtype=torch.int64,
                       device=dev)
    plain = ref = None
    if rank == 0:
        params = lm.init_lm(cfg, seed=0, device=dev)
        plain = serve_loop(cfg, params, prompt, FULL_STEPS, max_len,
                           moe_groups=dp, kv_dtype=torch.bfloat16)
        feed.copy_(plain["tokens"])
        del params, plain["cache"]
        cs._clear(dev)
        # the same layers in fp32, fed the same tokens: how far bf16
        # alone moves the logits
        params = lm.init_lm(cfg, seed=0, device=dev, dtype=torch.float32)
        ref = serve_loop(cfg, params, prompt, FULL_STEPS, max_len,
                         moe_groups=dp, feed=feed[:, :FULL_STEPS])
        del params, ref["cache"]
        cs._clear(dev)
    dist.broadcast(feed, 0)
    params = placed_init(cfg, mesh)
    got = serve_loop(cfg, params, prompt, FULL_STEPS, max_len, mesh,
                     moe_groups=dp, kv_dtype=torch.bfloat16,
                     feed=feed[:, :FULL_STEPS])
    row = None
    if rank == 0:
        def errs(run, to):
            return [float((a.float() - b.float()).abs().max())
                    for a, b in zip(run["logits"], to["logits"])]
        scale = max(float(b.float().abs().max()) for b in plain["logits"])
        row = {"layers": cfg.num_layers, "max_abs_err": errs(got, plain),
               "bound": FULL_PERIOD_TOL * scale,
               "tokens_agree": float((got["tokens"] == feed).float().mean()),
               "bf16_vs_fp32": errs(plain, ref),
               "sharded_vs_fp32": errs(got, ref),
               "fp32_tokens_agree": float(
                   (ref["tokens"] == feed).float().mean())}
        row["fp32_ratio"] = (max(row["sharded_vs_fp32"])
                             / max(row["bf16_vs_fp32"]))
        row["fp32_ratio_bound"] = FULL_PERIOD_FP32_RATIO
        row["within_old_bound"] = max(row["max_abs_err"]) <= row["bound"]
        row["ok"] = row["fp32_ratio"] <= FULL_PERIOD_FP32_RATIO
    del params, got
    cs._clear(dev)
    return row


def _serve_full_cpu_check(cs, mesh):
    """jamba-v0.1-52b whole in fp32 on ``mesh`` at capacity factor 8:
    LM_CPU_BATCH x LM_CPU_PROMPT tokens and LM_CPU_STEPS teacher-forced
    decode steps through ``serve_loop``, against chip_smoke's
    ``layerwise_cpu_logits`` (the CPU one layer at a time, each layer
    brought whole with ``sharding.whole``, a collective every rank
    joins, so every rank computes the CPU side); the MoE routing of both
    sides by (MoE layer, step)."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.dist import sharding as sh
    dev = sh.device_of(mesh)
    cfg = dataclasses.replace(get_config(FULL_ARCH), capacity_factor=8.0)
    t0 = time.perf_counter()
    params = placed_init(cfg, mesh, dtype=torch.float32)
    init_s = time.perf_counter() - t0
    param_gib = _local_gib(params)
    n, B, S = cs.LM_CPU_STEPS + 1, cs.LM_CPU_BATCH, cs.LM_CPU_PROMPT
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n, B, S)).astype(np.int32))
    inputs = [{"tokens": toks[0]}] + [{"tokens": toks[t, :, :1]}
                                      for t in range(1, n)]
    max_len = S + cs.LM_CPU_STEPS
    routes = cs.RoutingLog(), cs.RoutingLog()

    def step(i):
        routes[0].step = i
        return contextlib.nullcontext()
    t0 = time.perf_counter()
    with routes[0]:
        card = serve_loop(cfg, params, toks[0].to(dev), cs.LM_CPU_STEPS,
                          max_len, mesh, feed=toks[1:, :, 0].T,
                          step_ctx=step)
    card_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    t0 = time.perf_counter()
    try:
        with routes[1]:
            want = cs.layerwise_cpu_logits(params, cfg, inputs, max_len,
                                           routes[1])
    finally:
        torch.set_num_threads(threads)
    cpu_s = time.perf_counter() - t0
    errs = []
    for a, b in zip(card["logits"], want):
        b = b[:, -1, :]
        errs.append({"max_abs_err": float((a.cpu() - b).abs().max()),
                     "bound": cs.LM_CPU_TOL * float(b.abs().max()),
                     "finite": bool(torch.isfinite(a).all())})
    try:
        routing = cs.compare_routing(FULL_ARCH, routes[0].calls,
                                     routes[1].calls)
        routing["ok"] = True
    except SystemExit:
        routing = {"ok": False}
    del params
    cs._clear(dev)
    return {"mesh": list(mesh.shape), "param_gib": param_gib,
            "init_s": init_s, "card_s": card_s, "cpu_s": cpu_s,
            "logits": errs, "routing": routing,
            "ok": routing["ok"] and all(
                e["max_abs_err"] <= e["bound"] and e["finite"]
                for e in errs)}


def case_serve_full(d: Path, mesh):
    """Under ``torchrun`` on four cards: jamba-v0.1-52b at full width and
    all 32 layers.  On (1, 4) and (2, 2): the timed bf16 run
    (``_serve_full_timed``) and the one-period check
    (``_serve_full_period``); on (1, 4), the fp32 whole-model check
    against the CPU (``_serve_full_cpu_check``).  Everything to
    ``serve_full.json`` on rank 0; fails after writing it where a check
    failed."""
    import subprocess as sp
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    cs = _chip_smoke()
    rank, dev = dist.get_rank(), sh.device_of(mesh)
    try:
        smi = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip().splitlines()
    except FileNotFoundError:            # gloo ranks on a host with no card
        smi = []
    out = {"card": smi[0].strip() if smi else None,
           "device": _device_name(dev), "torch": torch.__version__,
           "cards": dist.get_world_size()}
    bad = []

    def save():
        if rank == 0:
            (d / "serve_full.json").write_text(json.dumps(out, indent=1))
    for name, model in (("1x4", 4), ("2x2", 2)):
        m = make_debug_mesh(model=model)
        t0 = time.perf_counter()
        row = out[name] = _serve_full_timed(d, cs, m, name)
        got = [r["launches"] for r in row["ranks"]]
        if any(g != row["planned_launches"] for g in got):
            bad.append((name, "launches", got))
        save()
        row["period"] = _serve_full_period(cs, m)
        if rank == 0 and not row["period"]["ok"]:
            bad.append((name, "period"))
        if name == "1x4":
            row["cpu_check"] = _serve_full_cpu_check(cs, m)
            if not row["cpu_check"]["ok"]:
                bad.append((name, "cpu_check"))
        row["s"] = time.perf_counter() - t0
        save()
    out["bad"] = bad
    save()
    if bad:
        raise AssertionError(f"serve_full: {bad}")


def case_serve_period(d: Path, mesh):
    """``_serve_full_period`` alone on (1, 4) and (2, 2), to
    ``serve_period.json`` on rank 0; fails where a period is out of its
    bound."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    cs = _chip_smoke()
    out = {name: _serve_full_period(cs, make_debug_mesh(model=model))
           for name, model in (("1x4", 4), ("2x2", 2))}
    if dist.get_rank() == 0:
        (d / "serve_period.json").write_text(json.dumps(out, indent=1))
        bad = [name for name, row in out.items() if not row["ok"]]
        if bad:
            raise AssertionError(f"serve_period out of bound: {bad}")


def serve_counts(d: Path) -> None:
    """The collectives of jamba-v0.1-52b's decode step at the timed
    run's shapes (FULL_BATCH rows, a cache of FULL_PROMPT + FULL_STEPS,
    bf16) on (1, 4) and (2, 2), counted by ``launch/dryrun.py``'s
    ``CostCounter`` on meta over a ``fake`` group of four ranks, to
    ``serve_counts.json``."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    D.fake_world(4)
    shape = ShapeConfig("serve_full", FULL_PROMPT + FULL_STEPS, FULL_BATCH,
                        "decode")
    out = {"torch": torch.__version__}
    for name, model in SERVE_MESHES.items():
        t0 = time.perf_counter()
        *_, rec = D.lower_cell(FULL_ARCH, shape, False,
                               mesh=make_debug_mesh(model=model))
        out[name] = {"collectives": rec["collectives"],
                     "collective_bytes_per_device":
                         rec["collective_bytes_per_device"],
                     "flops_per_device": rec["flops_per_device"],
                     "bytes_accessed_per_device":
                         rec["bytes_accessed_per_device"],
                     "memory": rec["memory"], "s": time.perf_counter() - t0}
        print(name, json.dumps(out[name]), flush=True)
    (Path(d) / "serve_counts.json").write_text(json.dumps(out, indent=1))


# ---------------------------------------------------------------------------
# training across four cards

#: qwen3-14b at full size on four cards (case_train_full, train_cli): its
#: own config (grad_accum 8, full remat), bf16, 8 x 512 tokens a step
TRAIN_FULL_ARCH = "qwen3-14b"
TRAIN_FULL_BATCH, TRAIN_FULL_SEQ = 8, 512
#: train_full's layers (0: all 40), steps, the step after which it saves
#: (the step after it taken again on (1, 4) from the restored
#: checkpoint) and whether its last step is traced.  TRAIN_FULL_LAYERS=n
#: runs the same path shorter: n layers, two steps, the save after the
#: first, no trace (the checkpoint's size sets the run's length: a
#: full-size save takes minutes)
TRAIN_FULL_LAYERS = int(os.environ.get("TRAIN_FULL_LAYERS", 0))
TRAIN_FULL_STEPS, TRAIN_FULL_SAVE_AFTER, TRAIN_FULL_TRACE = (
    (2, 1, False) if TRAIN_FULL_LAYERS else (4, 3, True))
#: the launcher's run in train_cli: its steps, and the step boundary its
#: SIGTERM stops it at
TRAIN_CLI_STEPS, TRAIN_CLI_STOP_AT = 4, 2
#: a bf16 step's loss on (1, 4) from the restored checkpoint against the
#: same step on (2, 2), relative.  The meshes cut the row-parallel
#: products' partial sums differently, each rounded to bf16 before the
#: ranks add them, and the loss is an fp32 mean over 4,096 tokens of the
#: perturbed logits; a wrong batch moves it by the spread of such a mean
#: of cross entropies.  Read on four gloo ranks with the smoke qwen3-14b
#: at 8 x 512 tokens: the (1, 4) step 5.1e-5 and 9.6e-6 from (2, 2), a
#: wrong batch 1.9e-3 and 9.5e-3.  The bound sits between: ten times the
#: larger mesh reading, under a quarter of the smaller wrong batch's.
#: train_full records both readings on the cards beside it: the (1, 4)
#: loss of the right batch and of the next step's, forward only
TRAIN_MESH_TOL = 5e-4
#: the launcher's stopped and resumed steps against train_full's same
#: steps on the same (2, 2) mesh from the same seeds, relative: the same
#: state (a checkpoint is exact) and the same step on the same mesh
TRAIN_CLI_TOL = 1e-6
#: bf16 peak of one H100 (NVIDIA's data sheet, SXM, dense)
H100_BF16_FLOPS = 989e12
#: full-width 2-layer fp32 cuts, one step on (2, 2) against the same step
#: unsharded on rank 0's card (case_train_cuts): the MoE cut keeps all
#: its experts at capacity factor 8, as the MoE parity tests run
TRAIN_CUT_ARCHS = {"qwen3-14b": {}, "deepseek-moe-16b":
                   {"capacity_factor": 8.0}}
TRAIN_CUT_LAYERS = 2
#: loss and grad_norm, relative (the gloo tests' bound); each leaf's
#: update, relative L2, as tests/test_torch_sharding.py holds the sharded
#: step's updates: Adam's first step divides each gradient by its own
#: magnitude, so a leaf whose gradient is a sum that nearly cancels (the
#: qk-normed attention's wk) moves by the fp32 rounding of that sum over
#: the ranks' partial sums (4.4e-4 on four gloo ranks at smoke size, no
#: element changing sign).  The leaves over 1e-4 are recorded beside it.
TRAIN_CUT_TOL, TRAIN_CUT_UPDATE_TOL = 1e-5, 1e-2


def _smi():
    """``nvidia-smi``'s name and power limit of each card (none on a host
    without one)."""
    import subprocess as sp
    try:
        return [x.strip() for x in sp.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()]
    except FileNotFoundError:
        return []


def _machine(d: Path) -> dict:
    """The host's memory and the free disk under ``d``."""
    import shutil
    mem = Path("/proc/meminfo").read_text().split("\n")[0].split()
    du = shutil.disk_usage(d)
    return {"mem_total_gib": int(mem[1]) / 2 ** 20, "disk_total": du.total,
            "disk_free": du.free, "cpus": os.cpu_count()}


def _ckpt_root(d: Path) -> Path:
    """Where the full-size checkpoints go: ``d``, or, where a host's disk
    under ``d`` cannot hold them, a directory under ``TRAIN_CKPT_ROOT``
    named after ``d`` (so two runs that share the root write apart)."""
    import hashlib
    root = os.environ.get("TRAIN_CKPT_ROOT")
    if not root:
        return Path(d)
    tag = hashlib.sha256(str(Path(d).resolve()).encode()).hexdigest()[:12]
    return Path(root) / f"run-{tag}"


def _peak_rss_gib():
    """This process's peak resident set (``VmHWM``), GiB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmHWM:"):
            return int(line.split()[1]) / 2 ** 20
    return None


def _mem_row(tree, dev):
    """This rank's local state and peak allocated bytes, GiB (the peak
    since the last ``reset_peak_memory_stats``)."""
    import torch
    return {"local_gib": _local_gib(tree) if tree is not None else 0.0,
            "peak_gib": _gib(torch.cuda.max_memory_allocated(dev))}


def _stage(rows):
    """Every rank's ``_mem_row`` and the largest of each."""
    return {"ranks": rows,
            "max_local_gib": max(r["local_gib"] for r in rows),
            "max_peak_gib": max(r["peak_gib"] for r in rows)}


def trace_summary(cs, trace: Path) -> dict:
    """A chrome trace's device records (kernels, memcpys, memsets): their
    count, the kernels', and the busy ms (chip_smoke's ``busy_ms``, the
    union of their intervals), with ``nccl_records``; the file read once
    (``device_records`` would build an event object a record)."""
    events = json.loads(trace.read_text())["traceEvents"]
    recs = sorted(((e["cat"], e["ts"], e["ts"] + e.get("dur", 0.0))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda r: r[1])
    return {"records": len(recs),
            "kernels": sum(1 for r in recs if r[0] == "kernel"),
            "busy_ms": cs.busy_ms(recs), **nccl_records(trace, events)}


def collective_counter():
    """A dispatch mode recording each collective one rank runs as
    ``launch/dryrun.py``'s ``CostCounter`` does on meta ((kind, output
    bytes) in ``collectives``, read by ``dryrun.collective_bytes``), and
    nothing else: light enough to leave on for a whole train step on the
    card."""
    from repro_torch.launch import dryrun as D

    class CollectiveCounter(D.CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func._overloadpacket.__name__
            if name in D._COLLECTIVES and func.namespace in D._COLLECTIVE_NS:
                outs = D._tensors(out) or D._tensors(args[:1])
                self.collectives.append(
                    (D._COLLECTIVES[name], sum(D._nbytes(t) for t in outs)))
            return out
    return CollectiveCounter()


def state_hashes(state) -> dict:
    """Each checkpoint key's manifest hash of a (sharded) state, its
    leaves gathered whole one at a time (every rank joins); key ``j``
    copied to the host on rank ``j % world`` and hashed there in a
    thread while the ranks gather the next keys (a rank holds one key on
    its host at once).  Every rank gets every key's hash."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.train import checkpoint as ckpt
    rank, world = dist.get_rank(), dist.get_world_size()

    def digest(rows):
        h = hashlib.sha256()
        for r in rows:
            ckpt._update(h, r)
        return h.hexdigest()[:16]

    mine, pending = {}, None
    with ThreadPoolExecutor(1) as pool:
        for j, (k, (ls, _)) in enumerate(ckpt._keys(state).items()):
            own = j % world == rank
            if own and pending is not None:
                mine[pending[0]] = pending[1].result()
                pending = None
            rows = []
            for leaf in ls:
                t = sh.whole(leaf.detach())
                if own:
                    rows.append(ckpt._to_host(t)[0])
                del t
            if own:
                pending = (k, pool.submit(digest, rows))
            del rows
        if pending is not None:
            mine[pending[0]] = pending[1].result()
    out = {}
    for part in per_rank(mine):
        out.update(part)
    return out


def forward_loss(t, batch) -> float:
    """The step's loss of ``batch`` on trainer ``t``'s state, forward
    only: the mean of its micro-batches' losses, as the step takes it."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import steps as St
    from repro_torch.models import lm
    act = sh.named(t.mesh, sh.P(t.rules["batch"], None, None))
    accum = t.cfg.grad_accum
    micros = St._split_batch(batch, accum) if accum > 1 else [batch]
    with torch.no_grad():
        total = sum(sh.whole(lm.train_loss(t.state["params"], t.cfg, m,
                                           act_spec=act)[0]) for m in micros)
    return float(total / len(micros))


def case_train_full(d: Path, mesh):
    """Under ``torchrun`` on four cards: qwen3-14b at full size in bf16
    through ``Trainer(mesh=...)`` on (2, 2) from its placed init,
    TRAIN_FULL_STEPS steps of 8 x 512 tokens timed, a sync checkpoint
    after step TRAIN_FULL_SAVE_AFTER, the last step traced on rank 0;
    then the state freed, the checkpoint restored onto (1, 4), every
    leaf's hash checked against the manifest and the step after the
    checkpoint taken again there, beside the forward-only loss of that
    step's batch and of the next step's.  Each rank's local state and
    peak GiB at every stage; everything to ``train_full.json`` on rank
    0, written as it goes; fails after writing it where a check failed.
    TRAIN_FULL_LAYERS may cut the layers and the steps."""
    import contextlib
    import dataclasses
    import gc
    import math
    import shutil
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainConfig
    from repro_torch.tree import leaves
    cs = _chip_smoke()
    rank, world, dev = dist.get_rank(), dist.get_world_size(), \
        sh.device_of(mesh)
    cfg = get_config(TRAIN_FULL_ARCH)
    if TRAIN_FULL_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_FULL_LAYERS)
    B, S = TRAIN_FULL_BATCH, TRAIN_FULL_SEQ
    ckdir = _ckpt_root(d) / "train_full_ckpt"
    if rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
        ckdir.parent.mkdir(parents=True, exist_ok=True)
    dist.barrier()
    smi = _smi()
    # every stage's peak stays under the card's memory
    card_bytes = (torch.cuda.get_device_properties(dev).total_memory
                  if dev.type == "cuda" else math.inf)
    out = {"card": smi[0] if smi else None, "device": _device_name(dev),
           "torch": torch.__version__, "cards": world,
           "card_gib": _gib(card_bytes),
           "arch": TRAIN_FULL_ARCH, "layers": cfg.num_layers,
           "full_layers": get_config(TRAIN_FULL_ARCH).num_layers,
           "batch": [B, S], "steps": TRAIN_FULL_STEPS,
           "save_after": TRAIN_FULL_SAVE_AFTER,
           "grad_accum": cfg.grad_accum, "remat": cfg.remat,
           "ckpt_dir": str(ckdir), "machine": _machine(ckdir.parent)}
    bad = []

    def save():
        if rank == 0:
            (d / "train_full.json").write_text(json.dumps(out, indent=1))

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier()

    def clear():
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def stage(name, tree, **extra):
        row = _stage(per_rank(_mem_row(tree, dev)))
        row.update(extra)
        out[name] = row
        if row["max_peak_gib"] * 2 ** 30 >= card_bytes:
            bad.append((name, "peak"))
        save()
        print(f"[train_full] {name}: {json.dumps(extra)} local "
              f"{row['max_local_gib']:.2f} GiB, peak "
              f"{row['max_peak_gib']:.2f} GiB", flush=True)
        return row

    data = SyntheticLMData(cfg.vocab_size, B, S)
    tcfg = TrainConfig(ckpt_dir=str(ckdir), ckpt_async=False)
    m22 = mesh
    assert tuple(m22.shape) == (2, 2), m22
    t = Trainer(cfg, tcfg, data, mesh=m22)
    clear()
    t0 = time.perf_counter()
    t.state = t.init_state()
    sync()
    n_params = sum(x.numel() for x in leaves(t.state["params"]))
    stage("init", t.state, s=time.perf_counter() - t0, params=n_params,
          state_gib=_gib(sum(_nbytes(x) for x in leaves(t.state))))

    # the steps, a sync checkpoint after TRAIN_FULL_SAVE_AFTER, the last
    # step traced on rank 0 (the card's records; the collectives by a
    # dispatch mode, as the dry-run counts them on meta: a host trace of
    # a step this long is GBs)
    from repro_torch.launch import dryrun as D
    ms, losses, norms, peaks = [], [], [], []
    box, trace = {}, d / "train_full_step_rank0.json"
    counter = collective_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(TRAIN_FULL_STEPS):
        traced = TRAIN_FULL_TRACE and rank == 0 and i + 1 == TRAIN_FULL_STEPS
        batch = t.batch_at(i)
        sync()
        t0 = time.perf_counter()
        with (_traced(cs, dev, box, trace, host=False) if traced
              else contextlib.nullcontext()), \
                (counter if traced else contextlib.nullcontext()):
            t.state, m = t.step_fn(t.state, batch)
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        del batch, m
        print(f"[train_full] step {i + 1}: {ms[-1]:.1f} ms, loss "
              f"{losses[-1]:.6f}", flush=True)
        if i + 1 == TRAIN_FULL_SAVE_AFTER:
            peaks.append(_mem_row(t.state, dev))
            if rank == 0:
                out["machine_before_save"] = _machine(ckdir.parent)
            clear()
            sync()
            t0 = time.perf_counter()
            path = ckpt.save_checkpoint(ckdir, i + 1, t.state)
            save_s = time.perf_counter() - t0
            disk = (sum(f.stat().st_size for f in path.iterdir())
                    if rank == 0 else None)
            stage("save", t.state, s=save_s, step=i + 1, bytes_on_disk=disk,
                  rank0_peak_rss_gib=_peak_rss_gib() if rank == 0 else None)
            torch.cuda.reset_peak_memory_stats(dev)
    peaks.append(_mem_row(t.state, dev))
    steps = _stage(per_rank({"local_gib": peaks[-1]["local_gib"],
                             "peak_gib": max(p["peak_gib"] for p in peaks)}))
    med = statistics.median(ms[1:] or ms)
    untraced = ms[1:-1] if TRAIN_FULL_TRACE else ms[1:]
    tokens = B * S
    steps.update({
        "step_ms": ms, "step_ms_median": med,
        "step_ms_median_untraced": statistics.median(untraced or ms),
        "losses": losses, "grad_norms": norms,
        "tokens_per_s": tokens / med * 1e3,
        "flops_6nt": 6 * n_params * tokens,
        "mfu_at_bf16_peak": 6 * n_params * tokens / (med / 1e3)
        / (world * H100_BF16_FLOPS)})
    out["steps"] = steps
    if steps["max_peak_gib"] * 2 ** 30 >= card_bytes:
        bad.append(("steps", "peak"))
    first = losses[0] / math.log(cfg.vocab_size)
    steps["first_loss_over_ln_vocab"] = first
    if not (all(math.isfinite(x) for x in losses) and 0.5 <= first <= 1.5):
        bad.append(("steps", "losses", losses))
    if TRAIN_FULL_TRACE and rank == 0:
        box.clear()
        summary = trace_summary(cs, trace)
        summary.update({
            "step": TRAIN_FULL_STEPS, "ms": ms[-1], "mesh": list(m22.shape),
            "collectives": D.collective_bytes(counter),
            "idle_share": 1 - summary["busy_ms"] / ms[-1],
            "idle_share_untraced": 1 - summary["busy_ms"]
            / steps["step_ms_median_untraced"],
            "trace_bytes": trace.stat().st_size})
        out["traced"] = summary
        trace.unlink()
    save()

    # free the state; the checkpoint onto (1, 4)
    t.state = None
    del t
    clear()
    m14 = make_debug_mesh(model=4)
    t = Trainer(cfg, tcfg, data, mesh=m14)
    like = t.init_state(device="meta")
    sync()
    t0 = time.perf_counter()
    t.state = ckpt.restore_checkpoint(ckdir, TRAIN_FULL_SAVE_AFTER, like,
                                      shardings=t.shardings)
    sync()
    largest = _gib(max(_nbytes(x) for x in leaves(like)))
    row = stage("restore", t.state, s=time.perf_counter() - t0,
                onto=list(m14.shape), largest_leaf_gib=largest)
    # the streamed restore's own bound: the shards plus one leaf whole
    row["within_local_plus_largest_leaf"] = all(
        r["peak_gib"] <= r["local_gib"] + largest for r in row["ranks"])
    t0 = time.perf_counter()
    got = state_hashes(t.state)
    manifest = json.loads((ckdir / f"step_{TRAIN_FULL_SAVE_AFTER}"
                           / "manifest.json").read_text())["arrays"]
    off = sorted(k for k, v in manifest.items() if got.get(k) != v["hash"])
    out["restore"].update({"hash_s": time.perf_counter() - t0,
                           "keys": len(manifest), "hashes_off": off})
    if off or set(got) != set(manifest):
        bad.append(("restore", "hashes", off[:5]))
    torch.cuda.reset_peak_memory_stats(dev)
    want = losses[TRAIN_FULL_SAVE_AFTER]
    # the readings the bound stands between: the right batch's loss on
    # (1, 4), and a wrong batch's (the next step's), forward only
    after = TRAIN_FULL_SAVE_AFTER
    fwd = {"right": forward_loss(t, t.batch_at(after)),
           "wrong": forward_loss(t, t.batch_at(after + 1))}
    fwd_rel = {k: abs(v - want) / abs(want) for k, v in fwd.items()}
    batch = t.batch_at(after)
    sync()
    t0 = time.perf_counter()
    t.state, m = t.step_fn(t.state, batch)
    torch.cuda.synchronize(dev)
    again = float(m["loss"])
    rel = abs(again - want) / abs(want)
    stage("step_on_1x4", t.state, ms=(time.perf_counter() - t0) * 1e3,
          step=after + 1, loss=again, loss_2x2=want, rel=rel,
          grad_norm=float(m["grad_norm"]), grad_norm_2x2=norms[after],
          forward_losses=fwd, forward_rel=fwd_rel, bound=TRAIN_MESH_TOL)
    if not rel <= TRAIN_MESH_TOL:
        bad.append(("step_on_1x4", rel))
    del batch, m
    t.state = None
    clear()
    if rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
        if ckdir.parent != d:
            shutil.rmtree(ckdir.parent, ignore_errors=True)
    out["bad"] = bad
    save()
    if bad:
        raise AssertionError(f"train_full: {bad}")


def case_train_cuts(d: Path, mesh):
    """Under ``torchrun`` on four cards: per arch of TRAIN_CUT_ARCHS, the
    2-layer cut at full width in fp32 (its own grad_accum, 8 x 512
    tokens): one step on rank 0's card alone, then the same step on
    (2, 2); loss, grad_norm and each leaf's update against TRAIN_CUT_TOL
    and TRAIN_CUT_UPDATE_TOL (with the share of elements whose update
    changed sign: Adam's first step is about sign(g) a element), to
    ``train_cuts.json``.  Fails after writing it where a bound broke."""
    import dataclasses
    import gc
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist import sharding as sh
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import Trainer, TrainConfig
    from repro_torch.tree import key, leaves, walk
    rank, dev = dist.get_rank(), sh.device_of(mesh)
    m22 = mesh
    smi = _smi()
    out = {"card": smi[0] if smi else None, "device": _device_name(dev),
           "torch": torch.__version__, "cards": dist.get_world_size(),
           "mesh": list(m22.shape), "archs": {}}
    bad = []

    def fp32_state(t):
        st = t.init_state()
        st["opt"] = None                       # before the fp32 one
        st["params"] = _fp32(st["params"])
        st["opt"] = adamw_init(st["params"])
        return st

    def clear():
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    for arch, kw in TRAIN_CUT_ARCHS.items():
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=TRAIN_CUT_LAYERS, **kw)
        data = SyntheticLMData(cfg.vocab_size, TRAIN_FULL_BATCH,
                               TRAIN_FULL_SEQ)
        tcfg = TrainConfig(ckpt_dir=str(d / "unused"))
        row = {"grad_accum": cfg.grad_accum,
               "capacity_factor": cfg.capacity_factor}
        one = None
        t0 = time.perf_counter()
        if rank == 0:
            t = Trainer(cfg, tcfg, data, device=dev)
            st = fp32_state(t)
            row["state_gib"] = _gib(sum(_nbytes(x) for x in leaves(st)))
            p0 = [x.clone() for x in leaves(st["params"])]
            st, m = t.step_fn(st, t.batch_at(0))
            one = (float(m["loss"]), float(m["grad_norm"]),
                   [(x - y).cpu() for x, y in zip(leaves(st["params"]), p0)])
            del t, st, m, p0
            clear()
        row["one_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        t = Trainer(cfg, tcfg, data, mesh=m22)
        st = fp32_state(t)
        p0 = [sh.local_shard(x).clone() for x in leaves(st["params"])]
        st, m = t.step_fn(st, t.batch_at(0))
        row["mesh_s"] = time.perf_counter() - t0
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        upd, flips, n = [], 0, 0
        names = [key(path) + ("" if r is None else f"[{r}]")
                 for path, r, _ in walk(st["params"])]
        for i, (x, y) in enumerate(zip(leaves(st["params"]), p0)):
            u = DTensor.from_local(sh.local_shard(x) - y, x.device_mesh,
                                   x.placements, run_check=False,
                                   shape=x.shape, stride=x.stride())
            u = u.full_tensor()
            if rank == 0:
                w = one[2][i].to(dev)
                upd.append(float((u - w).norm()
                                 / w.norm().clamp_min(1e-30)))
                flips += int(((u > 0) != (w > 0)).sum())
                n += w.numel()
            del u
        if rank == 0:
            row.update({
                "loss": [loss, one[0]], "grad_norm": [norm, one[1]],
                "rel_loss": abs(loss - one[0]) / abs(one[0]),
                "rel_grad_norm": abs(norm - one[1]) / abs(one[1]),
                "max_rel_update_l2": max(upd), "leaves": len(upd),
                "update_sign_flips": flips, "elements": n,
                "leaves_over_1e-4": {names[i]: x for i, x in enumerate(upd)
                                     if x > 1e-4}})
            if not (row["rel_loss"] <= TRAIN_CUT_TOL
                    and row["rel_grad_norm"] <= TRAIN_CUT_TOL
                    and row["max_rel_update_l2"] <= TRAIN_CUT_UPDATE_TOL):
                bad.append(arch)
            print(f"[train_cuts] {arch}: {json.dumps(row)}", flush=True)
        row["peak_gib"] = max(r["peak_gib"] for r in per_rank(
            _mem_row(None, dev)))
        out["archs"][arch] = row
        del t, st, m, p0, one
        clear()
        torch.cuda.reset_peak_memory_stats(dev)
        if rank == 0:
            (d / "train_cuts.json").write_text(json.dumps(out, indent=1))
    out["bad"] = bad
    if rank == 0:
        (d / "train_cuts.json").write_text(json.dumps(out, indent=1))
        if bad:
            raise AssertionError(f"train_cuts out of bound: {bad}")


def train_counts(d: Path) -> None:
    """The collectives, FLOPs, bytes and memory of train_full's step
    (qwen3-14b, its own config, 8 x 512 tokens) on (2, 2) and (1, 4),
    counted by ``launch/dryrun.py``'s ``CostCounter`` on meta over a
    ``fake`` group of four ranks: the 1- and 2-layer stacks at the
    config's grad_accum, extrapolated to its 40 layers (every layer's
    work is the same), and the full depth's arguments placed, to
    ``train_counts.json``."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    D.fake_world(4)
    cfg = get_config(TRAIN_FULL_ARCH)
    shape = ShapeConfig("train_full", TRAIN_FULL_SEQ, TRAIN_FULL_BATCH,
                        "train")
    out = {"torch": torch.__version__, "arch": TRAIN_FULL_ARCH,
           "layers": cfg.num_layers, "grad_accum": cfg.grad_accum}
    n = cfg.num_layers
    for name, model in SERVE_MESHES.items():
        t0 = time.perf_counter()
        mesh = make_debug_mesh(model=model)
        c1, c2 = (D.lower_cell(TRAIN_FULL_ARCH, shape, False, mesh=mesh,
                               cfg=dataclasses.replace(cfg, num_layers=k))[3]
                  for k in (1, 2))
        ext = lambda a, b: a + (n - 1) * (b - a)
        kinds = set(c1["collectives"]) | set(c2["collectives"])
        colls = {k: {f: ext(c1["collectives"].get(k, {}).get(f, 0),
                            c2["collectives"].get(k, {}).get(f, 0))
                     for f in ("count", "bytes")} for k in sorted(kinds)}
        arg = D.local_bytes(D.cell_arguments(cfg, shape, mesh)[1])
        out[name] = {
            "collectives": colls,
            "collective_bytes_per_device": sum(v["bytes"]
                                               for v in colls.values()),
            "flops_per_device": ext(c1["flops_per_device"],
                                    c2["flops_per_device"]),
            "bytes_accessed_per_device": ext(
                c1["bytes_accessed_per_device"],
                c2["bytes_accessed_per_device"]),
            "argument_bytes": arg,
            "temp_bytes": ext(c1["memory"]["temp_bytes"],
                              c2["memory"]["temp_bytes"]),
            "probes": {"1": c1, "2": c2}, "s": time.perf_counter() - t0}
        out[name]["peak_bytes"] = arg + out[name]["temp_bytes"]
        print(name, json.dumps({k: v for k, v in out[name].items()
                                if k != "probes"}), flush=True)
        (Path(d) / "train_counts.json").write_text(json.dumps(out, indent=1))


def _workers(pid: int, module: str) -> list:
    """PIDs of the processes under ``pid`` that run ``-m module`` (the
    ranks ``torchrun`` started, not ``torchrun`` itself)."""
    parents = {}
    for p in Path("/proc").iterdir():
        if not p.name.isdigit():
            continue
        try:
            stat = (p / "stat").read_text()
            cmd = (p / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        parents[int(p.name)] = (int(stat.rsplit(")", 1)[1].split()[1]),
                                [c.decode() for c in cmd])
    out = []
    for q, (ppid, cmd) in parents.items():
        up = ppid
        while up and up != pid and up in parents:
            up = parents[up][0]
        if (up == pid and module in cmd
                and "torch.distributed.run" not in cmd):
            out.append(q)
    return out


def _launch(cmd, env, stop_after=None, timeout=1800):
    """Run ``cmd`` (torchrun and its ranks, a session of their own),
    echoing its output; once every rank has printed a line holding
    ``stop_after``, and TRAIN_CLI_STOP_DELAY later (so that every rank is
    inside the next step), SIGTERM to the ranks (not to ``torchrun``,
    which would kill them before a long checkpoint is written).  Returns
    (exit code, seconds, lines, the ranks signalled)."""
    import signal
    import subprocess as sp
    import threading
    t0 = time.perf_counter()
    p = sp.Popen(cmd, env=env, stdout=sp.PIPE, stderr=sp.STDOUT, text=True,
                 start_new_session=True)
    timer = threading.Timer(timeout, os.killpg, (p.pid, signal.SIGKILL))
    timer.start()
    lines, signalled = [], []
    try:
        for line in p.stdout:
            print(line, end="", flush=True)
            lines.append(line.rstrip("\n"))
            # the ranks share the pipe: their lines may run together
            seen = stop_after and sum(x.count(stop_after) for x in lines)
            if not signalled and seen == TRAIN_CLI_RANKS:
                signalled = _workers(p.pid, "repro_torch.launch.train")
                time.sleep(TRAIN_CLI_STOP_DELAY)
                for q in signalled:
                    os.kill(q, signal.SIGTERM)
        rc = p.wait()
    finally:
        timer.cancel()
    return rc, time.perf_counter() - t0, lines, signalled


#: the launcher's ranks, and how long after the last rank's line of the
#: first step the harness waits before signalling them (a full-size step
#: takes tens of seconds; a CPU rehearsal sets its own)
TRAIN_CLI_RANKS = 4
TRAIN_CLI_STOP_DELAY = float(os.environ.get("TRAIN_CLI_STOP_DELAY", 5.0))


def _steps(lines) -> dict:
    """{step: [loss of each rank's ``[trainer] step N loss X`` line]}."""
    import re
    out = {}
    for k, v in re.findall(r"\[trainer\] step (\d+) loss ([-\d.]+)",
                           "\n".join(lines)):
        out.setdefault(int(k), []).append(float(v))
    return out


def _done(lines) -> list:
    """Each rank's ``[train] done: {...}`` metrics (the last step's, its
    loss in full)."""
    import ast
    import re
    return [ast.literal_eval(m) for m in re.findall(
        r"\[train\] done: (\{[^}]*\})", "\n".join(lines))]


def train_cli(d: Path) -> None:
    """On four cards, no process group of its own: ``python -m
    torch.distributed.run --standalone --nproc-per-node 4 -m
    repro_torch.launch.train --arch qwen3-14b --mesh debug`` (8 x 512,
    TRAIN_CLI_STEPS steps), SIGTERM to its four ranks while the second
    step runs (after the first step's line, the one the launcher's
    default logs): every rank stops at the TRAIN_CLI_STOP_AT boundary
    with one checkpoint there and exits 0; the same command again
    resumes from there and runs to the end, its last checkpoint written
    sync.  Each run's last loss (its ``[train] done`` line) within
    TRAIN_CLI_TOL of ``train_full.json``'s same step on the same (2, 2)
    mesh, where that file is there from a run at full depth.  To
    ``train_cli.json``; fails after writing it where a check failed.
    With ``TRAIN_CKPT_ROOT`` set (a RAM disk that holds one full-size
    checkpoint, beside a disk under ``d`` that holds one more), the
    stopped run writes through a link to it, and the relaunch finds that
    checkpoint by a link from ``d`` and writes its own on ``d``'s disk."""
    import math
    import shutil
    import sys
    from repro_torch.train import checkpoint as ckpt
    d = Path(d)
    ckdir, spill = d / "train_cli_ckpt", _ckpt_root(d) / "train_cli_ckpt"
    for p in (ckdir, spill):
        if p.is_symlink():
            p.unlink()
        shutil.rmtree(p, ignore_errors=True)
    if spill != ckdir:
        spill.mkdir(parents=True)
        ckdir.symlink_to(spill)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(TRAIN_CLI_RANKS),
           "-m", "repro_torch.launch.train",
           "--arch", TRAIN_FULL_ARCH, "--mesh", "debug",
           "--batch", str(TRAIN_FULL_BATCH), "--seq", str(TRAIN_FULL_SEQ),
           "--steps", str(TRAIN_CLI_STEPS), "--ckpt-every", "1000",
           "--ckpt-dir", str(ckdir)]
    # a rehearsal's own arguments, which override the ones above (e.g.
    # "--smoke --device cpu --seq 16")
    cmd += os.environ.get("TRAIN_CLI_ARGS", "").split()
    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
    smi = _smi()
    out = {"card": smi[0] if smi else None, "cmd": cmd[1:],
           "machine": _machine(d), "spill": str(spill),
           "bound": TRAIN_CLI_TOL}
    bad = []

    def save():
        (d / "train_cli.json").write_text(json.dumps(out, indent=1))
    count = lambda lines, text: sum(x.count(text) for x in lines)
    last = TRAIN_CLI_STOP_AT - 1
    rc, s, lines, sig = _launch(cmd, env, stop_after="[trainer] step 0 ")
    done = _done(lines)
    out["stopped"] = {
        "rc": rc, "s": s, "signalled": len(sig),
        "step_lines": {k: len(v) for k, v in _steps(lines).items()},
        "done": done, "checkpoints": ckpt.latest_steps(ckdir)}
    save()
    st = out["stopped"]
    if not (rc == 0 and len(sig) == TRAIN_CLI_RANKS
            and st["checkpoints"] == [TRAIN_CLI_STOP_AT]
            and len(done) == TRAIN_CLI_RANKS
            and all(x["step"] == last for x in done)):
        bad.append("stopped")
    if spill != ckdir:             # the relaunch writes under d, and finds
        ckdir.unlink()             # the stopped run's checkpoint by a link
        ckdir.mkdir()
        for p in spill.iterdir():
            (ckdir / p.name).symlink_to(p)
    rc, s, lines, _ = _launch(cmd, env)
    again = _done(lines)
    out["resumed"] = {
        "rc": rc, "s": s, "done": again,
        "resumed_lines": count(lines,
                               f"resumed from step {TRAIN_CLI_STOP_AT}"),
        "checkpoints": ckpt.latest_steps(ckdir)}
    if not (rc == 0 and out["resumed"]["resumed_lines"] == TRAIN_CLI_RANKS
            and len(again) == TRAIN_CLI_RANKS
            and all(x["step"] == TRAIN_CLI_STEPS - 1
                    and math.isfinite(x["loss"]) for x in again)
            and out["resumed"]["checkpoints"] == [TRAIN_CLI_STOP_AT,
                                                  TRAIN_CLI_STEPS]):
        bad.append("resumed")
    full = d / "train_full.json"
    ref = json.loads(full.read_text()) if full.exists() else {}
    want = ref.get("steps", {}).get("losses", [])
    if (ref.get("layers") == ref.get("full_layers")
            and len(want) >= TRAIN_CLI_STEPS):
        rel = {str(x["step"]): abs(x["loss"] - want[x["step"]])
               / abs(want[x["step"]]) for x in done + again}
        out["train_full_losses"], out["rel"] = want, rel
        if not all(r <= TRAIN_CLI_TOL for r in rel.values()):
            bad.append("losses against train_full")
    shutil.rmtree(ckdir, ignore_errors=True)
    shutil.rmtree(spill, ignore_errors=True)
    if spill.parent != d:
        shutil.rmtree(spill.parent, ignore_errors=True)
    out["bad"] = bad
    save()
    if bad:
        raise AssertionError(f"train_cli: {bad}")


def main(case, d, rank=None, world=None):
    """``rank``/``world`` given: a gloo rank on a FileStore in ``d``;
    else a ``torchrun`` rank on its card (NCCL)."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    d = Path(d)
    if case in ("serve_counts", "train_counts", "train_cli"):
        return {"serve_counts": serve_counts, "train_counts": train_counts,
                "train_cli": train_cli}[case](d)
    if rank is None:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        # the whole-model check holds every rank at a collective while
        # each runs its CPU side, minutes at a time
        dist.init_process_group("nccl", timeout=datetime.timedelta(
            minutes=60))
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{d}/store-{case}", rank=int(rank),
            world_size=int(world))
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh()
        if case == "steps":
            case_steps(d, mesh)
            case_grads(d, mesh)
        else:
            {"ckpt": case_ckpt, "trainer": case_trainer,
             "repairs": case_repairs, "pin": case_pin,
             "serve_one": case_serve_one, "cards": case_cards,
             "full": case_full, "serve_cards": case_serve_cards,
             "serve_full": case_serve_full,
             "serve_period": case_serve_period,
             "train_full": case_train_full,
             "train_cuts": case_train_cuts}[case](d, mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
