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

(``full`` in place of ``cards``: qwen2-1.5b at full size on the mesh.)
"""
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
    """compressed_psum over a 1-D mesh of the world; the elastic restore
    of a (2, 2) checkpoint onto (4, 1) and onto no mesh; a checkpoint
    the JAX package wrote, restored onto the mesh."""
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

    # elastic: a (2, 2) trainer's checkpoint onto (4, 1) and no mesh
    cfg = _cfg("qwen2-1.5b", grad_accum=1)
    data = SyntheticLMData(cfg.vocab_size, 4, 16)
    tcfg = TrainConfig(steps=1, ckpt_every=1, ckpt_dir=str(d / "elastic"),
                       ckpt_async=False, log_every=100)
    t = Trainer(cfg, tcfg, data, mesh=mesh)
    t.run()
    saved = [x.full_tensor() for x in leaves(t.state)]
    like = t.init_state(device="meta")
    tall = make_debug_mesh(model=1)
    assert tuple(tall.shape) == (world, 1)
    t2 = Trainer(cfg, tcfg, data, mesh=tall)
    onto = ckpt.restore_checkpoint(d / "elastic", 1, like,
                                   shardings=t2.shardings)
    plain = ckpt.restore_checkpoint(d / "elastic", 1, like, device="cpu")
    for a, b, c in zip(saved, leaves(onto), leaves(plain), strict=True):
        assert b.device_mesh is tall
        assert torch.equal(a, b.full_tensor()) and torch.equal(a, c)
        assert a.dtype == b.dtype == c.dtype

    # a JAX package's checkpoint onto the mesh
    jlike = Trainer(cfg, TrainConfig(ckpt_dir=str(d / "jax")), data,
                    mesh=mesh)
    jstate = ckpt.restore_checkpoint(d / "jax", 2, like,
                                     shardings=jlike.shardings)
    jplain = ckpt.restore_checkpoint(d / "jax", 2, like, device="cpu")
    _check_local_shards(jstate)
    for b, c in zip(leaves(jstate), leaves(jplain), strict=True):
        assert torch.equal(b.full_tensor(), c)
    if rank == 0:
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
    (``small.json``), a stop, and grad compression."""
    import torch
    from repro_torch.train.trainer import TrainConfig
    cfg, data, make = trainer_setup()
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
#: parity's dense, MoE (GQA and MLA) and SSM smoke variants
HEAD_ARCHS = {"qwen2-1.5b": {}, "qwen2-1.5b-h6": {"num_heads": 6}}
SERVE_ARCHS = ["qwen2-1.5b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
               "mamba2-1.3b"]


def _metrics(step, state, batch):
    _, m = step(state, batch)
    return {k: float(v) for k, v in m.items()}


def case_repairs(d: Path, mesh):
    """The sharded step's repairs, each against the unsharded function:
    a train step on a (1, 4) mesh whose 'model' axis does not divide the
    heads; ``shard_local`` with a first argument placed (Shard(0),
    Shard(0)) and a second (Shard(0), Replicate()); prefill and one
    decode step on the (2, 2) mesh.  Results to ``repairs.json``."""
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

    # prefill, then one decode step, on (2, 2) against unsharded
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch, capacity_factor=8.0)
        B, S, Lmax = 4, 16, 32
        params = lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
        rng = np.random.default_rng(4)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1),
                                             dtype=np.int64).astype(np.int32))
        runs = []
        for m in (None, mesh):
            cache = lm.init_cache(cfg, B, Lmax, kv_dtype=torch.float32,
                                  device="cpu")
            p, act = params, None
            pre, dec = {"tokens": toks[:, :S]}, {"tokens": toks[:, S:]}
            if m is not None:
                rp = sh.make_rules("prefill")
                p = sh.place_tree(params, sh.named(m, sh.param_specs(params,
                                                                     rp)))
                cache = sh.place_tree(cache, sh.named(m, sh.cache_specs(
                    cache, cfg, rp)))
                act = sh.named(m, sh.P(rp["batch"], None, None))
                pre, dec = ({k: sh.place(v, sh.named(m, sh.P(
                    rp["batch"], None))) for k, v in t.items()}
                    for t in (pre, dec))
            lp, cache = St.make_prefill_step(cfg, Lmax, act_spec=act)(
                p, pre, cache)
            ld, cache = St.make_decode_step(cfg, act_spec=act)(
                p, dec, cache, S)
            runs.append([sh.whole(t).detach() for t in
                         [lp, ld] + leaves_of(cache)])
        (plain, sharded) = runs
        out["serve"][arch] = {
            "prefill_logits": float((sharded[0] - plain[0]).abs().max()),
            "decode_logits": float((sharded[1] - plain[1]).abs().max()),
            "cache": max(float((x - y).abs().max())
                         for x, y in zip(sharded[2:], plain[2:])),
            "cache_leaves": len(plain) - 2}
    if torch.distributed.get_rank() == 0:
        (d / "repairs.json").write_text(json.dumps(out))


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


def main(case, d, rank=None, world=None):
    """``rank``/``world`` given: a gloo rank on a FileStore in ``d``;
    else a ``torchrun`` rank on its card (NCCL)."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    d = Path(d)
    if rank is None:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl")
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
             "repairs": case_repairs,
             "cards": case_cards, "full": case_full}[case](d, mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
