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
``serve_period``: its one-period bf16 check alone.)  The
collectives of these serving steps, counted on meta over a ``fake``
group of four ranks (no card, no group needed):

    PYTHONPATH=src python tests/_torch_mesh_worker.py serve_counts <dir>
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


def _own(t):
    """A placed DTensor whose local shard owns its storage: a dim-0 shard
    is a view of the whole tensor it was cut from, which would otherwise
    stay alive beside it."""
    from torch.distributed.tensor import DTensor
    loc = t.to_local()
    if loc.untyped_storage().nbytes() == loc.numel() * loc.element_size():
        return t
    return DTensor.from_local(loc.clone(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def placed_init(cfg, mesh, dtype=None, mode="prefill"):
    """``lm.init_lm(cfg, seed=0)``'s params on ``mesh``, placed by
    ``param_specs`` under ``make_rules(mode)`` one piece at a time as
    they are drawn on this rank's device: each rank keeps its shards
    only, and no device holds more than the model's largest layer
    beside them."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.models import lm
    from repro_torch.tree import map_tree
    specs = sh.named(mesh, sh.param_specs(lm.init_lm(cfg, device="meta"),
                                          sh.make_rules(mode)))

    def place(path, piece):
        node = specs
        for k in path:
            node = node[k]
        return map_tree(lambda t, s: _own(sh.place(t, s)), piece, node)
    return lm.init_lm(cfg, seed=0, device=sh.device_of(mesh),
                      dtype=dtype or torch.bfloat16, place=place)


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


def nccl_records(trace: Path) -> dict:
    """The collectives of a ``torch.profiler`` chrome trace: the NCCL
    kernels by name (count, device us), and the c10d calls by their
    ``Collective name`` (count, output bytes: ``Out msg nelems`` times
    the dtype's size)."""
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


def _traced(cs, dev, box, trace: Path):
    """A ``torch.profiler`` context (CPU and CUDA, shapes recorded) as
    chip_smoke's ``profiled`` opens one: a warm-up step whose records are
    dropped, the region held open TRACE_PAD_S on both sides.  On exit
    ``box`` holds the profile and ``trace`` its chrome trace."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    @contextlib.contextmanager
    def ctx():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True,
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
    greedy, then on ``mesh`` teacher-forced with its tokens; every
    step's worst logits difference against FULL_PERIOD_TOL x the
    unsharded max |logits|.  Beside it, the same layers in fp32 on rank
    0's card, fed the same tokens: each bf16 run's distance from it."""
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
        row["ok"] = max(row["max_abs_err"]) <= row["bound"]
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


def main(case, d, rank=None, world=None):
    """``rank``/``world`` given: a gloo rank on a FileStore in ``d``;
    else a ``torchrun`` rank on its card (NCCL)."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    d = Path(d)
    if case == "serve_counts":
        return serve_counts(d)
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
             "serve_period": case_serve_period}[case](d, mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
