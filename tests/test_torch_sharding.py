"""Parity of the port's training sharding (``dist/sharding.py``,
``launch/mesh.py``) with the JAX package's, mirroring
``tests/test_sharding.py``: the rules and specs in one process, the
meshes under a ``"fake"`` process group of 256 and 512 ranks, and the
sharded train step on a (2, 2) mesh of four ``gloo`` CPU processes
against the reference's unsharded jitted step (the reference's own SPMD
test needs forced host devices).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mesh_worker import (GRAD_ARCHS, HEAD_ARCHS, SERVE_ARCHS,
                                SERVE_CACHE_TOL, SERVE_LOGITS_TOL,
                                SERVE_LOOP_ARCHS, SERVE_MESHES, SERVE_STEPS,
                                SMALL_ARCHS, SMALL_BATCH, STEP_ACCUM,
                                STEP_ARCHS, STEP_BATCH, STEP_LR, STEP_SEQ,
                                run_ranks, step_runs)
from _torch_parity import _clear_port_caches  # noqa: F401
from repro.configs import base as jbase
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import base as tbase
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import key, walk


def _shapes(arch, base):
    cfg = base.smoke_variant(base.get_config(arch))
    if base is jbase:
        return jax.eval_shape(lambda: jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    return lm.init_lm(cfg, device="meta")


def _ref_flat(tree, is_leaf=None):
    return {jsh._path_str(path): v for path, v in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def _at(tree, path, rep):
    """The node of a port tree at a reference path (a segment's repeat
    ``rep``)."""
    for k in path:
        if isinstance(tree, list) and tree and isinstance(tree[0], list):
            tree = tree[k][rep]
        else:
            tree = tree[k]
    return tree


def _port_flat(params, tree):
    """reference key -> the port tree's leaf (the same at every repeat,
    checked)."""
    out = {}
    for path, rep, _ in walk(params):
        v = _at(tree, path, rep)
        k = key(path)
        assert out.setdefault(k, v) == v, (k, out[k], v)
    return out


@pytest.mark.parametrize("arch", tbase.list_archs())
def test_every_param_has_a_rule_and_the_reference_axes(arch):
    """logical_axes covers every leaf of every architecture, and names
    each leaf with the reference's tuple (leading "layers" included)."""
    params = _shapes(arch, tbase)
    axes = sh.logical_axes(params)
    got = _port_flat(params, axes)
    want = _ref_flat(jsh.logical_axes(_shapes(arch, jbase)),
                     is_leaf=lambda a: isinstance(a, tuple))
    assert got == want


def test_no_dead_rules():
    """Every _AXIS_TABLE pattern is the FIRST match for at least one
    real param path across the current architectures, and the table is
    the reference's."""
    assert [(p.pattern, a) for p, a in sh._AXIS_TABLE] == [
        (p.pattern, a) for p, a in jsh._AXIS_TABLE]
    first = set()
    for arch in tbase.list_archs():
        for path, _, _ in walk(_shapes(arch, tbase)):
            p = key(path)
            first.add(next(i for i, (pat, _) in enumerate(sh._AXIS_TABLE)
                           if pat.search(p)))
    assert first == set(range(len(sh._AXIS_TABLE)))


def _specs(arch):
    rules = sh.make_rules("train", multi_pod=False)
    params = _shapes(arch, tbase)
    port = _port_flat(params, sh.param_specs(params, rules))
    ref = _ref_flat(jsh.param_specs(_shapes(arch, jbase),
                                    jsh.make_rules("train")),
                    is_leaf=lambda s: isinstance(s, jsh.P))
    return port, ref


def _dropped(ref_spec, n):
    """The reference's stacked spec as a per-repeat leaf's: the leading
    entries ("layers": None) dropped."""
    entries = tuple(ref_spec)
    assert all(e is None for e in entries[:len(entries) - n])
    return sh.P(*entries[len(entries) - n:])


@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "deepseek-v2-lite-16b"])
def test_param_specs_are_the_reference_per_repeat(arch):
    port, ref = _specs(arch)
    assert set(port) == set(ref)
    for k, spec in port.items():
        assert spec == _dropped(ref[k], len(spec)), k


def test_param_specs_2d_sharded():
    """Big matrices get both an FSDP ('data') and a TP ('model') axis."""
    port, ref = _specs("qwen2-72b")
    wq = [v for k, v in port.items() if k.endswith("attn/wq/w")][0]
    assert wq == sh.P("data", "model")
    assert tuple(ref["segments/0/pos0/attn/wq/w"]) == (None, "data", "model")
    assert port["embed/embedding"] == sh.P("model", "data")
    mlp_wo = [v for k, v in port.items() if k.endswith("mlp/wo/w")][0]
    assert mlp_wo == sh.P("model", "data")


def test_moe_expert_sharding():
    port, _ = _specs("deepseek-moe-16b")
    wi = [v for k, v in port.items() if k.endswith("moe/experts/wi")][0]
    assert wi == sh.P("model", "data", None)    # EP x FSDP


def test_multipod_batch_rule():
    for args in [("train", False), ("train", True), ("decode", False, True),
                 ("prefill", True, True)]:
        assert sh.make_rules(*args) == jsh.make_rules(*args)
    r1 = sh.make_rules("train", multi_pod=False)
    r2 = sh.make_rules("train", multi_pod=True)
    assert r1["batch"] == ("data",)
    assert r2["batch"] == ("pod", "data")
    rl = sh.make_rules("decode", multi_pod=False, long_context=True)
    assert rl["batch"] is None and rl["kv_len"] == ("data",)
    assert sh.opt_specs("x") == {"master": "x", "m": "x", "v": "x"}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_batch_specs_match_reference(arch, multi_pod):
    """On input_specs (M-RoPE positions take the batch rule at dim 1)."""
    from repro_torch.launch import steps as tsteps
    shape = tbase.ShapeConfig("t", 16, 8, "train")
    jshape = jbase.ShapeConfig("t", 16, 8, "train")
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    got = sh.batch_specs(tsteps.input_specs(tcfg, shape),
                         sh.make_rules("train", multi_pod))
    want = jsh.batch_specs(jsteps.input_specs(jcfg, jshape),
                           jsh.make_rules("train", multi_pod))
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b"])
def test_cache_specs_match_reference(arch, long_context):
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    got = sh.cache_specs(lm.cache_shapes(tcfg, 2, 16), tcfg,
                         sh.make_rules("decode", False, long_context))
    want = jsh.cache_specs(
        jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, 16)), jcfg,
        jsh.make_rules("decode", False, long_context))
    flat_w = [tuple(s) for s in jax.tree.leaves(
        want, is_leaf=lambda s: isinstance(s, jsh.P))]
    flat_g = []

    def collect(node):
        if isinstance(node, sh.P):
            flat_g.append(tuple(node))
        elif isinstance(node, dict):
            for k in sorted(node):
                collect(node[k])
        else:
            for v in node:
                collect(v)
    collect(got)
    assert flat_g == flat_w


# ---------------------------------------------------------------------------
# placements and meshes under a fake process group

@pytest.fixture
def fake_world():
    """A "fake" process group of n ranks in this process (this is rank
    0), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    made = []

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        made.append(n)
    yield make
    if made:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec, want", [
    (sh.P(None, "data", "model"), ("S1", "S2")),
    (sh.P("model", "data"), ("S1", "S0")),
    (sh.P(("data",), None), ("S0", "R")),
    (sh.P(None, None), ("R", "R")),
    (sh.P("model", "data", None), ("S1", "S0")),
])
def test_placements_of_a_spec(fake_world, spec, want):
    from torch.distributed.tensor import Replicate, Shard
    fake_world(256)
    mesh = M.make_production_mesh()
    code = {Replicate(): "R"} | {Shard(d): f"S{d}" for d in range(4)}
    got = tuple(code[p] for p in sh.named(mesh, spec).placements)
    assert got == want


def test_placements_across_pods(fake_world):
    """("pod", "data") shards one dim over two mesh dims, major first; an
    entry out of the mesh's order, or an axis used twice, raises."""
    from torch.distributed.tensor import Replicate, Shard
    fake_world(512)
    mesh = M.make_production_mesh(multi_pod=True)
    rules = sh.make_rules("train", multi_pod=True)
    act = sh.named(mesh, sh.P(rules["batch"], None, None))
    assert act.placements == (Shard(0), Shard(0), Replicate())
    tree = sh.named(mesh, {"a": [sh.P("model", None)]})
    assert tree["a"][0].placements == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="order"):
        sh.named(mesh, sh.P(("data", "pod"))).placements
    with pytest.raises(ValueError, match="two dims"):
        sh.named(mesh, sh.P("data", "data")).placements


@pytest.mark.parametrize("n, multi_pod, shape, axes", [
    (256, False, (16, 16), ("data", "model")),
    (512, True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh_shapes(fake_world, n, multi_pod, shape, axes):
    fake_world(n)
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    assert tuple(mesh.shape) == shape
    assert mesh.mesh_dim_names == axes
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError, match=f"needs {768 - n} ranks"):
        M.make_production_mesh(multi_pod=not multi_pod)


@pytest.mark.parametrize("n, model, shape", [
    (256, 2, (128, 2)), (512, 2, (256, 2)), (256, 16, (16, 16)),
    (4, 8, (1, 4))])
def test_debug_mesh_shapes(fake_world, n, model, shape):
    fake_world(n)
    mesh = M.make_debug_mesh(model=model)
    assert tuple(mesh.shape) == shape
    assert mesh.mesh_dim_names == ("data", "model")


def test_a_mesh_dim_of_size_one_replicates(fake_world):
    """On a (1, 1) mesh (one card) every spec is Replicate: a size-1 dim
    cuts nothing, and DTensor cannot flatten a one-row batch sharded
    over it."""
    from torch.distributed.tensor import Replicate
    fake_world(1)
    mesh = M.make_debug_mesh()
    assert tuple(mesh.shape) == (1, 1)
    for spec in (sh.P("data", "model"), sh.P(("data",), None, None)):
        assert sh.named(mesh, spec).placements == (Replicate(),) * 2


@pytest.mark.parametrize("multi_pod, rows, want", [
    (True, 32, ("S0", "S0", "R")), (True, 16, ("R", "S0", "R")),
    (True, 48, ("R", "S0", "R")), (True, 2, ("S0", "R", "R")),
    (True, 1, ("R", "R", "R")), (False, 8, ("R", "R")),
    (False, 16, ("S0", "R"))])
def test_a_batch_its_ranks_do_not_divide_is_cut_over_the_most_that_do(
        fake_world, multi_pod, rows, want):
    """The batch rule on a micro-batch of ``rows``: cut over the largest
    set of the batch axes whose size divides the rows (the minor axis
    where two tie), replicated over the rest; the batch and the
    activation spec fitted alike (``placements_for``)."""
    from torch.distributed.tensor import Replicate, Shard
    fake_world(512 if multi_pod else 256)
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    rules = sh.make_rules("train", multi_pod)
    code = {Replicate(): "R", Shard(0): "S0"}
    act = sh.named(mesh, sh.P(rules["batch"], None, None))
    tokens = torch.empty((rows, 16), dtype=torch.int32, device="meta")
    batch = sh.named(mesh, sh.batch_specs({"tokens": tokens}, rules))
    got = sh.place(tokens, batch["tokens"])
    assert tuple(code[p] for p in got.placements) == want
    assert act.placements_for((rows, 16, 64)) == got.placements
    assert got.shape == tokens.shape


def test_production_mesh_names_its_ranks(fake_world):
    fake_world(4)
    with pytest.raises(ValueError, match="needs 256 ranks; this process "
                                         "group has 4"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# the sharded step on four gloo processes against the reference

def _fp32_tree(cfg):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jlm.init_lm(cfg, jax.random.PRNGKey(0)))


def _make_batch(cfg, rng, B=STEP_BATCH):
    S = STEP_SEQ
    return {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """Per run of ``step_runs`` (an arch on the parity batch, or on the
    small batch): the reference's jitted step from fp32 params, and the
    port's step on a (2, 2) mesh from the same params and batch."""
    d = tmp_path_factory.mktemp("mesh_steps")
    rng = np.random.default_rng(0)
    ref = {}
    for tag, arch in step_runs():
        jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get_config(
            arch)), grad_accum=STEP_ACCUM)
        tcfg = dataclasses.replace(tbase.smoke_variant(tbase.get_config(
            arch)), grad_accum=STEP_ACCUM)
        jp = _fp32_tree(jcfg)
        if tag == arch:
            tp = lm.params_from_numpy(
                jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg,
                device="cpu", dtype=torch.float32)
            ckpt.save_checkpoint(d / f"{arch}_in", 0, {
                "params": tp, "opt": adamw_init(tp),
                "step": torch.zeros((), dtype=torch.int32)})
        batch = _make_batch(jcfg, rng, STEP_BATCH if tag == arch
                            else SMALL_BATCH)
        np.savez(d / f"{tag}_batch.npz", **batch)
        jstate = {"params": jp, "opt": jadamw_init(jp),
                  "step": jnp.zeros((), jnp.int32)}
        jstep = jax.jit(jsteps.make_train_step(jcfg, peak_lr=STEP_LR))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        ref[tag] = (jp, jstate, {k: float(v) for k, v in jm.items()})
    run_ranks("steps", d, timeout=400)
    return d, ref


def _check_step(d, ref, tag):
    """The port's sharded step ``tag`` against the reference's: loss and
    grad_norm within 1e-5 relative, the same lr, each leaf's update
    within 1e-2 relative in L2; every rank held only its shards."""
    jp, jstate, jm = ref[tag]
    got = json.loads((d / f"{tag}_metrics.json").read_text())
    np.testing.assert_allclose(got["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert got["lr"] == jm["lr"]
    assert got["local_numel"] < got["numel"] / 2
    params = ckpt.load_numpy(d / f"{tag}_out", 1, prefix="params")
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jstate["params"]):
        node, p0 = params["params"], jp
        for k in path:
            kk = getattr(k, "key", getattr(k, "idx", None))
            node, p0 = node[kk], p0[kk]
        want, p0 = np.asarray(want, np.float32), np.asarray(p0, np.float32)
        moved = np.linalg.norm(want - p0)
        assert moved > 0
        assert np.linalg.norm(node - want) <= 1e-2 * moved, (
            jax.tree_util.keystr(path))
        n += 1
    assert n == len(jax.tree.leaves(jstate["params"]))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_step_matches_the_reference_unsharded_step(arch,
                                                           sharded_steps):
    """One step at grad_accum 2 (micro-batches of global rows) on a
    (2, 2) mesh: loss and grad_norm within 1e-5 relative of the
    reference's unsharded jitted step, each leaf's update within 1e-2
    relative in L2; every rank held only its shards."""
    _check_step(*sharded_steps, arch)


@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_sharded_step_with_micro_batches_under_the_batch_ranks(
        arch, sharded_steps):
    """A batch of 2 rows at grad_accum 2 on the (2, 2) mesh, so each
    micro-batch's one row spans 'data' = 2 (as 16 rows span the
    multi-pod mesh's 32 batch ranks in qwen2-72b's real step): the
    micro-batch and its activations are replicated over 'data', and the
    step equals the reference's unsharded step as above, dense and with
    MoE capacity routing (where a padded row would compete)."""
    _check_step(*sharded_steps, f"{arch}-b{SMALL_BATCH}")


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_loss_and_grads_match_unsharded(arch, sharded_steps):
    """Hybrid (jamba), M-RoPE positions sharded at dim 1 (qwen2-vl) and
    embeds input (musicgen) on the (2, 2) mesh: train_loss within 1e-5
    relative and every gradient within 1e-4 relative in L2 of the
    port's unsharded ones, fp32 (the ranks compute both)."""
    d, _ = sharded_steps
    got = json.loads((d / f"{arch}_grads.json").read_text())
    np.testing.assert_allclose(got["loss"][0], got["loss"][1], rtol=1e-5)
    assert got["max_rel_grad_l2"] <= 1e-4, got


# ---------------------------------------------------------------------------
# the sharded step's repairs for the production meshes, on four gloo ranks

@pytest.fixture(scope="module")
def repairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_repairs")
    run_ranks("repairs", d, timeout=400)
    return json.loads((d / "repairs.json").read_text())


@pytest.mark.parametrize("arch", sorted(HEAD_ARCHS))
def test_sharded_step_with_heads_the_model_axis_does_not_divide(arch,
                                                                repairs):
    """A train step at grad_accum 2 on a (1, 4) mesh, whose 'model' axis
    of 4 divides neither the 2 kv heads nor (the -h6 variant) the 6
    query heads: loss and grad_norm within 1e-5 relative of the
    unsharded step (DTensor cannot cut a head across ranks; the heads
    are split whole and padded, ``layers.split_heads``/``pad_heads``)."""
    got = repairs["heads"][arch]
    H, KVH = got["heads"]
    assert KVH % 4 and (H % 4 or arch == "qwen2-1.5b")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["sharded"][k], got["unsharded"][k],
                                   rtol=1e-5)
    assert got["sharded"]["lr"] == got["unsharded"]["lr"]


def test_shard_local_brings_arguments_to_the_first_ones_shards(repairs):
    """A first argument placed (Shard(0), Shard(0)) and a second
    (Shard(0), Replicate()), as ``_gold`` met the logits and labels at
    16 x 16: the result and both gradients equal the whole computation
    (fp64), each gradient in its argument's placements."""
    got = repairs["shard_local"]
    assert got["out"] == got["grad_a"] == got["grad_b"] == 0.0
    assert got["placements"] == ["(Shard(dim=0), Shard(dim=0))",
                                 "(Shard(dim=0), Replicate())"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(arch, repairs):
    """Dense, MoE (under GQA and MLA), SSM and hybrid smoke variants in
    fp32: a prefill of 16 tokens
    and one decode step (jamba: SERVE_STEPS) on DTensor params and caches
    placed by ``cache_specs`` (the per-repeat layout ``lm_forward``
    reads) on the (2, 2) mesh: the logits within 2e-4 of the unsharded
    steps', every cache leaf within 1e-5 (fp32 rounding of the partial
    sums the ranks add)."""
    got = repairs["serve"][arch]
    assert got["prefill_logits"] <= 2e-4 and got["decode_logits"] <= 2e-4
    assert got["cache"] <= 1e-5
    # two layers: k and v (GQA), one latent (MLA), three conv tails and
    # the SSM state (Mamba2); jamba's period: one attention layer and
    # seven Mamba layers
    assert got["cache_leaves"] == {"deepseek-v2-lite-16b": 2,
                                   "mamba2-1.3b": 8,
                                   "jamba-v0.1-52b": 30}.get(arch, 4)


@pytest.mark.parametrize("mesh", sorted(SERVE_MESHES))
@pytest.mark.parametrize("arch", SERVE_LOOP_ARCHS)
def test_sharded_serve_loop_matches_unsharded(arch, mesh, repairs):
    """The hybrid (attention + Mamba + MoE) smoke variant in fp32 through
    the worker's ``serve_loop``: a prefill of 16 tokens and SERVE_STEPS
    decode steps on (2, 2) and on (1, 4) (2 kv heads over a 'model'
    axis of 4: padded heads in prefill; the Mamba tails and SSM state
    through ``shard_local``), teacher-forced with the unsharded greedy
    run's tokens.  Every step's logits within 2e-4 of the unsharded
    loop's, every cache leaf within 1e-5 after the last step, the
    sharded run's own argmaxes equal to the unsharded tokens, and after
    every step each cache leaf still placed as ``cache_specs`` says and
    holding only its share (checked on the ranks: a rank that found one
    otherwise failed the run)."""
    got = repairs["serve_loop"][arch][mesh]
    assert got["mesh"] == [4 // SERVE_MESHES[mesh], SERVE_MESHES[mesh]]
    assert got["steps"] == SERVE_STEPS
    assert len(got["logits"]) == SERVE_STEPS + 1
    assert max(got["logits"]) <= SERVE_LOGITS_TOL, got["logits"]
    assert got["cache"] <= SERVE_CACHE_TOL
    assert got["tokens_equal"]


def test_sharded_prefill_pads_the_ssd_chunks_on_local_tensors(repairs):
    """A prompt of SERVE_PAD_PROMPT tokens, which the Mamba2 scan's chunk
    does not divide, through the smoke jamba's sharded prefill and one
    decode step on (2, 2), fp32: the logits within 2e-4 and the cache
    within 1e-5 of unsharded (the scan pads the sequence to whole chunks
    and cuts it back on each rank's local tensors; torch 2.11's DTensor
    failed ``F.pad`` on the 2-D mesh)."""
    got = repairs["serve_pad"]
    assert got["steps"] == 1 and got["cache_leaves"] == 30
    assert max(got["logits"]) <= SERVE_LOGITS_TOL, got["logits"]
    assert got["cache"] <= SERVE_CACHE_TOL
    assert got["tokens_equal"]


def test_serve_loop_on_one_rank_gives_the_unsharded_tokens(
        tmp_path_factory):
    """``serve_loop`` on one gloo rank's (1, 1) mesh (what chip_smoke's
    mesh serving phase runs on one card): the smoke jamba's SERVE_STEPS
    greedy tokens, each run fed its own argmaxes, equal to the unsharded
    loop's, and the logits bit-equal (every placement is ``Replicate``,
    so every op runs on the whole tensors)."""
    d = tmp_path_factory.mktemp("mesh_serve_one")
    run_ranks("serve_one", d, world=1, timeout=300)
    got = json.loads((d / "serve_one.json").read_text())
    sharded, plain = got["tokens"]
    assert np.array(plain).shape == (4, SERVE_STEPS + 1)
    assert sharded == plain
    assert got["logits"] == 0.0


# ---------------------------------------------------------------------------
# the residual pinned after the mixer, on four gloo ranks

@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_pin")
    run_ranks("pin", d, timeout=400)
    return json.loads((d / "pin.json").read_text())


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_the_residual_pinned_after_the_mixer_matches_unsharded(arch, pinned):
    """On the (2, 2) mesh, fp32: a layer forward that reduces the
    residual's ``Partial`` placement (the mixer's row-parallel output
    added) right after the mixer, and the same forward without that pin,
    each against the unsharded step.  The gradients at the mixer's
    output, the residual before the pin, the MLP's output and the
    layer's output within 1e-5 relative in L2 of the unsharded ones,
    every param's gradient within 1e-4 (the CE's mean over ranks), the
    loss and one train step's loss and grad_norm within 1e-5 relative:
    no partial sum is reduced twice or in the wrong place, whichever
    layer reduces it (DTensor's version decides that).  The tapped
    forward is a copy of ``models/lm.py::_layer_fwd``: unsharded, its
    loss and gradients equal the real function's bit for bit."""
    got = pinned[arch]
    assert got["copy_is_real"]
    (_, places), = [v for k, v in got["pinned"]["taps"].items()
                    if k == "mixer_out"]
    assert any("Partial" in pl for pl in places), places
    for variant in ("unpinned", "pinned"):
        row = got[variant]
        assert row["loss_rel"] <= 1e-5, (variant, row)
        assert set(row["taps"]) >= {"mixer_out", "before_pin", "layer_out"}
        for name, (worst, _) in row["taps"].items():
            assert worst <= 1e-5, (variant, name, worst)
        assert row["worst_param_grad"][0] <= 1e-4, (variant, row)
        for k in ("loss", "grad_norm"):
            assert row["step_rel"][k] <= 1e-5, (variant, k, row)
