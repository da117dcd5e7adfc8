"""Parity of the port's training path (losses, ``launch/steps.py``, the
trainer, the data pipeline and the launcher) with the JAX package's, on
the CPU at smoke size.

Params come from the JAX package's ``init_lm`` cast to fp32 and cross as
numpy; the reference's train step runs under ``jax.jit``, the port's
eagerly.  The integration tests mirror ``tests/test_training.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, chip_smoke, np32  # noqa: F401
from repro.configs import base as jbase
from repro.data import FileLMData as JFileLMData
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import base as tbase
from repro_torch.data import FileLMData, SyntheticLMData
from repro_torch.kernels import _build
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.train.trainer import TrainConfig, Trainer

#: dense, SSM, MoE and hybrid families, M-RoPE (whose positions split
#: along dim 1 under gradient accumulation), and MHA fed embeddings with
#: an untied head (musicgen)
TRAIN_ARCHS = ["qwen2-1.5b", "mamba2-1.3b", "deepseek-moe-16b",
               "jamba-v0.1-52b", "qwen2-vl-2b", "musicgen-large"]


def both_configs(arch, **kw):
    return tuple(dataclasses.replace(
        base.smoke_variant(base.get_config(arch)), **kw)
        for base in (jbase, tbase))


def fp32_tree(cfg, seed=0):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jlm.init_lm(cfg, jax.random.PRNGKey(seed)))


def port_params(jp, tcfg):
    return lm.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg,
        device="cpu", dtype=torch.float32)


def make_batch(cfg, B, S, rng):
    batch = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.input_mode == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections:
        # distinct rows, so a micro-batch taking the wrong rows shows
        batch["positions"] = (np.arange(S, dtype=np.int32)[None, None]
                              + 3 * np.arange(B, dtype=np.int32)[None, :,
                                                                 None]
                              + np.arange(3, dtype=np.int32)[:, None, None])
    return batch


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def assert_params_close(tp, tcfg, jp, atol):
    got = lm.params_to_numpy(tp, tcfg)
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        node = got
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want, np.float32),
                                   rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(jax.tree.leaves(got))


def assert_updates_close(tp, tcfg, jp, p0, rtol):
    """Each leaf's update from ``p0`` (the reference's layout) within
    ``rtol`` of the reference's in relative L2: a wrong update of any
    step shows here even where Adam's steps are small against an
    elementwise bound."""
    got = jax.tree.leaves(lm.params_to_numpy(tp, tcfg))
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(jp)]
    for a, b, z in zip(got, want, jax.tree.leaves(p0), strict=True):
        d = np.linalg.norm(b - z)
        assert d > 0
        assert np.linalg.norm(a - b) <= rtol * d, (
            np.linalg.norm(a - b) / d, a.shape)


#: peak lr of the parity steps: the warmup's first steps then move a
#: param by 3e-5 to 9e-5, well above the 1e-5 elementwise bound
PARITY_LR = 3e-3


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch, rng):
    """Three fp32 steps of each package's make_train_step from the same
    params and batch (the smoke config's own grad_accum) at peak lr
    3e-3: loss within 1e-5 relative and every param within 1e-5 after
    steps 1 and 3, each leaf's update within 1e-2 relative in L2; no
    kernel launched."""
    jcfg, tcfg = both_configs(arch)
    jp = fp32_tree(jcfg)
    tp = port_params(jp, tcfg)
    p0 = lm.params_to_numpy(tp, tcfg)
    batch = make_batch(jcfg, 8, 16, rng)
    jstate = {"params": jp, "opt": jadamw_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": adamw_init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jsteps.make_train_step(jcfg, peak_lr=PARITY_LR))
    tstep = tsteps.make_train_step(tcfg, peak_lr=PARITY_LR)
    for k in range(3):
        jstate, jm = jstep(jstate, to_j(batch))
        tstate, tm = tstep(tstate, to_t(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-5)
        assert float(tm["lr"]) == float(jm["lr"])
        if k in (0, 2):
            assert_params_close(tstate["params"], tcfg, jstate["params"],
                                atol=1e-5)
            assert_updates_close(tstate["params"], tcfg, jstate["params"],
                                 p0, rtol=1e-2)
    assert int(tstate["step"]) == 3
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-2b"])
def test_chip_smokes_embeds_batch_gives_the_reference_loss(arch):
    """The batch function of chip_smoke's embeddings training phase
    (``embeds_train_batch``, loaded from the script) at smoke size, 8
    rows of 64, qwen2-vl's rows each the M-RoPE image grid
    ``LM_CPU_GRID``: three fp32 steps of each package's make_train_step
    on that numpy batch (the smoke config's grad_accum 4, so the grid's
    positions split on dim 1) give the same loss and grad_norm within
    1e-5 relative."""
    cs = chip_smoke()
    jcfg, tcfg = both_configs(arch)
    batch = cs.embeds_train_batch(tcfg, 8, 64, 0, grid=cs.LM_CPU_GRID)
    assert batch["embeds"].shape == (8, 64, tcfg.d_model)
    assert batch["embeds"].dtype == np.float32
    assert 0 <= batch["labels"].min() and batch["labels"].max() < \
        tcfg.vocab_size
    if tcfg.mrope_sections:
        grid, _ = cs.mrope_grid(*cs.LM_CPU_GRID)
        assert batch["positions"].shape == (3, 8, 64)
        assert (batch["positions"] == grid[:, None]).all()
        assert (grid[1] != grid[0]).any()       # the image's rows move
    else:
        assert "positions" not in batch
    assert jcfg.grad_accum == 4
    jp = fp32_tree(jcfg)
    tp = port_params(jp, tcfg)
    jstate = {"params": jp, "opt": jadamw_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": adamw_init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jsteps.make_train_step(jcfg, peak_lr=PARITY_LR))
    tstep = tsteps.make_train_step(tcfg, peak_lr=PARITY_LR)
    for _ in range(3):
        jstate, jm = jstep(jstate, to_j(batch))
        tstate, tm = tstep(tstate, to_t(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)


def test_train_step_with_grad_compression_matches_reference(rng):
    """int8 + error feedback on the reference's stacked leaves (a block
    spans two layers there): two fp32 steps at peak lr 3e-3, loss within
    1e-5 relative, params within 1e-5, each leaf's update within 1e-2
    relative in L2.  A code whose scaled value lands on a rounding
    boundary may move one step between the packages (the gradients
    differ in their last bits), so the feedback residual must agree
    within 1e-6 on all but a thousandth of its elements; the codec on
    equal inputs is bit for bit (tests/test_torch_checkpoint.py)."""
    jcfg, tcfg = both_configs("qwen2-1.5b", grad_accum=1)
    from repro.dist import compress as JC
    from repro_torch.dist import compress as TC
    jp = fp32_tree(jcfg, 1)
    tp = port_params(jp, tcfg)
    p0 = lm.params_to_numpy(tp, tcfg)
    batch = make_batch(jcfg, 4, 16, rng)
    jstate = {"params": jp, "opt": jadamw_init(jp),
              "step": jnp.zeros((), jnp.int32), "ef": JC.init_feedback(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp),
              "step": torch.zeros((), dtype=torch.int32),
              "ef": TC.init_feedback(tp)}
    jstep = jax.jit(jsteps.make_train_step(jcfg, peak_lr=PARITY_LR,
                                           grad_compression=True))
    tstep = tsteps.make_train_step(tcfg, peak_lr=PARITY_LR,
                                   grad_compression=True)
    for _ in range(2):
        jstate, jm = jstep(jstate, to_j(batch))
        tstate, tm = tstep(tstate, to_t(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert_params_close(tstate["params"], tcfg, jstate["params"], atol=1e-5)
    assert_updates_close(tstate["params"], tcfg, jstate["params"], p0,
                         rtol=1e-2)
    got = jax.tree.leaves(lm.params_to_numpy(tstate["ef"], tcfg))
    want = [np.asarray(a) for a in jax.tree.leaves(jstate["ef"])]
    off = sum(int((np.abs(a - b) > 1e-6).sum()) for a, b in zip(got, want))
    total = sum(a.size for a in want)
    assert off <= total // 1000, (off, total)
    assert any(np.abs(a).max() > 0 for a in want)


@pytest.mark.parametrize("vocab", [256, 250])
def test_cross_entropy_matches_chunked_and_reference(vocab, rng):
    """Padded vocab slots (250 of 256) are out of the partition function
    and take no gradient; the chunked CE (a sequence not a multiple of
    the chunk) equals the whole one, and both equal the reference's."""
    B, S, Dm, V = 2, 37, 16, 256
    hidden = rng.normal(size=(B, S, Dm)).astype(np.float32)
    w = rng.normal(size=(Dm, V)).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    want = float(jlm.cross_entropy(jnp.asarray(hidden) @ jnp.asarray(w),
                                   jnp.asarray(labels), vocab))
    want_c = float(jlm.cross_entropy_chunked(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(labels), vocab,
        chunk=16))
    h = torch.from_numpy(hidden).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    lab = torch.from_numpy(labels)
    got = lm.cross_entropy(h @ wt, lab, vocab)
    gw, gh = torch.autograd.grad(got, (wt, h))
    got_c = lm.cross_entropy_chunked(h, wt, lab, vocab, chunk=16)
    gwc, ghc = torch.autograd.grad(got_c, (wt, h))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    np.testing.assert_allclose(float(got_c.detach()), want_c, rtol=1e-6)
    np.testing.assert_allclose(float(got_c.detach()), float(got.detach()),
                               rtol=1e-6)
    np.testing.assert_allclose(np32(gwc), np32(gw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np32(ghc), np32(gh), rtol=1e-5, atol=1e-7)
    jgw = jax.grad(lambda w_: jlm.cross_entropy(
        jnp.asarray(hidden) @ w_, jnp.asarray(labels), vocab))(
        jnp.asarray(w))
    np.testing.assert_allclose(np32(gw), np.asarray(jgw), rtol=1e-5,
                               atol=1e-7)
    assert not gw[:, vocab:].any()
    with torch.no_grad():        # no recompute without grad
        assert float(lm.cross_entropy_chunked(h, wt, lab, vocab,
                                              chunk=16)) == float(got_c)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b"])
def test_train_loss_matches_reference_both_ce_impls(arch, rng):
    """train_loss (and its aux) for ce_impl "simple" and "chunked"."""
    for impl in ("simple", "chunked"):
        jcfg, tcfg = both_configs(arch, ce_impl=impl)
        jp = fp32_tree(jcfg, 2)
        tp = port_params(jp, tcfg)
        batch = make_batch(jcfg, 2, 24, rng)
        jl, jaux = jlm.train_loss(jp, jcfg, to_j(batch))
        tl, taux = lm.train_loss(tp, tcfg, to_t(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-6)


def _grads(tcfg, tp, batch):
    leaves = []

    def track(node):
        if isinstance(node, dict):
            return {k: track(v) for k, v in node.items()}
        if isinstance(node, list):
            return [track(v) for v in node]
        t = node.detach().clone().requires_grad_(True)
        leaves.append(t)
        return t
    p = track(tp)
    loss, _ = lm.train_loss(p, tcfg, batch)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-moe-16b"])
def test_remat_policies_give_equal_grads(arch, rng):
    """remat "none", "full" (each layer recomputed) and "dots" (matmul
    outputs kept) differ in what backward keeps, not in what it gives."""
    jcfg, _ = both_configs(arch)
    tp = port_params(fp32_tree(jcfg, 4), both_configs(arch)[1])
    batch = to_t(make_batch(jcfg, 2, 12, rng))
    out = {}
    for remat in ("none", "full", "dots"):
        tcfg = both_configs(arch, remat=remat)[1]
        out[remat] = _grads(tcfg, tp, batch)
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            np.testing.assert_allclose(np32(a), np32(b), rtol=1e-6,
                                       atol=1e-9)
    with pytest.raises(ValueError, match="remat"):
        _grads(both_configs(arch, remat="some")[1], tp, batch)


def test_grad_accum_equivalence(rng):
    """accum=4 matches accum=1 up to accumulation-order rounding
    (tests/test_training.py's check on the port, at its bounds)."""
    _, cfg1 = both_configs("qwen2-1.5b", grad_accum=1)
    cfg4 = dataclasses.replace(cfg1, grad_accum=4)
    jp = fp32_tree(both_configs("qwen2-1.5b")[0])
    batch = to_t({"tokens": rng.integers(0, 256, (8, 16)).astype(np.int32),
                  "labels": rng.integers(0, 256, (8, 16)).astype(np.int32)})
    out = []
    for cfg in (cfg1, cfg4):
        tp = port_params(jp, cfg)
        state = {"params": tp, "opt": adamw_init(tp),
                 "step": torch.zeros((), dtype=torch.int32)}
        out.append(tsteps.make_train_step(cfg)(state, batch))
    (s1, m1), (s4, m4) = out
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-3
    a = lm.params_to_numpy(s1["params"], cfg1)
    b = lm.params_to_numpy(s4["params"], cfg4)
    np.testing.assert_allclose(a["embed"]["embedding"],
                               b["embed"]["embedding"], atol=5e-3)
    np.testing.assert_allclose(a["segments"][0]["pos0"]["mlp"]["wi"]["w"],
                               b["segments"][0]["pos0"]["mlp"]["wi"]["w"],
                               atol=1e-6)


class _FixedData(SyntheticLMData):
    """Constant batch: the memorization workload — loss must collapse."""

    def batch_at(self, step):
        return super().batch_at(0)


def _trained(arch, tmp_path, steps=30, **kw):
    cfg = dataclasses.replace(tbase.smoke_variant(tbase.get_config(arch)),
                              grad_accum=1)
    data = _FixedData(cfg.vocab_size, 8, 32, seed=3)
    tcfg = TrainConfig(steps=steps, ckpt_every=1000, ckpt_dir=str(tmp_path),
                       peak_lr=3e-3, log_every=1000, **kw)
    tr = Trainer(cfg, tcfg, data, device="cpu")
    tr.run()
    first = np.mean([m["loss"] for m in tr.metrics_log[:5]])
    last = np.mean([m["loss"] for m in tr.metrics_log[-5:]])
    return first, last


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_loss_decreases(arch, tmp_path):
    """The Trainer (bf16 params, the reference's default) memorizes a
    fixed batch: tests/test_training.py's dense and ssm checks."""
    first, last = _trained(arch, tmp_path)
    assert last < first - 0.5, (first, last)


def test_grad_compression_trains(tmp_path):
    """int8+EF compressed gradients still drive the loss down."""
    first, last = _trained("qwen2-1.5b", tmp_path, steps=25,
                           grad_compression=True)
    assert last < first - 0.5, (first, last)


def test_straggler_detection(tmp_path):
    import time as time_mod
    cfg = dataclasses.replace(tbase.smoke_variant(
        tbase.get_config("qwen2-1.5b")), grad_accum=1)
    data = SyntheticLMData(cfg.vocab_size, 2, 8)
    tcfg = TrainConfig(steps=10, ckpt_every=1000, ckpt_dir=str(tmp_path),
                       straggler_factor=2.0, log_every=1000)
    tr = Trainer(cfg, tcfg, data, device="cpu")
    orig = tr.step_fn
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        # every step takes 50 ms or more, so a shared CPU's jitter of a
        # few ms cannot double one; the ninth is the straggler
        time_mod.sleep(1.0 if calls["n"] == 9 else 0.05)
        return orig(state, batch)

    tr.step_fn = slow_step
    tr.run()
    assert any("straggler_detected" in m for m in tr.metrics_log)
    assert sum("straggler_detected" in m for m in tr.metrics_log) == 1
    assert "straggler_detected" in tr.metrics_log[8]


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_matches_reference(seed):
    want, got = (JSyntheticLMData(300, 4, 32, seed=seed),
                 SyntheticLMData(300, 4, 32, seed=seed))
    for step in (0, 1, 42, 10_000):
        a, b = want.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(next(iter(got))["tokens"],
                                  want.batch_at(0)["tokens"])
    b = got.batch_at(42)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_data_matches_reference(dtype, tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(5).integers(0, 60000, 5000).astype(dtype) \
        .tofile(path)
    want = JFileLMData(str(path), 1000, 3, 20, dtype=dtype)
    got = FileLMData(str(path), 1000, 3, 20, dtype=dtype)
    assert got.num_batches == want.num_batches
    for step in (0, 1, 5, want.num_batches + 2):
        a, b = want.batch_at(step), got.batch_at(step)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_specs_match_reference():
    """input_specs and state_specs: the reference's shapes and dtypes
    (the state in its stacked layout), as meta tensors."""
    from repro_torch.tree import key, walk
    for arch in ("qwen2-1.5b", "qwen2-vl-2b", "musicgen-large"):
        jcfg, tcfg = both_configs(arch)
        for kind in ("train_4k", "decode_32k"):
            want = jsteps.input_specs(jcfg, jbase.SHAPES[kind])
            got = tsteps.input_specs(tcfg, tbase.SHAPES[kind])
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert got[k].device.type == "meta"
                assert str(got[k].dtype).split(".")[-1] == \
                    want[k].dtype.name
        want = {jax.tree_util.keystr(p, simple=True, separator="/"): v
                for p, v in jax.tree_util.tree_leaves_with_path(
                    jsteps.state_specs(jcfg))}
        rows = {}
        for path, rep, leaf in walk(tsteps.state_specs(tcfg)):
            assert leaf.device.type == "meta"
            rows.setdefault(key(path), []).append((rep, leaf))
        assert sorted(rows) == sorted(want)
        for k, rs in rows.items():
            shape = tuple(rs[0][1].shape)
            if rs[0][0] is not None:
                shape = (len(rs),) + shape
            assert shape == want[k].shape, k
            assert str(rs[0][1].dtype).split(".")[-1] == want[k].dtype.name


def test_prefill_and_decode_steps_match_reference(rng):
    jcfg, tcfg = both_configs("qwen2-1.5b")
    jp = fp32_tree(jcfg, 5)
    tp = port_params(jp, tcfg)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, 16, kv_dtype=jnp.float32)
    tcache = lm.init_cache(tcfg, 2, 16, kv_dtype=torch.float32,
                           device="cpu")
    jl, jcache = jsteps.make_prefill_step(jcfg, 16)(
        jp, {"tokens": jnp.asarray(toks[:, :8])}, jcache)
    tl, tcache = tsteps.make_prefill_step(tcfg, 16)(
        tp, {"tokens": torch.from_numpy(toks[:, :8])}, tcache)
    np.testing.assert_allclose(np32(tl), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    jl, _ = jsteps.make_decode_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks[:, 8:])}, jcache, 8)
    tl, _ = tsteps.make_decode_step(tcfg)(
        tp, {"tokens": torch.from_numpy(toks[:, 8:])}, tcache, 8)
    assert tl.shape == (2, tcfg.padded_vocab)
    np.testing.assert_allclose(np32(tl), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)


def test_skip_head_and_params_to_numpy(rng):
    """lm_forward(skip_head=True) gives the reference's final hidden
    states; params_to_numpy inverts params_from_numpy exactly (bf16
    too)."""
    for arch in ("qwen2-1.5b", "deepseek-moe-16b", "jamba-v0.1-52b"):
        jcfg, tcfg = both_configs(arch)
        jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
        npy = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
        tp = lm.params_from_numpy(npy, tcfg, device="cpu")
        back = lm.params_to_numpy(tp, tcfg)
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_leaves_with_path(npy),
                jax.tree_util.tree_leaves_with_path(back)):
            assert pa == pb
            assert b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    jp = fp32_tree(jcfg, 6)
    tp = port_params(jp, tcfg)
    batch = make_batch(jcfg, 2, 8, rng)
    batch.pop("labels")
    want, _, _ = jlm.lm_forward(jp, jcfg, to_j(batch), skip_head=True)
    got, _, _ = lm.lm_forward(tp, tcfg, to_t(batch), skip_head=True)
    assert got.shape == (2, 8, tcfg.d_model)
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(ValueError, match="stack plan"):
        lm.params_to_numpy(tp, dataclasses.replace(tcfg, num_layers=16))


def test_maybe_constrain_on_one_device():
    """No spec: the tensor itself; a spec on a plain tensor (no mesh)
    raises rather than running unsharded."""
    from repro_torch.nn import layers as L
    x = torch.ones(2, 3)
    assert L.maybe_constrain(x, None) is x
    with pytest.raises(TypeError, match="needs a DTensor"):
        L.maybe_constrain(x, ("data", None, None))


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """python -m repro_torch.launch.train --device cpu: six steps with a
    checkpoint every three, then a second run resumes from the last."""
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "6",
            "--ckpt-every", "3", "--ckpt-dir", str(tmp_path), "--seq", "16",
            "--batch", "4", "--device", "cpu"]
    launcher.main(args)
    assert ckpt.latest_steps(tmp_path) == [3, 6]
    out = capsys.readouterr().out
    assert "[train] done:" in out and "'step': 5" in out
    launcher.main(args[:4] + ["8"] + args[5:])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "'step': 7" in out
    assert ckpt.latest_steps(tmp_path) == [3, 6, 8]
    # --mesh debug: a world of one gloo rank, resumed onto its (1, 1) mesh
    launcher.main(args[:4] + ["9"] + args[5:] + ["--mesh", "debug"])
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "'step': 8" in out
    assert ckpt.latest_steps(tmp_path) == [6, 8, 9]
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        launcher.main(args + ["--mesh", "pod"])
    assert not dist.is_initialized()


def test_the_last_checkpoint_is_saved_sync(tmp_path, monkeypatch):
    """The run's last checkpoint is written sync, the ones before it
    async: the last is joined at once, so writing it async gains
    nothing, and an async save first copies the whole state to the host
    (which a state of hundreds of GiB does not fit) where a sync save
    streams it one key at a time."""
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    real, calls = ckpt.save_checkpoint, []

    def save(*a, **kw):
        calls.append(kw.get("async_", False))
        return real(*a, **kw)
    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "4",
                   "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                   "--seq", "16", "--batch", "4", "--device", "cpu"])
    assert calls == [True, False]
    assert ckpt.latest_steps(tmp_path) == [2, 4]


def test_sigterm_checkpoints_at_the_next_step_boundary(tmp_path,
                                                       monkeypatch):
    """A SIGTERM that lands inside the second step's optimizer update
    lets that step finish, writes a sync checkpoint of step 2 and
    returns; it equals the checkpoint of an uninterrupted two-step run
    array for array (a state saved mid-update would mix two steps)."""
    import os
    import signal
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt
    real, calls = tsteps.adamw_update, []

    def update(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **kw)

    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "6",
            "--ckpt-every", "100", "--seq", "16", "--batch", "4",
            "--device", "cpu"]
    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(tsteps, "adamw_update", update)
    launcher.main(args + ["--ckpt-dir", str(tmp_path / "stopped")])
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(calls) == 2
    assert ckpt.latest_steps(tmp_path / "stopped") == [2]
    monkeypatch.setattr(tsteps, "adamw_update", real)
    launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "2",
                   "--ckpt-every", "100", "--seq", "16", "--batch", "4",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path / "whole")])
    got = ckpt.load_numpy(tmp_path / "stopped", 2)
    want = ckpt.load_numpy(tmp_path / "whole", 2)
    got_l, want_l = ([np.asarray(a) for a in jax.tree.leaves(t)]
                     for t in (got, want))
    assert len(got_l) == len(want_l) > 0
    for a, b in zip(got_l, want_l):
        np.testing.assert_array_equal(a, b)
    assert int(got["step"]) == 2


# ---------------------------------------------------------------------------
# on a (2, 2) mesh of four gloo processes

@pytest.fixture(scope="module")
def mesh_trainer(tmp_path_factory):
    """The ``trainer`` case of ``_torch_mesh_worker`` on four gloo ranks,
    run once for the tests below."""
    from _torch_mesh_worker import run_ranks
    d = tmp_path_factory.mktemp("mesh_trainer")
    run_ranks("trainer", d, timeout=300)
    return d


@pytest.mark.parametrize("compression", [False, True])
def test_mesh_init_places_each_piece_as_it_is_drawn(mesh_trainer,
                                                    compression):
    """Trainer(mesh=(2, 2)).init_state(), with and without the grad
    compression residuals: every leaf bit-equal to the state drawn whole
    and placed (the same placements and local shards), each shard owning
    its storage, and no rank held more than the largest piece of the
    model (a layer, the embedding) whole at once while placing; drawn
    whole and placed, it held the whole state."""
    rows = json.loads((mesh_trainer / "init.json").read_text())
    assert len(rows) == 4
    for r in rows:
        got = r[f"ef={compression}"]
        assert got["equal"] and got["owned"], r
        assert 0 < got["peak"] <= r["largest_piece"] < got["whole"], r


def test_mesh_trainer_resumes_to_the_unsharded_loss(mesh_trainer, tmp_path):
    """Trainer(mesh=(2, 2)) takes 2 steps (a checkpoint each), a second
    one resumes onto the mesh and takes step 3: each loss within 1e-5
    of the unsharded trainer's, whose state each rank shards."""
    from _torch_mesh_worker import trainer_setup
    got = json.loads((mesh_trainer / "trainer.json").read_text())
    cfg, data, make = trainer_setup()
    t = make(cfg, TrainConfig(steps=3, ckpt_dir=str(tmp_path / "one"),
                              ckpt_every=100, log_every=100), data,
             device="cpu")
    t.run()
    want = [m["loss"] for m in t.metrics_log]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_mesh_trainer_takes_micro_batches_under_the_batch_ranks(
        mesh_trainer, tmp_path):
    """Trainer(mesh=(2, 2)) on batches of 2 rows at grad_accum 2, so a
    micro-batch's one row spans 'data' = 2: its first step's loss and
    grad_norm within 1e-5 of the unsharded trainer's."""
    from _torch_mesh_worker import SMALL_BATCH, trainer_setup
    got = json.loads((mesh_trainer / "small.json").read_text())
    cfg, data, make = trainer_setup(rows=SMALL_BATCH)
    t = make(cfg, TrainConfig(steps=1, ckpt_dir=str(tmp_path / "one"),
                              ckpt_every=100, log_every=100), data,
             device="cpu")
    t.run()
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], t.metrics_log[0][k], rtol=1e-5)


def test_mesh_grad_compression_codes_the_global_rows(mesh_trainer):
    """One fp32 step with int8 + error feedback on the (2, 2) mesh
    against the same step unsharded: the loss within 1e-5, each leaf's
    update within 1e-2 relative in L2, and the feedback residuals within
    1e-6 on all but a thousandth of their elements (the blocks are the
    global rows', as the reference's; blocks cut per shard would scale
    every block differently)."""
    got = json.loads((mesh_trainer / "compressed.json").read_text())
    np.testing.assert_allclose(got["loss"][0], got["loss"][1], rtol=1e-5)
    assert got["max_rel_update_l2"] <= 1e-2, got
    assert got["ef_off"] <= got["ef_total"] // 1000, got
    assert got["ef_max"] > 0


def test_mesh_trainer_stops_every_rank_at_one_boundary(mesh_trainer):
    """A stop requested on rank 0 alone inside step 2 (its SIGTERM): the
    ranks agree at the next step boundary, every rank runs 2 steps, and
    one sync checkpoint of step 2 is written."""
    got = json.loads((mesh_trainer / "stop.json").read_text())
    assert got == {"steps_run": 2, "state_step": 2, "checkpoints": [2]}


def test_torchrun_launcher_on_four_cpu_ranks(tmp_path):
    """python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --smoke --mesh debug --device cpu: exits 0
    with the last step's checkpoint written once, by rank 0."""
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", "qwen2-1.5b", "--smoke", "--mesh", "debug",
           "--device", "cpu", "--steps", "2", "--seq", "16", "--batch",
           "8", "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, env=dict(__import__("os").environ,
                                       PYTHONPATH=str(src),
                                       OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("[train] done:") == 4
    from repro_torch.train import checkpoint as ckpt
    assert ckpt.latest_steps(tmp_path) == [2]
