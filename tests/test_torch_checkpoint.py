"""The port's checkpoints (``train/checkpoint.py``) and gradient codec
(``dist/compress.py``) against the JAX package's.

The fault-tolerance cases mirror ``tests/test_checkpoint.py``.  The
format is the reference's: a checkpoint either package writes restores
in the other with equal arrays, keys and hashes, and a run the JAX
trainer starts, the port's trainer resumes to the JAX trainer's own
result.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, np32  # noqa: F401
from repro.configs import base as jbase
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.dist import compress as JC
from repro.optim import adamw_init as jadamw_init
from repro.train import checkpoint as jckpt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import base as tbase
from repro_torch.data import SyntheticLMData
from repro_torch.dist import compress as TC
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tree import leaves, map_tree


def _tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(
                rng.integers(0, 9, (3,)).astype(np.int32)),
                "c": torch.from_numpy(rng.normal(size=(5,)).astype(
                    np.float32)).to(torch.bfloat16)}}


def _meta(tree):
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_roundtrip(tmp_path, rng):
    t = _tree(rng)
    ckpt.save_checkpoint(tmp_path, 7, t)
    r = ckpt.restore_checkpoint(tmp_path, 7, _meta(t), device="cpu")
    _equal(t, r)
    manifest = json.loads((tmp_path / "step_7" / "manifest.json")
                          .read_text())
    assert manifest["arrays"]["nested/c"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_7" /
                   manifest["arrays"]["nested/c"]["file"]).dtype == np.uint16


def test_latest_and_gc(tmp_path, rng):
    t = _tree(rng)
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, t, keep=3)
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_steps(tmp_path) == [3, 4, 5]     # older GC'd
    assert ckpt.latest_step(tmp_path / "none") is None


def test_corruption_detected(tmp_path, rng):
    t = _tree(rng)
    d = ckpt.save_checkpoint(tmp_path, 1, t)
    manifest = json.loads((d / "manifest.json").read_text())
    fname = manifest["arrays"]["a"]["file"]
    arr = np.load(d / fname)
    arr[0, 0] += 1.0                                   # silent bit-flip
    np.save(d / fname, arr)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore_checkpoint(tmp_path, 1, _meta(t), device="cpu")


def test_restore_refuses_another_tree(tmp_path, rng):
    t = _tree(rng)
    ckpt.save_checkpoint(tmp_path, 1, t)
    extra = dict(_meta(t), d=torch.empty((2,), device="meta"))
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore_checkpoint(tmp_path, 1, extra, device="cpu")
    fewer = {"a": _meta(t)["a"]}
    with pytest.raises(ValueError, match="extra"):
        ckpt.restore_checkpoint(tmp_path, 1, fewer, device="cpu")
    wrong = dict(_meta(t), a=torch.empty((4, 8), device="meta"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(tmp_path, 1, wrong, device="cpu")
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore_checkpoint(tmp_path, 1, _meta(t), device="cpu",
                                shardings={"a": None})


def test_incomplete_checkpoint_ignored(tmp_path, rng):
    """A crash mid-write (tmp dir, no manifest) must be invisible."""
    t = _tree(rng)
    ckpt.save_checkpoint(tmp_path, 3, t)
    (tmp_path / "step_9.tmp").mkdir()                  # simulated crash
    (tmp_path / "step_11").mkdir()                     # no manifest
    assert ckpt.latest_step(tmp_path) == 3


def test_async_checkpoint_copies_before_the_writer_runs(tmp_path, rng):
    """The host copy is taken before save returns: a tensor updated in
    place right after (as the donated train step does) is saved as it
    was."""
    t = _tree(rng)
    want = {"a": t["a"].clone()}
    th = ckpt.save_checkpoint(tmp_path, 2, {"a": t["a"]}, async_=True)
    t["a"].add_(1.0)
    th.join()
    assert ckpt.latest_step(tmp_path) == 2
    _equal(want, ckpt.restore_checkpoint(tmp_path, 2, _meta(want),
                                         device="cpu"))


def _smoke(arch="qwen2-1.5b"):
    return (dataclasses.replace(jbase.smoke_variant(jbase.get_config(arch)),
                                grad_accum=1),
            dataclasses.replace(tbase.smoke_variant(tbase.get_config(arch)),
                                grad_accum=1))


def test_trainer_resume(tmp_path):
    """Kill-and-restart: the second trainer must resume, not restart."""
    _, cfg = _smoke()
    data = SyntheticLMData(cfg.vocab_size, 4, 16)
    tcfg = TrainConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                       ckpt_async=False, log_every=100)
    t1 = Trainer(cfg, tcfg, data, device="cpu")
    t1.run()
    assert ckpt.latest_step(tmp_path) == 4

    tcfg2 = TrainConfig(steps=6, ckpt_every=2, ckpt_dir=str(tmp_path),
                        ckpt_async=False, log_every=100)
    t2 = Trainer(cfg, tcfg2, data, device="cpu")
    start = t2.resume_or_init()
    assert start == 4                                   # resumed, not 0
    _equal(t1.state, t2.state)                          # bit for bit
    t2.state = None
    t2.run()
    assert ckpt.latest_step(tmp_path) == 6


# ---------------------------------------------------------------------------
# gradient compression: the codec against the reference, bit for bit

def test_quantize_matches_reference_and_error_bounded(rng):
    x = (rng.normal(size=(1000,)) * 3).astype(np.float32)
    x[256:512] = 0.0                                   # an all-zero block
    jq, js, jshape = JC.quantize(jnp.asarray(x))
    q, s, shape = TC.quantize(torch.from_numpy(x))
    assert shape == jshape and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    deq = TC.dequantize(q, s, shape)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(JC.dequantize(jq, js, jshape)))
    # int8 symmetric: per-block error <= scale/2 = max|block|/254
    err = np.abs(deq.numpy() - x)
    assert err.max() <= np.abs(x).max() / 254 + 1e-6


def test_error_feedback_matches_reference_and_converges(rng):
    """Fifty EF steps in both packages: the same residual bits every
    step; the sum of compressed gradients tracks the true sum."""
    g = (rng.normal(size=(256, 3)) * 0.01).astype(np.float32)
    jerr, terr = jnp.zeros_like(jnp.asarray(g)), torch.zeros(g.shape)
    total = torch.zeros(g.shape)
    for _ in range(50):
        (jq, js, jsh), jerr = JC.quantize_with_feedback(jnp.asarray(g), jerr)
        (q, s, sh), terr = TC.quantize_with_feedback(torch.from_numpy(g),
                                                     terr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
        total = total + TC.dequantize(q, s, sh)
    drift = np.abs(total.numpy() - 50 * g).max()
    assert drift <= np.abs(g).max() / 100


def test_tree_codec_codes_the_reference_stacked_leaves(rng):
    """A layer's leaf is a row of the reference's stacked array: the
    rows are coded together (a block spans two layers), equal to the
    reference's per-leaf codec on the stacked tree bit for bit."""
    R = 3
    jg = {"final": jnp.asarray(rng.normal(size=(70,)), jnp.float32),
          "segments": [{"pos0": {"s": jnp.asarray(
              rng.normal(size=(R, 100)), jnp.float32).astype(jnp.bfloat16)}}]}
    je = jax.tree.map(lambda a: 0.01 * jnp.ones(a.shape, jnp.float32), jg)
    jd, jne = JC.tree_quantize_with_feedback(jg, je)

    def port(tree):
        conv = lambda a: torch.from_numpy(np.array(
            a.astype(jnp.float32))).to(torch.bfloat16 if a.dtype ==
                                       jnp.bfloat16 else torch.float32)
        return {"final": conv(tree["final"]),
                "segments": [[{"pos0": {"s": conv(
                    tree["segments"][0]["pos0"]["s"][r])}}
                    for r in range(R)]]}
    td, tne = TC.tree_quantize_with_feedback(port(jg), port(je))
    for got, want in ((td, jd), (tne, jne)):
        np.testing.assert_array_equal(np32(got["final"]),
                                      np.asarray(want["final"]))
        for r in range(R):
            np.testing.assert_array_equal(
                np32(got["segments"][0][r]["pos0"]["s"]),
                np.asarray(want["segments"][0]["pos0"]["s"][r]))
    feedback = TC.init_feedback(port(jg))
    assert feedback["segments"][0][1]["pos0"]["s"].dtype == torch.float32


# ---------------------------------------------------------------------------
# parity trap: one format for both packages

class _Fp32JTrainer(JTrainer):
    """The JAX trainer on fp32 params (the reference's default is bf16):
    the state it starts from and the like-tree it restores into."""

    def init_state(self):
        s = super().init_state()
        p = jax.tree.map(lambda a: a.astype(jnp.float32)
                         if a.dtype == jnp.bfloat16 else a, s["params"])
        return {"params": p, "opt": jadamw_init(p), "step": s["step"]}


class _Fp32Trainer(Trainer):
    """The port's trainer on fp32 params, as ``_Fp32JTrainer``."""

    def init_state(self, device=None):
        s = super().init_state(device)
        p = map_tree(lambda t: t.float(), s["params"])
        return {"params": p, "opt": adamw_init(p), "step": s["step"]}


def _manifest(d):
    return json.loads((d / "manifest.json").read_text())["arrays"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_jax_checkpoint_restores_in_the_port_and_back(dtype, tmp_path):
    """The JAX trainer's step-2 checkpoint restores into the port's
    state (a norm scale of a layer is row r of the reference's (R, D)
    array); saved again by the port it has the same keys, files, shapes,
    dtypes and hashes, and the JAX package restores the port's copy to
    the same arrays."""
    jcfg, tcfg = _smoke()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    data = JSyntheticLMData(jcfg.vocab_size, 4, 16)
    jt = (_Fp32JTrainer if dtype == "float32" else JTrainer)(
        jcfg, JTrainConfig(steps=2, ckpt_every=2, ckpt_dir=str(jdir),
                           ckpt_async=False, log_every=100), data)
    jt.run()
    tt = (_Fp32Trainer if dtype == "float32" else Trainer)(
        tcfg, TrainConfig(steps=2, ckpt_dir=str(jdir)), data, device="cpu")
    assert tt.resume_or_init() == 2
    want = jt.state["params"]["segments"][0]["pos0"]["ln1"]["scale"]
    for r in range(want.shape[0]):
        np.testing.assert_array_equal(
            np32(tt.state["params"]["segments"][0][r]["pos0"]["ln1"]
                 ["scale"]), np.asarray(want[r]))
    assert tt.state["params"]["embed"]["embedding"].dtype == getattr(
        torch, dtype)
    ckpt.save_checkpoint(tdir, 2, tt.state)
    assert _manifest(tdir / "step_2") == _manifest(jdir / "step_2")
    like = jax.eval_shape(jt.init_state)
    back = jckpt.restore_checkpoint(tdir, 2, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt.state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # load_numpy: the params as params_from_numpy takes them
    tree = ckpt.load_numpy(jdir, 2)
    assert sorted(tree) == ["opt", "params", "step"]
    p = lm.params_from_numpy(tree["params"], tcfg, device="cpu",
                             dtype=getattr(torch, dtype))
    _equal(p, tt.state["params"])
    assert list(ckpt.load_numpy(jdir, 2, prefix="params")) == ["params"]


def test_a_port_checkpoint_restores_in_the_jax_package(tmp_path):
    """The port's trainer (bf16, grad compression on, so ef/... too)
    checkpoints; the JAX package restores it into its own trainer's
    like-tree with every leaf equal."""
    jcfg, tcfg = _smoke()
    data = SyntheticLMData(tcfg.vocab_size, 4, 16)
    tt = Trainer(tcfg, TrainConfig(steps=2, ckpt_every=2,
                                   ckpt_dir=str(tmp_path), ckpt_async=True,
                                   grad_compression=True), data,
                 device="cpu")
    tt.run()
    jt = JTrainer(jcfg, JTrainConfig(steps=2, ckpt_dir=str(tmp_path),
                                     grad_compression=True), data)
    assert jt.resume_or_init() == 2
    manifest = _manifest(tmp_path / "step_2")
    assert "params/segments/0/pos0/ln1/scale" in manifest
    assert any(k.startswith("ef/segments/0/pos0/") for k in manifest)
    assert manifest["params/segments/0/pos0/ln1/scale"]["shape"] == [
        tcfg.num_layers, tcfg.d_model]
    tree = ckpt.load_numpy(tmp_path, 2)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jt.state):
        node = tree
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      np.asarray(node, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    assert int(jt.state["step"]) == 2


def test_the_port_resumes_a_jax_run(tmp_path):
    """The JAX trainer takes 2 fp32 steps at peak lr 3e-3 and
    checkpoints; the port's trainer resumes from its directory to step
    4; the masters equal the JAX trainer's own uninterrupted step 4
    within 1e-5, and each leaf's update over steps 3-4 is within 1e-2 of
    its own in relative L2 (a resume that lost the moments moves them by
    about half)."""
    jcfg, tcfg = _smoke()
    lr = 3e-3
    data = JSyntheticLMData(jcfg.vocab_size, 4, 16)
    first = _Fp32JTrainer(jcfg, JTrainConfig(
        steps=2, ckpt_every=2, ckpt_dir=str(tmp_path / "run"),
        ckpt_async=False, log_every=100, peak_lr=lr), data)
    first.run()
    port = _Fp32Trainer(tcfg, TrainConfig(steps=4, ckpt_every=2,
                                          ckpt_dir=str(tmp_path / "run"),
                                          log_every=100, peak_lr=lr),
                        SyntheticLMData(tcfg.vocab_size, 4, 16),
                        device="cpu")
    port.run()
    whole = _Fp32JTrainer(jcfg, JTrainConfig(
        steps=4, ckpt_every=100, ckpt_dir=str(tmp_path / "whole"),
        ckpt_async=False, log_every=100, peak_lr=lr), data)
    whole.run()
    assert [m["step"] for m in port.metrics_log] == [2, 3]
    for got, want in zip(port.metrics_log, whole.metrics_log[2:]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["lr"] == want["lr"]
    assert ckpt.latest_steps(tmp_path / "run") == [2, 4]
    back = ckpt.load_numpy(tmp_path / "run", 4)
    mid = ckpt.load_numpy(tmp_path / "run", 2)
    for path, want in jax.tree_util.tree_leaves_with_path(
            whole.state["opt"]["master"]):
        node, start = back["opt"]["master"], mid["opt"]["master"]
        for k in path:
            k = getattr(k, "key", getattr(k, "idx", None))
            node, start = node[k], start[k]
        want = np.asarray(want)
        np.testing.assert_allclose(node, want, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
        d = np.linalg.norm(want - start)
        assert d > 0
        assert np.linalg.norm(node - want) <= 1e-2 * d, (
            jax.tree_util.keystr(path), np.linalg.norm(node - want) / d)
    assert int(back["step"]) == 4


# ---------------------------------------------------------------------------
# on a (2, 2) mesh of four gloo processes

@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory):
    """The ``ckpt`` case of ``_torch_mesh_worker``: compressed_psum's
    inputs (four rows and their residuals) and a JAX trainer's step-2
    checkpoint go in; the ranks run once."""
    from _torch_mesh_worker import run_ranks
    d = tmp_path_factory.mktemp("mesh_ckpt")
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 600)) * 2).astype(np.float32)
    err = (rng.normal(size=(4, 600)) * 1e-2).astype(np.float32)
    np.savez(d / "psum_in.npz", x=x, err=err)
    jcfg, _ = _smoke()
    jt = JTrainer(jcfg, JTrainConfig(steps=2, ckpt_every=2,
                                     ckpt_dir=str(d / "jax"),
                                     ckpt_async=False, log_every=100),
                  JSyntheticLMData(jcfg.vocab_size, 4, 16))
    jt.run()
    run_ranks("ckpt", d, timeout=300)
    return d, x, err


def test_compressed_psum_matches_the_reference_codec_sum(mesh_ckpt):
    """compressed_psum over a 4-rank mesh axis: the all-reduce of each
    rank's payload equals the sum of the reference's
    dequantize(quantize_with_feedback(x_i, e_i)) over the four rows
    (fp32 sums, in any order: 1e-6 relative), and each rank's new
    residual is the reference's bit for bit; within 2% of the exact
    sum, as the reference's own psum test holds it."""
    d, x, err = mesh_ckpt
    out = np.load(d / "psum_out.npz")
    deqs, errs = [], []
    for i in range(4):
        (q, s, shape), ne = JC.quantize_with_feedback(jnp.asarray(x[i]),
                                                      jnp.asarray(err[i]))
        deqs.append(np.asarray(JC.dequantize(q, s, shape)))
        errs.append(np.asarray(ne))
    want = np.sum(deqs, axis=0)
    np.testing.assert_allclose(out["sum"], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out["err"], np.stack(errs))
    exact = (x + err).sum(0)
    assert np.abs(out["sum"] - exact).max() / np.abs(exact).max() < 0.02


def test_compressed_psum_on_one_rank_is_the_codec(tmp_path, rng):
    """A world of one rank: the sum is dequantize(quantize_with_feedback)
    bit for bit; a mesh of two dims is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    x = torch.from_numpy(rng.normal(size=(3, 300)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(3, 300)).astype(np.float32))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out, ne = TC.compressed_psum(x, None, e)
        (q, s, shape), want_e = TC.quantize_with_feedback(x, e)
        assert torch.equal(out, TC.dequantize(q, s, shape))
        assert torch.equal(ne, want_e)
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("a", "b"))
        assert torch.equal(TC.compressed_psum(x, mesh["a"], e)[0], out)
        with pytest.raises(ValueError, match="one mesh axis"):
            TC.compressed_psum(x, mesh, e)
    finally:
        dist.destroy_process_group()


def test_elastic_restore_onto_another_mesh_and_none(mesh_ckpt):
    """A (2, 2) trainer's checkpoint restores onto (4, 1) and onto no
    mesh bit-equal to the state it saved, and the JAX trainer's
    checkpoint restores onto the (2, 2) mesh (each rank its shards)
    equal to its restore without a mesh (the ranks check; rank 0 marks
    it done)."""
    d, _, _ = mesh_ckpt
    assert (d / "ckpt_ok").read_text() == "ok"
    tree = ckpt.load_numpy(d / "elastic", 1)
    assert int(tree["step"]) == 1
    assert sorted(tree) == ["opt", "params", "step"]
