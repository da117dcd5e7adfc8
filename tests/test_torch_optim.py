"""Parity of the port's optimizer (``optim/``) with the JAX package's.

The schedule is held to the reference's jitted train step bit for bit;
AdamW runs on a random tree in the reference's stacked layout (the
port's per-layer lists on its side) at 1e-6.  Weight decay follows the
reference's stacked shapes: a per-layer norm scale decays in both
packages, ``final_norm.scale`` in neither.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, np32  # noqa: F401
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import cosine_schedule

R, D, F = 3, 8, 12


@pytest.mark.parametrize("kw", [
    {},
    dict(peak_lr=1.0, warmup_steps=10, total_steps=100),
    dict(peak_lr=3e-3, warmup_steps=7, total_steps=1000, min_ratio=0.05)])
def test_cosine_schedule_bit_for_bit(kw):
    """Steps 0-12,000 through the reference's jitted schedule (what its
    train step computes) and the port's: equal float32 bits."""
    steps = np.arange(0, 12001, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jcosine(s, **kw)))(
        jnp.asarray(steps)))
    got = np.array([cosine_schedule(int(s), **kw).item() for s in steps],
                   np.float32)
    np.testing.assert_array_equal(got, want)
    # the step may be a 0-d tensor, as state["step"] is
    assert cosine_schedule(torch.tensor(57, dtype=torch.int32),
                           **kw).item() == want[57]


def test_cosine_schedule_shape_and_eager_reference():
    """The reference's own schedule test on the port, and the eager
    reference (which divides where the jitted one multiplies by the
    reciprocal) within a float32 ulp."""
    lr0 = float(cosine_schedule(0, peak_lr=1.0, warmup_steps=10,
                                total_steps=100))
    lr_peak = float(cosine_schedule(10, peak_lr=1.0, warmup_steps=10,
                                    total_steps=100))
    lr_end = float(cosine_schedule(99, peak_lr=1.0, warmup_steps=10,
                                   total_steps=100, min_ratio=0.1))
    assert lr0 < 0.2 and abs(lr_peak - 1.0) < 1e-5 and lr_end < 0.15
    for s in (0, 5, 99, 100, 101, 4321, 9999, 10000, 11000):
        np.testing.assert_allclose(cosine_schedule(s).item(),
                                   float(jcosine(s)), rtol=2.4e-7)
    assert cosine_schedule(3).dtype == torch.float32


def _ref_tree(rng, dtype):
    """A tree in the reference's stacked layout: an embedding, one
    segment of R layers (a norm scale (R, D), a bias (R, F), a weight
    (R, D, F)) and a final norm (D,)."""
    def a(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return jnp.asarray(x).astype(dtype)
    return {"embed": {"embedding": a(16, D)},
            "segments": [{"pos0": {"ln1": {"scale": a(R, D)},
                                   "mlp": {"b": a(R, F), "w": a(R, D, F)}}}],
            "final_norm": {"scale": a(D)}}


def _to_port(tree):
    """The reference's stacked tree -> the port's (a list of repeats per
    segment), as torch tensors of the same dtype."""
    def conv(x):
        t = torch.from_numpy(np.array(x.astype(jnp.float32)))
        return t.to(torch.bfloat16 if x.dtype == jnp.bfloat16
                    else torch.float32)

    def unstack(node, r):
        if isinstance(node, dict):
            return {k: unstack(v, r) for k, v in node.items()}
        return conv(node[r])
    out = {k: jax.tree.map(conv, v) for k, v in tree.items()
           if k != "segments"}
    out["segments"] = [[unstack(seg, r) for r in range(R)]
                       for seg in tree["segments"]]
    return out


def _ref_layout(tree):
    """The port's tree back in the reference's stacked layout (numpy)."""
    out = {k: jax.tree.map(np32, v) for k, v in tree.items()
           if k != "segments"}
    out["segments"] = [jax.tree.map(lambda *rs: np.stack([np32(r)
                                                          for r in rs]), *seg)
                       for seg in tree["segments"]]
    return out


def _assert_trees_close(got, want, **tol):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("donate", [False, True])
def test_adamw_update_matches_reference(dtype, donate, rng):
    """One update from a non-initial state (step 5, random moments, the
    clip active): new params, master, m and v within 1e-6, grad_norm
    within 2e-5 relative; the params keep their dtype."""
    jp = _ref_tree(rng, dtype)
    jg = jax.tree.map(lambda a: a * 3.0, _ref_tree(rng, dtype))
    jopt = {"master": jax.tree.map(lambda a: a.astype(jnp.float32), jp),
            "m": jax.tree.map(lambda a: 0.1 * a.astype(jnp.float32),
                              _ref_tree(rng, "float32")),
            "v": jax.tree.map(lambda a: 0.01 * jnp.square(a),
                              _ref_tree(rng, "float32"))}
    step, lr = jnp.asarray(5, jnp.int32), 1e-3
    want_p, want_opt, want_m = jadamw.adamw_update(jp, jg, jopt, step, lr)

    tp, tg = _to_port(jp), _to_port(jg)
    topt = {k: _to_port(v) for k, v in jopt.items()}
    got_p, got_opt, got_m = tadamw.adamw_update(
        tp, tg, topt, torch.tensor(5, dtype=torch.int32), lr, donate=donate)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=2e-5)
    assert float(want_m["grad_norm"]) > 1.0          # the clip is active
    tol = dict(rtol=1e-6, atol=1e-6)
    for k in ("master", "m", "v"):
        _assert_trees_close(_ref_layout(got_opt[k]), want_opt[k], **tol)
    # params: the master cast to their dtype (one bf16 rounding apart)
    _assert_trees_close(_ref_layout(got_p), want_p,
                        **(tol if dtype == "float32"
                           else dict(rtol=8e-3, atol=1e-6)))
    for t in jax.tree.leaves(got_p):
        assert t.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16)
    if donate:          # updated in place
        assert got_p["final_norm"]["scale"] is tp["final_norm"]["scale"]
        assert got_opt["m"]["embed"]["embedding"] is \
            topt["m"]["embed"]["embedding"]
    else:               # the inputs are left as they were
        np.testing.assert_array_equal(np32(tp["final_norm"]["scale"]),
                                      np.asarray(jp["final_norm"]["scale"],
                                                 np.float32))
        np.testing.assert_array_equal(
            np32(topt["m"]["embed"]["embedding"]),
            np.asarray(jopt["m"]["embed"]["embedding"]))


def test_weight_decay_follows_the_reference_stacked_shape(rng):
    """Parity trap: with zero gradients and moments an update is the
    decay alone, lr * wd * master.  In the reference every per-layer
    leaf is stacked (R, ...) and decays, its norm scales and biases
    included; only the 1-d final norm does not.  The port's per-layer
    leaves are 1-d too and must decay all the same."""
    jp = _ref_tree(rng, "float32")
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jopt = {"master": jp, "m": zeros, "v": zeros}
    lr, wd = 1e-2, 0.1
    want_p, _, _ = jadamw.adamw_update(jp, zeros, jopt,
                                       jnp.asarray(0, jnp.int32), lr)
    tp = _to_port(jp)
    got_p, _, _ = tadamw.adamw_update(
        tp, _to_port(zeros), {"master": _to_port(jp), "m": _to_port(zeros),
                 "v": _to_port(zeros)}, 0, lr)
    got = _ref_layout(got_p)
    for name, path in (("layer norm", ("segments", 0, "pos0", "ln1",
                                       "scale")),
                       ("layer bias", ("segments", 0, "pos0", "mlp", "b")),
                       ("final norm", ("final_norm", "scale"))):
        w, g, p0 = want_p, got, jp
        for k in path:
            w, g, p0 = w[k], g[k], p0[k]
        p0 = np.asarray(p0)
        decayed = name != "final norm"
        expect = p0 * (1 - lr * wd) if decayed else p0
        np.testing.assert_allclose(np.asarray(w), expect, rtol=1e-6,
                                   err_msg=f"reference, {name}")
        np.testing.assert_allclose(g, expect, rtol=1e-6,
                                   err_msg=f"port, {name}")
    # a 1-d leaf of a layer in the port decays: it stands for a 2-d array
    assert tp["segments"][0][0]["pos0"]["ln1"]["scale"].dim() == 1


def test_global_norm_and_init_match_reference(rng):
    jp = _ref_tree(rng, "bfloat16")
    tp = _to_port(jp)
    np.testing.assert_allclose(float(tadamw.global_norm(tp)),
                               float(jadamw.global_norm(jp)), rtol=2e-5)
    f32 = _to_port(_ref_tree(np.random.default_rng(1), "float32"))
    opt = tadamw.adamw_init(f32)
    leaf = f32["final_norm"]["scale"]
    master = opt["master"]["final_norm"]["scale"]
    assert master.dtype == torch.float32
    assert master.data_ptr() != leaf.data_ptr()     # a copy, not an alias
    assert not opt["m"]["segments"][0][2]["pos0"]["mlp"]["w"].any()
    v = opt["v"]["segments"][0][1]["pos0"]["ln1"]["scale"]
    assert v.dtype == torch.float32


def test_grad_clip_off_and_on(rng):
    """grad_clip=0 leaves the gradient unscaled; a small gradient is not
    scaled up by the clip."""
    jp = _ref_tree(rng, "float32")
    jg = jax.tree.map(lambda a: 1e-3 * a, _ref_tree(rng, "float32"))
    jopt = jadamw.adamw_init(jp)
    for clip in (0.0, 1.0, 1e-4):
        want, wopt, _ = jadamw.adamw_update(jp, jg, jopt,
                                            jnp.asarray(2, jnp.int32), 1e-2,
                                            grad_clip=clip)
        got, gopt, _ = tadamw.adamw_update(
            _to_port(jp), _to_port(jg), tadamw.adamw_init(_to_port(jp)), 2,
            1e-2, grad_clip=clip)
        _assert_trees_close(_ref_layout(gopt["m"]), wopt["m"], rtol=1e-6,
                            atol=1e-9)
        _assert_trees_close(_ref_layout(got), want, rtol=1e-6, atol=1e-7)


def test_global_norm_is_accurate_over_a_large_leaf():
    """A leaf of 2**24 elements (qwen2-1.5b's embedding holds 233 M): the
    norm within 1e-6 of the float64 one on the CPU, where the library's
    norm kernel sums in one fp32 accumulator."""
    x = torch.randn(1 << 24, generator=torch.Generator().manual_seed(0))
    x[:64] *= 1e3
    want = float(torch.linalg.vector_norm(x.double()))
    got = float(tadamw.global_norm({"w": x, "b": x[:5].clone()}))
    want = (want ** 2 + float(x[:5].double().square().sum())) ** 0.5
    assert abs(got - want) <= 1e-6 * want
