"""The port's MoE (``repro_torch.nn.moe``) against the JAX package's, on
the CPU at smoke size.

tests/test_moe.py's five tests run on the port; then the same numpy
params and inputs go through both ``moe_fwd``s (params cast to fp32 as
tests/test_moe.py does, the router fp32 in both) and the outputs agree
within 2e-5 and the aux statistics within 1e-6, over the capacity path,
``dropless``, ``n_groups`` and with and without shared experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # deterministic fallback; see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import _clear_port_caches, np32  # noqa: F401
from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.nn import moe as JM
from repro_torch.configs import base as tbase
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M

TOL = dict(rtol=2e-5, atol=2e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)


def _cfgs(E=4, K=2, cf=1.25, shared=None):
    out = []
    for base in (jbase, tbase):
        cfg = base.smoke_variant(base.get_config("deepseek-moe-16b"))
        kw = dict(num_experts=E, experts_per_token=K, capacity_factor=cf)
        if shared is not None:
            kw["num_shared_experts"] = shared
        out.append(dataclasses.replace(cfg, **kw))
    return out


def _cfg(**kw):
    return _cfgs(**kw)[1]


def _params(jcfg, seed=0, dtype=jnp.float32):
    """The reference's moe_init, its bf16 leaves cast to ``dtype``, and
    the same values as port params (fp32 numpy in between)."""
    jp = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16
                      else a, JM.moe_init(jax.random.PRNGKey(seed), jcfg))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            tdt if a.dtype == dtype else torch.float32), jp)
    return jp, tp


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port

def test_dropless_equals_manual_topk(rng):
    """Dropless MoE output == explicit per-token top-k expert mixture."""
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(rng.normal(size=(2, 6, cfg.d_model)).astype(
        np.float32))
    got, _ = M.moe_fwd(p, cfg, x, dropless=True)

    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    gates, eidx = torch.topk(probs, cfg.experts_per_token)
    gates = gates / gates.sum(-1, keepdim=True)
    ex = p["experts"]
    outs = []
    for t in range(xt.shape[0]):
        acc = torch.zeros(cfg.d_model)
        for k in range(cfg.experts_per_token):
            e = int(eidx[t, k])
            h = F.silu(xt[t] @ ex["wi"][e]) * (xt[t] @ ex["wg"][e])
            acc = acc + gates[t, k] * (h @ ex["wo"][e])
        outs.append(acc)
    want = torch.stack(outs).reshape(x.shape)
    if cfg.num_shared_experts:
        want = want + L.mlp_fwd(p["shared"], x)
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-4, atol=1e-4)


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 8), st.integers(1, 3), st.integers(0, 2**31 - 1))
def test_gate_mass_conserved(E, K, seed):
    """Renormalized top-k gates sum to 1 per token (the port's router:
    an identity router weight, so the logits are the inputs)."""
    K = min(K, E)
    cfg = _cfg(E=E, K=K)
    logits = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(1, 10, E)).astype(np.float32))
    _, eidx, gate_te, _, _ = M.dispatch({"router": {"w": torch.eye(E)}},
                                        cfg, logits)
    np.testing.assert_allclose(np32(gate_te.sum(-1)), 1.0, rtol=1e-5)
    assert eidx.shape == (1, 10, K)
    assert int((gate_te > 0).sum()) == 10 * K


def test_capacity_drops_reported(rng):
    """With a tiny capacity factor, dropped_frac must be > 0; with
    dropless it must be 0."""
    jcfg, cfg = _cfgs(cf=0.1)
    _, p = _params(jcfg)
    x = torch.from_numpy(rng.normal(size=(2, 32, cfg.d_model)).astype(
        np.float32))
    _, aux_tight = M.moe_fwd(p, cfg, x, dropless=False)
    _, aux_free = M.moe_fwd(p, cfg, x, dropless=True)
    assert float(aux_tight["dropped_frac"]) > 0.0
    assert float(aux_free["dropped_frac"]) == 0.0


def test_group_invariance_when_dropless(rng):
    """Dropless routing is per-token, so grouping must not change outputs."""
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    x = torch.from_numpy(rng.normal(size=(4, 8, cfg.d_model)).astype(
        np.float32))
    y1, _ = M.moe_fwd(p, cfg, x, dropless=True, n_groups=1)
    y2, _ = M.moe_fwd(p, cfg, x, dropless=True, n_groups=4)
    np.testing.assert_allclose(np32(y1), np32(y2), rtol=1e-4, atol=1e-4)


def test_load_balance_loss_minimized_by_uniform(rng):
    """The aux loss is K at uniform routing and larger when skewed:
    the reference's arithmetic, then through the port's moe_fwd with a
    router that sends every token to experts 0 and 1."""
    E, K = 8, 2
    me = torch.full((E,), 1.0 / E)
    ce = torch.full((E,), K / E)
    skew_me = torch.zeros(E).index_fill_(0, torch.tensor([0]), 1.0)
    skew_ce = torch.zeros(E).index_fill_(0, torch.tensor([0]), float(K))
    assert float(E * torch.sum(skew_me * skew_ce)) > float(
        E * torch.sum(me * ce)) == pytest.approx(K)

    jcfg, cfg = _cfgs(E=E, K=K)
    _, p = _params(jcfg)
    w = torch.zeros((cfg.d_model, E))
    w[:, :2] = 50.0
    p["router"]["w"] = w
    x = torch.from_numpy(np.abs(rng.normal(size=(2, 8, cfg.d_model))).astype(
        np.float32))
    _, aux = M.moe_fwd(p, cfg, x, dropless=True)
    assert float(aux["load_balance_loss"]) > K + 1.0


# ---------------------------------------------------------------------------
# parity with the reference

@pytest.mark.parametrize("dropless,n_groups,shared,cf", [
    (False, 1, None, 1.25), (False, 1, None, 0.5), (True, 1, None, 1.25),
    (False, 2, None, 0.5), (True, 2, 0, 1.25), (False, 1, 0, 0.5),
    (False, 4, None, 0.5)])
def test_moe_fwd_matches_reference(dropless, n_groups, shared, cf, rng):
    """cf 0.5 makes the capacity bind (C = 8 of 32 tokens at n_groups 1)."""
    jcfg, cfg = _cfgs(cf=cf, shared=shared)
    assert bool(cfg.num_shared_experts) == (shared is None)
    jp, tp = _params(jcfg, seed=3)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want, jaux = JM.moe_fwd(jp, jcfg, jnp.asarray(x), dropless=dropless,
                            n_groups=n_groups)
    got, aux = M.moe_fwd(tp, cfg, torch.from_numpy(x), dropless=dropless,
                         n_groups=n_groups)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert set(aux) == set(jaux) == {"load_balance_loss", "dropped_frac"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **AUX_TOL)
    assert (float(aux["dropped_frac"]) > 0.0) == (cf < 1 and not dropless)


def test_moe_fwd_indivisible_groups_fall_back_to_one(rng):
    """n_groups that does not divide the tokens routes in one group, in
    both packages."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    x = rng.normal(size=(1, 9, cfg.d_model)).astype(np.float32)
    want, _ = JM.moe_fwd(jp, jcfg, jnp.asarray(x), n_groups=2)
    got, _ = M.moe_fwd(tp, cfg, torch.from_numpy(x), n_groups=2)
    same, _ = M.moe_fwd(tp, cfg, torch.from_numpy(x), n_groups=1)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert torch.equal(got, same)


def test_capacity_is_the_reference_arithmetic():
    """Each expert's token count C, from dispatch's (ng, E, C) picks."""
    for E, K, cf in ((4, 2, 1.25), (64, 6, 1.25), (16, 2, 0.1), (8, 3, 8.0)):
        cfg = _cfg(E=E, K=K, cf=cf)
        p = {"router": {"w": torch.zeros((cfg.d_model, E))}}
        for G in (1, 7, 32, 2048):
            want = min(max(1, int(cf * G * K / E)), G)
            xg = torch.zeros((1, G, cfg.d_model))
            for dropless, C in ((False, want), (True, G)):
                assert M.dispatch(p, cfg, xg, dropless)[4].shape == (1, E, C)


def test_bf16_params_keep_the_router_fp32(rng):
    """bf16 params: the router leaf stays fp32 through init_lm and
    params_from_numpy (its leaf is named "w", like every dense weight),
    and moe_fwd then matches the reference's bf16 run at the bf16
    bound."""
    jcfg = jbase.smoke_variant(jbase.get_config("deepseek-moe-16b"))
    tcfg = tbase.smoke_variant(tbase.get_config("deepseek-moe-16b"))
    jparams = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    tparams = lm.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams),
        tcfg, device="cpu")
    drawn = lm.init_lm(tcfg, seed=0, device="cpu")
    for params in (tparams, drawn):
        moe = params["segments"][1][0]["pos0"]["moe"]
        assert moe["router"]["w"].dtype == torch.float32
        assert moe["experts"]["wi"].dtype == torch.bfloat16
        assert moe["shared"]["wi"]["w"].dtype == torch.bfloat16
        assert params["segments"][0][0]["pos0"]["mlp"]["wi"]["w"].dtype \
            == torch.bfloat16
    jmoe = jax.tree.map(lambda a: a[0], jparams["segments"][1]["pos0"]["moe"])
    x = torch.from_numpy(rng.normal(size=(2, 8, tcfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    want, jaux = JM.moe_fwd(jmoe, jcfg,
                            jnp.asarray(x.float().numpy(), jnp.bfloat16))
    got, aux = M.moe_fwd(tparams["segments"][1][0]["pos0"]["moe"], tcfg, x)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(np32(want)).max()))
    np.testing.assert_allclose(np32(got), np32(want), rtol=0,
                               atol=3e-2 * scale)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **AUX_TOL)


@pytest.mark.parametrize("dropless", [False, True])
def test_two_calls_are_bit_equal(dropless, rng):
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg, seed=5)
    x = torch.from_numpy(rng.normal(size=(4, 16, cfg.d_model)).astype(
        np.float32))
    a, aux_a = M.moe_fwd(p, cfg, x, dropless=dropless, n_groups=2)
    b, aux_b = M.moe_fwd(p, cfg, x, dropless=dropless, n_groups=2)
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
    assert sum(_build.LAUNCHES.values()) == 0


def test_moe_fwd_is_differentiable(rng):
    """Gradients reach the router, the expert banks, the shared experts
    and the input, as jax.grad's do."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=6)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = JM.moe_fwd(p, jcfg, xx)
        return jnp.sum(out * r) + aux["load_balance_loss"]
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_fwd(tp, cfg, xt)
    loss = torch.sum(out * torch.from_numpy(r)) + aux["load_balance_loss"]
    grads = torch.autograd.grad(loss, leaves + [xt])
    for g, want in zip(grads, jax.tree.leaves(jg) + [jgx]):
        scale = max(1.0, float(np.abs(np32(want)).max()))
        np.testing.assert_allclose(np32(g), np32(want), rtol=2e-4,
                                   atol=2e-5 * scale)
