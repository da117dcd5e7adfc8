"""The port's graph layer and resnet_like against the JAX package's.

``fuse_graph`` must fold the same nodes (resnet_like: 11 -> 8, the stem
pool and both residual adds), ``Graph.signature()`` must be the same
string, a warm process must rebuild a plan from the persisted
graph-level cache with zero plan() resolutions, and ``GraphPlan.run``
with weights carried across by ``params_from_numpy`` must match the JAX
package's run (fp32 3e-4, bf16 3e-2 of the output's scale).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (_clear_port_caches, np32,  # noqa: F401
                           ref_params_numpy)
from repro.core import graph as rgraph
from repro.models.cnn import resnet_like as ref_resnet_like
from repro_torch.core import convspec as tcs
from repro_torch.core import graph as tgraph
from repro_torch.models.cnn import params_from_numpy, resnet_like

TOLS = {"float32": 3e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (1, 32, 32, 3),
                                   (4, 32, 32, 3), (1, 224, 224, 3)])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_fusion_and_signatures_match_reference(shape, precision):
    rg = ref_resnet_like(num_classes=4).graph(shape, precision=precision)
    tg = resnet_like(num_classes=4).graph(shape, precision=precision)
    assert len(tg) == len(rg) == 11
    assert tg.signature() == rg.signature()
    rf, rmap = rgraph.fuse_graph(rg, backend="tpu")
    tf, tmap = tgraph.fuse_graph(tg, backend="cuda")
    assert tmap == rmap == {"stem": "pool:pool", "b1c2": "add:b1add",
                            "b2proj": "add:b2add"}
    assert len(tf) == len(rf) == 8
    assert tf.signature() == rf.signature()
    assert tf.shapes == rf.shapes


def test_graph_cache_replay_resolves_nothing():
    shape = (1, 32, 32, 3)
    gp = resnet_like().graph_plan(shape, backend="cuda")
    assert gp.source == "resolved"
    tcs.reset_plan_stats()
    gp2 = resnet_like().graph_plan(shape, backend="cuda")   # fresh memo
    assert gp2.source == "graph_cache"
    assert tcs.PLAN_STATS["resolutions"] == 0
    assert ({n: p.algorithm for n, p in gp2.conv_plans.items()}
            == {n: p.algorithm for n, p in gp.conv_plans.items()})
    # a persisted entry naming an unregistered executor is re-resolved
    key = tgraph._graph_key(gp.base_graph, "cuda")
    entry = tgraph._STORE.get(key)
    entry["algorithms"]["b1c1"] = "winograd_pallas"
    tgraph._STORE.put(key, entry)
    gp3 = resnet_like().graph_plan(shape, backend="cuda")
    assert gp3.source == "resolved"
    # unversioned entries are never decoded
    tgraph._STORE.put(key, {"algorithms": entry["algorithms"]})
    assert resnet_like().graph_plan(shape, backend="cuda").source \
        == "resolved"


def test_explain_covers_every_node_and_names_fusions():
    gp = resnet_like().graph_plan((1, 32, 32, 3), backend="cuda")
    txt = gp.explain()
    assert len(txt.splitlines()) == len(gp.graph) + 1
    for needle in ("fused[pool]=pool", "fused[add]=b1add",
                   "fused[add]=b2add", "cuconv_pallas", "gap", "head"):
        assert needle in txt


def test_warmup_runs_every_conv_node_and_tune_is_not_ported():
    gp = resnet_like().graph_plan((1, 16, 16, 3), backend="cuda")
    rows = gp.warmup(device="cpu")["nodes"]
    assert [r["node"] for r in rows] == [n.name
                                         for n in gp.graph.conv_nodes]
    with pytest.raises(NotImplementedError, match="not ported"):
        gp.warmup(tune="full")


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("batch", [1, 4])
def test_resnet_like_run_matches_reference_with_carried_weights(precision,
                                                                 batch):
    rm, tm = ref_resnet_like(num_classes=5), resnet_like(num_classes=5)
    rparams = rm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(ref_params_numpy(rparams), "cpu")
    x = np.random.default_rng(batch).normal(size=(batch, 32, 32, 3)) \
        .astype(np.float32)
    want = rm.graph_plan(x.shape, backend="cpu", precision=precision).run(
        jax.numpy.asarray(x), rparams)
    gp = tm.graph_plan(x.shape, backend="cuda", precision=precision)
    got = gp.run(torch.from_numpy(x), tparams)
    tol = TOLS["bfloat16" if precision else "float32"]
    want = np32(want)
    assert got.shape == want.shape == (batch, 5)
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))
    # the same through apply(), which plans for the tensor's device
    y = tm.apply(tparams, torch.from_numpy(x), precision=precision)
    np.testing.assert_allclose(np32(y), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def test_init_is_seeded_and_params_match_node_shapes():
    m = resnet_like(num_classes=7)
    a = m.init(3, device="cpu")
    b = m.init(torch.Generator().manual_seed(3), device="cpu")
    assert a.keys() == b.keys() == {"stem", "b1c1", "b1c2", "b2c1", "b2c2",
                                    "b2proj", "head"}
    for n in a:
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k])
    ref = ref_resnet_like(num_classes=7).init(jax.random.PRNGKey(0))
    assert ({n: {k: tuple(v.shape) for k, v in p.items()}
             for n, p in a.items()}
            == {n: {k: tuple(v.shape) for k, v in p.items()}
                for n, p in ref.items()})


def test_run_names_missing_params():
    gp = resnet_like().graph_plan((1, 8, 8, 3), backend="cuda")
    params = resnet_like().init(0, device="cpu")
    del params["b1c1"]
    with pytest.raises(ValueError, match="b1c1"):
        gp.run(torch.zeros(1, 8, 8, 3), params)


def test_precision_policy_matches_reference():
    for pol in ("bf16", tgraph.PrecisionPolicy("bf16", {"stem": "fp32"})):
        t = tgraph.PrecisionPolicy.of(pol)
        r = rgraph.PrecisionPolicy.of(
            pol if isinstance(pol, str)
            else rgraph.PrecisionPolicy("bf16", {"stem": "fp32"}))
        assert t.key() == r.key() and t.dtype_for("stem") == r.dtype_for(
            "stem")
    assert tgraph.PrecisionPolicy().quantizer() is None
    with pytest.raises(ValueError, match="stem0"):
        resnet_like().graph((1, 8, 8, 3), precision=tgraph.PrecisionPolicy(
            "bf16", overrides={"stem0": "fp32"}))
