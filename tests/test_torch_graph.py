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
    entry["algorithms"]["b1c1"] = "flash_attention"
    tgraph._STORE.put(key, entry)
    gp3 = resnet_like().graph_plan(shape, backend="cuda")
    assert gp3.source == "resolved"
    # unversioned entries are never decoded
    tgraph._STORE.put(key, {"algorithms": entry["algorithms"]})
    assert resnet_like().graph_plan(shape, backend="cuda").source \
        == "resolved"


def test_graph_cache_entry_of_other_plan_rules_is_re_resolved():
    """An entry persisted under older placement rules names algorithms
    that are still capable (plain ``winograd`` for an unfused 3x3) but
    no longer chosen: it is re-resolved, and the new entry replays."""
    shape = (4, 32, 32, 3)
    gp = resnet_like().graph_plan(shape, backend="cuda")
    key = tgraph._graph_key(gp.base_graph, "cuda")
    entry = tgraph._STORE.get(key)
    assert entry["rules"] == tgraph.PLAN_RULES
    old = dict(entry, rules=tgraph.PLAN_RULES - 1,
               algorithms=dict(entry["algorithms"], b1c1="winograd"))
    tgraph._STORE.put(key, old)
    tgraph.clear_cache()
    tcs.reset_plan_stats()
    gp2 = resnet_like().graph_plan(shape, backend="cuda")
    assert gp2.source == "resolved"
    assert tcs.PLAN_STATS["resolutions"] == len(gp2.conv_plans)
    assert gp2.conv_plans["b1c1"].algorithm == "winograd_pallas"
    assert tgraph._STORE.get(key)["rules"] == tgraph.PLAN_RULES
    tgraph.clear_cache()
    tcs.reset_plan_stats()
    gp3 = resnet_like().graph_plan(shape, backend="cuda")
    assert gp3.source == "graph_cache"
    assert tcs.PLAN_STATS["resolutions"] == 0
    assert ({n: p.algorithm for n, p in gp3.conv_plans.items()}
            == {n: p.algorithm for n, p in gp.conv_plans.items()})


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
    # tuning a plan made for the card on the CPU is refused
    with pytest.raises(ValueError, match="backend"):
        gp.warmup(tune="full", device="cpu")


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


# ---------------------------------------------------------------------------
# the planner at the shapes of this slice's paths

# The port's Winograd kernel stages at most 54 KB of shared memory, so no
# launch config is pruned by its budget; the reference's 12 MB VMEM
# budget prunes F(4,3) at (tt, tm, tc) = (256, 128, 128) for resnet50's
# 28x28x128 layer, so there the two default configs differ (chip_smoke
# forces the reference's).  No config the reference picks is pruned by
# the port.
CONFIG_DIFFS = {(28, 3, 128, 128): ({"m": 2, "tt": 256, "tm": 128,
                                     "tc": 128},
                                    {"m": 4, "tt": 256, "tm": 128,
                                     "tc": 128})}


@pytest.mark.parametrize("layer", [(56, 3, 64, 64), (28, 3, 128, 128)])
def test_resnet50_3x3_layers_plan_to_winograd_like_reference(layer):
    from repro.core import convspec as rcs
    hw, k, m, c = layer
    r = rcs.plan(rcs.ConvSpec((8, hw, hw, c), (k, k, c, m), padding=(1, 1)),
                 backend="tpu")
    t = tcs.plan(tcs.ConvSpec((8, hw, hw, c), (k, k, c, m), padding=(1, 1)),
                 backend="cuda")
    assert t.algorithm == r.algorithm == "winograd_pallas"
    assert t.source == r.source == "heuristic"
    want = CONFIG_DIFFS.get(layer, (r.config.as_dict(),) * 2)
    assert (r.config.as_dict(), t.config.as_dict()) == want
    ex = t.executor
    assert ex.config_supports(t.spec, want[0])[0]   # the port can run it


SERVED = [((32, 32, 3), (1, 4)), ((224, 224, 3), (1,))]


def test_served_plans_choose_the_reference_algorithms():
    """Every served node plans to the reference's executor at
    ``backend="tpu"``; only b1c1 at batch 4 changed from the first slice
    (cuDNN by cost then, winograd_pallas now)."""
    for shape, buckets in SERVED:
        for b in buckets:
            r = ref_resnet_like().graph_plan((b,) + shape, backend="tpu")
            t = resnet_like().graph_plan((b,) + shape, backend="cuda")
            got = {n: p.algorithm for n, p in t.conv_plans.items()}
            assert got == {n: p.algorithm for n, p in r.conv_plans.items()}
            for n, algo in got.items():
                assert algo == ("winograd_pallas"
                                if (n, b, shape[0]) == ("b1c1", 4, 32)
                                else "cuconv_pallas"), (n, b, shape)


def test_no_served_bucket_runs_a_conv_node_on_a_library_executor():
    """The CPU twin of chip_smoke's check: every non-grouped conv node of
    every served bucket, fp32 and int8, plans (for the card) onto a
    hand-written kernel."""
    from repro_torch.quant import Calibrator, QuantPolicy
    m = resnet_like()
    params = m.init(0, device="cpu")
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)) \
        .astype(np.float32)
    m.graph_plan(x.shape).warmup(device="cpu",
                                 calibrate=Calibrator(x, params))
    checked = 0
    for shape, buckets in SERVED:
        for b in buckets:
            for pol in (None, QuantPolicy()):
                if pol is not None and shape[0] != 32:
                    continue           # int8 is calibrated at 32x32
                gp = m.graph_plan((b,) + shape, backend="cuda",
                                  precision=pol)
                library = {n: p.algorithm
                           for n, p in gp.conv_plans.items()
                           if p.spec.groups == 1
                           and not p.executor.kernels}
                assert not library, (shape, b, pol, library)
                checked += len(gp.conv_plans)
    assert checked == 5 * 6


def test_warmup_calibrates_then_runs_every_node():
    from repro_torch.quant import Calibrator, QuantPolicy
    m = resnet_like()
    params = m.init(0, device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 3)) \
        .astype(np.float32)
    out = m.graph_plan(x.shape).warmup(device="cpu",
                                       calibrate=Calibrator(x, params))
    assert sorted(out["calibration"]) == sorted(
        n.name for n in m.graph(x.shape).conv_nodes)
    assert len(out["nodes"]) == 6
    gq = m.graph_plan(x.shape, precision=QuantPolicy())
    assert {n for n, q in gq.quant.items() if q.quantized} == {
        "b1c1", "b1c2", "b2c1", "b2c2"}
    rows = gq.warmup(device="cpu")["nodes"]
    assert [r["algorithm"] for r in rows].count("cuconv_int8") == 4
