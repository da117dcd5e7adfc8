"""Where the planner puts conv nodes on the card (backend ``"cuda"``).

ResNet-50 and GoogLeNet at 224x224 (the node lists of
``bench/configs/``), at buckets 1, 2, 4, 8 and 64: every conv node plans
onto an executor that launches the port's kernels, the overlapping 3x3/2
max pools after the stems and GoogLeNet's ``conv3`` stay nodes of their
own (no kernel fuses them; folded, they kept the conv on cuDNN or plain
PyTorch), and ``GraphPlan.placement()`` counts exactly that.
``resnet_like``'s 2x2/2 pool, which ``cuconv_fused`` fuses, still folds.
The unit-stride 5x5 convs claim the fused kernel; the 3x3s stay in
Winograd's region.  ``BucketPrograms.warmup`` records each bucket's
placement in a tracing ``Telemetry``.
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from _torch_parity import _clear_port_caches  # noqa: F401
from repro_torch.core import convspec as tcs
from repro_torch.core import executors
from repro_torch.core import graph as tgraph
from repro_torch.core.graph import ConvOp, GraphBuilder, PoolOp
from repro_torch.models.cnn import GraphModel, resnet_like
from repro_torch.serve import frontend as tfe

CONFIGS = Path(__file__).resolve().parents[1] / "bench" / "configs"
BUCKETS = (1, 2, 4, 8, 64)
# the pools left beside their conv: 3x3/2 with padding 1, which windows
# overlap and no kernel fuses
UNFOLDED = {"resnet50-fp32": ["pool1"], "googlenet-fp32": ["pool1", "pool2"]}
FIVE_BY_FIVE = ("i3ab3", "i3bb3", "i4ab3", "i4bb3", "i4cb3", "i4db3",
                "i4eb3", "i5ab3", "i5bb3")


def _model(name: str) -> GraphModel:
    """A node list as ``GraphBuilder`` calls: a conv's bias and ``act``
    are its epilogue."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())

    def build(in_shape, dtype):
        b = GraphBuilder(in_shape, dtype)
        for n in cfg["nodes"]:
            op, name, src = n["op"], n["name"], n["in"]
            if op == "conv":
                b.conv(name, src, n["k"], n["out"], stride=n.get("stride", 1),
                       padding=n.get("pad", 0),
                       epilogue="bias_relu" if n["act"] == "relu" else "bias")
            elif op == "pool":
                b.pool(name, src, kind=n["kind"], window=n["k"],
                       stride=n.get("stride", 1), padding=n.get("pad", 0))
            elif op == "add":
                b.add(name, src, activation=n.get("act", "none"))
            elif op == "concat":
                b.concat(name, src)
            elif op == "gap":
                b.gap(name, src)
            else:
                b.dense(name, src, n["out"])
        return b.graph()
    return GraphModel(build, tuple(cfg["image"]), name=cfg["name"])


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("name", sorted(UNFOLDED))
def test_every_conv_node_plans_onto_a_port_kernel(name, bucket):
    gp = _model(name).graph_plan((bucket, 224, 224, 3), backend="cuda")
    off = {n: (p.algorithm, p.reason) for n, p in gp.conv_plans.items()
           if not p.executor.kernels}
    assert not off, off
    assert not [v for v in gp.fused.values() if v.startswith("pool:")]
    pools = [n.name for n in gp.graph.nodes if isinstance(n, PoolOp)
             and tuple(n.window) == (3, 3) and tuple(n.stride) == (2, 2)]
    assert pools[:len(UNFOLDED[name])] == UNFOLDED[name]
    convs = len(gp.graph.conv_nodes)
    assert gp.placement() == {"kernel": convs, "library": 0, "plain": 0,
                              "pools_unfolded": UNFOLDED[name]}
    assert (f"placement=kernel:{convs},library:0,plain:0 pools_unfolded="
            f"{','.join(UNFOLDED[name])}") in gp.explain().splitlines()[0]
    # the stems on the fused kernel by the strided claim
    stem = gp.conv_plans["conv1"]
    assert (stem.algorithm, stem.reason) == (
        "cuconv_pallas", "strided conv: fused kernel on the card")
    if name == "googlenet-fp32":
        want = "winograd_pallas" if bucket > 1 else "cuconv_pallas"
        assert gp.conv_plans["conv3"].algorithm == want
        for n in FIVE_BY_FIVE:
            assert gp.conv_plans[n].algorithm == "cuconv_pallas", n


@pytest.mark.parametrize("name,bucket,want", [
    # (F cuconv_fused, W winograd_fused) at every bucket
    ("resnet50-fp32", 1, (53, 0)), ("resnet50-fp32", 8, (47, 6)),
    ("resnet50-fp32", 64, (40, 13)), ("googlenet-fp32", 1, (57, 0)),
    ("googlenet-fp32", 8, (54, 3)), ("googlenet-fp32", 64, (47, 10))])
def test_plan_table_counts(name, bucket, want):
    gp = _model(name).graph_plan((bucket, 224, 224, 3), backend="cuda")
    algos = [p.algorithm for p in gp.conv_plans.values()]
    assert (algos.count("cuconv_pallas"), algos.count("winograd_pallas")) \
        == want
    assert len(algos) == sum(want)


def test_resnet_like_still_folds_its_non_overlapping_pool():
    gp = resnet_like().graph_plan((4, 32, 32, 3), backend="cuda")
    assert gp.fused["stem"] == "pool:pool"
    assert gp.conv_plans["stem"].algorithm == "cuconv_pallas"
    assert gp.placement() == {"kernel": 6, "library": 0, "plain": 0,
                              "pools_unfolded": []}


def _conv_pool(window, stride, padding):
    b = GraphBuilder((2, 16, 16, 8))
    y = b.conv("c", "input", 3, 16)
    b.pool("p", y, kind="max", window=window, stride=stride, padding=padding)
    return b.graph()


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_a_pool_folds_only_where_a_kernel_fuses_it(backend):
    g = _conv_pool(3, 2, 1)
    fused = _folded_spec(g)
    # the plain executors run the folded pool after the bare conv ...
    assert "lax" in executors.supporting(fused)
    # ... but no kernel fuses an overlapping pool, so it stays a node
    assert executors.fusing(fused, "pool") == ()
    fg, fmap = tgraph.fuse_graph(g, backend)
    assert fmap == {} and fg is g
    gp = tgraph.plan_graph(g, backend=backend, use_cache=False)
    assert gp.placement()["pools_unfolded"] == ["p"]
    assert gp.placement()[
        "kernel" if backend == "cuda" else "plain"] == 1
    # a 2x2/2 pool is the fused kernel's, and folds
    g2 = _conv_pool(2, 2, 0)
    assert executors.fusing(_folded_spec(g2), "pool") == (
        "cuconv_pallas",)
    assert tgraph.fuse_graph(g2, backend)[1] == {"c": "pool:p"}
    # without the pass nothing counts as unfolded
    gp = tgraph.plan_graph(g, backend=backend, use_cache=False, fuse=False)
    assert gp.placement()["pools_unfolded"] == []


def _folded_spec(g):
    """The conv node's spec with the graph's pool folded in."""
    conv, pool = g.nodes
    assert isinstance(conv, ConvOp)
    return dataclasses.replace(conv.spec, fused_pool=(
        pool.kind, *pool.window, *pool.stride, *pool.padding))


@pytest.mark.parametrize("k,batch,hw", [(5, 64, 28), (5, 8, 28), (5, 64, 7),
                                        (7, 64, 56)])
def test_unit_stride_kxk_claims_the_fused_kernel(k, batch, hw):
    spec = tcs.ConvSpec((batch, hw, hw, 32), (k, k, 32, 64),
                        padding=(k // 2,) * 2, epilogue="bias_relu")
    p = tcs.plan(spec, backend="cuda")
    assert (p.algorithm, p.reason) == (
        "cuconv_pallas", "unit-stride KxK: fused kernel on the card")
    assert executors.get("cuconv_pallas").supports(spec)[0]
    # off the card the plain versions keep their regions
    assert tcs.plan(spec, backend="cpu").algorithm == "cuconv"
    # 3x3 stays Winograd's, large C included (direct's 45 loses to both)
    spec3 = tcs.ConvSpec((64, hw, hw, 256), (3, 3, 256, 64), padding=(1, 1))
    assert tcs.plan(spec3, backend="cuda").algorithm == "winograd_pallas"


def test_warmup_records_each_buckets_placement():
    model = _model("googlenet-fp32")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    fe = tfe.AsyncServeFrontend(model, params, {(32, 32, 3): (1, 2)},
                                backend="cuda", device="cpu", trace=True)
    fe.warmup()
    tel = fe.telemetry
    programs = fe.programs[(32, 32, 3)]
    assert sorted(tel.placements) == [1, 2]
    for b, got in tel.placements.items():
        assert got == programs.plan(b).placement()
        assert got["plain"] == got["library"] == 0
        assert got["pools_unfolded"] == ["pool1", "pool2"]
    off = tfe.AsyncServeFrontend(model, params, {(32, 32, 3): (1,)},
                                 backend="cuda", device="cpu")
    off.warmup()
    assert off.telemetry.placements is None
