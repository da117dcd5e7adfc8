"""The port's CNN models (``models/cnn.py``) and the chain-era
``ConvGraph`` against the JAX package's.

``SimpleCNN``, ``squeezenet_like``, ``tiny_cnn``, ``mobilenet_like`` and
``fire_like`` get the JAX package's params (its ``init`` on one key,
carried across by ``params_from_numpy``) and the same seeded input at
32x32, batch 2.  Through ``GraphModel.apply`` the outputs must agree
within 3e-4 of the output's abs max in fp32 and 3e-2 under the bf16
policy, planned for the CPU and for the card (``"cuda"``: the kernels'
plain versions on CPU tensors); through ``CnnServeEngine(device="cpu",
backend="cuda")`` within 3e-4.  Node names and ``Graph.signature()``
strings must be the reference's, as must ``ConvGraph.chain(...)``'s
lowering, and ``plan_graph`` takes a ``ConvGraph``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (_clear_port_caches, np32, rand,  # noqa: F401
                           ref_params_numpy)
from repro.core import graph as rgraph
from repro.models import cnn as rcnn
from repro.serve import cnn as rserve
from repro_torch.core import graph as tgraph
from repro_torch.models import cnn as tcnn
from repro_torch.serve import cnn as tserve

TOLS = {None: 3e-4, "bf16": 3e-2}
SIMPLE = [(3, 3, 8, 1), (1, 1, 12, 1), (5, 5, 6, 2)]
MODELS = {
    "squeezenet_like": lambda m: m.squeezenet_like(),
    "tiny_cnn": lambda m: m.tiny_cnn(),
    "mobilenet_like": lambda m: m.mobilenet_like(num_classes=5),
    "fire_like": lambda m: m.fire_like(num_classes=5),
    "simple_cnn": lambda m: m.SimpleCNN(SIMPLE, num_classes=4),
}


def _numpy(params):
    if "convs" in params:
        return {"convs": [{k: np.asarray(v, np.float32) for k, v in p.items()}
                          for p in params["convs"]],
                "head": np.asarray(params["head"], np.float32)}
    return ref_params_numpy(params)


def _pair(name):
    rm, tm = MODELS[name](rcnn), MODELS[name](tcnn)
    rparams = rm.init(jax.random.PRNGKey(0))
    return rm, rparams, tm, tcnn.params_from_numpy(_numpy(rparams), "cpu")


def _close(got, want, tol):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_matches_reference(name, precision, backend):
    rm, rparams, tm, tparams = _pair(name)
    x = rand(np.random.default_rng(0), (2, 32, 32, 3))
    want = rm.apply(rparams, jnp.asarray(x), precision=precision)
    gp = tm.graph_plan(x.shape, backend=backend, precision=precision)
    got = tm.apply(tparams, torch.from_numpy(x), graph_plan=gp)
    _close(got, want, TOLS[precision])
    if backend == "cpu":        # the memoized plan of the input's device
        _close(tm.apply(tparams, torch.from_numpy(x), precision=precision),
               want, TOLS[precision])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_served_outputs_match_reference_engine(name):
    rm, rparams, tm, tparams = _pair(name)
    ref = rserve.CnnServeEngine(rm, rparams, (32, 32, 3), buckets=(1, 2))
    port = tserve.CnnServeEngine(tm, tparams, (32, 32, 3), buckets=(1, 2),
                                 device="cpu", backend="cuda")
    port.warmup()
    rng = np.random.default_rng(1)
    for i, n in enumerate([1, 2, 1]):
        im = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
        ref.submit(rserve.ImageRequest(i, im))
        port.submit(tserve.ImageRequest(i, im))
    for a, r in zip(port.run(), ref.run()):
        _close(a.out, r.out, TOLS[None])
    assert port.stats == ref.stats


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 224, 224, 3)])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graphs_and_fusions_are_the_references(name, shape):
    rg = MODELS[name](rcnn).graph(shape)
    tg = MODELS[name](tcnn).graph(shape)
    assert [n.name for n in tg.nodes] == [n.name for n in rg.nodes]
    assert tg.signature() == rg.signature()
    assert tg.shapes == rg.shapes
    rf, rmap = rgraph.fuse_graph(rg, backend="tpu")
    tf, tmap = tgraph.fuse_graph(tg, backend="cuda")
    assert tmap == rmap and tf.signature() == rf.signature()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_gives_the_references_param_layout(name):
    rm, rparams, tm, _ = _pair(name)
    tparams = tm.init(torch.Generator().manual_seed(0), device="cpu")
    rshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rparams)
    if "convs" in tparams:
        tshapes = {"convs": [{k: tuple(v.shape) for k, v in p.items()}
                             for p in tparams["convs"]],
                   "head": tuple(tparams["head"].shape)}
    else:
        tshapes = {n: {k: tuple(v.shape) for k, v in p.items()}
                   for n, p in tparams.items()}
    assert tshapes == rshapes
    again = tm.init(0, device="cpu")      # a seed is a fresh generator
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(tparams), jax.tree_util.tree_leaves(again)))


def test_mobilenet_plans_only_its_grouped_nodes_onto_the_library():
    tm = tcnn.mobilenet_like()
    for shape in ((1, 32, 32, 3), (4, 224, 224, 3)):
        gp = tm.graph_plan(shape, backend="cuda")
        library = {n for n, p in gp.conv_plans.items()
                   if not p.executor.kernels}
        assert library == {"dw1", "dw2"}
        assert {gp.conv_plans[n].algorithm for n in library} == {"lax"}
    with pytest.raises(ValueError, match="grouped"):
        tm.graph_plan((1, 32, 32, 3), backend="cuda", force="cuconv_pallas")


def test_other_models_plan_every_conv_node_onto_a_kernel():
    for name in ("squeezenet_like", "fire_like", "tiny_cnn", "simple_cnn"):
        tm = MODELS[name](tcnn)
        for shape in ((1, 32, 32, 3), (4, 224, 224, 3)):
            gp = tm.graph_plan(shape, backend="cuda")
            assert all(p.executor.kernels for p in gp.conv_plans.values()), (
                name, shape, gp.explain())


# ---------------------------------------------------------------------------
# the chain-era API

CHAINS = [
    ([(3, 3, 8, 1), (1, 1, 4, 1)], (1, 16, 16, 3), "same", "bias_relu"),
    ([(3, 3, 8, 2), (5, 5, 4, 1), (1, 1, 6, 1)], (2, 15, 15, 4), "same",
     ["bias_relu", "relu", "bias"]),
    ([(3, 3, 6, 1), (3, 3, 6, 1)], (1, 12, 12, 3), "valid", "none"),
]


@pytest.mark.parametrize("layers,in_shape,padding,epilogue", CHAINS)
def test_convgraph_chain_lowers_as_the_reference(layers, in_shape, padding,
                                                 epilogue):
    r = rgraph.ConvGraph.chain(layers, in_shape, padding=padding,
                               epilogue=epilogue)
    t = tgraph.ConvGraph.chain(layers, in_shape, padding=padding,
                               epilogue=epilogue)
    assert [s.key() for s in t.nodes] == [s.key() for s in r.nodes]
    rir, tir = r.to_ir(), t.to_ir()
    assert [n.name for n in tir.nodes] == [n.name for n in rir.nodes] == [
        f"conv{i}" for i in range(len(layers))]
    assert tir.signature() == rir.signature() == t.signature()
    assert (len(t), t.in_shape, t.out_shape) == (len(r), r.in_shape,
                                                 r.out_shape)


def test_convgraph_refuses_broken_chains():
    with pytest.raises(ValueError, match="epilogue sequence"):
        tgraph.ConvGraph.chain([(3, 3, 8, 1)], (1, 8, 8, 3),
                               epilogue=["bias", "relu"])
    a = tgraph.ConvGraph.chain([(3, 3, 8, 1)], (1, 8, 8, 3)).nodes[0]
    with pytest.raises(ValueError, match="chain broken"):
        tgraph.ConvGraph((a, a))
    with pytest.raises(ValueError, match="at least one"):
        tgraph.ConvGraph(())


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_plan_graph_takes_a_convgraph_and_weight_pairs(backend):
    layers, in_shape, _, epilogue = CHAINS[1]
    r = rgraph.ConvGraph.chain(layers, in_shape, epilogue=epilogue)
    t = tgraph.ConvGraph.chain(layers, in_shape, epilogue=epilogue)
    rng = np.random.default_rng(0)
    pairs = [(rand(rng, s.filter_shape),
              rand(rng, (s.filter_shape[3],)) if s.has_bias else None)
             for s in t.nodes]
    x = rand(rng, in_shape)
    gp = tgraph.plan_graph(t, backend=backend)
    assert gp.source == "resolved"
    assert gp.graph.signature() == t.signature()
    want = rgraph.plan_graph(r).run(
        jnp.asarray(x), [(jnp.asarray(w), None if b is None else
                          jnp.asarray(b)) for w, b in pairs])
    got = gp.run(torch.from_numpy(x), [
        (torch.from_numpy(w), None if b is None else torch.from_numpy(b))
        for w, b in pairs])
    _close(got, want, TOLS[None])
    with pytest.raises(ValueError, match="weight pairs"):
        gp.run(torch.from_numpy(x), [])
    tgraph.clear_cache()
    assert tgraph.plan_graph(t, backend=backend).source == "graph_cache"


def test_simple_cnn_nodes_are_the_chains():
    m = tcnn.SimpleCNN(SIMPLE)
    g = m.graph((1, 32, 32, 3))
    chain = tgraph.ConvGraph.chain(SIMPLE, (1, 32, 32, 3)).to_ir()
    assert [(n.name, n.spec) for n in g.conv_nodes] == [
        (n.name, n.spec) for n in chain.conv_nodes]


# ---------------------------------------------------------------------------
# the eager layers and the params bridge

@pytest.mark.parametrize("stride", [1, 2])
def test_conv_block_and_maxpool_match_reference(stride):
    rng = np.random.default_rng(stride)
    x = rand(rng, (2, 9, 9, 4))
    p = {"w": rand(rng, (3, 3, 4, 6)), "b": rand(rng, (6,))}
    want = rcnn.conv_block({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), stride=stride)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tcnn.conv_block(tp, torch.from_numpy(x), stride=stride)
    _close(got, want, TOLS[None])
    _close(tcnn.conv_block(tp, torch.from_numpy(x), stride=stride,
                           algorithm="cuconv_pallas"), want, TOLS[None])
    np.testing.assert_array_equal(
        np32(tcnn.maxpool(torch.from_numpy(x))),
        np32(rcnn.maxpool(jnp.asarray(x))))
    np.testing.assert_array_equal(
        np32(tcnn.maxpool(torch.from_numpy(x), k=3, s=2)),
        np32(rcnn.maxpool(jnp.asarray(x), k=3, s=2)))


def test_params_from_numpy_takes_both_layouts():
    _, rparams, _, tparams = _pair("simple_cnn")
    assert len(tparams["convs"]) == len(SIMPLE)
    for rp, tp in zip(rparams["convs"], tparams["convs"]):
        assert set(tp) == {"w", "b"}
        np.testing.assert_array_equal(np32(tp["w"]), np32(rp["w"]))
        assert tp["w"].dtype == torch.float32
    np.testing.assert_array_equal(np32(tparams["head"]),
                                  np32(rparams["head"]))
    _, rparams, _, tparams = _pair("fire_like")
    assert set(tparams) == set(rparams)
    np.testing.assert_array_equal(np32(tparams["expand3"]["w"]),
                                  np32(rparams["expand3"]["w"]))
