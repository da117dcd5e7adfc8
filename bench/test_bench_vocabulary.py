"""The node lists' vocabulary past ResNet-50 and GoogLeNet: grouped convs,
GELU and channel LayerNorm, read alike by the netlist, the counts, the
plain reference, the program's adapter and the rooflines, on the CPU.

ConvNeXt-T (Liu et al., arXiv:2201.03545) is built here at its published
widths and counted, never run; a tiny list of its shape, with every op
kind, is checked by hand."""
import json
import math

import pytest
import torch
from torch import nn

from bench import counts, harness, netlist, readers
from bench.reference import cnn as reference
from bench.systems import cnn as system
from bench.test_bench_readers import PORT, Batch, FakeTrace
from repro_torch.core.graph import GraphBuilder

EPS = 1e-6


def conv(name, src, k, out, act="none", stride=1, pad=0, **kw):
    return {"op": "conv", "name": name, "in": src, "k": k, "out": out,
            "stride": stride, "pad": pad, "act": act, **kw}


def norm(name, src):
    return {"op": "norm", "name": name, "in": src, "eps": EPS}


def block(p, x, c):
    """ConvNeXt's block: depthwise 7x7, norm, 1x1 to 4C with GELU, 1x1
    back to C (its layer scale folded into this conv), residual add."""
    return [conv(f"{p}dw", x, 7, c, pad=3, groups=c),
            norm(f"{p}norm", f"{p}dw"),
            conv(f"{p}pw1", f"{p}norm", 1, 4 * c, "gelu"),
            conv(f"{p}pw2", f"{p}pw1", 1, c, gain=0.2),
            {"op": "add", "name": p, "in": [x, f"{p}pw2"]}]


def convnext(widths=(96, 192, 384, 768), depths=(3, 3, 9, 3),
             image=(224, 224, 3), classes=1000):
    """ConvNeXt's node list: a 4x4/4 stem and its norm; stages of
    ``depths`` blocks at ``widths``, each after the first entered by a
    norm and a 2x2/2 conv; GAP, a norm and the dense head."""
    nodes = [conv("stem", "input", 4, widths[0], stride=4),
             norm("stem_n", "stem")]
    x = "stem_n"
    for s, (c, d) in enumerate(zip(widths, depths)):
        if s:
            nodes += [norm(f"ds{s}_n", x),
                      conv(f"ds{s}", f"ds{s}_n", 2, c, stride=2)]
            x = f"ds{s}"
        for i in range(d):
            nodes += block(f"s{s}b{i}", x, c)
            x = f"s{s}b{i}"
    nodes += [{"op": "gap", "name": "gap", "in": x}, norm("head_n", "gap"),
              {"op": "dense", "name": "fc", "in": "head_n", "out": classes}]
    return config(nodes, image, classes)


def config(nodes, image, classes):
    return netlist.validate(
        {"name": "vocabulary", "image": list(image), "num_classes": classes,
         "system": "cnn", "reference": "cnn", "check": {"logit_err": 5e-4},
         "init": {"bias_std": 0.1, "norm_std": 0.1}, "nodes": nodes})


def tiny():
    """32x32x3, widths (8, 16), depths (1, 1), every op kind: stage 2 is
    entered by a 2x2/2 conv to 8 beside a 2x2/2 max pool, concatenated."""
    nodes = [conv("stem", "input", 4, 8, stride=4), norm("stem_n", "stem"),
             *block("a", "stem_n", 8), norm("ds_n", "a"),
             conv("ds", "ds_n", 2, 8, stride=2),
             {"op": "pool", "name": "dp", "in": "ds_n", "kind": "max", "k": 2,
              "stride": 2, "pad": 0},
             {"op": "concat", "name": "cat", "in": ["ds", "dp"]},
             *block("b", "cat", 16),
             {"op": "gap", "name": "gap", "in": "b"}, norm("head_n", "gap"),
             {"op": "dense", "name": "fc", "in": "head_n", "out": 10}]
    return config(nodes, (32, 32, 3), 10)


# -- the reference against torch.nn ------------------------------------

def one_node(node, image=(8, 8, 4)):
    cfg = config(node if isinstance(node, list) else [node], image, 0)
    gen = torch.Generator().manual_seed(11)
    params = netlist.draw_params(cfg, gen, "cpu")
    x = netlist.draw_images(cfg, gen, "cpu", 3)
    return cfg, params, x, reference.logits(cfg, params, x)


def nn_conv(p, groups):
    w = p["w"].permute(3, 2, 0, 1)
    m = nn.Conv2d(w.shape[1] * groups, w.shape[0], w.shape[2],
                  padding=w.shape[2] // 2, groups=groups)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(p["b"])
    return m


@pytest.mark.parametrize("groups,out", [(4, 4), (2, 6), (4, 8)])
def test_grouped_conv_is_nn_conv2d(groups, out):
    cfg, params, x, got = one_node(conv("g", "input", 3, out, pad=1,
                                        groups=groups))
    assert params["g"]["w"].shape == (3, 3, 4 // groups, out)
    with torch.no_grad():
        want = nn_conv(params["g"], groups)(x.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want)


def test_gelu_is_nn_gelu():
    cfg, params, x, got = one_node(conv("c", "input", 3, 4, "gelu", pad=1))
    with torch.no_grad():
        want = nn.GELU()(nn_conv(params["c"], 1)(x.permute(0, 3, 1, 2)))
    torch.testing.assert_close(got, want)
    assert (got < 0).any()


def nn_norm(p):
    m = nn.LayerNorm(p["w"].shape[0], eps=EPS)
    with torch.no_grad():
        m.weight.copy_(p["w"])
        m.bias.copy_(p["b"])
    return m


def test_norm_is_nn_layernorm_over_each_pixels_channels():
    cfg, params, x, got = one_node(norm("n", "input"))
    with torch.no_grad():
        want = nn_norm(params["n"])(x).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want)


def test_norm_after_gap_is_nn_layernorm():
    cfg, params, x, got = one_node([{"op": "gap", "name": "g", "in": "input"},
                                    norm("n", "g")])
    with torch.no_grad():
        want = nn_norm(params["n"])(x.mean(dim=(1, 2)))
    torch.testing.assert_close(got, want)


# -- the draw -------------------------------------------------------------

def test_norm_params_are_drawn_inside_the_two_draws():
    """A norm's scale is 1 + norm_std z in the weight draw, its shift
    bias_std z in the bias draw, each in node order."""
    cfg = tiny()
    p = netlist.draw_params(cfg, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    specs = netlist.param_specs(cfg)
    flat_w = torch.randn(sum(math.prod(s) for _, s, _ in specs),
                         generator=gen)
    flat_b = torch.randn(sum(s[-1] for _, s, _ in specs), generator=gen)
    (stem, shape, _), (name, _, std) = specs[:2]
    assert (stem, name, std) == ("stem", "stem_n", 0.1)
    ow, ob = math.prod(shape), shape[-1]
    assert torch.equal(p["stem_n"]["w"], 1 + 0.1 * flat_w[ow:ow + 8])
    assert torch.equal(p["stem_n"]["b"], 0.1 * flat_b[ob:ob + 8])


# -- the tiny list by hand -----------------------------------------------

TINY_SHAPES = {"stem": (2, 8, 8, 8), "stem_n": (2, 8, 8, 8),
               "adw": (2, 8, 8, 8), "apw1": (2, 8, 8, 32), "a": (2, 8, 8, 8),
               "ds": (2, 4, 4, 8), "dp": (2, 4, 4, 8), "cat": (2, 4, 4, 16),
               "bdw": (2, 4, 4, 16), "bpw1": (2, 4, 4, 64),
               "b": (2, 4, 4, 16), "gap": (2, 16), "head_n": (2, 16),
               "fc": (2, 10)}
TINY_PARAMS = {"stem": (4, 4, 3, 8), "stem_n": (8,), "adw": (7, 7, 1, 8),
               "anorm": (8,), "apw1": (1, 1, 8, 32), "apw2": (1, 1, 32, 8),
               "ds_n": (8,), "ds": (2, 2, 8, 8), "bdw": (7, 7, 1, 16),
               "bnorm": (16,), "bpw1": (1, 1, 16, 64), "bpw2": (1, 1, 64, 16),
               "head_n": (16,), "fc": (16, 10)}
#: multiply-adds an image of each conv: output pixels x K x K x C/g x M
TINY_MACS = {"stem": 64 * 16 * 3 * 8, "adw": 64 * 49 * 1 * 8,
             "apw1": 64 * 8 * 32, "apw2": 64 * 32 * 8, "ds": 16 * 4 * 8 * 8,
             "bdw": 16 * 49 * 1 * 16, "bpw1": 16 * 16 * 64,
             "bpw2": 16 * 64 * 16}
#: fp32 bytes an image: input, K x K x C/g x M weights, M biases, output
TINY_BYTES = {"adw": 4 * (512 + 49 * 8 + 8 + 512),
              "bdw": 4 * (256 + 49 * 16 + 16 + 256),
              "ds": 4 * (512 + 4 * 64 + 8 + 128)}


def test_tiny_shapes_and_params_by_hand():
    cfg = tiny()
    sh = netlist.shapes(cfg, 2)
    assert {k: sh[k] for k in TINY_SHAPES} == TINY_SHAPES
    assert {n: s for n, s, _ in netlist.param_specs(cfg)} == TINY_PARAMS
    p = netlist.draw_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert {n: tuple(v["w"].shape) for n, v in p.items()} == TINY_PARAMS
    assert all(v["b"].shape == (s[-1],) for n, s in TINY_PARAMS.items()
               for v in [p[n]])
    ops = {n["op"] for n in cfg["nodes"]}
    assert ops == set(netlist.KEYS)


def test_tiny_counts_by_hand():
    cfg = tiny()
    per = {c["name"]: c for c in counts.conv_nodes(cfg, 1)}
    assert {n: c["flops"] // 2 for n, c in per.items()} == TINY_MACS
    assert {n: per[n]["bytes"] for n in TINY_BYTES} == TINY_BYTES
    assert counts.macs_per_image(cfg) == sum(TINY_MACS.values()) + 16 * 10
    assert counts.conv_nodes(cfg, 3)[1]["flops"] == 3 * 2 * TINY_MACS["adw"]


# -- ConvNeXt-T at its published widths, counted -----------------------

def test_convnext_t_counts():
    cfg = convnext()
    ops = [n["op"] for n in cfg["nodes"]]
    assert (ops.count("conv"), ops.count("norm"), ops.count("add")) == (
        58, 23, 18)
    macs = counts.macs_per_image(cfg)
    assert macs == 4_455_531_264
    assert abs(macs - 4.5e9) <= 0.02 * 4.5e9
    dw = sum(c["flops"] // 2 for c in counts.conv_nodes(cfg, 1)
             if c["name"].endswith("dw"))
    assert dw == 105_106_176
    params = sum(math.prod(s) + s[-1] for _, s, _ in netlist.param_specs(cfg))
    assert params == 28_582_504
    layer_scale = sum(n["out"] for n in cfg["nodes"]
                      if n["name"].endswith("pw2"))
    assert layer_scale == 6_624 and params + layer_scale == 28_589_128
    sh = netlist.shapes(cfg)
    assert sh["stem"] == (1, 56, 56, 96) and sh["ds3"] == (1, 7, 7, 768)


def test_convnext_t_counted_without_groups_is_6_7_times_over():
    """Counted dense, the depthwise convs would be 25.49 G multiply-adds
    an image, and ``mfu.bulk`` would read 6.7 times too high."""
    cfg = convnext()
    for n in cfg["nodes"]:
        if n["name"].endswith("dw"):
            del n["groups"]
    assert counts.macs_per_image(cfg) == 29_841_438_720


# -- refusals --------------------------------------------------------------

def bad(edit):
    cfg = tiny()
    node = next(n for n in cfg["nodes"] if n["name"] == edit[0])
    edit[1](node, cfg)
    return cfg


REFUSED = {
    "unknown op": ("gap", lambda n, c: n.update(op="softmax")),
    "unknown key": ("adw", lambda n, c: n.update(dilation=2)),
    "unknown conv act": ("apw1", lambda n, c: n.update(act="silu")),
    "gelu after an add": ("a", lambda n, c: n.update(act="gelu")),
    "unknown pool kind": ("dp", lambda n, c: n.update(kind="avg")),
    "groups not dividing the input": ("adw", lambda n, c: n.update(
        groups=3, out=9)),
    "groups not dividing the output": ("ds", lambda n, c: n.update(
        groups=4, out=6)),
    "norm without eps": ("head_n", lambda n, c: n.pop("eps")),
    "norm without init.norm_std": ("stem_n", lambda n, c: c["init"].pop(
        "norm_std")),
    "an edge not yet made": ("fc", lambda n, c: n.update(**{"in": "nowhere"})),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_load_refuses_naming_the_node(case, tmp_path, monkeypatch):
    edit = REFUSED[case]
    (tmp_path / "bad.json").write_text(json.dumps(bad(edit)))
    monkeypatch.setattr(netlist, "CONFIGS", tmp_path)
    with pytest.raises(ValueError, match=repr(edit[0])):
        netlist.load("bad")


# -- the program's adapter ---------------------------------------------

def err(got, ref):
    return float((got - ref).abs().max()) / float(ref.pow(2).mean().sqrt())


def through_program(cfg, image):
    gen = torch.Generator().manual_seed(2 ** 31 + 3)
    params = netlist.draw_params(cfg, gen, "cpu")
    x = netlist.draw_images(cfg, gen, "cpu", 4, image)
    model = system.graph_model(cfg, image)
    gp = model.graph_plan(tuple(x.shape), backend="cuda")
    return gp, model.apply(params, x, graph_plan=gp).float(), \
        reference.logits(cfg, params, x)


def grouped():
    return config([conv("c1", "input", 3, 8, "relu", pad=1),
                   conv("dw", "c1", 3, 8, "relu", pad=1, groups=8),
                   conv("g2", "dw", 1, 16, groups=2),
                   {"op": "gap", "name": "gap", "in": "g2"},
                   {"op": "dense", "name": "fc", "in": "gap", "out": 10}],
                  (16, 16, 3), 10)


def test_grouped_convs_run_as_written_against_the_reference():
    cfg = grouped()
    gp, got, ref = through_program(cfg, (16, 16, 3))
    assert {n: p.spec.groups for n, p in gp.conv_plans.items()} == {
        "c1": 1, "dw": 8, "g2": 2}
    assert err(got, ref) < cfg["check"]["logit_err"]


def test_tiny_convnext_through_the_program():
    """Runs once the program has ``GraphBuilder.norm`` and the
    ``bias_gelu`` epilogue; until then ``graph_model`` refuses it."""
    cfg = tiny()
    try:
        system.graph_model(cfg)
    except NotImplementedError as e:
        pytest.skip(f"the program cannot run it yet: {e}")
    gp, got, ref = through_program(cfg, (32, 32, 3))
    assert err(got, ref) < cfg["check"]["logit_err"]


def test_adapter_asks_for_groups_and_the_gelu_epilogue():
    assert system.EPILOGUE_OF_ACT == {"none": "bias", "relu": "bias_relu",
                                      "gelu": "bias_gelu"}
    assert set(system.EPILOGUE_OF_ACT) == set(netlist.ACTS["conv"])


@pytest.fixture
def program_without_norm_or_gelu(monkeypatch):
    from repro_torch.core import convspec
    monkeypatch.setattr(convspec, "EPILOGUES",
                        tuple(e for e in convspec.EPILOGUES
                              if e != "bias_gelu"))
    monkeypatch.delattr(GraphBuilder, "norm", raising=False)


@pytest.mark.parametrize("node,piece", [
    (conv("c", "input", 3, 4, "gelu", pad=1), "bias_gelu"),
    (norm("n", "input"), "GraphBuilder.norm")])
def test_missing_pieces_are_refused_naming_the_node(
        program_without_norm_or_gelu, node, piece):
    with pytest.raises(NotImplementedError, match=repr(node["name"])) as e:
        system.graph_model(config([node], (8, 8, 4), 0))
    assert piece in str(e.value)


def test_run_cell_refuses_before_drawing_weights(
        program_without_norm_or_gelu, monkeypatch):
    cfg = tiny()
    cell = {"name": "tiny.bulk64", "config": "tiny", "traffic": "bulk64",
            "chips": 1}
    monkeypatch.setattr(harness, "load_cell",
                        lambda w: ({}, cell, cfg, {"pool": 8}))

    def drawn(*a, **kw):
        raise AssertionError("weights drawn before the refusal")
    monkeypatch.setattr(harness.netlist, "draw_params", drawn)
    with pytest.raises(NotImplementedError, match="'stem_n'"):
        harness.run_cell("tiny.bulk64", 1, 0.1, False, devices=["cpu"],
                         log=lambda *_: None)


# -- the rooflines ----------------------------------------------------------

#: a port-style depthwise kernel that ``counts.KERNEL_OF_LAUNCH`` lacks
DW_KERNEL = "void dwconv7x7_tc_kernel<float, 4>(float const*, float const*)"


def roofline_window(cfg, on, records):
    """A window of three batches of bucket 4 whose conv nodes ``on``
    maps to their executors' kernels."""
    return harness.Window(
        cfg=cfg, cards=1, image=tuple(cfg["image"]),
        batches=[Batch(4, 4)] * 3, kernel_nodes={4: frozenset(on)},
        node_kernels={4: on}, trace=FakeTrace(records))


def test_a_kernel_the_table_lacks_leaves_conv_roofline_alone():
    cfg = tiny()
    on = {c["name"]: ("cuconv_fused",) for c in counts.conv_nodes(cfg, 1)}
    port = [(PORT[0], 0.0, 2e-3)]
    known = {n: k for n, k in on.items() if not n.endswith("dw")}
    alone = readers.conv_roofline(roofline_window(cfg, known, port))
    on.update(adw=("dwconv7x7",), bdw=("dwconv7x7",))
    dw = [(DW_KERNEL, 2e-3, 3e-3), (DW_KERNEL, 3e-3, 3.5e-3)]
    assert readers.conv_roofline(roofline_window(cfg, on, port + dw)) == alone
    assert readers.kernel_roofline(roofline_window(cfg, on, port + dw),
                                   "cuconv_fused") == alone
    least = 3 * sum(c["least_s"] for c in counts.conv_nodes(cfg, 4)
                    if c["name"] in known)
    assert alone == pytest.approx(100.0 * least / 2e-3)


def test_kernel_rooflines_recombine_to_conv_roofline():
    cfg = netlist.load("resnet50-fp32")
    cfg = dict(cfg, image=[32, 32, 3])
    on = {c["name"]: ("winograd_fused",) if c["name"].endswith("c2")
          else ("cuconv_fused",) for c in counts.conv_nodes(cfg, 1)}
    records = [(PORT[0], 0.0, 5e-3), (PORT[1], 5e-3, 7e-3),
               (PORT[0], 7e-3, 8e-3), ("void at::max_pool<float>()", 8e-3,
                                       9e-3)]
    w = roofline_window(cfg, on, records)
    f = readers.kernel_roofline(w, "cuconv_fused")
    wg = readers.kernel_roofline(w, "winograd_fused")
    assert 0 < f <= 100 and 0 < wg <= 100
    least_f, least_w = f * 6e-3 / 100, wg * 2e-3 / 100
    assert 100 * (least_f + least_w) / 8e-3 == pytest.approx(
        readers.conv_roofline(w), rel=1e-12)
    assert readers.kernel_roofline(w, "direct_conv") is None


@pytest.mark.parametrize("launch", sorted(counts.KERNEL_OF_LAUNCH))
def test_each_launch_matches_its_kernel_alone(launch):
    match = counts.kernel_of(launch)
    hits = [k for k in PORT if match(k)]
    assert len(hits) == 1 and counts.KERNEL_OF_LAUNCH[launch] in hits[0]
    assert not match(DW_KERNEL)


def test_the_per_kernel_metrics_are_bound():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    for launch in ("cuconv_fused", "winograd_fused"):
        assert f"{launch}_roofline.bulk" in names
        w = roofline_window(tiny(), {"stem": (launch,)},
                            [(counts.KERNEL_OF_LAUNCH[launch], 0.0, 1e-3)])
        assert harness.reader(f"{launch}_roofline.bulk")(w) == \
            readers.kernel_roofline(w, launch)
