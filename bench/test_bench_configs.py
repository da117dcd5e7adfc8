"""The node lists against the published networks, and the port's
program of each against the plain reference, on the CPU."""
import numpy as np
import pytest
import torch

from bench import counts, netlist
from bench.reference import cnn as reference
from repro_torch.configs import cnn_paper

CONFIGS = ("resnet50-fp32", "googlenet-fp32")

#: stride-1 rows of ResNet-50 that ``cnn_paper.RESNET50`` leaves out:
#: each stage's first block reads the stage's input width (stage 1's
#: 1x1 conv at 64 channels, stage 2's first 1x1 at 56x56 before the
#: stride), and stage 1's projection is stride 1
RESNET50_FIRST_BLOCKS = {(56, 1, 64, 64), (56, 1, 128, 256),
                         (28, 1, 256, 512), (14, 1, 512, 1024)}

#: Szegedy et al., Table 1's "ops" column (M multiply-adds) against the
#: node list's; conv1's row (34 M) is not a 7x7 conv of 3 channels to 64
#: at 112x112 (118 M), so it is held to that count instead; each row
#: within 6% (5a reads 51.1 M against the table's 54)
GOOGLENET_TABLE1_M = {"conv2-3": 360, "i3a": 128, "i3b": 304, "i4a": 73,
                      "i4b": 88, "i4c": 100, "i4d": 119, "i4e": 170,
                      "i5a": 54, "i5b": 71}


def stride1_rows(cfg):
    sh = netlist.shapes(cfg)
    return {(sh[n["in"]][1], n["k"], n["out"], sh[n["in"]][3])
            for n in cfg["nodes"]
            if n["op"] == "conv" and n.get("stride", 1) == 1}


def test_resnet50_rows_are_the_papers():
    rows = stride1_rows(netlist.load("resnet50-fp32"))
    assert rows == set(cnn_paper.RESNET50) | RESNET50_FIRST_BLOCKS


def test_googlenet_rows_are_the_papers():
    rows = stride1_rows(netlist.load("googlenet-fp32"))
    assert rows == set(cnn_paper.GOOGLENET)


@pytest.mark.parametrize("name", CONFIGS)
def test_macs_match_the_published_count(name):
    cfg = netlist.load(name)
    macs = counts.macs_per_image(cfg)
    want = cfg["published_macs_per_image"]
    assert abs(macs - want) <= cfg["macs_tolerance"] * want, (macs, want)


def test_googlenet_modules_match_table1():
    cfg = netlist.load("googlenet-fp32")
    per = {}
    for c in counts.conv_nodes(cfg, 1):
        key = ("conv2-3" if c["name"] in ("conv2", "conv3")
               else c["name"][:3])
        per[key] = per.get(key, 0) + c["flops"] // 2
    for key, want in GOOGLENET_TABLE1_M.items():
        assert abs(per[key] / 1e6 - want) <= 0.06 * want, (key, per[key])


@pytest.mark.parametrize("name", CONFIGS)
def test_shapes_end_in_the_classes(name):
    cfg = netlist.load(name)
    sh = netlist.shapes(cfg, 2)
    last = cfg["nodes"][-1]["name"]
    assert sh[last] == (2, cfg["num_classes"])
    assert sh["gap"][1] == (2048 if name.startswith("resnet") else 1024)


@pytest.mark.parametrize("name", CONFIGS)
def test_draw_is_seeded_and_of_order_one(name):
    cfg = netlist.load(name)
    a = netlist.draw_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = netlist.draw_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in a)
    x = netlist.draw_images(cfg, torch.Generator().manual_seed(4), "cpu",
                            2, image=(32, 32, 3))
    y = reference.logits(cfg, a, x)
    rms = float(y.pow(2).mean().sqrt())
    assert 0.1 < rms < 10.0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)])
    got = reference.round_tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0])
    assert torch.equal(got, want)
    r = reference.round_tf32(torch.randn(1000))
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
    assert np.all(np.isfinite(r.numpy()))
