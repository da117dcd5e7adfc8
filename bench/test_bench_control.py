"""The check's control at a size a CPU test holds: the reference put in
the program's place one precision step down (TF32 operands, and bf16),
and the program's own bf16 path, must fail each configuration's limit,
where the program in fp32 passes it.  The chip readings these limits
were set from are in PERF.md (``bench/control.py`` at 224x224)."""
import numpy as np
import pytest
import torch

from bench import netlist
from bench.reference import cnn as reference
from bench.systems import cnn as system

IMAGE = (32, 32, 3)


def err(got, ref):
    scale = float(ref.pow(2).mean().sqrt())
    return float((got - ref).abs().max()) / scale


@pytest.fixture(scope="module", params=["resnet50-fp32", "googlenet-fp32"])
def case(request):
    cfg = netlist.load(request.param)
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    params = netlist.draw_params(cfg, gen, "cpu")
    x = netlist.draw_images(cfg, gen, "cpu", 8, IMAGE)
    return cfg, params, x, reference.logits(cfg, params, x)


def program(cfg, params, x, precision=None):
    model = system.graph_model(cfg, IMAGE, precision)
    gp = model.graph_plan(tuple(x.shape), backend="cuda")
    return model.apply(params, x, graph_plan=gp).float()


def test_program_passes(case):
    cfg, params, x, ref = case
    assert err(program(cfg, params, x), ref) < cfg["check"]["logit_err"]


@pytest.mark.parametrize("operands", ["tf32", "bf16"])
def test_reference_a_step_down_fails(case, operands):
    cfg, params, x, ref = case
    got = reference.logits(cfg, params, x, operands)
    assert err(got, ref) > cfg["check"]["logit_err"]


def test_program_in_bf16_fails(case):
    cfg, params, x, ref = case
    e = err(program(cfg, params, x, "bfloat16"), ref)
    assert np.isfinite(e) and e > cfg["check"]["logit_err"]
