"""The port's ConvSpec geometry and planner against the JAX package's.

``key()`` must give the same string for the same spec (it keys every
persisted cache), and the port's ``plan(spec, backend="cuda")`` must pick
the executor the JAX package picks on its accelerator backend
(``plan(spec, backend="tpu")``) wherever the JAX package's winner is
ported: the paper's profiled rows and ``resnet_like``'s nodes at batch 1.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches  # noqa: F401
from repro.configs import cnn_paper as rpaper
from repro.core import convspec as rcs
from repro.models.cnn import resnet_like as ref_resnet_like
from repro_torch.configs import cnn_paper as tpaper
from repro_torch.core import convspec as tcs
from repro_torch.models.cnn import resnet_like

SPECS = [
    # (in_shape, filter_shape, stride, padding, dtype, epilogue, groups,
    #  fused_add, fused_pool)
    ((1, 7, 7, 832), (1, 1, 832, 256), (1, 1), (0, 0), "float32", "none",
     1, "none", ()),
    ((2, 9, 9, 5), (3, 3, 5, 4), (2, 2), (1, 1), "bf16", "bias_relu", 1,
     "none", ()),
    ((1, 8, 8, 8), (3, 3, 1, 8), (1, 1), (1, 1), "fp32", "relu", 8, "none",
     ()),
    ((1, 16, 16, 16), (3, 3, 16, 16), (1, 1), (1, 1), "float32", "bias", 1,
     "add_relu", ()),
    ((1, 16, 16, 16), (1, 1, 16, 32), (2, 2), (0, 0), "bfloat16", "none", 1,
     "add", ()),
    ((1, 32, 32, 3), (3, 3, 3, 16), (1, 1), (1, 1), "float32", "bias_relu",
     1, "none", ("max", 2, 2, 2, 2, 0, 0)),
    ((4, 12, 10, 6), (5, 3, 6, 9), (1, 2), (2, 1), "float32", "none", 1,
     "none", ("avg", 3, 3, 2, 2, 1, 1)),
]


def _pair(geom):
    return tuple(mod.ConvSpec(*geom) for mod in (rcs, tcs))


@pytest.mark.parametrize("geom", SPECS)
def test_key_and_geometry_match_reference(geom):
    ref, port = _pair(geom)
    assert port.key() == ref.key()
    assert port.dtype == ref.dtype
    for attr in ("out_shape", "final_shape", "is_1x1", "unit_stride",
                 "has_bias", "wants_relu", "has_fusion"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.unfused().key() == ref.unfused().key()
    assert hash(port) == hash(dataclasses.replace(port))


@pytest.mark.parametrize("bad", [
    dict(epilogue="gelu"), dict(fused_add="mul"),
    dict(fused_add="add", epilogue="relu"),
    dict(fused_add="add", fused_pool=("max", 2, 2, 2, 2, 0, 0)),
    dict(fused_pool=("min", 2, 2, 2, 2, 0, 0)), dict(groups=3),
    dict(stride=(0, 1)), dict(padding=(-1, 0)),
    dict(filter_shape=(3, 3, 5, 8)), dict(in_shape=(1, 2, 2, 4)),
])
def test_invalid_specs_raise_in_both(bad):
    base = dict(in_shape=(1, 8, 8, 4), filter_shape=(3, 3, 4, 8),
                padding=(0, 0))
    base.update(bad)
    for mod in (rcs, tcs):
        with pytest.raises(ValueError):
            mod.ConvSpec(**base)


@pytest.mark.parametrize("padding", ["same", "valid", 2, (1, 0)])
@pytest.mark.parametrize("k", [(1, 1), (3, 3), (5, 3)])
def test_normalizers_match_reference(padding, k):
    assert tcs.normalize_pad(padding, *k) == rcs.normalize_pad(padding, *k)
    for s in (1, (2, 1)):
        assert tcs.normalize_stride(s) == rcs.normalize_stride(s)
    for size in (7, 13, 224):
        assert tcs.out_size(size, k[0], 1, 2) == rcs.out_size(size, k[0], 1,
                                                               2)


def test_normalizers_refuse_bad_forms():
    for mod in (rcs, tcs):
        with pytest.raises(ValueError):
            mod.normalize_pad((1, 2, 3), 3, 3)
        with pytest.raises(ValueError):
            mod.normalize_stride((1, 0))


@pytest.mark.parametrize("spelling,want", [
    ("bf16", "bfloat16"), ("fp32", "float32"), ("f32", "float32"),
    (torch.bfloat16, "bfloat16"), (torch.float32, "float32"),
    (np.dtype("float32"), "float32"), ("int8", "int8")])
def test_canonical_dtype(spelling, want):
    assert tcs.canonical_dtype(spelling) == want
    if not isinstance(spelling, torch.dtype):
        assert rcs.canonical_dtype(spelling) == want


def test_for_conv_matches_reference():
    import jax.numpy as jnp
    for bias, act, epi in ((None, None, "none"), (True, None, "bias"),
                           (None, "relu", "relu"), (True, "relu",
                                                    "bias_relu")):
        rx, rw = jnp.zeros((2, 9, 9, 4)), jnp.zeros((3, 3, 4, 6))
        tx, tw = torch.zeros(2, 9, 9, 4), torch.zeros(3, 3, 4, 6)
        r = rcs.ConvSpec.for_conv(rx, rw, 2, "same",
                                  bias=jnp.zeros(6) if bias else None,
                                  activation=act)
        t = tcs.ConvSpec.for_conv(tx, tw, 2, "same",
                                  bias=torch.zeros(6) if bias else None,
                                  activation=act)
        assert t.key() == r.key() and t.epilogue == epi
    with pytest.raises(ValueError, match="activation"):
        tcs.ConvSpec.for_conv(tx, tw, activation="gelu")


def test_paper_configs_are_the_reference_data():
    assert tpaper.PROFILED == rpaper.PROFILED
    assert tpaper.NETWORKS == rpaper.NETWORKS
    assert tpaper.all_distinct() == rpaper.all_distinct()
    assert tpaper.MOBILENET_DW == rpaper.MOBILENET_DW
    for net in tpaper.NETWORKS:
        assert (tpaper.filter_size_fractions(net)
                == rpaper.filter_size_fractions(net))


# ---------------------------------------------------------------------------
# plan parity: the port on "cuda" picks what the JAX package picks on "tpu"

def _profiled_specs(mod, label):
    hw, n, k, m, c = rpaper.PROFILED[label]
    return mod.ConvSpec((n, hw, hw, c), (k, k, c, m),
                        padding=((k - 1) // 2, (k - 1) // 2))


@pytest.mark.parametrize("label", sorted(rpaper.PROFILED))
def test_plan_on_profiled_rows_matches_reference_accelerator_plan(label):
    ref = rcs.plan(_profiled_specs(rcs, label), backend="tpu")
    port = tcs.plan(_profiled_specs(tcs, label), backend="cuda")
    assert port.algorithm == ref.algorithm, port.explain()
    assert port.source == ref.source == "heuristic"
    want = "conv1x1_pallas" if label.startswith("t3") else "cuconv_pallas"
    assert port.algorithm == want


@pytest.mark.parametrize("hw", [32, 224])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_on_resnet_like_nodes_matches_reference(hw, dtype):
    from repro.core.graph import fuse_graph as rfuse
    from repro_torch.core.graph import fuse_graph as tfuse
    rg, _ = rfuse(ref_resnet_like().graph((1, hw, hw, 3), precision=dtype),
                  backend="tpu")
    tg, _ = tfuse(resnet_like().graph((1, hw, hw, 3), precision=dtype),
                  backend="cuda")
    rspecs = {n.name: n.spec for n in rg.conv_nodes}
    tspecs = {n.name: n.spec for n in tg.conv_nodes}
    assert sorted(rspecs) == sorted(tspecs)
    for name in rspecs:
        assert tspecs[name].key() == rspecs[name].key()
        r = rcs.plan(rspecs[name], backend="tpu")
        t = tcs.plan(tspecs[name], backend="cuda")
        assert t.algorithm == r.algorithm == "cuconv_pallas", t.explain()


def test_unported_winner_falls_to_cost_tier_and_says_so():
    """At batch 4 the JAX package plans b1c1 on winograd_pallas, which is
    not ported: the port's plan falls to its cost tier, and explain()
    shows it."""
    spec_r = ref_resnet_like().graph((4, 32, 32, 3)).node("b1c1").spec
    spec_t = resnet_like().graph((4, 32, 32, 3)).node("b1c1").spec
    assert rcs.plan(spec_r, backend="tpu").algorithm == "winograd_pallas"
    p = tcs.plan(spec_t, backend="cuda")
    assert p.source == "cost" and "cheapest supported" in p.explain()


def test_plan_counts_resolutions_and_off_card_backend_claims_no_kernel():
    spec = _profiled_specs(tcs, "t4_A")
    tcs.reset_plan_stats()
    p = tcs.plan(spec, backend="cpu")
    assert tcs.PLAN_STATS["resolutions"] == 1
    assert p.algorithm == rcs.plan(_profiled_specs(rcs, "t4_A"),
                                   backend="cpu").algorithm == "cuconv"
    assert tcs.reset_plan_stats() == 1


def test_plan_tune_is_not_ported_and_says_so():
    with pytest.raises(NotImplementedError, match="not ported"):
        tcs.plan(_profiled_specs(tcs, "t3_A"), backend="cuda", tune="algo")
