"""The port's executor registry against the JAX package's.

Each ported executor, forced, must compute what the JAX package's
executor of the same name computes on the same numpy inputs (fp32 3e-4,
bf16 3e-2 — the bounds of ``tests/test_executors.py``), fused residual
add and fused pool included; it must declare the same capabilities; and
the registry's planning rules (forced configs, persisted winners and
configs, capability honesty) must hold as they do in the JAX package.
On the CPU the kernel executors run their kernels' plain versions.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (_clear_port_caches, np32, rand, to_jax,  # noqa: F401
                           to_torch)
from repro.core import convspec as rcs
from repro_torch.core import autotune, executors
from repro_torch.core import convspec as tcs
from repro_torch.kernels import _build, cuconv_fused

TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=3e-2, atol=3e-2)}

PORTED = ("lax", "im2col", "cuconv_two_stage", "conv1x1_pallas",
          "cuconv_two_stage_pallas", "cuconv", "cuconv_pallas")

# (in_shape, (kh, kw), m, stride, padding, epilogue, groups, fused_add,
#  fused_pool): every capability axis, and the fused forms of resnet_like
SWEEP = [
    ((1, 8, 8, 6), (3, 3), 4, (1, 1), (1, 1), "bias_relu", 1, "none", ()),
    ((2, 9, 9, 5), (3, 3), 4, (2, 2), (1, 1), "none", 1, "none", ()),
    ((1, 6, 6, 8), (1, 1), 4, (1, 1), (0, 0), "none", 1, "none", ()),
    ((1, 6, 6, 8), (1, 1), 4, (1, 1), (0, 0), "bias", 1, "none", ()),
    ((1, 7, 7, 4), (5, 5), 3, (1, 1), (2, 2), "bias", 1, "none", ()),
    ((1, 8, 8, 8), (3, 3), 8, (1, 1), (1, 1), "relu", 8, "none", ()),
    ((1, 8, 8, 6), (3, 3), 5, (1, 1), (1, 1), "bias", 1, "add_relu", ()),
    ((2, 8, 8, 6), (1, 1), 7, (2, 2), (0, 0), "bias", 1, "add", ()),
    ((1, 8, 8, 3), (3, 3), 6, (1, 1), (1, 1), "bias_relu", 1, "none",
     ("max", 2, 2, 2, 2, 0, 0)),
    ((2, 8, 8, 3), (3, 3), 6, (1, 1), (1, 1), "none", 1, "none",
     ("avg", 2, 2, 2, 2, 0, 0)),
]


def _spec(mod, geom, dtype):
    in_shape, (kh, kw), m, stride, padding, epi, groups, fadd, fpool = geom
    return mod.ConvSpec(in_shape, (kh, kw, in_shape[3] // groups, m),
                        stride, padding, dtype, epi, groups, fadd, fpool)


def _operands(spec, rng):
    x = rand(rng, spec.in_shape)
    w = rand(rng, spec.filter_shape)
    b = rand(rng, (spec.filter_shape[3],)) if spec.has_bias else None
    a = rand(rng, spec.out_shape) if spec.fused_add != "none" else None
    return x, w, b, a


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", PORTED)
def test_forced_executor_matches_reference(name, dtype):
    rng = np.random.default_rng(0)
    compared = 0
    for geom in SWEEP:
        rspec, tspec = _spec(rcs, geom, dtype), _spec(tcs, geom, dtype)
        from repro.core import executors as rex
        r_ok = rex.get(name).supports(rspec)[0]
        t_ok = executors.get(name).supports(tspec)[0]
        assert t_ok == r_ok, (name, tspec.key())
        if not t_ok:
            continue
        x, w, b, a = _operands(tspec, rng)
        want = rcs.plan(rspec, force=name, backend="cpu")(
            to_jax(x), to_jax(w), to_jax(b), to_jax(a))
        tplan = tcs.plan(tspec, force=name, backend="cuda")
        assert tplan.algorithm == name and tplan.source == "forced"
        got = tplan(to_torch(x), to_torch(w), to_torch(b), to_torch(a))
        assert tuple(got.shape) == tuple(want.shape) == tspec.final_shape
        assert str(got.dtype)[6:] == dtype
        np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype],
                                   err_msg=f"{name} {tspec.key()}")
        compared += 1
    assert compared >= 2


@pytest.mark.parametrize("name", PORTED)
def test_declarations_match_reference(name):
    from repro.core import executors as rex
    r, t = rex.get(name), executors.get(name)
    assert (t.dtypes, t.accum, t.supports_groups, t.fuses_epilogue,
            t.tunable) == (r.dtypes, r.accum, r.supports_groups,
                           r.fuses_epilogue, r.tunable)
    for geom in SWEEP:
        rspec, tspec = _spec(rcs, geom, "float32"), _spec(tcs, geom,
                                                          "float32")
        assert ([c.as_dict() for c in t.configs(tspec)]
                == [c.as_dict() for c in r.configs(rspec)])
        assert t.fusions(tspec) == r.fusions(rspec)
        assert t.cost(tspec) == pytest.approx(r.cost(rspec))


def test_registry_holds_the_ported_executors_in_reference_order():
    from repro.core import executors as rex
    assert executors.names() == PORTED
    assert [n for n in rex.names() if n in PORTED] == list(PORTED)
    with pytest.raises(KeyError, match="unknown algorithm"):
        executors.get("winograd_pallas")
    with pytest.raises(ValueError, match="already registered"):
        executors.register(executors.LaxExecutor())
    with pytest.raises(KeyError):
        executors.unregister("direct")


def test_third_party_executor_joins_negotiation():
    class Mine(executors.Executor):
        name = "mine"

        def heuristic_claim(self, spec, backend):
            return (99, "mine claims cuda") if backend == "cuda" else None

        def _execute(self, spec, x, w, bias, config=None):
            from repro_torch.core import cuconv
            return cuconv.conv_lax(x, w, spec.stride, spec.padding)

    spec = _spec(tcs, SWEEP[0], "float32")
    executors.register(Mine())
    try:
        p = tcs.plan(spec, backend="cuda")
        assert p.algorithm == "mine" and p.source == "heuristic"
        assert tcs.plan(spec, backend="cpu").algorithm != "mine"
    finally:
        executors.unregister("mine")
    assert "mine" not in executors.names()


def test_forced_infeasible_config_raises_naming_executor_config_spec():
    spec = _spec(tcs, SWEEP[0], "float32")
    with pytest.raises(ValueError) as e:
        tcs.plan(spec, force="cuconv_pallas", backend="cuda",
                 config={"rows": 99})
    msg = str(e.value)
    assert "cuconv_pallas" in msg and "'rows': 99" in msg
    assert spec.key() in msg
    with pytest.raises(ValueError, match="no tunable dim"):
        tcs.plan(spec, force="lax", backend="cuda", config={"tm": 8})
    # the JAX package refuses the same forced config
    with pytest.raises(ValueError, match="cuconv_pallas"):
        rcs.plan(_spec(rcs, SWEEP[0], "float32"), force="cuconv_pallas",
                 backend="cpu", config={"rows": 99})


def test_shared_memory_budget_prunes_configs_by_the_kernel_model():
    """The budget is Hopper's 227 KB of shared memory a block can use,
    applied to the same model the kernel wrapper launches with."""
    spec = tcs.ConvSpec((1, 224, 224, 3), (3, 3, 3, 16), padding=(1, 1),
                        epilogue="bias_relu",
                        fused_pool=("max", 2, 2, 2, 2, 0, 0))
    ex = executors.get("cuconv_pallas")
    big = executors.LaunchConfig.of({"tm": 16, "rows": 16})
    ok, why = ex.config_supports(spec, big)
    assert not ok and "shared memory" in why
    assert ex.vmem_bytes(spec, big) == cuconv_fused.smem_bytes(
        spec.in_shape, spec.filter_shape, tm=16, rows=16, pad=(1, 1),
        pool=("max", 2, 2))
    assert ex.vmem_bytes(spec, big) > _build.SMEM_LIMIT
    assert ex.default_config(spec).as_dict() == {"tm": 16, "rows": 8}
    gemm = executors.get("conv1x1_pallas")
    s1 = tcs.ConvSpec((1, 7, 7, 832), (1, 1, 832, 256))
    assert not gemm.config_supports(s1, {"tp": 49, "tm": 128,
                                         "tc": 512})[0]
    assert gemm.default_config(s1).as_dict()["tc"] == 256


def test_persisted_winner_and_configs_replay_and_stale_ones_heal():
    spec = _spec(tcs, SWEEP[0], "float32")
    autotune.record_best(spec, "cuda", "cuconv_pallas",
                         {"tm": 4, "rows": 2})
    p = tcs.plan(spec, backend="cuda")
    assert (p.algorithm, p.source, p.config_source) == (
        "cuconv_pallas", "measured", "measured")
    assert p.config.as_dict() == {"tm": 4, "rows": 2}
    # a config gone stale (rows > OH) is dropped, never served
    autotune.record_config(spec, "cuda", "cuconv_pallas", {"rows": 64})
    p = tcs.plan(spec, backend="cuda")
    assert p.config_source == "default" and p.source == "measured"
    # a persisted winner naming an unregistered executor is ignored
    autotune.record_best(spec, "cuda", "winograd_pallas")
    assert tcs.plan(spec, backend="cuda").source == "heuristic"
    # entries are epilogue-insensitive and backend-distinct
    assert autotune.cached_best(spec, "cpu") is None
    assert autotune.MEASURE_STATS["timed_calls"] == 0


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_plan_never_selects_an_incapable_executor(backend):
    for dtype in ("float32", "bfloat16"):
        for geom in SWEEP:
            spec = _spec(tcs, geom, dtype)
            p = tcs.plan(spec, backend=backend)
            assert executors.get(p.algorithm).supports(spec)[0], p.explain()
            assert p.config is not None
            ok, why = executors.get(p.algorithm).config_supports(spec,
                                                                 p.config)
            assert ok, why


def test_forced_two_stage_on_strided_spec_takes_declared_fallback():
    spec = _spec(tcs, SWEEP[1], "float32")
    p = tcs.plan(spec, force="cuconv_two_stage_pallas", backend="cuda")
    assert p.source == "fallback" and p.algorithm == "lax"
    grouped = _spec(tcs, SWEEP[5], "float32")
    with pytest.raises(ValueError, match="grouped"):
        tcs.plan(grouped, force="cuconv_pallas", backend="cuda")


def test_conv2d_entry_point_plans_for_the_tensors_device():
    import repro_torch
    rng = np.random.default_rng(1)
    x, w = to_torch(rand(rng, (1, 7, 7, 8))), to_torch(rand(rng, (3, 3, 8, 5)))
    b = torch.zeros(5)
    y = repro_torch.conv2d(x, w, bias=b, activation="relu")
    want = torch.relu(executors.get("lax").fn(x, w, padding="same"))
    np.testing.assert_allclose(np32(y), np32(want), rtol=3e-4, atol=3e-4)
    y2 = repro_torch.conv2d(x, w, algorithm="cuconv_pallas")
    np.testing.assert_allclose(np32(y2),
                               np32(executors.get("lax").fn(x, w)),
                               rtol=3e-4, atol=3e-4)
