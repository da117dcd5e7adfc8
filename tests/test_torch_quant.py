"""The port's int8 subsystem against the JAX package's (mirrors
``tests/test_quant.py``; its ``tune="full"`` and ``AsyncServeFrontend``
parts are not ported).

The same seeded numpy inputs and weights go through both packages.  For
the same inputs the int8 codes, the int32 accumulators and the
calibrated amax are bit-equal, and ``calibration.json`` holds its entries
under identical keys.  A whole int8 ``resnet_like`` agrees with the JAX
package's within 1e-5 of the output's abs max when every conv node is
int8, so each node sees the same input in both packages; under the
default policy the fp32 stem in front of the first int8 node differs in
its last bits between the packages, which can move one int8 code by one
step, so there the comparison is the documented accuracy bound.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (_clear_port_caches, np32, rand, to_jax,  # noqa: F401
                           to_torch, ref_params_numpy)
from repro.core import convspec as rcs
from repro.models import cnn as RM
from repro.quant import calibrate as rcal
from repro.quant import symmetric as rsym
from repro.quant.policy import QuantPolicy as RQuantPolicy
from repro_torch.core import convspec as tcs
from repro_torch.core import executors
from repro_torch.core.graph import GraphBuilder, PrecisionPolicy
from repro_torch.models import cnn as TM
from repro_torch.quant import calibrate as cal
from repro_torch.quant import symmetric
from repro_torch.quant.accuracy import DEFAULT_BOUND, assert_accuracy
from repro_torch.quant.policy import QuantPolicy


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sample_batch(rng, batch=4, shape=(32, 32, 3)):
    return np.asarray(rng.standard_normal((batch,) + shape), np.float32)


def _tiny_model():
    """Two eligible convs + head (the reference test's tiny model)."""
    def build(in_shape, dtype):
        b = GraphBuilder(in_shape, dtype)
        y = b.conv("c0", "input", 3, 6)
        y = b.conv("c1", y, 1, 8)
        y = b.gap("gap", y)
        b.dense("head", y, 3)
        return b.graph()
    return TM.GraphModel(build, (8, 8, 3), name="tinyq")


def _models(seed=0):
    """resnet_like in both packages, the JAX package's weights carried
    across."""
    rm, tm = RM.resnet_like(), TM.resnet_like()
    rparams = rm.init(jax.random.PRNGKey(seed))
    return rm, rparams, tm, TM.params_from_numpy(ref_params_numpy(rparams),
                                                 "cpu")


def _calibrated_resnet(rng, batch=4):
    """The port's resnet_like + params + a sample batch, calibrated."""
    _, _, m, params = _models()
    x = _sample_batch(rng, batch)
    out = m.graph_plan(x.shape).warmup(device="cpu",
                                       calibrate=cal.Calibrator(x, params))
    return m, params, x, out["calibration"]


# ---------------------------------------------------------------------------
# symmetric helpers

def test_symmetric_codes_are_bit_equal_to_reference(rng):
    x = rng.normal(size=(4096,)).astype(np.float32) * 3.0
    scale = symmetric.scale_for(symmetric.abs_max(torch.from_numpy(x)))
    rscale = rsym.scale_for(rsym.abs_max(jnp.asarray(x)))
    assert np.float32(scale.item()) == np.float32(rscale)
    q = symmetric.quantize_to_int8(torch.from_numpy(x), scale)
    rq = rsym.quantize_to_int8(jnp.asarray(x), rscale)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    # exact halves round to even, as jnp.round does
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0])
    np.testing.assert_array_equal(
        symmetric.quantize_to_int8(halves, torch.tensor(1.0)).numpy(),
        np.asarray(rsym.quantize_to_int8(jnp.asarray(halves.numpy()),
                                         jnp.float32(1.0))))
    w = rng.normal(size=(3, 3, 6, 5)).astype(np.float32)
    ws = symmetric.channel_scales(torch.from_numpy(w))
    rws = rsym.channel_scales(jnp.asarray(w))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(rws))
    np.testing.assert_array_equal(
        symmetric.quantize_to_int8(torch.from_numpy(w), ws).numpy(),
        np.asarray(rsym.quantize_to_int8(jnp.asarray(w), rws)))


def test_symmetric_roundtrip_and_zero_scale(rng):
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32) * 3.0)
    scale = symmetric.scale_for(symmetric.abs_max(x))
    back = symmetric.dequantize_int8(symmetric.quantize_to_int8(x, scale),
                                     scale)
    assert float((back - x).abs().max()) <= float(scale) / 2 + 1e-7
    z = symmetric.quantize_to_int8(torch.zeros(4), torch.tensor(0.0))
    assert not z.any()


# ---------------------------------------------------------------------------
# calibration persistence

def test_calibration_keys_and_entries_match_reference(rng, tmp_path,
                                                      monkeypatch):
    """The same model, weights and sample batch give calibration.json
    entries under identical keys, with identical specs and counts; the
    amax of the stem (whose input is the same array in both packages) is
    bit-equal, and the others agree to the last bits of the fp32 convs
    in front of them."""
    x = _sample_batch(rng)
    rm, rparams, tm, tparams = _models()
    rm.graph_plan(x.shape).warmup(calibrate=rcal.Calibrator(x, rparams))
    tm.graph_plan(x.shape).warmup(device="cpu",
                                  calibrate=cal.Calibrator(x, tparams))
    ref = json.loads(rcal._STORE.path().read_text())
    port = json.loads(cal._STORE.path().read_text())
    assert cal._STORE.path().parent.name == "torch"
    assert sorted(port) == sorted(ref) and len(port) == 6
    for key, e in port.items():
        r = ref[key]
        assert {k: e[k] for k in ("schema", "spec", "batches", "samples")} \
            == {k: r[k] for k in ("schema", "spec", "batches", "samples")}
        assert e["amax"] == pytest.approx(r["amax"], rel=1e-6)
        assert e["pct"]["99.9"] == pytest.approx(r["pct"]["99.9"], rel=1e-5)
    stem = f"{cal.graph_key(tm.graph(x.shape))}/stem"
    assert stem == f"{rcal.graph_key(rm.graph(x.shape))}/stem"
    assert port[stem]["amax"] == ref[stem]["amax"]
    assert port[stem]["pct"] == ref[stem]["pct"]


def test_calibration_determinism(rng, tmp_path, monkeypatch):
    x = _sample_batch(rng)

    def calibrate_fresh(store):
        monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / store))
        cal.clear_cache()
        _, _, m, params = _models()
        cal.Calibrator(x, params).collect(m.graph_plan(x.shape))
        return json.loads((tmp_path / store / "torch" /
                           "calibration.json").read_text())

    first, second = calibrate_fresh("a"), calibrate_fresh("b")
    assert first == second and len(first) >= 6


def test_calibration_entry_schema_gate():
    g = TM.resnet_like().graph((1, 32, 32, 3))
    key = f"{cal.graph_key(g)}/stem"
    for bad in [{"amax": 1.0},
                {"schema": cal.CALIB_SCHEMA + 1, "amax": 1.0},
                {"schema": cal.CALIB_SCHEMA, "amax": "big"},
                "not-a-dict"]:
        cal._STORE.put(key, bad)
        assert cal.calibration_entry(g, "stem") is None


def test_calibration_is_batch_and_dtype_normalized(rng):
    m, params, x, entries = _calibrated_resnet(rng, batch=4)
    assert set(entries) >= {"stem", "b1c1", "b1c2", "b2c1", "b2c2", "b2proj"}
    for in_shape, dtype in [((1, 32, 32, 3), "float32"),
                            ((8, 32, 32, 3), "float32"),
                            ((4, 32, 32, 3), "bfloat16")]:
        g = m.graph(in_shape, dtype=dtype)
        e = cal.calibration_entry(g, "b1c1")
        assert e is not None and e["amax"] > 0
        assert e["spec"].startswith("n*h") and "-*-" in e["spec"]
        assert cal.graph_key(g) == rcal.graph_key(
            RM.resnet_like().graph(in_shape, dtype=dtype))


def test_recalibration_merges_running_max(rng):
    _, _, m, params = _models()
    small = _sample_batch(rng) * 0.1
    big = _sample_batch(rng) * 10.0
    gp = m.graph_plan(small.shape)
    gen = cal.generation()
    first = cal.Calibrator(small, params).collect(gp)["stem"]
    merged = cal.Calibrator(big, params).collect(gp)["stem"]
    assert merged["amax"] >= first["amax"]
    assert merged["batches"] == first["batches"] + 1
    assert cal.generation() > gen


# ---------------------------------------------------------------------------
# the quantize pass: eligibility gates and provenance

def test_quantize_gates_and_provenance_match_reference(rng):
    m, params, x, _ = _calibrated_resnet(rng)
    rm, rparams, _, _ = _models()
    rm.graph_plan(x.shape).warmup(calibrate=rcal.Calibrator(x, rparams))
    for kw in ({}, {"skip": ("b1c1",)}, {"skip_first_last": False}):
        gp = m.graph_plan(x.shape, precision=QuantPolicy(**kw))
        rgp = rm.graph_plan(x.shape, precision=RQuantPolicy(**kw))
        assert ({n: (q.dtype, q.source) for n, q in gp.quant.items()}
                == {n: (q.dtype, q.source) for n, q in rgp.quant.items()})
    gp = m.graph_plan(x.shape, precision=QuantPolicy())
    assert sorted(n for n, q in gp.quant.items() if q.quantized) == [
        "b1c1", "b1c2", "b2c1", "b2c2"]
    assert gp.quant["stem"].source == "fp:first"
    assert gp.quant["b2proj"].source == "fp:last"
    assert {n: p.algorithm for n, p in gp.conv_plans.items()} == {
        "stem": "cuconv_pallas", "b1c1": "cuconv_int8",
        "b1c2": "cuconv_int8", "b2c1": "cuconv_int8",
        "b2c2": "cuconv_int8", "b2proj": "cuconv_pallas"}
    assert all(gp.conv_plans[n].quant.x_scale == gp.quant[n].x_scale
               for n in ("b1c1", "b1c2", "b2c1", "b2c2"))


def test_uncalibrated_model_stays_fp(rng):
    m = _tiny_model()
    params = m.init(0, device="cpu")
    x = torch.from_numpy(_sample_batch(rng, batch=2, shape=(8, 8, 3)))
    gp = m.graph_plan(x.shape,
                      precision=QuantPolicy(skip_first_last=False))
    assert all(q.source == "fp:no-calibration" for q in gp.quant.values())
    y_fp = m.graph_plan(x.shape,
                        precision=PrecisionPolicy("float32")).run(x, params)
    np.testing.assert_allclose(np32(gp.run(x, params)), np32(y_fp),
                               rtol=1e-5, atol=1e-5)


def test_stale_calibration_falls_back_until_recalibrated(rng):
    m, params, x, _ = _calibrated_resnet(rng)
    g = m.graph(x.shape)
    key = f"{cal.graph_key(g)}/b1c1"
    stale = dict(cal._STORE.get(key))
    stale["spec"] = "n*h9w9c9-k9x9m9-s9x9-p9x9-*-none"
    cal._STORE.put(key, stale)
    gq = m.graph_plan(x.shape, precision=QuantPolicy())
    assert gq.quant["b1c1"].source == "fp:stale-calibration"
    assert gq.quant["b1c2"].quantized
    m.graph_plan(x.shape).warmup(device="cpu",
                                 calibrate=cal.Calibrator(x, params))
    assert m.graph_plan(x.shape,
                        precision=QuantPolicy()).quant["b1c1"].quantized


def test_quant_policy_keys_match_reference():
    kws = [{}, {"observer": "percentile"}, {"skip_first_last": False},
           {"skip": ("stem",)}, {"default": "bf16"}]
    keys = [QuantPolicy(**kw).key() for kw in kws]
    assert keys == [RQuantPolicy(**kw).key() for kw in kws]
    assert len(set(keys) | {PrecisionPolicy("float32").key()}) == 6
    assert QuantPolicy().quantizer() == QuantPolicy()
    assert PrecisionPolicy().quantizer() is None
    assert isinstance(QuantPolicy(), PrecisionPolicy)
    with pytest.raises(ValueError):
        QuantPolicy(observer="entropy")


# ---------------------------------------------------------------------------
# the int8 executor

def _int8_spec(mod, x, w, b):
    spec = mod.ConvSpec.for_conv(x, w, 1, "same", bias=b, activation="relu")
    return spec, dataclasses.replace(spec, dtype="int8")


def test_int8_executor_matches_reference_and_explains(rng):
    x = rand(rng, (2, 10, 10, 6))
    w = (rng.normal(size=(3, 3, 6, 5)) * 0.1).astype(np.float32)
    b = rand(rng, (5,))
    spec, q8 = _int8_spec(tcs, to_torch(x), to_torch(w), to_torch(b))
    assert "cuconv_int8" in executors.supporting(q8)
    plan = tcs.plan(q8, backend="cuda")
    assert plan.executor.name == "cuconv_int8"
    assert "int8" in plan.explain() and "int32" in plan.explain()
    got = plan(to_torch(x), to_torch(w), to_torch(b), None)
    _, rq8 = _int8_spec(rcs, to_jax(x), to_jax(w), to_jax(b))
    want = np32(rcs.plan(rq8, backend="cpu")(to_jax(x), to_jax(w),
                                             to_jax(b), None))
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    y_fp = np32(tcs.plan(spec, backend="cuda")(to_torch(x), to_torch(w),
                                               to_torch(b), None))
    assert np.abs(np32(got) - y_fp).max() / np.abs(y_fp).max() \
        < DEFAULT_BOUND


def test_int8_accumulator_is_bit_equal_to_reference(rng):
    """The executor's bare int8 conv (patch matrix -> int8 GEMM) gives
    the reference's int32 accumulator for the same codes."""
    ex = executors.get("cuconv_int8")
    from repro.core import executors as rex
    x = rng.integers(-127, 128, (2, 9, 9, 4)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 4, 7)).astype(np.int8)
    tspec = tcs.ConvSpec((2, 9, 9, 4), (3, 3, 4, 7), (2, 2), (1, 1), "int8")
    rspec = rcs.ConvSpec((2, 9, 9, 4), (3, 3, 4, 7), (2, 2), (1, 1), "int8")
    got = ex._execute(tspec, torch.from_numpy(x), torch.from_numpy(w), None)
    want = rex.get("cuconv_int8")._execute(rspec, jnp.asarray(x),
                                           jnp.asarray(w), None, True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_per_channel_weight_scales(rng):
    x = to_torch(rand(rng, (1, 8, 8, 4)))
    w = to_torch(rand(rng, (3, 3, 4, 3))) * torch.tensor([1e-2, 1.0, 1e2])
    spec = tcs.ConvSpec.for_conv(x, w, 1, "same")
    y_fp = np32(tcs.plan(spec, backend="cuda")(x, w, None, None))
    y_q = np32(tcs.plan(dataclasses.replace(spec, dtype="int8"),
                        backend="cuda")(x, w, None, None))
    for ch in range(3):
        ref = np.abs(y_fp[..., ch]).max()
        assert np.abs(y_q[..., ch] - y_fp[..., ch]).max() / ref < 0.05


@pytest.mark.parametrize("epilogue,fused_add", [("bias_relu", "none"),
                                                ("bias", "add_relu")])
def test_spec_accuracy_matches_reference(epilogue, fused_add):
    """Per-layer int8 error on the same seeded operands: the same int8
    codes in both packages, so the same error up to the fp32 twin's last
    bits."""
    from repro.quant.accuracy import spec_accuracy as rspec_accuracy
    from repro_torch.quant.accuracy import spec_accuracy
    kw = dict(padding=(1, 1), epilogue=epilogue, fused_add=fused_add)
    got = spec_accuracy(tcs.ConvSpec((2, 9, 9, 6), (3, 3, 6, 8), **kw),
                        seed=3, device="cpu")
    want = rspec_accuracy(rcs.ConvSpec((2, 9, 9, 6), (3, 3, 6, 8), **kw),
                          seed=3)
    assert got["rel_err"] < DEFAULT_BOUND
    assert got["ref_absmax"] == pytest.approx(want["ref_absmax"], rel=1e-5)
    assert got["rel_err"] == pytest.approx(want["rel_err"], rel=1e-3)


# ---------------------------------------------------------------------------
# end to end: quantized graphs against the JAX package

def test_int8_resnet_like_run_matches_reference(rng):
    x = _sample_batch(rng)
    rm, rparams, tm, tparams = _models()
    rm.graph_plan(x.shape).warmup(calibrate=rcal.Calibrator(x, rparams))
    # the reference's calibration.json, read by the port under the same
    # keys: both packages quantize with the same scales
    for key, entry in json.loads(rcal._STORE.path().read_text()).items():
        cal._STORE.put(key, entry)
    pol = dict(skip_first_last=False)
    want = np32(rm.graph_plan(x.shape, precision=RQuantPolicy(**pol))
                .run(x, rparams))
    gp = tm.graph_plan(x.shape, backend="cuda", precision=QuantPolicy(**pol))
    assert sorted(n for n, q in gp.quant.items() if q.quantized) == [
        "b1c1", "b1c2", "b2c1", "b2c2", "b2proj", "stem"]
    got = np32(gp.run(torch.from_numpy(x), tparams))
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the default policy: fp32 stem and b2proj around four int8 nodes
    want = np32(rm.graph_plan(x.shape, precision=RQuantPolicy())
                .run(x, rparams))
    got = np32(tm.graph_plan(x.shape, backend="cuda",
                             precision=QuantPolicy())
               .run(torch.from_numpy(x), tparams))
    assert np.abs(got - want).max() <= DEFAULT_BOUND * np.abs(want).max()


def test_quantized_resnet_accuracy_and_explain(rng):
    m, params, x, _ = _calibrated_resnet(rng)
    rep = assert_accuracy(m, params, x)
    assert rep["rel_err"] <= DEFAULT_BOUND
    assert rep["quantized_nodes"] == ["b1c1", "b1c2", "b2c1", "b2c2"]
    assert rep["fp_nodes"] == {"stem": "fp:first", "b2proj": "fp:last"}
    text = m.graph_plan(x.shape, precision=QuantPolicy()).explain()
    assert "quant[int8<-calib:absmax]" in text
    assert "fused[add]=b1add quant[int8" in text
