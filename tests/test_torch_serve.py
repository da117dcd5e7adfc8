"""The port's CnnServeEngine against the JAX package's.

``resnet_like`` served by ``CnnServeEngine(device="cpu",
backend="cuda")`` — planned exactly as on the card, running the kernels'
plain versions — with weights carried across by ``params_from_numpy``
must match the JAX package's engine on the same request stream: within
3e-4 of the output's abs max in fp32, 3e-2 under the bf16 policy.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, ref_params_numpy  # noqa: F401
from repro.models.cnn import resnet_like as ref_resnet_like
from repro.serve import cnn as rserve
from repro_torch.core import convspec as tcs
from repro_torch.models.cnn import params_from_numpy, resnet_like
from repro_torch.serve import cnn as tserve

TOLS = {None: 3e-4, "bf16": 3e-2}


def _engines(image_shape, buckets, precision=None):
    rm, tm = ref_resnet_like(num_classes=4), resnet_like(num_classes=4)
    rparams = rm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(ref_params_numpy(rparams), "cpu")
    ref = rserve.CnnServeEngine(rm, rparams, image_shape, buckets=buckets,
                                precision=precision)
    port = tserve.CnnServeEngine(tm, tparams, image_shape, buckets=buckets,
                                 precision=precision, device="cpu",
                                 backend="cuda")
    return ref, port


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("image_shape,buckets,sizes", [
    ((32, 32, 3), (1, 4), [1, 3, 2, 4, 1]),
    ((16, 16, 3), (1, 2), [2, 1, 2]),
])
def test_served_outputs_match_reference_engine(image_shape, buckets, sizes,
                                               precision):
    ref, port = _engines(image_shape, buckets, precision)
    port.warmup()
    rng = np.random.default_rng(0)
    for i, n in enumerate(sizes):
        im = rng.normal(size=(n,) + image_shape).astype(np.float32)
        ref.submit(rserve.ImageRequest(i, im))
        port.submit(tserve.ImageRequest(i, im))
    tcs.reset_plan_stats()
    got = port.run()
    assert tcs.PLAN_STATS["resolutions"] == 0      # warm: no re-plans
    want = ref.run()
    for a, r in zip(got, want):
        assert a.done and a.out.shape == r.out.shape == (r.images.shape[0], 4)
        r_out = np.asarray(r.out, np.float32)
        np.testing.assert_allclose(
            a.out, r_out, rtol=0,
            atol=TOLS[precision] * np.abs(r_out).max(),
            err_msg=f"request {a.rid}")
    assert port.stats == ref.stats
    assert port.compiled_buckets == tuple(sorted(buckets))
    want_dtype = "bfloat16" if precision else "float32"
    assert port.serve_dtypes() == {b: want_dtype for b in buckets}


def test_bucket_plans_run_the_kernels_the_card_would():
    _, port = _engines((32, 32, 3), (1, 4))
    for b in (1, 4):
        gp = port.programs.plan(b)
        assert gp.backend == "cuda"
        algos = {n: p.algorithm for n, p in gp.conv_plans.items()}
        assert algos["stem"] == algos["b1c2"] == "cuconv_pallas"
    # batch 4's b1c1 is winograd_pallas, as in the JAX package
    b1c1 = port.programs.plan(4).conv_plans["b1c1"]
    assert (b1c1.algorithm, b1c1.source) == ("winograd_pallas", "heuristic")
    assert port.programs.plan(1).conv_plans["b1c1"].algorithm == \
        "cuconv_pallas"


@pytest.mark.parametrize("units,bucket", [(1, 1), (3, 4), (5, 4), (8, 4)])
def test_packing_helpers_match_reference(units, bucket):
    rng = np.random.default_rng(units)
    reqs_r, reqs_t, chunk_r, chunk_t = [], [], [], []
    for i, n in enumerate((2, 1, 3, 2)):
        im = rng.normal(size=(n, 4, 4, 3)).astype(np.float32)
        reqs_r.append(rserve.ImageRequest(i, im))
        reqs_t.append(tserve.ImageRequest(i, im))
    for rr, tr in zip(reqs_r, reqs_t):
        chunk_r += [(rr, j) for j in range(rr.images.shape[0])]
        chunk_t += [(tr, j) for j in range(tr.images.shape[0])]
    chunk_r, chunk_t = chunk_r[:units], chunk_t[:units]
    b = max(bucket, units)
    xr = rserve.pack_units(chunk_r, b, (4, 4, 3), np.float32)
    xt = tserve.pack_units(chunk_t, b, (4, 4, 3), np.float32)
    np.testing.assert_array_equal(xt, xr)
    assert ([(r.rid, i0, i1) for r, i0, i1 in
             tserve.contiguous_blocks(chunk_t)]
            == [(r.rid, i0, i1) for r, i0, i1 in
                rserve.contiguous_blocks(chunk_r)])
    y = rng.normal(size=(b, 2)).astype(np.float32)
    rserve.scatter_outputs(chunk_r, y)
    tserve.scatter_outputs(chunk_t, y)
    for (rr, i0, i1), (tr, _, _) in zip(rserve.contiguous_blocks(chunk_r),
                                        tserve.contiguous_blocks(chunk_t)):
        np.testing.assert_array_equal(tr.out[i0:i1], rr.out[i0:i1])


def test_engine_refuses_bad_requests_and_buckets():
    _, port = _engines((8, 8, 3), (2,))
    with pytest.raises(ValueError, match="image shape"):
        port.submit(tserve.ImageRequest(0, np.zeros((1, 9, 8, 3))))
    with pytest.raises(ValueError):
        tserve.ImageRequest(0, np.zeros((8, 3)))
    with pytest.raises(ValueError, match="buckets"):
        tserve.CnnServeEngine(resnet_like(), {}, (8, 8, 3), buckets=(),
                              device="cpu")
    # an engine on the CPU planning for the card cannot tune for it
    with pytest.raises(ValueError, match="backend"):
        port.warmup(tune="algo")


def test_smoke_deployment_is_the_reference_one():
    from repro.configs import serve as rcfg
    from repro_torch.configs import serve as tcfg
    assert tcfg.SMOKE_FRONTEND == tcfg.FrontendConfig(
        **{f: getattr(rcfg.SMOKE_FRONTEND, f) for f in (
            "geometries", "max_wait_ms", "default_deadline_ms",
            "pipeline_depth")})
    assert (tcfg.SMOKE_FRONTEND.geometry_map()
            == rcfg.SMOKE_FRONTEND.geometry_map())
    assert tcfg.DEFAULT_SLO_MS == rcfg.DEFAULT_SLO_MS


def _calibrate_both(ref_model, rparams, x):
    """Calibrate the JAX package's resnet_like and hand its
    calibration.json to the port under the same keys, so both packages
    quantize with the same scales."""
    import json
    from repro.quant import calibrate as rcal
    from repro_torch.quant import calibrate as tcal
    ref_model.graph_plan(x.shape).warmup(
        calibrate=rcal.Calibrator(x, rparams))
    for key, entry in json.loads(rcal._STORE.path().read_text()).items():
        tcal._STORE.put(key, entry)


@pytest.mark.parametrize("skip_first_last", [True, False])
def test_int8_serving_matches_direct_plan_and_reference(skip_first_last):
    """A calibrated resnet_like served by ``CnnServeEngine(precision=
    QuantPolicy())`` on the CPU: every bucket serves int8, the served
    outputs equal the direct quantized plan's, and the JAX package's
    int8 engine agrees — within 1e-5 of the output's abs max when every
    conv is int8 (each node sees the same input in both packages), and
    within the 0.05 accuracy bound under the default policy, whose fp32
    stem may move an int8 code of the next node by one step."""
    from repro.quant.policy import QuantPolicy as RQuantPolicy
    from repro_torch.quant.accuracy import DEFAULT_BOUND
    from repro_torch.quant.policy import QuantPolicy
    rm, tm = ref_resnet_like(num_classes=4), resnet_like(num_classes=4)
    rparams = rm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(ref_params_numpy(rparams), "cpu")
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)) \
        .astype(np.float32)
    _calibrate_both(rm, rparams, x)
    kw = dict(skip_first_last=skip_first_last)
    port = tserve.CnnServeEngine(tm, tparams, (32, 32, 3), buckets=(1, 4),
                                 precision=QuantPolicy(**kw), device="cpu",
                                 backend="cuda")
    ref = rserve.CnnServeEngine(rm, rparams, (32, 32, 3), buckets=(1, 4),
                                precision=RQuantPolicy(**kw))
    port.warmup()
    want_dtype = "int8" if not skip_first_last else "float32+int8"
    assert port.serve_dtypes() == ref.serve_dtypes() == {
        1: want_dtype, 4: want_dtype}
    sizes = [1, 3, 2, 4, 1]
    rng = np.random.default_rng(1)
    for i, n in enumerate(sizes):
        im = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
        port.submit(tserve.ImageRequest(i, im))
        ref.submit(rserve.ImageRequest(i, im))
    got, want = port.run(), ref.run()
    direct = tm.graph_plan(x.shape, backend="cuda",
                           precision=QuantPolicy(**kw))
    tol = 1e-5 if not skip_first_last else DEFAULT_BOUND
    for a, r in zip(got, want):
        r_out = np.asarray(r.out, np.float32)
        np.testing.assert_allclose(a.out, r_out, rtol=0,
                                   atol=tol * np.abs(r_out).max())
        if a.images.shape[0] == 4:
            d = direct.run(torch.from_numpy(a.images), tparams).numpy()
            np.testing.assert_allclose(a.out, d, rtol=1e-5, atol=1e-5)
    assert port.stats == ref.stats
