"""The port's async serving front end against the JAX package's.

Mirrors ``tests/test_frontend.py`` case by case: each scenario runs once
through ``repro.serve.frontend.AsyncServeFrontend`` (XLA:CPU, Pallas in
interpret mode) and once through ``repro_torch``'s
(``device="cpu", backend="cuda"``: planned as on the card, the kernels'
plain versions), with the same params (``params_from_numpy``), the same
numpy images and the same clock script (a ``FakeClock`` per package,
advanced in step).  Scheduling decisions must be equal — statuses,
``DeadlineExceeded`` lateness, completion order, ``batches_by_program``,
``slo_closes``, ``overlapped_batches``, ``max_inflight``, and under a
fake clock the whole ``stats()`` — and outputs within 3e-4 of the
reference's abs max.  Then the int8 case of
``tests/test_quant.py::test_quantized_serving_end_to_end``, the packing
property of ``tests/test_serve_properties.py``, and the one deliberate
difference: a request's ``compute_ms`` is the union of its batches'
in-flight windows, never more than its ``total_ms``.
"""
import json

import jax
import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # deterministic fallback; see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import _clear_port_caches, ref_params_numpy  # noqa: F401
from repro.models import cnn as rcnn
from repro.serve import frontend as rfe
from repro_torch.core import convspec as tcs
from repro_torch.models import cnn as tcnn
from repro_torch.serve import frontend as tfe

TINY = [(3, 3, 6, 2), (1, 1, 4, 1)]
TOL = 3e-4
#: the scheduling half of stats(): equal whatever the clock
DECISIONS = ("requests", "served", "deadline_misses", "images", "batches",
             "padded_slots", "overlapped_batches", "geometries",
             "batches_by_program", "serve_dtype_by_program", "pending",
             "inflight", "max_inflight", "slo_closes", "late_served",
             "serve_dtypes")


class FakeClock:
    """Deterministic injectable clock (seconds); advance in ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance_ms(self, ms: float) -> None:
        self.t += ms / 1e3


class TickClock(FakeClock):
    """A clock that advances 1 ms every time it is read."""

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def _chain_params_numpy(params):
    return {"convs": [{k: np.asarray(v, np.float32) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"], np.float32)}


def _models(which="tiny"):
    """(reference model, params), (port model, params): same weights."""
    if which == "tiny":
        rm = rcnn.SimpleCNN(TINY, num_classes=3)
        tm = tcnn.SimpleCNN(TINY, num_classes=3)
        rp = rm.init(jax.random.PRNGKey(0))
        tp = tcnn.params_from_numpy(_chain_params_numpy(rp), "cpu")
    else:
        rm = rcnn.resnet_like(num_classes=4)
        tm = tcnn.resnet_like(num_classes=4)
        rp = rm.init(jax.random.PRNGKey(0))
        tp = tcnn.params_from_numpy(ref_params_numpy(rp), "cpu")
    return (rm, rp), (tm, tp)


def _both(geoms, *, model="tiny", clock=FakeClock, warm=True, **kw):
    """A reference and a port frontend over the same params, each with
    its own clock; returns ``[(frontend, clock), (frontend, clock)]``."""
    (rm, rp), (tm, tp) = _models(model)
    out = []
    for cls, m, p, extra in ((rfe.AsyncServeFrontend, rm, rp, {}),
                             (tfe.AsyncServeFrontend, tm, tp,
                              dict(device="cpu", backend="cuda"))):
        c = clock() if clock is not None else None
        fe = cls(m, p, geoms, **kw, **extra,
                 **({} if c is None else {"clock": c}))
        if warm:
            fe.warmup()
        out.append((fe, c))
    return out


def _requests(rng, sizes, deadlines=None):
    """Per request (images, deadline_ms), the same for both packages."""
    return [(rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
             None if deadlines is None else deadlines[i])
            for i, (n, hw) in enumerate(sizes)]


def _submit(fe, mod, reqs):
    out = [mod.ServeRequest(rid=i, images=im, deadline_ms=d)
           for i, (im, d) in enumerate(reqs)]
    for r in out:
        fe.submit(r)
    return out


def _same_decisions(ref, port, *, whole_stats):
    """Equal scheduling decisions (and, under a fake clock, equal
    stats() in full)."""
    sr, sp = ref.stats(), port.stats()
    for k in DECISIONS:
        assert sp.get(k) == sr.get(k), (k, sp.get(k), sr.get(k))
    if whole_stats:
        assert sp == sr
    assert [(b.geometry, b.bucket, b.units, b.overlapped)
            for b in port.telemetry.batches] == [
        (b.geometry, b.bucket, b.units, b.overlapped)
        for b in ref.telemetry.batches]


def _same_outputs(ref_reqs, port_reqs, tol=TOL):
    for r, p in zip(ref_reqs, port_reqs):
        assert (r.status, r.done, r.rid) == (p.status, p.done, p.rid)
        if r.out is None:
            assert p.out is None
            continue
        want = np.asarray(r.out, np.float32)
        assert p.out.shape == want.shape
        np.testing.assert_allclose(p.out, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"request {r.rid}")


# ---------------------------------------------------------------------------
# correctness: multi-resolution serving

def test_multi_resolution_mixed_stream_matches_reference(rng):
    (fr, _), (fp, _) = _both({(16, 16, 3): (1, 4), (8, 8, 3): (1, 2)},
                             clock=None)
    reqs = _requests(rng, [(1, 16), (3, 8), (5, 16), (2, 8), (1, 8),
                           (4, 16)])
    rr, rp = _submit(fr, rfe, reqs), _submit(fp, tfe, reqs)
    done_r = fr.run()
    tcs.reset_plan_stats()
    done_p = fp.run()
    assert tcs.PLAN_STATS["resolutions"] == 0   # warm frontend: no re-plans
    assert [r.rid for r in done_p] == [r.rid for r in done_r]
    assert all(r.status == tfe.SERVED and r.done for r in done_p)
    _same_decisions(fr, fp, whole_stats=False)
    _same_outputs(rr, rp)
    assert set(fp.stats()["geometries"]) == {"16x16x3", "8x8x3"}


def test_rejects_unserved_geometry(rng):
    (_, _), (tm, tp) = _models()
    fe = tfe.AsyncServeFrontend(tm, tp, {(8, 8, 3): (1,)}, device="cpu")
    with pytest.raises(ValueError, match="matches no served geometry"):
        fe.submit(tfe.ServeRequest(rid=0, images=rng.normal(
            size=(1, 12, 12, 3)).astype(np.float32)))
    with pytest.raises(ValueError, match="geometries"):
        tfe.AsyncServeFrontend(tm, tp, {}, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        tfe.AsyncServeFrontend(tm, tp, {(8, 8, 3): (1,)}, device="cpu",
                               pipeline_depth=0)


# ---------------------------------------------------------------------------
# deadline-aware admission

def test_expired_request_rejected_with_typed_result(rng):
    pair = _both({(8, 8, 3): (2,)})
    reqs = _requests(rng, [(2, 8), (1, 8)], deadlines=[10.0, 10_000.0])
    subs, dones = [], []
    for (fe, clock), mod in zip(pair, (rfe, tfe)):
        subs.append(_submit(fe, mod, reqs))
        clock.advance_ms(50.0)      # past late's deadline, within ok's
        dones.append(fe.run())
    (fr, _), (fp, _) = pair
    by_rid = {r.rid: r for r in dones[1]}
    ref_late = {r.rid: r for r in dones[0]}[0]
    assert by_rid[0].status == tfe.DEADLINE_EXCEEDED
    assert isinstance(by_rid[0].error, tfe.DeadlineExceeded)
    assert (by_rid[0].error.rid, by_rid[0].error.deadline_ms,
            by_rid[0].error.lateness_ms) == (
        ref_late.error.rid, ref_late.error.deadline_ms,
        ref_late.error.lateness_ms)
    assert by_rid[0].error.lateness_ms == pytest.approx(40.0)
    assert str(by_rid[0].error) == str(ref_late.error)
    assert by_rid[0].out is None and by_rid[0].done
    assert by_rid[1].status == tfe.SERVED and by_rid[1].out is not None
    _same_decisions(fr, fp, whole_stats=True)
    _same_outputs(*subs)
    assert fp.stats()["deadline_misses"] == 1


def test_default_deadline_applies_to_unmarked_requests(rng):
    pair = _both({(8, 8, 3): (1,)}, default_deadline_ms=20.0)
    reqs = _requests(rng, [(1, 8), (1, 8)], deadlines=[None, 500.0])
    dones = []
    for (fe, clock), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        clock.advance_ms(100.0)
        dones.append([(r.rid, r.status) for r in fe.run()])
    assert dones[1] == dones[0]
    assert dict(dones[1]) == {0: tfe.DEADLINE_EXCEEDED, 1: tfe.SERVED}
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)


def test_admission_is_edf_within_a_bucket(rng):
    """Earlier deadlines dispatch first regardless of submit order."""
    pair = _both({(8, 8, 3): (1,)}, clock=None)
    reqs = _requests(rng, [(1, 8)] * 3, deadlines=[60_000.0, 1_000.0, None])
    orders = []
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        a, b, c = [mod.ServeRequest(rid=i, images=im, deadline_ms=d)
                   for i, (im, d) in enumerate(reqs)]
        for r in (a, c, b):
            fe.submit(r)
        orders.append([r.rid for r in fe.run()])
    assert orders[1] == orders[0] == [1, 0, 2]


def test_committed_request_completes_despite_late_deadline(rng):
    pair = _both({(8, 8, 3): (2,)}, pipeline_depth=2)
    reqs = _requests(rng, [(3, 8)], deadlines=[10.0])
    subs, dones = [], []
    for (fe, clock), mod in zip(pair, (rfe, tfe)):
        subs.append(_submit(fe, mod, reqs))
        fe.poll()                   # bucket-full: dispatches (r, 0..1)
        clock.advance_ms(50.0)      # deadline passes mid-request
        dones.append([(r.rid, r.status) for r in fe.run()])
    assert dones[1] == dones[0] == [(0, tfe.SERVED)]
    st_ = pair[1][0].stats()
    assert st_["deadline_misses"] == 0 and st_["late_served"] == 1
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)
    _same_outputs(*subs)


# ---------------------------------------------------------------------------
# continuous batching: the bucket-full-or-max-wait close policy

def test_short_batch_waits_for_max_wait(rng):
    pair = _both({(8, 8, 3): (4,)}, max_wait_ms=10.0)
    reqs = _requests(rng, [(1, 8)])
    for (fe, clock), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        assert fe.poll() == [] and fe.stats()["batches"] == 0
        clock.advance_ms(5.0)
        assert fe.poll() == [] and fe.stats()["batches"] == 0   # not yet
        clock.advance_ms(6.0)                                   # 11 > 10
        fe.poll()
        done = fe.flush()
        assert [r.rid for r in done] == [0] and done[0].status == "served"
    st_ = pair[1][0].stats()
    assert st_["batches"] == 1 and st_["padded_slots"] == 3
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)


def test_full_bucket_dispatches_without_waiting(rng):
    pair = _both({(8, 8, 3): (1, 4)}, max_wait_ms=10_000.0)
    reqs = _requests(rng, [(4, 8)])
    subs = []
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        subs.append(_submit(fe, mod, reqs))
        fe.poll()                   # zero wall-clock has passed
        assert [r.rid for r in fe.flush()] == [0]
    st_ = pair[1][0].stats()
    assert st_["batches"] == 1 and st_["padded_slots"] == 0
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)
    _same_outputs(*subs)


def test_tight_deadline_closes_batch_before_max_wait(rng):
    pair = _both({(8, 8, 3): (4,)}, max_wait_ms=10.0)
    reqs = _requests(rng, [(1, 8)], deadlines=[3.0])
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        fe.poll()                   # slack 3ms < 10ms remaining wait
        done = fe.flush()
        assert [r.rid for r in done] == [0] and done[0].status == "served"
    st_ = pair[1][0].stats()
    assert st_["slo_closes"] == 1
    assert st_["batches"] == 1 and st_["padded_slots"] == 3
    assert st_["deadline_misses"] == 0 and st_["late_served"] == 0
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)


def test_loose_deadline_still_waits_for_max_wait(rng):
    pair = _both({(8, 8, 3): (4,)}, max_wait_ms=10.0)
    reqs = _requests(rng, [(1, 8)], deadlines=[50.0])
    for (fe, clock), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        assert fe.poll() == [] and fe.stats()["batches"] == 0
        clock.advance_ms(4.0)       # slack 46ms > 6ms remaining: wait on
        assert fe.poll() == [] and fe.stats()["batches"] == 0
        clock.advance_ms(7.0)       # 11ms > max_wait: the NORMAL close
        fe.poll()
        assert [r.rid for r in fe.flush()] == [0]
    assert pair[1][0].stats()["slo_closes"] == 0
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)


@pytest.mark.parametrize("margin,closes", [(0.0, 0), (5.0, 1)])
def test_slo_close_margin_adds_service_headroom(rng, margin, closes):
    """A 12ms deadline against 10ms of remaining wait is loose at margin
    0 but tight at margin 5 (12 <= 10 + 5)."""
    pair = _both({(8, 8, 3): (4,)}, max_wait_ms=10.0,
                 slo_close_margin_ms=margin, warm=bool(margin))
    reqs = _requests(rng, [(1, 8)], deadlines=[12.0])
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        got = fe.poll()
        assert got == [] and fe.stats()["slo_closes"] == closes
        if closes:
            done = fe.flush()
            assert [r.rid for r in done] == [0]
            assert done[0].status == "served"
    _same_decisions(pair[0][0], pair[1][0], whole_stats=True)


# ---------------------------------------------------------------------------
# double-buffered dispatch

def test_steady_state_batches_overlap_transfer_with_compute(rng):
    pair = _both({(8, 8, 3): (2,)}, pipeline_depth=2, clock=None)
    reqs = _requests(rng, [(2, 8)] * 5)
    subs = []
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        subs.append(_submit(fe, mod, reqs))
        assert len(fe.run()) == 5
    fp = pair[1][0]
    st_ = fp.stats()
    assert st_["batches"] == 5 and st_["overlapped_batches"] == 4
    assert st_["max_inflight"] == 2 and st_["inflight"] == 0
    for prev, nxt in zip(fp.telemetry.batches, fp.telemetry.batches[1:]):
        assert nxt.overlapped
        assert nxt.transfer_t0 < prev.harvest_t   # the overlap window
    _same_decisions(pair[0][0], fp, whole_stats=False)
    _same_outputs(*subs)


def test_pipeline_depth_one_never_overlaps(rng):
    pair = _both({(8, 8, 3): (2,)}, pipeline_depth=1, clock=None)
    reqs = _requests(rng, [(2, 8)] * 3)
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        fe.run()
    st_ = pair[1][0].stats()
    assert st_["overlapped_batches"] == 0 and st_["max_inflight"] == 1
    _same_decisions(pair[0][0], pair[1][0], whole_stats=False)


# ---------------------------------------------------------------------------
# telemetry

_ROLLUP_SIZES = [(2, 16), (1, 8), (3, 16), (2, 8)]


def test_stats_rollups_are_complete_and_json_ready(rng):
    pair = _both({(16, 16, 3): (1, 4), (8, 8, 3): (1, 2)}, clock=None)
    reqs = _requests(rng, _ROLLUP_SIZES, deadlines=[60_000.0] * 4)
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        fe.run()
    fp = pair[1][0]
    st_ = fp.stats()
    json.dumps(st_)                      # must be JSON-serializable
    lat = st_["latency_ms"]
    assert set(lat) == {"queue", "transfer", "compute", "total"}
    for stage, ps in lat.items():
        assert set(ps) == {"p50", "p95", "p99"}
        assert ps["p50"] <= ps["p95"] <= ps["p99"], stage
        assert all(v >= 0.0 for v in ps.values()), stage
    assert st_["requests"] == st_["served"] == 4
    assert st_["deadline_misses"] == 0
    assert set(st_) == set(pair[0][0].stats())
    for t in fp.telemetry.requests:
        assert t.total_ms >= t.compute_ms
        assert t.total_ms >= t.queue_ms
    _same_decisions(pair[0][0], fp, whole_stats=False)


def test_compute_ms_is_the_union_of_a_requests_windows(rng):
    """A clock that advances 1 ms per read, the scenario above: every
    request's compute_ms <= total_ms; a request one batch carried has
    the reference's compute_ms exactly, and every other stage is the
    reference's too; a request two batches carried is charged the union
    of their windows, less than the reference's sum."""
    pair = _both({(16, 16, 3): (1, 4), (8, 8, 3): (1, 2)}, clock=TickClock)
    reqs = _requests(rng, _ROLLUP_SIZES, deadlines=[60_000.0] * 4)
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        fe.run()
    (fr, _), (fp, _) = pair
    _same_decisions(fr, fp, whole_stats=False)
    ref = {t.rid: t for t in fr.telemetry.requests}
    # 16x16: (r0, r0, r2, r2) in bucket 4, then (r2,) in bucket 1;
    # 8x8: (r1, r3) in bucket 2, then (r3,) in bucket 1
    two_batches = {2, 3}
    for t in fp.telemetry.requests:
        r = ref[t.rid]
        assert t.compute_ms <= t.total_ms, t
        assert t.queue_ms <= t.total_ms, t
        assert (t.queue_ms, t.transfer_ms, t.total_ms) == (
            r.queue_ms, r.transfer_ms, r.total_ms)
        if t.rid in two_batches:
            assert t.compute_ms < r.compute_ms      # union < sum
        else:
            assert t.compute_ms == r.compute_ms     # one batch carried it
    assert [b.units for b in fp.telemetry.batches] == [4, 1, 2, 1]


def test_compute_ms_stays_within_total_on_a_slow_device(rng, monkeypatch):
    """The same scenario on a device that takes 20 ms a batch (the host
    blocks that long in each harvest): at depth 2 two batches of request
    2 are in flight together, and the reference's summed compute_ms
    exceeds the request's own total (the assertion at
    tests/test_frontend.py:349 fails so when the host harvests late);
    the port's union does not."""
    import types
    from repro_torch.serve import cnn as tserve
    pair = _both({(16, 16, 3): (1, 4), (8, 8, 3): (1, 2)}, clock=TickClock)
    (fr, cr), (fp, cp) = pair

    def slow_ref_get(x):             # the reference's harvest only
        cr.advance_ms(20.0)
        return jax.device_get(x)
    monkeypatch.setattr(rfe, "jax", types.SimpleNamespace(
        block_until_ready=jax.block_until_ready, device_get=slow_ref_get))
    harvest = tserve.BucketPrograms.harvest

    def slow_harvest(self, h):
        cp.advance_ms(20.0)
        return harvest(self, h)
    monkeypatch.setattr(tserve.BucketPrograms, "harvest", slow_harvest)
    reqs = _requests(rng, _ROLLUP_SIZES, deadlines=[60_000.0] * 4)
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        _submit(fe, mod, reqs)
        fe.run()
    _same_decisions(fr, fp, whole_stats=False)
    ref = {t.rid: t for t in fr.telemetry.requests}
    assert ref[2].compute_ms > ref[2].total_ms          # the reference's
    for t in fp.telemetry.requests:
        assert t.compute_ms <= t.total_ms, t
        assert (t.queue_ms, t.total_ms) == (ref[t.rid].queue_ms,
                                            ref[t.rid].total_ms)


def test_warmup_builds_exactly_the_programs_that_serve(rng):
    """Requests in ANY host dtype are packed to the one input_dtype()
    the warmup ran: serving resolves no plan and builds no program."""
    pair = _both({(8, 8, 3): (1, 2)}, clock=None)
    ims = [rng.normal(size=(3, 8, 8, 3)),                 # float64
           rng.normal(size=(2, 8, 8, 3)).astype(np.float16)]
    subs = []
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        subs.append([mod.ServeRequest(rid=i, images=im)
                     for i, im in enumerate(ims)])
        for r in subs[-1]:
            fe.submit(r)
        tcs.reset_plan_stats()
        fe.run()
    fp = pair[1][0]
    assert tcs.PLAN_STATS["resolutions"] == 0
    assert fp.programs[(8, 8, 3)].compiled_buckets == (1, 2)
    assert all(r.status == tfe.SERVED for r in subs[1])
    _same_outputs(subs[0], subs[1], tol=2e-3)


# ---------------------------------------------------------------------------
# acceptance: an IR model at two resolutions through one frontend

def test_acceptance_resnet_two_resolutions_zero_misses(rng):
    from repro_torch.configs.serve import SMOKE_FRONTEND
    pair = _both(SMOKE_FRONTEND.geometry_map(), model="resnet", clock=None,
                 max_wait_ms=SMOKE_FRONTEND.max_wait_ms,
                 default_deadline_ms=SMOKE_FRONTEND.default_deadline_ms,
                 pipeline_depth=SMOKE_FRONTEND.pipeline_depth)
    sizes = [(1, 32), (2, 16), (4, 32), (1, 16), (3, 32), (2, 16)]
    reqs = _requests(rng, sizes, deadlines=[None if i % 2 else 30_000.0
                                            for i in range(len(sizes))])
    subs = []
    for (fe, _), mod in zip(pair, (rfe, tfe)):
        subs.append(_submit(fe, mod, reqs))
        assert all(r.status == "served" for r in fe.run())
    st_ = pair[1][0].stats()
    assert st_["deadline_misses"] == 0 and st_["late_served"] == 0
    assert st_["served"] == 6
    assert len(st_["batches_by_program"]) >= 2
    assert (st_["latency_ms"]["total"]["p99"]
            >= st_["latency_ms"]["total"]["p50"])
    _same_decisions(pair[0][0], pair[1][0], whole_stats=False)
    _same_outputs(*subs)


# ---------------------------------------------------------------------------
# int8 (tests/test_quant.py::test_quantized_serving_end_to_end)

def _calibrate_both(ref_model, rparams, x):
    """Calibrate the JAX package's resnet_like and hand its
    calibration.json to the port under the same keys, so both packages
    quantize with the same scales."""
    from repro.quant import calibrate as rcal
    from repro_torch.quant import calibrate as tcal
    ref_model.graph_plan(x.shape).warmup(
        calibrate=rcal.Calibrator(x, rparams))
    for key, entry in json.loads(rcal._STORE.path().read_text()).items():
        tcal._STORE.put(key, entry)


def test_quantized_frontend_serves_int8(rng):
    from repro.quant.policy import QuantPolicy as RQuantPolicy
    from repro_torch.quant.accuracy import DEFAULT_BOUND
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
    (rm, rp), (tm, tp) = _models("resnet")
    x = np.asarray(rng.standard_normal((4, 32, 32, 3)), np.float32)
    _calibrate_both(rm, rp, x)
    fes = []
    for cls, m, p, pol, extra in (
            (rfe.AsyncServeFrontend, rm, rp, RQuantPolicy(), {}),
            (tfe.AsyncServeFrontend, tm, tp, QuantPolicy(),
             dict(device="cpu", backend="cuda"))):
        fe = cls(m, p, {(32, 32, 3): (1, 4)}, precision=pol, **extra)
        fe.warmup()
        fes.append(fe)
    subs = []
    for fe, mod in zip(fes, (rfe, tfe)):
        subs.append(_submit(fe, mod, [(x[i:i + 1], None)
                                      for i in range(3)]))
        fe.run()
    fr, fp = fes
    st_ = fp.stats()
    assert all("int8" in d for d in st_["serve_dtype_by_program"].values())
    assert sum(c["batches"] for d, c in st_["serve_dtypes"].items()
               if "int8" in d) == st_["batches"]
    _same_decisions(fr, fp, whole_stats=False)
    # the default policy keeps the stem fp32: an int8 code may move one
    # step between the packages (ROADMAP.md §3), held to the accuracy bound
    _same_outputs(subs[0], subs[1], tol=DEFAULT_BOUND)
    # and the port's frontend serves what the port's int8 engine serves
    eng = CnnServeEngine(tm, tp, (32, 32, 3), buckets=(1, 4),
                         precision=QuantPolicy(), device="cpu",
                         backend="cuda")
    eng.warmup()
    for i in range(3):
        eng.submit(ImageRequest(i, x[i:i + 1]))
    for a, b in zip(eng.run(), subs[1]):
        np.testing.assert_array_equal(a.out, b.out)


# ---------------------------------------------------------------------------
# the packing property (tests/test_serve_properties.py)

HW = 6
_PROP = {}


def _prop_models():
    if not _PROP:
        rm = rcnn.SimpleCNN([(1, 1, 3, 1)], num_classes=4)
        rp = rm.init(jax.random.PRNGKey(0))
        tm = tcnn.SimpleCNN([(1, 1, 3, 1)], num_classes=4)
        _PROP.update(rm=rm, rp=rp, tm=tm, tp=tcnn.params_from_numpy(
            _chain_params_numpy(rp), "cpu"), rows={})
    return _PROP


def _expected_row(marker):
    """The reference model's output on a constant image."""
    p = _prop_models()
    if marker not in p["rows"]:
        x = np.full((1, HW, HW, 3), float(marker), np.float32)
        p["rows"][marker] = np.asarray(p["rm"].apply(p["rp"], x))[0]
    return p["rows"][marker]


@settings(max_examples=8, deadline=None)
@given(st.sampled_from([(1,), (2,), (1, 3), (2, 4), (1, 2, 4)]),
       st.tuples(*[st.integers(1, 5)] * 3),
       st.sampled_from([1, 2, 3]))
def test_frontend_packing_invariants(buckets, sizes, depth):
    p = _prop_models()
    fe = tfe.AsyncServeFrontend(p["tm"], p["tp"], {(HW, HW, 3): buckets},
                                pipeline_depth=depth, device="cpu",
                                backend="cuda")
    reqs, marker = [], 1
    for rid, n in enumerate(sizes):
        imgs = np.zeros((n, HW, HW, 3), np.float32)
        for i in range(n):
            imgs[i] = marker
            marker += 1
        reqs.append(tfe.ServeRequest(rid=rid, images=imgs))
    for r in reqs:
        fe.submit(r)
    done = fe.run()
    assert sorted(r.rid for r in done) == list(range(len(sizes)))
    assert all(r.status == tfe.SERVED for r in done)
    for r in reqs:
        assert r.out is not None and r.out.shape[0] == r.images.shape[0]
        for i in range(r.images.shape[0]):
            np.testing.assert_allclose(
                r.out[i], _expected_row(r.images[i, 0, 0, 0]),
                rtol=TOL, atol=TOL,
                err_msg=f"request {r.rid} image {i} wrong/missing result")
    st_ = fe.stats()
    assert st_["images"] == sum(sizes)
    for b in fe.telemetry.batches:
        assert b.padded < min(buckets), (b.bucket, b.padded)
        assert b.units + b.padded == b.bucket
    assert st_["max_inflight"] <= depth
    for stage, ps in st_["latency_ms"].items():
        assert ps["p50"] <= ps["p95"] <= ps["p99"], stage
    for t in fe.telemetry.requests:
        assert t.compute_ms <= t.total_ms and t.queue_ms <= t.total_ms
