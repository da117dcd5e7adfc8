"""The port's serving telemetry against the JAX package's.

``repro_torch.serve.telemetry`` is a copy of ``repro.serve.telemetry``
but for one deliberate difference: ``percentile`` interpolates as
``s[lo] + frac*(s[hi] - s[lo])`` clamped to ``[s[lo], s[hi]]``, which
is monotone in ``q`` in floating point.  On random series both give the
same percentiles within 1e-12 relative; on the two series Hypothesis
shrank the reference's failures to, the port's stay monotone and inside
the series' range.
"""
import json

import numpy as np
import pytest
try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:   # deterministic fallback; see _hypothesis_compat
    from _hypothesis_compat import given, settings, strategies as st

    def example(*_a):
        return lambda fn: fn

from repro.serve import telemetry as rtel
from repro_torch.serve import telemetry as ttel

REL = 1e-12
#: the inputs Hypothesis shrank the reference's monotonicity failures to
#: (tests/test_serve_properties.py::test_rollup_percentiles_monotone
#: divides each by 7)
SHRUNK = [(0, 0, 0, 0, 0, 8775, 8775), (0, 0, 0, 0, 0, 7851, 7851)]


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(6))
def test_percentile_matches_reference_on_random_series(seed):
    rng = np.random.default_rng(seed)
    xs = list(rng.exponential(scale=3.0, size=int(rng.integers(1, 40))))
    for q in (0, 1, 10, 25, 50, 75, 90, 95, 99, 99.9, 100):
        _close(ttel.percentile(xs, q), rtel.percentile(xs, q))
    _close(ttel.rollup_percentiles(xs), rtel.rollup_percentiles(xs))
    assert ttel.STAGES == rtel.STAGES


def _traces(seed, shard_devices=None):
    """The same random request and batch traces for both packages."""
    rng = np.random.default_rng(seed)
    reqs, batches = [], []
    for rid in range(int(rng.integers(3, 12))):
        q, tr, c = rng.exponential(2.0, size=3)
        status = "served" if rng.random() < 0.8 else "deadline_exceeded"
        reqs.append(dict(rid=rid, geometry="8x8x3",
                         images=int(rng.integers(1, 5)), status=status,
                         deadline_ms=None if rid % 3 else 50.0,
                         queue_ms=float(q), transfer_ms=float(tr),
                         compute_ms=float(c), total_ms=float(q + tr + c)))
    for i in range(int(rng.integers(1, 9))):
        bucket = 4 if shard_devices is None else 2 * shard_devices
        units = int(rng.integers(1, bucket + 1))
        t0 = float(i)
        shard = None
        if shard_devices is not None:
            per = bucket // shard_devices
            shard = [max(0, min(per, units - j * per))
                     for j in range(shard_devices)]
        batches.append(dict(
            geometry="8x8x3", bucket=bucket, units=units,
            padded=bucket - units, transfer_t0=t0, transfer_t1=t0 + 1e-4,
            dispatch_t=t0 + 2e-4, harvest_t=t0 + 3e-3,
            overlapped=bool(i), shard_units=shard,
            dtype=("int8", "float32", None)[i % 3]))
    out = []
    for mod in (ttel, rtel):
        tel = mod.Telemetry()
        for r in reqs:
            tel.record_request(mod.RequestTrace(**r))
        for b in batches:
            tel.record_batch(mod.BatchTrace(**b))
        out.append(tel)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shard_devices", [None, 1, 2, 4])
def test_rollups_match_reference_on_the_same_traces(seed, shard_devices):
    port, ref = _traces(seed, shard_devices)
    _close(port.latency_ms(), ref.latency_ms())
    _close(port.rollup(), ref.rollup())
    json.dumps(port.rollup())
    _close(port.shard_rollup(), ref.shard_rollup())
    assert port.dtype_rollup() == ref.dtype_rollup()
    assert (port.shard_rollup() is None) == (shard_devices is None)
    for a, b in zip(port.batches, ref.batches):
        _close(a.transfer_ms, b.transfer_ms)
        _close(a.compute_ms, b.compute_ms)
    assert port.deadline_misses == ref.deadline_misses


def _monotone_and_bounded(samples):
    xs = [s / 7.0 for s in samples]
    ps = ttel.rollup_percentiles(xs)
    assert ps["p50"] <= ps["p95"] <= ps["p99"]
    assert min(xs) <= ps["p50"] and ps["p99"] <= max(xs)
    qs = np.linspace(0, 100, 201)
    vals = [ttel.percentile(xs, q) for q in qs]
    assert all(a <= b for a, b in zip(vals, vals[1:]))


@pytest.mark.parametrize("samples", SHRUNK)
def test_percentile_monotone_on_the_reference_shrunk_cases(samples):
    """The reference's rollup breaks p99 <= max (8775) or p95 <= p99
    (7851) here; the port's does not."""
    _monotone_and_bounded(samples)
    xs = [s / 7.0 for s in samples]
    r = rtel.rollup_percentiles(xs)
    assert not (r["p50"] <= r["p95"] <= r["p99"] <= max(xs))


@settings(max_examples=60, deadline=None)
@given(st.tuples(*[st.integers(0, 10_000)] * 7))
@example(SHRUNK[0])
@example(SHRUNK[1])
def test_percentile_monotone_in_q(samples):
    _monotone_and_bounded(samples)


def test_empty_series_is_rejected():
    with pytest.raises(ValueError, match="empty"):
        ttel.percentile([], 50)
    with pytest.raises(ValueError):
        ttel.rollup_percentiles([])
    assert ttel.Telemetry().latency_ms() == {}
    assert ttel.Telemetry().shard_rollup() is None
