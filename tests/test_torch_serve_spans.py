"""The serving path's spans and counters (``serve/telemetry.py``), on the
CPU under a clock that advances 1 ms a read, so two span edges are equal
only where they are one read.

Off (the default) the front end records nothing and makes no ``Span``.
On, every batch has one ``batch.form``, ``dispatch`` and ``harvest``
span, children lie inside their parents and carry their batch, ``wait``
marks exactly the spans where the host blocks on the device, and each
``BatchTrace`` time is a span edge; ``warmup`` has a plan and an eager
child a bucket.  The card's slot, copy wait and capture spans are held
by ``tests/test_torch_cuda.py``; here the forced read of a slot runs on
hand-made slots."""
import types

import numpy as np
import torch

from repro_torch.models import cnn as tcnn
from repro_torch.serve import cnn as tserve
from repro_torch.serve import frontend as tfe
from repro_torch.serve import telemetry as ttel

TINY = [(3, 3, 6, 2), (1, 1, 4, 1)]
WAITS = {"dispatch.slot.wait", "dispatch.copy_wait", "harvest.wait"}
TOP = {"batch.form", "dispatch", "harvest", "warmup"}


class TickClock:
    """A clock that advances 1 ms every time it is read."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def __call__(self) -> float:
        self.t += 1e-3
        self.reads += 1
        return self.t


def _frontend(trace, clock=None, **kw):
    model = tcnn.SimpleCNN(TINY, num_classes=3)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    kw.setdefault("device", "cpu")
    return tfe.AsyncServeFrontend(
        model, params, {(16, 16, 3): (1, 4)}, backend="cuda",
        clock=clock or TickClock(), trace=trace, **kw)


def _serve(fe, sizes=(2, 1, 3)):
    rng = np.random.default_rng(0)
    reqs = [tfe.ServeRequest(rid=i, images=rng.normal(
        size=(n, 16, 16, 3)).astype(np.float32)) for i, n in enumerate(sizes)]
    for r in reqs:
        fe.submit(r)
    done = fe.run()
    assert all(r.status == tfe.SERVED for r in done)
    return reqs


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _check_tree(spans):
    """Children inside their parents and of their batch; ``wait`` on
    exactly the wait spans; names from the documented set."""
    for s in spans:
        assert s.t0 <= s.t1, s
        assert s.wait == (s.name in WAITS), s
        if s.parent is None:
            assert s.name in TOP, s
            continue
        p = spans[s.parent]
        assert s.name.startswith(p.name + "."), (s, p)
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
        assert s.batch == p.batch, (s, p)


def test_spans_are_off_by_default_and_record_nothing(monkeypatch):
    def no_span(*a, **k):
        raise AssertionError("a span was made with tracing off")
    monkeypatch.setattr(ttel, "Span", no_span)
    clock = TickClock()
    fe = _frontend(False, clock)
    fe.warmup()
    _serve(fe)
    tel = fe.telemetry
    assert tel.spans is None and tel.counters is None
    assert all(p.telemetry is None for p in fe.programs.values())
    assert [b.seq for b in tel.batches] == [0, 1, 2]
    # untraced, the clock is read as before spans: each submit, each
    # form pass (three close a batch, the last finds none), and per batch
    # the copy's issue, the copy done, the launch and the harvest
    assert clock.reads == 3 + 4 + 3 * 4


def test_every_batch_has_its_spans_and_shares_its_clock_reads():
    fe = _frontend(True)
    fe.warmup()
    reqs = _serve(fe)
    tel = fe.telemetry
    spans = tel.spans
    _check_tree(spans)
    seqs = [b.seq for b in tel.batches]
    assert seqs == [0, 1, 2]
    for b in tel.batches:
        tops = {s.name: (i, s) for i, s in enumerate(spans)
                if s.parent is None and s.batch == b.seq}
        assert set(tops) == {"batch.form", "dispatch", "harvest"}
        di, d = tops["dispatch"]
        kids = {s.name: s for s in _children(spans, di)}
        assert list(kids) == ["dispatch.pack", "dispatch.copy",
                              "dispatch.launch"]
        assert b.transfer_t0 == kids["dispatch.copy"].t0
        assert b.transfer_t1 == kids["dispatch.copy"].t1
        assert b.dispatch_t == kids["dispatch.launch"].t1 == d.t1
        assert d.t0 == kids["dispatch.pack"].t0
        hi, h = tops["harvest"]
        kids = {s.name: s for s in _children(spans, hi)}
        assert list(kids) == ["harvest.wait", "harvest.read",
                              "harvest.scatter"]
        assert b.harvest_t == kids["harvest.read"].t1 \
            == kids["harvest.scatter"].t0
        assert h.t1 == kids["harvest.scatter"].t1
        assert tops["batch.form"][1].t1 < d.t0
        assert tel.counters[b.seq] == {
            "packed_bytes": b.bucket * 16 * 16 * 3 * 4, "replays": 0,
            "captures": 0, "forced_reads": 0}
    # buckets (1, 4): (r0, r0, r1, r2), then r2 alone twice
    assert [b.bucket for b in tel.batches] == [4, 1, 1]
    by_rid = {t.rid: t.batches for t in tel.requests}
    assert by_rid == {0: (0,), 1: (0,), 2: (0, 1, 2)}
    assert [r.out.shape for r in reqs] == [(2, 3), (1, 3), (3, 3)]


def test_warmup_has_a_plan_and_an_eager_child_a_bucket():
    fe = _frontend(True)
    fe.warmup()
    spans = fe.telemetry.spans
    _check_tree(spans)
    (i, w), = [(i, s) for i, s in enumerate(spans) if s.name == "warmup"]
    assert w.batch is None
    assert [s.name for s in _children(spans, i)] == [
        "warmup.plan", "warmup.eager"] * 2
    assert all(s.parent == i for s in spans[i + 1:])


def test_a_two_device_cpu_mesh_records_the_same_spans():
    fe = _frontend(True, mesh=("cpu",) * 2, device=None)
    fe.warmup()
    _serve(fe, sizes=(5, 3))
    tel = fe.telemetry
    _check_tree(tel.spans)
    # global buckets (2, 8): (r0 x5, r1 x3), nothing left
    assert [(b.bucket, b.shard_units) for b in tel.batches] == [(8, [4, 4])]
    names = [s.name for s in tel.spans if s.batch == 0]
    assert names == ["batch.form", "dispatch", "dispatch.pack",
                     "dispatch.copy", "dispatch.launch", "harvest",
                     "harvest.wait", "harvest.read", "harvest.scatter"]
    assert tel.counters[0]["packed_bytes"] == 8 * 16 * 16 * 3 * 4
    assert [t.batches for t in tel.requests] == [(0,), (0,)]


class _Done:
    def __init__(self):
        self.synced = 0

    def synchronize(self):
        self.synced += 1


def test_a_forced_slot_read_records_its_wait():
    """A slot whose batch was never harvested: ``_take_slot`` waits on
    its done events (every device's) under ``dispatch.slot.wait``, reads
    it out, and says it did."""
    model = tcnn.SimpleCNN(TINY, num_classes=3)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tel = ttel.Telemetry(trace=True)
    progs = tserve.BucketPrograms(model, params, (16, 16, 3), buckets=(4,),
                                  device="cpu", backend="cuda",
                                  telemetry=tel)
    done = [_Done(), _Done()]
    out = torch.arange(12.0).reshape(4, 3)
    slot = types.SimpleNamespace(host_out=out, done=done, owner=None)
    progs._slots = [slot]
    clock = TickClock()
    assert progs._take_slot(clock) == (slot, False)
    assert tel.spans == []
    owner = tserve.Dispatched(4, 4, 0.0, 0.0, 0.0, slot=slot)
    slot.owner = owner
    tel.open_span("dispatch", clock(), batch=7)
    tel.open_span("dispatch.slot", clock())
    assert progs._take_slot(clock) == (slot, True)
    tel.close_span(clock())
    tel.close_span(clock())
    synced = [d.synced for d in done]
    assert all(n >= 1 for n in synced)
    np.testing.assert_array_equal(owner.y, out.numpy())
    assert slot.owner is None and owner.slot is None
    _check_tree(tel.spans)
    assert [(s.name, s.parent, s.batch, s.wait) for s in tel.spans] == [
        ("dispatch", None, 7, False), ("dispatch.slot", 0, 7, False),
        ("dispatch.slot.wait", 1, 7, True)]
    progs.wait(owner)                   # read already: returns at once
    assert [d.synced for d in done] == synced


def test_counters_add_up_per_batch():
    tel = ttel.Telemetry(trace=True)
    tel.count(3, packed_bytes=10, replays=1)
    tel.count(3, forced_reads=True, replays=1)
    assert tel.counters == {3: {"packed_bytes": 10, "replays": 2,
                                "captures": 0, "forced_reads": 1}}
    assert ttel.Telemetry().counters is None


def test_tracing_leaves_outputs_and_decisions_alone():
    """The same requests give the same outputs and the same stats() but
    its latencies with spans on as off (the clock is read more often
    traced, so the times differ)."""
    outs = []
    for trace in (False, True):
        fe = _frontend(trace)
        fe.warmup()
        outs.append(([r.out for r in _serve(fe)],
                     {k: v for k, v in fe.stats().items()
                      if k != "latency_ms"}))
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert outs[0][1] == outs[1][1]
