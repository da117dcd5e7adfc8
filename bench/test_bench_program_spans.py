"""``bench/program_spans.py`` on hand-made records: the host's work is
the window's batches' top spans less their wait spans, the idle share in
it moves with the clock's shift, ``warmup_s`` is the ``warmup`` span,
each reader reads nothing without the program's spans, and gaps and
memcpy records are put down to the right spans, and the idle share is
read only where the shift holds the memcpy records to their spans; then
one CPU run of a
cell through ``run_cell`` with the program's spans on."""
import pytest

from bench import harness, program_spans as ps
from bench.test_bench_faults import SEED, SMALL, few_threads  # noqa: F401

MS = 1e-3


class Batch:
    def __init__(self, seq, units):
        self.seq, self.units = seq, units


class FakeTrace:
    def __init__(self, busy, t1, shift=0.0, records=None, spans=()):
        self.busy, self.t0, self.t1 = {0: busy}, 0.0, t1
        self.shift, self.records, self.spans = shift, records or {}, spans

    @property
    def window_s(self):
        return self.t1 - self.t0


def _spans():
    """Batch 0 (outside the window) and batch 1, in ms: form 0-1,
    dispatch 1-5 with a copy 1-2 and its wait 2-4, harvest 10-13 with
    its wait 10-12; a warmup of 2 s before them."""
    s = [("warmup", -3.0, -1.0, None, None, False),
         ("warmup.plan", -3.0, -2.0, 0, None, False),
         ("batch.form", -0.5 * MS, -0.2 * MS, None, 0, False)]
    base = len(s)
    s += [("batch.form", 0.0, 1 * MS, None, 1, False),
          ("dispatch", 1 * MS, 5 * MS, None, 1, False),
          ("dispatch.copy", 1 * MS, 2 * MS, base + 1, 1, False),
          ("dispatch.copy_wait", 2 * MS, 4 * MS, base + 1, 1, True),
          ("dispatch.launch", 4 * MS, 5 * MS, base + 1, 1, False),
          ("harvest", 10 * MS, 13 * MS, None, 1, False),
          ("harvest.wait", 10 * MS, 12 * MS, base + 5, 1, True),
          ("harvest.read", 12 * MS, 13 * MS, base + 5, 1, False)]
    return s


def records(h2d_start, d2h_end, shift=0.0):
    """Card 0's memcpy records of batch 1 (``_spans``), moved by
    ``shift``."""
    return {0: [("Memcpy HtoD (Pinned -> Device)", h2d_start + shift,
                 3.9 * MS + shift),
                ("Memcpy DtoH (Device -> Pinned)", 9 * MS + shift,
                 d2h_end + shift)]}


def window(spans=None, trace=None):
    return harness.Window(batches=[Batch(1, 4)], cards=1, spans=spans,
                          trace=trace)


def test_host_work_leaves_out_waits_and_other_batches():
    # form 1 + dispatch 4 - wait 2 + harvest 3 - wait 2 = 4 ms, 4 images
    assert ps.host_ms_per_image(window(_spans())) == pytest.approx(1.0)


def test_idle_in_dispatch_is_idle_and_work_after_the_shift():
    # work 0-2, 4-5, 12-13 ms; the card idle 0-2 ms of 20
    busy = [(2 * MS, 20 * MS)]
    w = window(_spans(), FakeTrace(busy, 20 * MS,
                                   records=records(1.2 * MS, 11.9 * MS)))
    assert ps.idle_in_dispatch(w) == pytest.approx(10.0)
    # shifted 1 ms later, work 1-3 ms meets the idle 1-2 ms only
    w = window(_spans(), FakeTrace(
        busy, 20 * MS, shift=1 * MS,
        records=records(1.2 * MS, 11.9 * MS, shift=1 * MS)))
    assert ps.idle_in_dispatch(w) == pytest.approx(5.0)
    # the card busy throughout: no idle to explain
    w = window(_spans(), FakeTrace([(0.0, 20 * MS)], 20 * MS,
                                   records=records(1.2 * MS, 11.9 * MS)))
    assert ps.idle_in_dispatch(w) == 0.0


@pytest.mark.parametrize("shift,recs", [
    (1 * MS, records(1.2 * MS, 11.9 * MS)),     # records 1 ms early
    (0.0, records(1.2 * MS, 12.3 * MS)),        # D2H after its wait
    (0.0, {}),                                  # no memcpy records
])
def test_idle_in_dispatch_reads_nothing_where_the_clocks_disagree(
        shift, recs):
    w = window(_spans(), FakeTrace([(2 * MS, 20 * MS)], 20 * MS,
                                   shift=shift, records=recs))
    assert not ps.clock_ok(ps.clock_check(w))
    assert ps.idle_in_dispatch(w) is None


def test_warmup_s_reads_the_warmup_span():
    assert ps.warmup_s(window(_spans())) == pytest.approx(2.0)
    assert ps.warmup_s(window(_spans()[2:])) is None


@pytest.mark.parametrize("read", [ps.host_ms_per_image,
                                  ps.idle_in_dispatch, ps.warmup_s])
@pytest.mark.parametrize("spans", [None, []])
def test_no_program_spans_read_nothing(read, spans):
    assert read(window(spans, FakeTrace([], 20 * MS))) is None


@pytest.mark.parametrize("a,b,want", [
    ([(0, 10)], [(2, 3), (5, 6)], [(0, 2), (3, 5), (6, 10)]),
    ([(0, 1), (4, 5)], [(0.5, 4.5)], [(0, 0.5), (4.5, 5)]),
    ([(0, 1)], [(1, 2)], [(0, 1)]),
    ([(1, 2)], [(0, 3)], [])])
def test_interval_difference(a, b, want):
    assert ps._minus(a, b) == want
    assert ps._overlap_s(a, b) == pytest.approx(
        sum(t1 - t0 for t0, t1 in a) - sum(t1 - t0 for t0, t1 in want))


def test_gaps_fall_to_the_innermost_span_that_holds_half():
    spans = _spans()
    tr = FakeTrace([(0.0, 2.2 * MS), (3.9 * MS, 11 * MS),
                    (11.5 * MS, 20 * MS)], 20 * MS,
                   spans=[("poll", 0.0, 15 * MS)])
    gaps = ps.idle_gaps(tr, 0)
    assert gaps == [(2.2 * MS, 3.9 * MS), (11 * MS, 11.5 * MS)]
    path, share = ps.innermost(spans, tr, *gaps[0])
    assert path == ["dispatch", "dispatch.copy_wait"] and share == 1.0
    assert ps.innermost(spans, tr, *gaps[1])[0] == ["harvest",
                                                   "harvest.wait"]
    assert ps.innermost(spans, tr, 6 * MS, 9 * MS) == ([], 0.0)
    assert ps.harness_label(tr, 6 * MS, 9 * MS) == "poll"
    assert ps.harness_label(tr, 16 * MS, 17 * MS) == "loop"


def test_clock_check_holds_memcpys_to_their_spans():
    w = window(_spans(), FakeTrace([], 20 * MS,
                                   records=records(1.2 * MS, 11.9 * MS)))
    got = ps.clock_check(w)
    assert got["h2d_start"]["within"] == got["d2h_end"]["within"] == 1.0
    assert got["h2d_lead_median_s"] == pytest.approx(0.2 * MS)
    assert ps.clock_ok(got)
    # the H2D record 0.3 ms before its copy's issue: the clocks disagree
    w.trace.records = records(0.7 * MS, 12.3 * MS)
    got = ps.clock_check(w)
    assert got["h2d_start"]["within"] == 0.0
    assert got["h2d_start"]["worst_s"] == pytest.approx(0.3 * MS)
    assert got["d2h_end"]["worst_s"] == pytest.approx(0.3 * MS)
    assert not ps.clock_ok(got)


def test_a_cpu_run_keeps_the_programs_spans():
    """``run_cell`` through ``_spied``: the front end records spans for
    every batch of the window, and the readers that need no device trace
    read them."""
    with ps._spied(True) as got:
        got["imported"] = ps.T_START
        r = harness.run_cell("resnet50-fp32.bulk64", SEED, 0.25, False,
                             devices=["cpu"], log=lambda *_: None, **SMALL)
    assert r["correct"]
    w = got["window"]
    w.spans = got["server"].telemetry.spans
    assert w.batches and {b.seq for b in w.batches} <= {
        s.batch for s in w.spans}
    assert ps.host_ms_per_image(w) > 0 and ps.warmup_s(w) > 0
    split = ps.setup_split(got, 1.0)
    assert split["program_warmup"] == ps.warmup_s(w)
    assert split["draw_params"] > 0 and split["served_init"] > 0
    spans = ps.span_totals(w)
    assert spans["dispatch"]["s"] > spans["dispatch.pack"]["s"] > 0
    assert ps.counters(w, got["server"].telemetry)["packed_bytes"] == sum(
        b.bucket * 16 * 16 * 3 * 4 for b in w.batches)
