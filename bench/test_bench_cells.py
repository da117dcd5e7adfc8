"""A whole run of each cell on the CPU, small and sound: ``correct``
holds, every request due is compared, and the result line carries its
end-to-end metrics, then ``check`` last.  The look for cards is skipped
(``devices=``); sizes as in ``test_bench_faults``."""
import json

import pytest

from bench import harness
from bench.test_bench_faults import CELLS, few_threads, run  # noqa: F401


@pytest.mark.parametrize("workload,devices", CELLS)
def test_sound_run_is_correct(workload, devices):
    r = run(workload, devices)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["check"]["logit_err"]["value"] < r["check"]["logit_err"]["limit"]
    assert list(r)[-1] == "check"
    bench, cell, _, _ = harness.load_cell(workload)
    want = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                    "end_to_end")}
    assert set(r["metrics"]) == want


def test_cells_report_their_metrics():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell,
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.cell_metrics(bench, cell, "per_layer")
        assert per and all(m["moves"] in e2e for m in per)
        for m in per:
            assert callable(harness.reader(m["name"]))


def test_closed_loop_work_is_the_same_for_every_seed():
    """Each client is due again when its reply comes back; a seed moves
    the requests' pool offsets, never their number or size."""
    import numpy as np
    from bench import loadgen
    mix = {"loop": "closed", "clients": 3, "images": 4}
    offsets = []
    for seed in (1, 2 ** 31 + 9):
        src = loadgen.Source(mix, np.random.default_rng(seed), 0.0, 64)
        first = src.due(0.0)
        assert [r.images for r in first] == [4, 4, 4]
        assert src.due(5.0) == [] and src.next_due() == float("inf")
        src.complete([first[1]], 2.0)
        (again,) = src.due(2.0)
        assert again.due == 2.0 and first[1].done == 2.0
        offsets.append([r.offset for r in src.requests])
        assert all(0 <= o <= 60 for o in offsets[-1])
    assert offsets[0] != offsets[1]
