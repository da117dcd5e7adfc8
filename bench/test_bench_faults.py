"""A whole run of each cell on the CPU, small, with the timed path broken
under the harness: ``correct`` must come out false for an answer
altered where it is produced, half of a batch's rows left out, and the
check's control in the program's place (each batch's logits from the
plain reference with TF32 operands, the step below fp32) —
``test_bench_cells`` holds the sound runs.

The look for cards is skipped (``devices=``); images are 16x16 and the
pool 64, which the CPU serves in seconds."""
import json

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import cnn as reference

SMALL = dict(image=(16, 16, 3), pool=64)
SECONDS = 0.25
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def break_harvest(damage):
    """A fault: the served program's outputs, damaged as they come back
    from the card (``BucketPrograms.harvest``)."""
    def fault(served):
        progs = served.programs
        sound = progs.harvest

        def harvest(h):
            y = np.array(sound(h), copy=True)
            damage(y, progs)
            return y
        progs.harvest = harvest
    return fault


def altered(y, progs):
    y[0, 7] += 0.05


def half_left_out(y, progs):
    y[len(y) // 2:] = 0.0


def tf32_in_place(served):
    """The control in the program's place: each batch's logits are the
    plain reference's with TF32 operands, over the rows packed for it."""
    progs = served.programs
    dispatch, harvest, rows = progs.dispatch, progs.harvest, {}

    def dispatch_tf32(b, chunk, **kw):
        h = dispatch(b, chunk, **kw)
        rows[id(h)] = progs.pack(chunk, b)
        return h

    def harvest_tf32(h):
        harvest(h)
        x = torch.from_numpy(rows.pop(id(h)))
        return reference.logits(served.cfg, served.params, x, "tf32").numpy()
    progs.dispatch, progs.harvest = dispatch_tf32, harvest_tf32


#: every cell of BENCHMARK.json, on as many CPU devices as it asks cards
CELLS = [(c["name"], ("cpu",) * c["chips"]) for c in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(workload, devices, fault=None):
    return harness.run_cell(workload, SEED, SECONDS, False,
                            devices=list(devices), fault=fault,
                            log=lambda *_: None, **SMALL)


@pytest.mark.parametrize("workload,devices,fault", [
    (w, d, f) for w, d in CELLS
    for f in (break_harvest(altered), break_harvest(half_left_out),
              tf32_in_place)],
    ids=lambda v: getattr(v, "__qualname__", None))
def test_broken_run_is_not_correct(workload, devices, fault):
    r = run(workload, devices, fault)
    assert not r["correct"] and r["failed"] > 0
