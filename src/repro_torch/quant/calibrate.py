"""Per-node activation range calibration, persisted across processes.

``GraphPlan.warmup(calibrate=Calibrator(x, params))`` runs the fp graph
over a caller-supplied sample batch and records, for every conv node,
the absolute range of its INPUT activation — both observers at once:

  * ``absmax`` — max|x| over the batch (exact, outlier-sensitive);
  * ``percentile`` — the 99.9th percentile of |x| (clips outliers; which
    observer the scale uses is ``QuantPolicy.observer``'s choice).

Entries persist in a schema-versioned ``calibration.json`` under
``$REPRO_CACHE_DIR/torch/`` keyed by batch- and dtype-normalized graph
signature + node name — the JAX package's keys and entry layout, so a
calibration taken at batch 8 in fp32 serves every serving bucket and
every fp fallback dtype of the same architecture::

    {"schema": 1, "spec": "n*h32w32c3-k3x3m16-s1x1-p1x1-*-bias_relu",
     "amax": 4.37, "pct": {"99.9": 3.91}, "batches": 2, "samples": 16}

Unversioned or foreign-schema entries are dropped on read; an entry
whose recorded normalized spec no longer matches the node is stale, and
the node falls back to fp until recalibrated.
"""
from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.plancache import JsonCache

#: persisted-entry schema; bump when the entry shape changes
CALIB_SCHEMA = 1

_STORE = JsonCache("calibration.json")

# monotone generation counter: bumped on every persist so plan memos
# keyed on it re-resolve after a recalibration
_GENERATION = [0]

#: collection effort: passes over a sample batch and nodes observed
CALIB_STATS = {"collections": 0, "observed_nodes": 0}

_BATCH_RE = re.compile(r"(?:(?<=:)|^)n\d+h")     # conv key batch dim
_INSHAPE_RE = re.compile(r"in\(\d+,")            # graph input batch dim
_DTYPE_RE = re.compile(r"-(float\d+|bfloat16|int8)-")


def generation() -> int:
    """Bumped on every persisted calibration — memo-staleness token."""
    return _GENERATION[0]


def clear_cache() -> None:
    """Drop the in-memory mirror (tests); the JSON file is untouched."""
    _STORE.clear()


def reset_calib_stats() -> dict:
    """Zero ``CALIB_STATS``; returns the counts before."""
    old = dict(CALIB_STATS)
    for k in CALIB_STATS:
        CALIB_STATS[k] = 0
    return old


def normalized_spec(spec) -> str:
    """A ConvSpec key with batch and dtype wildcarded — activation
    ranges depend on neither."""
    key = _BATCH_RE.sub("n*h", spec.key())
    return _DTYPE_RE.sub("-*-", key)


def graph_key(graph) -> str:
    """Batch/dtype-normalized graph identity for calibration keying (the
    same string as the JAX package's for the same graph)."""
    blob = "|".join([f"v{CALIB_SCHEMA}", f"in{tuple(graph.in_shape)}",
                     f"out:{graph.output}"]
                    + [n.descriptor() for n in graph.nodes])
    blob = _INSHAPE_RE.sub("in(*,", blob)
    blob = _BATCH_RE.sub("n*h", blob)
    blob = _DTYPE_RE.sub("-*-", blob)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _entry_key(graph, node_name: str) -> str:
    return f"{graph_key(graph)}/{node_name}"


def calibration_entry(graph, node_name: str) -> Optional[dict]:
    """The persisted, schema-gated entry for this node, or None."""
    e = _STORE.get(_entry_key(graph, node_name))
    if not isinstance(e, dict) or e.get("schema") != CALIB_SCHEMA:
        return None
    if not isinstance(e.get("amax"), (int, float)):
        return None
    return e


def record_calibration(graph, node_name: str, spec, amax: float,
                       pct: Dict[str, float], samples: int) -> dict:
    """Persist, merging with any prior batch (running max — the
    conservative union of observed ranges).  Returns the stored entry."""
    key = _entry_key(graph, node_name)
    prev = calibration_entry(graph, node_name)
    entry = {"schema": CALIB_SCHEMA, "spec": normalized_spec(spec),
             "amax": float(amax),
             "pct": {k: float(v) for k, v in pct.items()},
             "batches": 1, "samples": int(samples)}
    if prev is not None and prev.get("spec") == entry["spec"]:
        entry["amax"] = max(entry["amax"], float(prev["amax"]))
        for k, v in (prev.get("pct") or {}).items():
            if k in entry["pct"]:
                entry["pct"][k] = max(entry["pct"][k], float(v))
        entry["batches"] = int(prev.get("batches", 0)) + 1
        entry["samples"] = int(prev.get("samples", 0)) + entry["samples"]
    _STORE.put(key, entry)
    _GENERATION[0] += 1
    return entry


def input_tensor(x, params):
    """``x`` as a tensor on the device of ``params`` (numpy arrays and
    tensors elsewhere are moved there; a tensor already there is kept)."""
    first = next(iter(next(iter(params.values())).values()))
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, device=first.device)


class Calibrator:
    """A sample batch + parameters + observer choice, handed to
    ``GraphPlan.warmup(calibrate=...)``.  ``x`` is a numpy array or a
    tensor; it runs on the device of ``params``."""

    OBSERVERS = ("absmax", "percentile")

    def __init__(self, x, params, observer: str = "absmax",
                 percentile: float = 99.9):
        if observer not in self.OBSERVERS:
            raise ValueError(
                f"observer must be one of {self.OBSERVERS}; got {observer!r}")
        self.x = x
        self.params = params
        self.observer = observer
        self.percentile = float(percentile)

    def collect(self, graph_plan) -> Dict[str, dict]:
        """Run the plan over the sample batch, observing every conv
        node's input activation; persist and return the entries.  Keys
        by the plan's PRE-fusion graph (fusion never changes a conv
        node's input), so the quantize pass finds what warmup recorded."""
        key_graph = graph_plan.base_graph or graph_plan.graph
        specs = {n.name: n.spec for n in key_graph.nodes
                 if getattr(n, "op", None) == "conv"}
        observed: Dict[str, Any] = {}

        def observe(name, value):
            if name in specs:
                observed[name] = np.abs(value.detach().float().cpu().numpy())

        CALIB_STATS["collections"] += 1
        graph_plan.run(input_tensor(self.x, self.params), self.params,
                       observe=observe)
        pct_key = f"{self.percentile:g}"
        entries = {}
        for name, mag in observed.items():
            CALIB_STATS["observed_nodes"] += 1
            entries[name] = record_calibration(
                key_graph, name, specs[name],
                amax=float(mag.max()) if mag.size else 0.0,
                pct={pct_key: float(np.percentile(mag, self.percentile))
                     if mag.size else 0.0},
                samples=int(np.shape(self.x)[0]))
        return entries


def scale_source(entry: dict, observer: str, percentile: float = 99.9
                 ) -> tuple:
    """(amax, provenance string) for the chosen observer — falls back to
    absmax when the recorded percentile key is missing."""
    if observer == "percentile":
        pct = entry.get("pct") or {}
        key = f"{percentile:g}"
        if key in pct:
            return float(pct[key]), f"calib:pct{key}"
    return float(entry["amax"]), "calib:absmax"
