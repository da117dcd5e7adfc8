"""The persisted half of measured autotuning: winners, configs, verdicts.

Measured winners are persisted keyed by ``(backend, ConvSpec.key())`` in
``$REPRO_CACHE_DIR/torch/autotune.json`` as schema-versioned entries::

    {"schema": 2, "algorithm": "cuconv_pallas",   # measured winner (or null)
     "configs": {"cuconv_pallas": {"tm": 256, "rows": 4}},
     "fusion": {"wins": true, ...}}               # fused-vs-unfused verdict

the JAX package's schema, so a plan reads an entry the same way in both
packages.  ``configs`` maps per algorithm; unversioned or foreign-schema
entries are dropped on read.  The timing sweep that writes winners
(``tune="algo"|"full"``, CUDA events on the card) is not ported yet:
``record_best``/``record_config`` are its persistence API.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.convspec import ConvSpec, default_backend
from repro_torch.core.plancache import JsonCache

#: persisted-entry schema (the JAX package's v2)
AUTOTUNE_SCHEMA = 2

_STORE = JsonCache("autotune.json")

#: observable measurement effort — replay-from-cache paths must leave
#: these at zero
MEASURE_STATS = {"algo_sweeps": 0, "config_sweeps": 0, "fusion_sweeps": 0,
                 "timed_calls": 0}


def reset_measure_stats() -> dict:
    """Zero the measurement counters; returns the discarded counts."""
    old = dict(MEASURE_STATS)
    for k in MEASURE_STATS:
        MEASURE_STATS[k] = 0
    return old


def _key(spec: ConvSpec, backend: str) -> str:
    # the epilogue rides whatever algorithm wins, so the cache key is
    # epilogue-insensitive (but dtype- and fusion-distinct)
    if spec.epilogue != "none":
        spec = dataclasses.replace(spec, epilogue="none")
    return f"{backend}/{spec.key()}"


def _entry(spec: ConvSpec, backend: Optional[str]) -> Optional[dict]:
    """The persisted entry for this spec, schema-gated."""
    e = _STORE.get(_key(spec, backend or default_backend()))
    if not isinstance(e, dict) or e.get("schema") != AUTOTUNE_SCHEMA:
        return None
    algo = e.get("algorithm")
    if algo is not None and not isinstance(algo, str):
        return None         # algorithm may be null: config-only entries
    return e


def cached_best(spec: ConvSpec, backend: Optional[str] = None
                ) -> Optional[str]:
    """Persisted measured winner for this spec on this backend, if any."""
    e = _entry(spec, backend)
    return None if e is None else e.get("algorithm")


def cached_config(spec: ConvSpec, backend: Optional[str] = None,
                  algorithm: Optional[str] = None):
    """Persisted measured launch config for ``algorithm`` on this spec
    (default: the entry's winner), or None.  Validity against the
    executor's current declarations is the caller's job."""
    from repro_torch.core.executors import LaunchConfig
    e = _entry(spec, backend)
    if e is None:
        return None
    if algorithm is None:
        algorithm = e.get("algorithm")
        if algorithm is None:
            return None
    cfgs = e.get("configs")
    cfg = cfgs.get(algorithm) if isinstance(cfgs, dict) else None
    if not isinstance(cfg, dict):
        return None
    try:
        return LaunchConfig.of(cfg)
    except ValueError:
        return None                 # malformed dims: drop


def _merged_entry(spec: ConvSpec, backend: str) -> dict:
    e = _entry(spec, backend)
    if e is None:
        e = {"schema": AUTOTUNE_SCHEMA, "algorithm": None, "configs": {}}
    if not isinstance(e.get("configs"), dict):
        e["configs"] = {}
    return e


def record_best(spec: ConvSpec, backend: str, algorithm: str,
                config=None) -> None:
    """Persist a measured winner; ``config``, if given, records under the
    winner's per-algorithm config slot."""
    entry = _merged_entry(spec, backend)
    entry["algorithm"] = algorithm
    if config:
        from repro_torch.core.executors import LaunchConfig
        entry["configs"][algorithm] = LaunchConfig.of(config).as_dict()
    _STORE.put(_key(spec, backend), entry)


def record_config(spec: ConvSpec, backend: str, algorithm: str,
                  config) -> None:
    """Persist a measured launch config for ``algorithm`` without
    touching the entry's measured-winner field."""
    from repro_torch.core.executors import LaunchConfig
    entry = _merged_entry(spec, backend)
    entry["configs"][algorithm] = LaunchConfig.of(config).as_dict()
    _STORE.put(_key(spec, backend), entry)


def fusion_verdict(spec: ConvSpec, backend: Optional[str] = None
                   ) -> Optional[bool]:
    """Persisted fused-vs-unfused verdict for a fused spec: True (fusion
    measured at least as fast), False (slower: the graph pass keeps the
    nodes apart) or None (never measured: the pass fuses)."""
    e = _entry(spec, backend)
    if e is None or not isinstance(e.get("fusion"), dict):
        return None
    return bool(e["fusion"].get("wins", True))


def clear_cache() -> None:
    """Drop the in-memory mirror (tests); the JSON file is untouched."""
    _STORE.clear()
