"""Measured per-layer algorithm and launch-config selection, persisted
across processes.

  heuristic mode   the registered executors' region claims
                   (``executors.negotiate``); ``select_algorithm`` is the
                   shape-tuple wrapper.
  measured mode    ``measure_algorithm`` times every capable executor
                   (the paper's race: each hand-written kernel against
                   cuDNN, per layer); ``measure_config`` then races the
                   winner's candidate launch configs, one timing per
                   distinct launch (``Executor.launch_key``);
                   ``measure_fusion`` settles a fused spec against its
                   unfused decomposition.  ``tune_spec`` is the one entry
                   point ``plan(tune=...)``, ``GraphPlan.warmup(tune=...)``
                   and the serving warmup share.

Timing: on the card, ``device_ms`` (a few calls captured in one CUDA
graph, replayed between CUDA events, so host dispatch is left out); on
the CPU, the median of ``time.perf_counter`` around synchronous calls.
TF32 stays off for every candidate (``no_tf32``), so no library call
wins an fp32 race by computing in TF32.  A candidate that raises is
named in ``MEASURE_STATS["failed"]``.  In a race for the card (backend
``"cuda"``) a failed hand-written kernel ends the sweep with its error
and nothing of that sweep is persisted: the fastest other candidate
must not stand in for it unnoticed.  Any other failed candidate (a
plugin, a library call, a plain composition, or anything on the CPU) is
skipped.

Winners are persisted keyed by ``(backend, ConvSpec.key())`` in
``$REPRO_CACHE_DIR/torch/autotune.json`` as schema-versioned entries::

    {"schema": 2, "algorithm": "cuconv_pallas",   # measured winner (or null)
     "configs": {"cuconv_pallas": {"tm": 256, "rows": 4}},
     "fusion": {"wins": true, ...}}               # fused-vs-unfused verdict

the JAX package's schema, so a plan reads an entry the same way in both
packages.  ``configs`` maps per algorithm: tuning a forced executor's
configs never overwrites the measured winner.  Unversioned or
foreign-schema entries are dropped on read and measured again.  The
backend of a measurement is ``backend_for(device)`` of the device it ran
on: ``"cuda"`` on the card, ``"cpu"`` on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.convspec import (ConvPlan, ConvSpec, backend_for,
                                       default_backend, normalize_stride,
                                       resolve_device,
                                       torch_dtype)
from repro_torch.core.plancache import JsonCache

#: persisted-entry schema (the JAX package's v2)
AUTOTUNE_SCHEMA = 2

_STORE = JsonCache("autotune.json")

#: observable measurement effort — replay-from-cache paths must leave
#: the counts at zero and the lists empty.  ``timed``: one record per
#: timed candidate (``kind`` "algo" | "config" | "fusion", ``spec`` key,
#: ``algorithm``, ``config``, ``ms``); ``failed``: one per candidate that
#: raised (the same keys, ``error`` for ``ms``).
MEASURE_STATS = {"algo_sweeps": 0, "config_sweeps": 0, "fusion_sweeps": 0,
                 "timed_calls": 0, "timed": [], "failed": []}

#: a timing on the card: calls captured in one CUDA graph, replays
#: timed, eager calls before the capture
GRAPH_CALLS, GRAPH_REPLAYS, WARM_CALLS = 20, 10, 3


def reset_measure_stats() -> dict:
    """Zero the measurement counters and empty the records; returns what
    was discarded."""
    old = {k: (list(v) if isinstance(v, list) else v)
           for k, v in MEASURE_STATS.items()}
    for k, v in MEASURE_STATS.items():
        MEASURE_STATS[k] = [] if isinstance(v, list) else 0
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


# ---------------------------------------------------------------------------
# timing

@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS and cuDNN inside, restored after: an fp32
    candidate (the library executor, the im2col and cuconv compositions)
    must not win a race by computing in TF32."""
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


def device_ms(fn: Callable[[], object], *,
              replays: int = GRAPH_REPLAYS) -> float:
    """Device milliseconds of one ``fn()`` on the card.

    ``fn`` runs ``WARM_CALLS`` times eagerly on a side stream first
    (kernels built, caches and the allocator warm, and a call that raises
    raises here, before any capture).  Then ``GRAPH_CALLS`` calls are
    captured in one CUDA graph with its own memory pool (collector held
    off, ``_build.graph_capture``), replayed once, and replayed
    ``replays`` times between two CUDA events: the host's dispatch of
    each call is
    not in the interval.  The graph and its pool are dropped on return,
    so many timings do not grow peak memory.  A call that raises inside
    the capture still ends it before the error propagates."""
    from repro_torch.kernels import _build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARM_CALLS):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with _build.graph_capture(), torch.cuda.stream(side):
            graph.capture_begin()
            try:
                for _ in range(GRAPH_CALLS):
                    fn()
            finally:
                graph.capture_end()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * GRAPH_CALLS)
    finally:
        del graph
        torch.cuda.empty_cache()


def _time_plan(p, x, w, bias, repeats: int, addend=None) -> float:
    """Seconds of one execution of plan ``p`` on the operands' device,
    TF32 off: ``device_ms`` over ``repeats`` replays on the card, the
    median of ``repeats`` synchronous calls (after one warm call) on the
    CPU."""
    args = (x, w, bias) if addend is None else (x, w, bias, addend)
    with no_tf32():
        if x.device.type == "cuda":
            ms = device_ms(lambda: p(*args), replays=repeats)
            MEASURE_STATS["timed_calls"] += (WARM_CALLS
                                             + GRAPH_CALLS * (1 + repeats))
            return ms / 1e3
        p(*args)                             # warm
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            p(*args)
            ts.append(time.perf_counter() - t0)
    MEASURE_STATS["timed_calls"] += 1 + repeats
    return statistics.median(ts)


def _timed(kind: str, spec: ConvSpec, algorithm: str, config,
           seconds: float) -> None:
    MEASURE_STATS["timed"].append({
        "kind": kind, "spec": spec.key(), "algorithm": algorithm,
        "config": config.as_dict() if config else None,
        "ms": seconds * 1e3})


def _failed(kind: str, spec: ConvSpec, algorithm: str, config, err,
            device, backend: str, kernels: Sequence[str]) -> None:
    """Name a candidate that raised.  On the card, synchronize: an error
    that left the context unusable (an illegal address) raises here and
    ends the sweep instead of failing every later candidate.  In a race
    for the card, a candidate that launches hand-written ``kernels``
    raises out of the sweep (before anything of it is persisted)."""
    MEASURE_STATS["failed"].append({
        "kind": kind, "spec": spec.key(), "algorithm": algorithm,
        "config": config.as_dict() if config else None,
        "error": f"{type(err).__name__}: {err}"[:300]})
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    if backend == "cuda" and kernels:
        raise RuntimeError(
            f"{kind} race on {spec.key()}: {algorithm}, which launches "
            f"the hand-written kernel(s) {list(kernels)}, failed: "
            f"{type(err).__name__}: {err}") from err


# ---------------------------------------------------------------------------
# the sweeps

def select_algorithm(x_shape, w_shape, stride=1,
                     backend: Optional[str] = None) -> str:
    """Heuristic choice for a configuration (the executors' region
    claims; no measurement)."""
    from repro_torch.core import executors
    spec = ConvSpec(tuple(map(int, x_shape)), tuple(map(int, w_shape)),
                    normalize_stride(stride))
    return executors.negotiate(spec, backend or default_backend())[0]


def default_candidates(spec: ConvSpec) -> Sequence[str]:
    """Every registered executor that can execute ``spec`` exactly — the
    hand-written kernels and the library baseline alike."""
    from repro_torch.core import executors
    return executors.supporting(spec)


def _fused_operands(spec: ConvSpec, device=None):
    """Synthesized zero (x, w, bias, addend) for timing a bare spec on
    ``device``.  An int8 spec times on zeros too: the int8 executor's
    dynamic scale of an all-zero input is guarded (``quant.symmetric``)."""
    dtype = torch_dtype(spec.dtype)
    if dtype == torch.int8:
        dtype = torch.float32        # int8 nodes take fp32 activations
    dev = resolve_device(device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    b = zeros((spec.filter_shape[3],)) if spec.has_bias else None
    a = zeros(spec.out_shape) if spec.fused_add != "none" else None
    return zeros(spec.in_shape), zeros(spec.filter_shape), b, a


def _spec_of(x, w, stride, padding, bias, activation, groups, spec):
    if spec is not None:
        return spec
    return ConvSpec.for_conv(x, w, stride, padding, bias=bias,
                             activation=activation, groups=groups)


def _addend(spec: ConvSpec, x):
    if spec.fused_add == "none":
        return None
    return torch.zeros(spec.out_shape, dtype=x.dtype, device=x.device)


def measure_algorithm(x, w, stride=1, padding="same", repeats=3,
                      candidates: Optional[Sequence[str]] = None,
                      bias=None, activation: Optional[str] = None,
                      groups: int = 1,
                      spec: Optional[ConvSpec] = None) -> str:
    """Time every capable candidate on the operands' device and persist
    the winner under that device's backend.

    A persisted winner that is still a registered, capable executor
    short-circuits the sweep (a stale one is measured again).
    ``candidates=None`` means every registered executor filtered by its
    declared capabilities.  ``bias`` /
    ``activation`` ride into the timed executions (the epilogue runs as
    it deploys); the persisted key is epilogue-insensitive.  Each
    executor is timed under its ``default_config``.  ``spec`` overrides
    the operand-derived descriptor (a fused spec cannot be inferred from
    operands).  Unknown or incapable candidates are skipped; a candidate
    that raises is named in ``MEASURE_STATS["failed"]`` and skipped, or,
    in a race for the card where it launches a hand-written kernel, its
    error ends the sweep with nothing persisted.
    When nothing timed successfully nothing is persisted, and the
    negotiated choice is returned.
    """
    from repro_torch.core import executors
    spec = _spec_of(x, w, stride, padding, bias, activation, groups, spec)
    addend = _addend(spec, x)
    backend = backend_for(x.device)
    hit = cached_best(spec, backend)
    if hit is not None and executors.capable(hit, spec):
        return hit
    if candidates is None:
        candidates = default_candidates(spec)
    MEASURE_STATS["algo_sweeps"] += 1
    best, best_t = None, float("inf")
    for name in candidates:
        if not executors.capable(name, spec):
            continue
        cfg = None
        try:
            # default_config inside the guard: one candidate's broken
            # tuning declarations degrade the sweep, not crash it
            cfg = executors.get(name).default_config(spec)
            p = ConvPlan(spec, name, "candidate", "autotune timing",
                         backend, config=cfg)
            t = _time_plan(p, x, w, bias, repeats, addend)
        except Exception as e:      # a candidate may fail: name it
            _failed("algo", spec, name, cfg, e, x.device, backend,
                    executors.get(name).kernels)
            continue
        _timed("algo", spec, name, cfg, t)
        if t < best_t:
            best, best_t = name, t
    if best is None:
        return executors.negotiate(spec, backend)[0]
    record_best(spec, backend, best)
    return best


def _distinct_launches(ex, spec, feasible):
    """One config per distinct launch (``Executor.launch_key``): the
    default config where it is among a launch's configs, else the first.
    Configs that launch the same kernel the same way are timed once."""
    default = ex.default_config(spec)
    reps = {}
    for c in feasible:
        k = ex.launch_key(spec, c)
        if k not in reps or c == default:
            reps[k] = c
    return list(reps.values())


def measure_config(x, w, stride=1, padding="same", repeats=3,
                   algorithm: Optional[str] = None,
                   candidates=None, bias=None,
                   activation: Optional[str] = None,
                   groups: int = 1,
                   spec: Optional[ConvSpec] = None) -> Tuple[str, object]:
    """Race an executor's candidate launch configs, persist the winner.

    ``algorithm=None`` tunes the spec's measured winner (else the
    negotiated choice).  Candidates default to the executor's declared
    ``configs(spec)``, pruned through ``config_supports`` before anything
    is timed, and cut to one config per distinct launch
    (``Executor.launch_key``): on the card the fused, direct, two-stage,
    1x1 and int8 kernels pick their own geometry, so their configs are
    one launch, and a default list of one launch is not raced at all.
    With default candidates a persisted, still-valid config replays free;
    an explicit ``candidates`` list is always timed and its winner
    persisted.  Returns ``(algorithm, LaunchConfig)``.
    """
    from repro_torch.core import executors
    spec = _spec_of(x, w, stride, padding, bias, activation, groups, spec)
    addend = _addend(spec, x)
    backend = backend_for(x.device)
    if algorithm is None:
        algorithm = cached_best(spec, backend)
        if algorithm is None or not executors.capable(algorithm, spec):
            algorithm = executors.negotiate(spec, backend)[0]
    ex = executors.get(algorithm)
    if not ex.supports(spec)[0]:
        return algorithm, ex.default_config(spec)
    explicit = candidates is not None
    if not explicit:
        hit = cached_config(spec, backend, algorithm)
        if hit is not None and ex.config_supports(spec, hit)[0]:
            return algorithm, hit
        candidates = ex.configs(spec)
    feasible = []
    for c in candidates:
        c = executors.LaunchConfig.of(c)
        if ex.config_supports(spec, c)[0] and c not in feasible:
            feasible.append(c)
    feasible = _distinct_launches(ex, spec, feasible) if feasible else []
    if not feasible or (len(feasible) == 1
                        and (not feasible[0] or not explicit)):
        # untunable, nothing survived pruning, or one launch: no race
        return algorithm, ex.default_config(spec)
    MEASURE_STATS["config_sweeps"] += 1
    best, best_t = None, float("inf")
    for cfg in feasible:
        p = ConvPlan(spec, algorithm, "candidate",
                     "autotune config timing", backend, config=cfg,
                     config_source="candidate")
        try:
            t = _time_plan(p, x, w, bias, repeats, addend)
        except Exception as e:      # a candidate may fail: name it
            _failed("config", spec, algorithm, cfg, e, x.device, backend,
                    ex.kernels)
            continue
        _timed("config", spec, algorithm, cfg, t)
        if t < best_t:
            best, best_t = cfg, t
    if best is None:
        return algorithm, ex.default_config(spec)
    record_config(spec, backend, algorithm, best)
    return algorithm, best


def measure_fusion(spec: ConvSpec, backend: Optional[str] = None,
                   repeats: int = 3, force: bool = False,
                   device=None) -> Optional[bool]:
    """Time a fused spec against its unfused decomposition on ``device``
    (default: the card) and persist the verdict under ``backend``
    (default: the device's).

    The unfused side runs the plan the pre-fusion graph would resolve,
    followed by the torch add/ReLU or ``ops.pool2d`` the consumed node
    would run.  The verdict persists under the fused spec's key as
    ``{"fusion": {"wins": bool, "fused_us": ..., "unfused_us": ...}}``
    and replays free; ``force=True`` measures again.  Returns the
    verdict, or None when timing failed (nothing is persisted then).
    """
    from repro_torch.core import convspec
    from repro_torch.kernels import ops
    if not spec.has_fusion:
        raise ValueError(f"spec {spec.key()} carries no fusion to measure")
    device = resolve_device(device)
    backend = backend or backend_for(device)
    if not force:
        hit = fusion_verdict(spec, backend)
        if hit is not None:
            return hit
    MEASURE_STATS["fusion_sweeps"] += 1
    x, w, b, addend = _fused_operands(spec, device)
    fused_plan = convspec.plan(spec, backend=backend)
    base_plan = convspec.plan(spec.unfused(), backend=backend)
    if spec.fused_add != "none":
        post_relu = spec.fused_add == "add_relu"

        def unfused(x, w, bias=None, addend=None):
            y = base_plan(x, w, bias) + addend
            return torch.relu(y) if post_relu else y
    else:
        kind, pkh, pkw, psh, psw, pph, ppw = spec.fused_pool

        def unfused(x, w, bias=None):
            return ops.pool2d(base_plan(x, w, bias), kind=kind,
                              window=(pkh, pkw), stride=(psh, psw),
                              padding=(pph, ppw))
    times = {}
    for side, fn, p in (("fused", fused_plan, fused_plan),
                        ("unfused", unfused, base_plan)):
        name = p.algorithm if side == "fused" else f"{p.algorithm}+unfused"
        try:
            times[side] = _time_plan(fn, x, w, b, repeats, addend)
        except Exception as e:      # leave the verdict open
            _failed("fusion", spec, name, None, e, device, backend,
                    p.executor.kernels)
            return None
        _timed("fusion", spec, name, None, times[side])
    wins = times["fused"] <= times["unfused"]
    entry = _merged_entry(spec, backend)
    entry["fusion"] = {"wins": wins,
                       "fused_us": round(times["fused"] * 1e6, 3),
                       "unfused_us": round(times["unfused"] * 1e6, 3)}
    _STORE.put(_key(spec, backend), entry)
    return wins


def tune_spec(spec: ConvSpec, *, tune: str = "algo",
              backend: Optional[str] = None, repeats: int = 3,
              algorithm: Optional[str] = None,
              device=None) -> Tuple[str, object]:
    """Measure a bare ConvSpec on ``device`` (default: the card; operands
    synthesized from its shapes): the one tuning entry point
    ``plan(tune=...)``, ``GraphPlan.warmup(tune=...)`` and the serving
    warmup share.

    ``tune="algo"`` runs the executor race — even when ``algorithm`` pins
    the executor, so the race's winner is recorded for later unforced
    plans (the pin only decides what this plan serves).  ``tune="full"``
    also settles a fused spec against its unfused decomposition, then
    races the launch configs of the pinned executor or of the winner.
    ``backend`` must be the device's (``backend_for(device)``): timings
    taken on one device are never recorded under another's key.  Returns
    ``(algorithm, LaunchConfig | None)``.
    """
    if tune not in ("algo", "full"):
        raise ValueError(f'tune must be "algo" or "full"; got {tune!r}')
    device = resolve_device(device)
    measured_on = backend_for(device)
    backend = backend or measured_on
    if backend != measured_on:
        raise ValueError(
            f"measured tuning must run on the target backend: asked for "
            f"{backend!r} but the timings run on {device} "
            f"(backend {measured_on!r})")
    x, w, b, _ = _fused_operands(spec, device)
    act = "relu" if spec.wants_relu else None
    kwargs = dict(stride=spec.stride, padding=spec.padding, repeats=repeats,
                  bias=b, activation=act, groups=spec.groups, spec=spec)
    if tune == "algo" or algorithm is None:
        best = measure_algorithm(x, w, **kwargs)
        if algorithm is None:
            algorithm = best
    if tune == "full":
        if spec.has_fusion:
            # the graph pass consults the persisted verdict on its next
            # rewrite of this spec
            measure_fusion(spec, backend=backend, repeats=repeats,
                           device=device)
        return measure_config(x, w, algorithm=algorithm, **kwargs)
    return algorithm, None
