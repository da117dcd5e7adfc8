"""The port's measured autotune sweep (``core/autotune.py``) against the
JAX package's.

Mirrors the sweep tests of ``tests/test_autotune_configs.py``, the
``measure_fusion`` and verdict cases of ``tests/test_fusion.py``, and
the measured warmups of ``tests/test_graph.py``, ``tests/test_serve.py``
and ``tests/test_convspec.py``, on the CPU: plans for backend ``"cpu"``
timed on ``device="cpu"`` (the card's timings are chip_smoke's and
``tests/test_torch_cuda.py``'s).  Where a test needs a particular
winner, it pins the candidates or replaces the timer (``clock``), so no
assertion rides on which executor wins a timing race.  Tuned outputs are
held to the executor bounds: fp32 3e-4, Winograd F(4,3) 2e-3, of the
output's scale.
"""
import json

import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, rand  # noqa: F401
from repro_torch.core import autotune
from repro_torch.core import convspec as cs
from repro_torch.core import executors as ex
from repro_torch.core import graph as tg
from repro_torch.core.cuconv import conv_lax
from repro_torch.core.plancache import cache_dir

CPU = "cpu"
SPEC_1X1 = cs.ConvSpec((1, 6, 6, 8), (1, 1, 8, 4))
SPEC_3X3 = cs.ConvSpec((1, 8, 8, 8), (3, 3, 8, 16), (1, 1), (1, 1))


def _operands(spec, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rand(rng, spec.in_shape))
    w = torch.from_numpy(rand(rng, spec.filter_shape))
    return x, w


def _close(got, want, tol=3e-4):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


def _measured_nothing():
    return not any(autotune.MEASURE_STATS.values())


@pytest.fixture
def clock(monkeypatch):
    """Replace the timer: each candidate still runs once (so one that
    raises fails as it would), and takes ``clock["fn"](plan)`` seconds
    (the unfused side of a fusion race is a plain function)."""
    state = {"fn": lambda p: 1.0}

    def fake(p, x, w, bias, repeats, addend=None):
        p(x, w, bias) if addend is None else p(x, w, bias, addend)
        autotune.MEASURE_STATS["timed_calls"] += 1
        return state["fn"](p)
    monkeypatch.setattr(autotune, "_time_plan", fake)
    return state


def _by_algorithm(times):
    return lambda p: times.get(getattr(p, "algorithm", "unfused"), 1.0)


# ---------------------------------------------------------------------------
# the race and its replay

@pytest.mark.parametrize("tune", ["algo", "full"])
def test_replay_from_the_persisted_winner_makes_zero_measurements(tune):
    p = cs.plan(SPEC_3X3, tune=tune, device=CPU)
    assert p.source == "measured" and p.backend == CPU
    assert autotune.MEASURE_STATS["algo_sweeps"] == 1
    timed = {r["algorithm"] for r in autotune.MEASURE_STATS["timed"]
             if r["kind"] == "algo"}
    assert timed == set(autotune.default_candidates(SPEC_3X3))
    autotune.clear_cache()                       # a later process
    autotune.reset_measure_stats()
    again = cs.plan(SPEC_3X3, tune=tune, device=CPU)
    assert _measured_nothing()
    assert (again.algorithm, again.config) == (p.algorithm, p.config)
    assert cs.plan(SPEC_3X3, backend=CPU).algorithm == p.algorithm


def test_measured_cache_persists_across_reload():
    x, w = _operands(SPEC_1X1)
    best = autotune.measure_algorithm(x, w, repeats=1,
                                      candidates=("lax", "cuconv"))
    assert best in ("lax", "cuconv")
    assert (cache_dir() / "autotune.json").exists()
    autotune.clear_cache()
    spec = cs.ConvSpec.for_conv(x, w, 1, "same")
    assert autotune.cached_best(spec, CPU) == best
    assert autotune.cached_best(spec, "cuda") is None
    p = cs.plan(spec, backend=CPU)
    assert p.source == "measured" and p.algorithm == best


def test_measured_winner_serves_epilogue_specs():
    x, w = _operands(SPEC_3X3)
    best = autotune.measure_algorithm(x, w, repeats=1,
                                      candidates=("lax", "cuconv"))
    spec = cs.ConvSpec.for_conv(x, w, 1, "same", bias=torch.zeros(16),
                                activation="relu")
    p = cs.plan(spec, backend=CPU)
    assert p.source == "measured" and p.algorithm == best


def test_measured_cache_ignored_for_other_spec():
    spec = cs.ConvSpec((1, 5, 5, 4), (3, 3, 4, 4))
    autotune.record_best(SPEC_3X3, CPU, "lax")
    assert autotune.cached_best(spec, CPU) is None
    assert cs.plan(spec, backend=CPU).source == "heuristic"


def test_default_candidates_include_the_kernels_and_the_library():
    cands = set(autotune.default_candidates(cs.ConvSpec((1, 4, 4, 4),
                                                        (1, 1, 4, 3))))
    assert {"cuconv_pallas", "conv1x1_pallas", "cuconv_two_stage_pallas",
            "direct", "lax"} <= cands
    strided = cs.ConvSpec((1, 8, 8, 4), (3, 3, 4, 3), (2, 2), (1, 1))
    assert "cuconv_two_stage_pallas" not in autotune.default_candidates(
        strided)
    assert autotune.default_candidates(SPEC_3X3) == ex.supporting(SPEC_3X3)
    # the default race runs and times the fused-epilogue deployment
    x, w = _operands(cs.ConvSpec((1, 4, 4, 4), (1, 1, 4, 3)))
    best = autotune.measure_algorithm(x, w, repeats=1, bias=torch.ones(3),
                                      activation="relu")
    assert best in cands
    assert {r["spec"] for r in autotune.MEASURE_STATS["timed"]} == {
        "n1h4w4c4-k1x1m3-s1x1-p0x0-float32-bias_relu"}


def test_select_algorithm_is_the_negotiated_choice():
    for backend in (CPU, "cuda"):
        assert autotune.select_algorithm((1, 8, 8, 8), (3, 3, 8, 16),
                                         backend=backend) == ex.negotiate(
            cs.ConvSpec((1, 8, 8, 8), (3, 3, 8, 16)), backend)[0]


def test_forced_tune_never_overwrites_the_measured_winner(clock):
    clock["fn"] = _by_algorithm({"lax": 0.5})
    cs.plan(SPEC_1X1, tune="algo", device=CPU)
    assert autotune.cached_best(SPEC_1X1, CPU) == "lax"
    p = cs.plan(SPEC_1X1, force="conv1x1_pallas", tune="full", device=CPU)
    assert p.algorithm == "conv1x1_pallas"
    assert autotune.cached_best(SPEC_1X1, CPU) == "lax"
    assert cs.plan(SPEC_1X1, backend=CPU).algorithm == "lax"


def test_forced_tune_algo_still_runs_the_executor_sweep(clock):
    clock["fn"] = _by_algorithm({"cuconv": 0.5})
    p = cs.plan(SPEC_1X1, force="conv1x1_pallas", tune="algo", device=CPU)
    assert p.algorithm == "conv1x1_pallas" and p.source == "forced"
    assert autotune.MEASURE_STATS["algo_sweeps"] == 1
    assert autotune.cached_best(SPEC_1X1, CPU) == "cuconv"


def test_tune_algo_then_full_compose(clock):
    clock["fn"] = _by_algorithm({"winograd_pallas": 0.5})
    cs.plan(SPEC_3X3, tune="algo", device=CPU)
    assert autotune.cached_best(SPEC_3X3, CPU) == "winograd_pallas"
    autotune.reset_measure_stats()
    p = cs.plan(SPEC_3X3, tune="full", device=CPU)
    assert autotune.MEASURE_STATS["algo_sweeps"] == 0      # winner cached
    assert autotune.MEASURE_STATS["config_sweeps"] == 1
    assert p.algorithm == "winograd_pallas"
    assert p.config_source == "measured"


def test_tune_rejects_foreign_backend_and_bad_mode():
    with pytest.raises(ValueError, match="backend"):
        cs.plan(SPEC_3X3, tune="algo", backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="backend"):
        autotune.tune_spec(SPEC_3X3, backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="tune"):
        cs.plan(SPEC_3X3, tune="everything", device=CPU)
    with pytest.raises(ValueError, match="tune"):
        autotune.tune_spec(SPEC_3X3, tune="configs", device=CPU)
    assert _measured_nothing()
    assert autotune.cached_best(SPEC_3X3, "cuda") is None


def test_a_stale_persisted_winner_is_measured_again(clock):
    autotune.record_best(SPEC_3X3, CPU, "an_unregistered_plugin")
    clock["fn"] = _by_algorithm({"im2col": 0.5})
    assert cs.plan(SPEC_3X3, tune="algo", device=CPU).algorithm == "im2col"
    assert autotune.MEASURE_STATS["algo_sweeps"] == 1
    assert autotune.cached_best(SPEC_3X3, CPU) == "im2col"


# ---------------------------------------------------------------------------
# failed candidates

class _BrokenTuningExecutor(ex.Executor):
    """A registered executor whose tuning-space declarations raise."""
    name = "broken_tuning_plugin"

    def configs(self, spec):
        raise RuntimeError("broken tuning space")

    def _execute(self, spec, x, w, bias, config=None):
        return conv_lax(x, w, stride=spec.stride, padding=spec.padding)


class _RaisingExecutor(ex.Executor):
    """A registered executor whose launch fails."""
    name = "raising_plugin"

    def _execute(self, spec, x, w, bias, config=None):
        raise RuntimeError("boom: the launch failed")


class _RaisingKernelExecutor(_RaisingExecutor):
    """A registered executor that launches a hand-written kernel, whose
    launch fails; two launch configs, so it has a config race too."""
    name = "raising_kernel_plugin"
    kernels = ("raising_kernel",)
    tunable = ("tm",)

    def configs(self, spec):
        return (ex.LaunchConfig.of({"tm": 8}), ex.LaunchConfig.of({"tm": 16}))


@pytest.fixture
def plugin():
    registered = []

    def add(executor):
        registered.append(ex.register(executor).name)
    yield add
    for name in registered:
        ex.unregister(name)


def test_measure_algorithm_degrades_on_broken_tuning_declarations(plugin):
    plugin(_BrokenTuningExecutor())
    x, w = _operands(SPEC_1X1)
    best = autotune.measure_algorithm(
        x, w, stride=SPEC_1X1.stride, padding=SPEC_1X1.padding, repeats=1,
        candidates=("broken_tuning_plugin", "lax"))
    assert best == "lax"
    (f,) = autotune.MEASURE_STATS["failed"]
    assert f["algorithm"] == "broken_tuning_plugin"
    assert "broken tuning space" in f["error"]


def test_a_failed_candidate_is_recorded_by_name(plugin):
    plugin(_RaisingExecutor())
    x, w = _operands(SPEC_3X3)
    best = autotune.measure_algorithm(x, w, repeats=1,
                                      candidates=("raising_plugin", "lax",
                                                  "not_registered"))
    assert best == "lax"
    assert [r["algorithm"] for r in autotune.MEASURE_STATS["timed"]] == [
        "lax"]
    (f,) = autotune.MEASURE_STATS["failed"]
    assert (f["kind"], f["algorithm"], f["spec"]) == (
        "algo", "raising_plugin", SPEC_3X3.key())
    assert "boom" in f["error"]
    # nothing timed: nothing persisted, the negotiated choice returned
    autotune.reset_measure_stats()
    spec = cs.ConvSpec((1, 5, 5, 8), (3, 3, 8, 16), (1, 1), (1, 1))
    x, w = _operands(spec)
    got = autotune.measure_algorithm(x, w, spec=spec, repeats=1,
                                     candidates=("raising_plugin",))
    assert got == ex.negotiate(spec, CPU)[0]
    assert autotune.cached_best(spec, CPU) is None
    assert len(autotune.MEASURE_STATS["failed"]) == 1
    assert autotune.reset_measure_stats()["failed"]
    assert autotune.MEASURE_STATS["failed"] == []


@pytest.mark.parametrize("kind", ["algo", "config"])
def test_a_failed_kernel_ends_a_race_for_the_card(plugin, monkeypatch, kind):
    """A race for the card does not go on past a hand-written kernel that
    failed (the fastest other candidate would stand in for it): the
    error propagates, the candidate is named, and nothing is persisted.
    The same kernel failing in a race on the CPU is skipped."""
    plugin(_RaisingKernelExecutor())
    x, w = _operands(SPEC_3X3)
    kwargs = dict(stride=SPEC_3X3.stride, padding=SPEC_3X3.padding,
                  repeats=1)

    def race():
        if kind == "algo":
            return autotune.measure_algorithm(
                x, w, candidates=("lax", "raising_kernel_plugin"), **kwargs)
        return autotune.measure_config(
            x, w, algorithm="raising_kernel_plugin",
            candidates=({"tm": 8}, {"tm": 16}), **kwargs)
    monkeypatch.setattr(autotune, "backend_for", lambda device: "cuda")
    with pytest.raises(RuntimeError, match="raising_kernel.*boom"):
        race()
    (f,) = autotune.MEASURE_STATS["failed"]
    assert (f["kind"], f["algorithm"]) == (kind, "raising_kernel_plugin")
    autotune.clear_cache()              # what a later process reads
    assert autotune.cached_best(SPEC_3X3, "cuda") is None
    assert autotune.cached_config(SPEC_3X3, "cuda",
                                  "raising_kernel_plugin") is None
    assert not (cache_dir() / "autotune.json").exists() or not [
        k for k in json.loads((cache_dir() / "autotune.json").read_text())
        if k.startswith("cuda/")]
    monkeypatch.undo()
    autotune.reset_measure_stats()
    race()                              # on the CPU: skipped, recorded
    assert [r["algorithm"] for r in autotune.MEASURE_STATS["failed"]] == [
        "raising_kernel_plugin"] * (1 if kind == "algo" else 2)


# ---------------------------------------------------------------------------
# launch configs

def test_configs_of_one_launch_are_timed_once():
    """The fused kernel picks its own geometry: its configs are one
    launch, so the default race has nothing to time, and an explicit
    list is timed once."""
    exe = ex.get("cuconv_pallas")
    feasible = [c for c in exe.configs(SPEC_3X3)
                if exe.config_supports(SPEC_3X3, c)[0]]
    assert len(feasible) >= 3
    assert {exe.launch_key(SPEC_3X3, c) for c in feasible} == {()}
    x, w = _operands(SPEC_3X3)
    algo, cfg = autotune.measure_config(x, w, repeats=1,
                                        algorithm="cuconv_pallas")
    assert (algo, cfg) == ("cuconv_pallas", exe.default_config(SPEC_3X3))
    assert _measured_nothing()
    assert autotune.cached_config(SPEC_3X3, CPU, "cuconv_pallas") is None
    wanted = ({"tm": 8, "rows": 1}, {"tm": 16, "rows": 2})
    _, cfg = autotune.measure_config(x, w, repeats=1,
                                     algorithm="cuconv_pallas",
                                     candidates=wanted)
    assert cfg.as_dict() == wanted[0]
    assert autotune.MEASURE_STATS["config_sweeps"] == 1
    assert len(autotune.MEASURE_STATS["timed"]) == 1
    assert autotune.cached_config(SPEC_3X3, CPU, "cuconv_pallas") == cfg


def test_winograd_configs_race_once_per_launch_persist_and_replay(clock):
    """Winograd's F(m,3) variant (and the channel block tm picks) is the
    dimension that really sweeps."""
    clock["fn"] = lambda p: 0.5 if p.config.get("m") == 4 else 1.0
    exe = ex.get("winograd_pallas")
    launches = {exe.launch_key(SPEC_3X3, c) for c in exe.configs(SPEC_3X3)
                if exe.config_supports(SPEC_3X3, c)[0]}
    assert {k[0] for k in launches} == {2, 4}
    p = cs.plan(SPEC_3X3, force="winograd_pallas", tune="full", device=CPU)
    assert autotune.MEASURE_STATS["config_sweeps"] == 1
    assert autotune.MEASURE_STATS["algo_sweeps"] == 0   # forced: no race
    timed = [r for r in autotune.MEASURE_STATS["timed"]
             if r["kind"] == "config"]
    assert len(timed) == len(launches)
    assert p.config["m"] == 4 and p.config_source == "measured"
    raw = json.loads((cache_dir() / "autotune.json").read_text())
    entry = raw[f"{CPU}/{SPEC_3X3.key()}"]
    assert entry["schema"] == autotune.AUTOTUNE_SCHEMA
    assert entry["algorithm"] is None       # a forced tune names no winner
    assert entry["configs"]["winograd_pallas"] == p.config.as_dict()
    autotune.clear_cache()
    autotune.reset_measure_stats()
    p2 = cs.plan(SPEC_3X3, force="winograd_pallas", backend=CPU)
    assert (p2.config, p2.config_source) == (p.config, "measured")
    assert _measured_nothing()
    x, w = _operands(SPEC_3X3)
    _close(p2(x, w), conv_lax(x, w, padding=(1, 1)), tol=2e-3)


def test_measure_config_short_circuits_on_valid_persisted_config():
    x, w = _operands(SPEC_3X3)
    algo, cfg = autotune.measure_config(x, w, repeats=1,
                                        algorithm="winograd_pallas")
    assert cfg
    autotune.reset_measure_stats()
    assert autotune.measure_config(x, w, repeats=1,
                                   algorithm="winograd_pallas") == (algo, cfg)
    assert _measured_nothing()
    # an explicit list is a request to measure exactly those configs
    wanted = ({"m": 2, "tt": 16, "tm": 16, "tc": 8},
              {"m": 4, "tt": 4, "tm": 16, "tc": 8})
    _, cfg3 = autotune.measure_config(x, w, repeats=1,
                                      algorithm="winograd_pallas",
                                      candidates=wanted)
    assert cfg3.as_dict() in [dict(d) for d in wanted]
    assert autotune.MEASURE_STATS["timed_calls"] > 0


def test_tuned_plan_matches_the_untuned_one():
    x, w = _operands(SPEC_3X3, seed=1)
    b = torch.from_numpy(rand(np.random.default_rng(2), (16,)))
    spec = cs.ConvSpec.for_conv(x, w, 1, "same", bias=b, activation="relu")
    untuned = cs.plan(spec, backend=CPU)
    tuned = cs.plan(spec, tune="full", device=CPU)
    assert tuned.source == "measured"
    tol = 2e-3 if tuned.config.get("m") == 4 else 3e-4
    _close(tuned(x, w, b), untuned(x, w, b), tol)


def test_int8_specs_tune_on_zeros_and_replay():
    """An int8 spec times on zeros: the dynamic scale of an all-zero
    input is guarded, so the race runs and replays."""
    spec = cs.ConvSpec((1, 8, 8, 8), (3, 3, 8, 16), (1, 1), (1, 1),
                       dtype="int8", epilogue="bias_relu")
    p = cs.plan(spec, tune="full", device=CPU)
    assert p.algorithm == "cuconv_int8" and p.source == "measured"
    assert not autotune.MEASURE_STATS["failed"]
    autotune.clear_cache()
    autotune.reset_measure_stats()
    assert cs.plan(spec, tune="full", device=CPU).algorithm == "cuconv_int8"
    assert _measured_nothing()


# ---------------------------------------------------------------------------
# timing

def test_cpu_timer_is_the_median_of_synchronous_calls():
    calls = []

    def fake_plan(*args):
        calls.append(len(args))
    x = torch.zeros(1)
    t = autotune._time_plan(fake_plan, x, x, None, repeats=3)
    assert calls == [3] * 4 and t >= 0
    assert autotune.MEASURE_STATS["timed_calls"] == 4
    autotune._time_plan(fake_plan, x, x, None, repeats=1, addend=x)
    assert calls[-1] == 4


def test_no_tf32_holds_tf32_off_and_restores_the_flags():
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with autotune.no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


# ---------------------------------------------------------------------------
# fusion verdicts

def _tiny_residual(backend_dtype="float32"):
    b = tg.GraphBuilder((1, 8, 8, 4), backend_dtype)
    c0 = b.conv("c0", "input", 3, 4)
    c1 = b.conv("c1", c0, 3, 4, epilogue="bias")
    b.add("sum", (c0, c1), activation="relu")
    return b.graph()


def test_measure_fusion_persists_verdict():
    spec = cs.ConvSpec((1, 8, 8, 3), (3, 3, 3, 4), (1, 1), (1, 1),
                       epilogue="bias", fused_add="add")
    got = autotune.measure_fusion(spec, repeats=1, force=True, device=CPU)
    assert got in (True, False)
    assert autotune.MEASURE_STATS["fusion_sweeps"] == 1
    assert autotune.fusion_verdict(spec, CPU) is got
    assert autotune.fusion_verdict(spec, "cuda") is None
    assert [r["kind"] for r in autotune.MEASURE_STATS["timed"]] == [
        "fusion", "fusion"]
    autotune.reset_measure_stats()
    assert autotune.measure_fusion(spec, device=CPU) is got   # replay
    assert _measured_nothing()
    with pytest.raises(ValueError):
        autotune.measure_fusion(spec.unfused(), device=CPU)


def test_fusion_verdict_gates_rewrite():
    gph = _tiny_residual()
    fg, fmap = tg.fuse_graph(gph, CPU)
    assert fmap                     # optimistic without a verdict
    fused_spec = fg.node("c1").spec
    entry = autotune._merged_entry(fused_spec, CPU)
    entry["fusion"] = {"wins": False, "fused_us": 2.0, "unfused_us": 1.0}
    autotune._STORE.put(autotune._key(fused_spec, CPU), entry)
    assert autotune.fusion_verdict(fused_spec, CPU) is False
    fg2, fmap2 = tg.fuse_graph(gph, CPU)
    assert fmap2 == {} and len(fg2) == 3
    assert tg.fuse_graph(gph, "cuda")[1] == fmap   # per backend


def test_full_warmup_splits_a_fusion_that_lost(clock):
    """tune="full" times each fused node against its unfused form; a
    lost verdict splits the node again, and the split graph serves."""
    from repro_torch.models.cnn import resnet_like
    clock["fn"] = lambda p: (2.0 if getattr(p, "spec", None) is not None
                             and p.spec.has_fusion else 1.0)
    model = resnet_like(num_classes=4)
    params = model.init(0, device=CPU)
    gp = model.graph_plan((1, 16, 16, 3), backend=CPU)
    assert len(gp.fused) == 3 and len(gp.graph) == 8
    gp.warmup(tune="full", repeats=1, device=CPU)
    assert gp.fused == {} and len(gp.graph) == 11
    assert set(gp.conv_plans) == {n.name for n in gp.graph.conv_nodes}
    assert autotune.MEASURE_STATS["fusion_sweeps"] == 3
    x = torch.from_numpy(rand(np.random.default_rng(0), (1, 16, 16, 3)))
    unfused = model.graph_plan((1, 16, 16, 3), backend=CPU, fuse=False)
    _close(gp.run(x, params), unfused.run(x, params))
    # a later process rebuilds the split program from the caches alone
    autotune.clear_cache()
    tg.clear_cache()
    autotune.reset_measure_stats()
    cs.reset_plan_stats()
    gp2 = resnet_like(num_classes=4).graph_plan((1, 16, 16, 3), backend=CPU)
    assert gp2.source == "graph_cache" and gp2.fused == {}
    assert cs.PLAN_STATS["resolutions"] == 0 and _measured_nothing()


# ---------------------------------------------------------------------------
# the graph layer

def test_warmup_measure_records_winners():
    gph = tg.ConvGraph.chain([(1, 1, 4, 1)], (1, 6, 6, 3))
    gp = tg.plan_graph(gph, backend=CPU)
    stats = gp.warmup(measure=True, repeats=1, device=CPU)
    (row,) = stats["nodes"]
    # the node runs the persisted winner: resolved against it, or taken
    # from the graph-level entry where that already names it
    (node,) = gp.graph.conv_nodes
    assert row["algorithm"] == autotune.cached_best(node.spec, CPU)
    assert row["source"] in ("measured", "graph_cache")
    assert autotune.MEASURE_STATS["algo_sweeps"] == 1


def test_warmup_measure_rejects_foreign_backend():
    gp = tg.plan_graph(tg.ConvGraph.chain([(1, 1, 4, 1)], (1, 6, 6, 3)),
                       backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        gp.warmup(measure=True, device=CPU)
    assert _measured_nothing()


def test_graph_warmup_tune_full_reports_and_replays_configs():
    from repro_torch.models.cnn import squeezenet_like
    gp = squeezenet_like().graph_plan((1, 16, 16, 3), backend=CPU)
    stats = gp.warmup(tune="full", repeats=1, device=CPU)
    assert all("config" in r and "config_source" in r
               for r in stats["nodes"])
    assert all(r["algorithm"] == autotune.cached_best(
        gp.graph.node(r["node"]).spec, CPU) for r in stats["nodes"])
    txt = gp.explain()
    for p in gp.conv_plans.values():
        if p.config:
            assert f"cfg[{p.config_source}]={p.config.key()}" in txt
    autotune.reset_measure_stats()
    cs.reset_plan_stats()
    gp2 = tg.plan_graph(gp.graph, backend=CPU)
    assert gp2.source == "graph_cache"
    for name, p in gp.conv_plans.items():
        assert gp2.conv_plans[name].algorithm == p.algorithm
        assert gp2.conv_plans[name].config == p.config
    assert _measured_nothing() and cs.PLAN_STATS["resolutions"] == 0


def test_measured_winner_invalidates_graph_cache_entry():
    gph = tg.ConvGraph.chain([(1, 1, 4, 1)], (1, 6, 6, 3))
    gp1 = tg.plan_graph(gph, backend=CPU)
    assert gp1.source == "resolved"
    other = next(a for a in ("lax", "im2col")
                 if a != gp1.node_plans[0].algorithm)
    autotune.record_best(gph.nodes[0], CPU, other)
    tg.clear_cache()
    gp2 = tg.plan_graph(gph, backend=CPU)
    assert gp2.source == "resolved"
    assert (gp2.node_plans[0].algorithm, gp2.node_plans[0].source) == (
        other, "measured")
    tg.clear_cache()
    assert tg.plan_graph(gph, backend=CPU).source == "graph_cache"


def test_a_warm_tuned_plan_resolves_nothing_on_a_second_tune(clock):
    clock["fn"] = _by_algorithm({"im2col": 0.5})
    gph = tg.ConvGraph.chain([(3, 3, 8, 1), (1, 1, 4, 1)], (1, 8, 8, 3))
    gp = tg.plan_graph(gph, backend=CPU)
    gp.warmup(tune="algo", repeats=1, device=CPU)
    assert {p.algorithm for p in gp.node_plans} == {"im2col"}
    cs.reset_plan_stats()
    autotune.reset_measure_stats()
    gp.warmup(tune="algo", repeats=1, device=CPU)
    assert cs.PLAN_STATS["resolutions"] == 0 and _measured_nothing()


# ---------------------------------------------------------------------------
# serving

def _served(model, params, shape, buckets):
    from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
    eng = CnnServeEngine(model, params, shape, buckets=buckets, device=CPU)
    return eng, ImageRequest


def test_serve_measured_warmup_rebuilds_programs():
    """A tune after the programs were built must not keep serving them:
    every bucket's program is rebuilt, and its CUDA graph dropped."""
    from repro_torch.models.cnn import SimpleCNN
    model = SimpleCNN([(1, 1, 4, 1)], num_classes=3)
    params = model.init(0, device=CPU)
    eng, ImageRequest = _served(model, params, (6, 6, 3), (1, 2))
    eng.warmup()
    fns_before = dict(eng.programs._fns)
    eng.programs.graphs[1] = "a stale graph"
    eng.warmup(measure=True)
    assert autotune.MEASURE_STATS["algo_sweeps"] > 0
    assert set(eng.programs._fns) == set(fns_before)
    assert all(eng.programs._fns[b] is not fns_before[b] for b in fns_before)
    assert "a stale graph" not in eng.programs.graphs.values()
    rng = np.random.default_rng(0)
    eng.submit(ImageRequest(0, rng.normal(size=(2, 6, 6, 3)).astype(
        np.float32)))
    (done,) = eng.run()
    want = model.apply(params, torch.from_numpy(done.images),
                       algorithm="lax")
    _close(torch.from_numpy(done.out), want)


def test_second_engine_over_a_tuned_cache_measures_and_plans_nothing():
    from repro_torch.models.cnn import resnet_like
    params = resnet_like(num_classes=4).init(0, device=CPU)
    eng, ImageRequest = _served(resnet_like(num_classes=4), params,
                                (16, 16, 3), (1, 2))
    eng.warmup(tune="full")
    assert autotune.MEASURE_STATS["algo_sweeps"] > 0
    plans = {b: {n: (p.algorithm, p.config) for n, p in
                 eng.programs.plan(b).conv_plans.items()}
             for b in eng.buckets}
    autotune.clear_cache()
    tg.clear_cache()
    autotune.reset_measure_stats()
    cs.reset_plan_stats()
    eng2, _ = _served(resnet_like(num_classes=4), params, (16, 16, 3),
                      (1, 2))
    eng2.warmup(tune="full")
    assert _measured_nothing() and cs.PLAN_STATS["resolutions"] == 0
    assert plans == {b: {n: (p.algorithm, p.config) for n, p in
                         eng2.programs.plan(b).conv_plans.items()}
                     for b in eng2.buckets}
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    for e in (eng, eng2):
        e.submit(ImageRequest(0, x))
    a, b = eng.run()[0].out, eng2.run()[0].out
    np.testing.assert_array_equal(a, b)


def test_forced_engine_is_not_tuned():
    from repro_torch.models.cnn import tiny_cnn
    model = tiny_cnn()
    eng, _ = _served(model, model.init(0, device=CPU), (8, 8, 3), (1,))
    eng.programs.algorithm = "lax"
    eng.warmup(tune="full")
    assert _measured_nothing()


# ---------------------------------------------------------------------------
# the persisted entry: the JAX package's schema and key

def test_persisted_entry_has_the_reference_schema_and_key(clock):
    """The port's entry for a spec sits under the reference's key
    (``backend/ConvSpec.key()``), with the reference's fields, and the
    JAX package reads it back."""
    from repro.core import autotune as rautotune
    from repro.core import convspec as rcs
    clock["fn"] = (lambda p: 0.5 if getattr(p, "algorithm", "") ==
                   "winograd_pallas" and p.config.get("m") == 2 else 1.0)
    spec = cs.ConvSpec((1, 8, 8, 8), (3, 3, 8, 16), (1, 1), (1, 1),
                       fused_add="add")
    rspec = rcs.ConvSpec((1, 8, 8, 8), (3, 3, 8, 16), (1, 1), (1, 1),
                         fused_add="add")
    assert spec.key() == rspec.key()
    autotune.record_best(spec, CPU, "winograd_pallas")
    autotune.tune_spec(spec, tune="full", device=CPU)
    raw = json.loads((cache_dir() / "autotune.json").read_text())
    key = rautotune._key(rspec, CPU)
    assert key == autotune._key(spec, CPU) == f"cpu/{spec.key()}"
    entry = raw[key]
    assert set(entry) == {"schema", "algorithm", "configs", "fusion"}
    assert entry["schema"] == rautotune.AUTOTUNE_SCHEMA
    assert set(entry["fusion"]) == {"wins", "fused_us", "unfused_us"}
    assert entry["configs"]["winograd_pallas"]["m"] == 2
    rautotune.clear_cache()
    try:
        rautotune._STORE.put(key, entry)
        assert rautotune.cached_best(rspec, CPU) == "winograd_pallas"
        assert rautotune.cached_config(rspec, CPU).as_dict() == \
            entry["configs"]["winograd_pallas"]
        assert rautotune.fusion_verdict(rspec, CPU) is entry["fusion"]["wins"]
    finally:
        rautotune.clear_cache()
