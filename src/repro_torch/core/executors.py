"""Executor registry: the open menu of convolution algorithms.

Every algorithm is a registered ``Executor`` declaring:

  name             stable string identity — what ``ConvPlan.algorithm``,
                   ``conv2d(algorithm=...)`` and the persisted
                   autotune/graphplans entries resolve through.  The
                   names are the JAX package's: ``cuconv_pallas``,
                   ``conv1x1_pallas``, ``cuconv_two_stage_pallas``,
                   ``winograd_pallas``, ``direct`` and ``cuconv_int8``
                   denote the CUDA kernels here.
  dtypes / accum   supported input dtypes and accumulation behaviour
  supports(spec)   exact capability over stride / groups / kernel size /
                   dtype / shared-memory working set
  heuristic_claim  the executor's claim on the paper's regions (figs
                   5-7), scored so negotiation can rank rivals
  cost(spec)       abstract cost model for the cheapest-supported tier
  vmem_bytes(spec, config)
                   the shared memory its CUDA kernel stages under a
                   launch config (the name is the JAX package's; the
                   budget is ``_build.SMEM_LIMIT``, the shared memory
                   one Hopper block can use, which the kernel wrappers
                   launch under too)
  configs(spec)    ordered candidate launch configs; ``config_supports``
                   prunes, ``default_config`` model-picks
  execute(...)     run the spec under a launch config, epilogue included

``convspec.plan()`` is pure negotiation over these declarations (forced
> measured cache > heuristic claims > cheapest supported).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from collections.abc import Mapping as _MappingABC
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.convspec import torch_dtype
from repro_torch.kernels._build import SMEM_LIMIT

# cost-model exchange rate: abstract cost units per byte of extra
# device-memory traffic (only has to rank executors, not predict time)
_COST_PER_HBM_BYTE = 8.0


def _is_small(spec) -> bool:
    """The paper's small-batch/small-spatial region (figs 5-7)."""
    n, h = spec.in_shape[0], spec.in_shape[1]
    return n == 1 or (h <= 14 and n <= 16)


def _itemsize(spec) -> int:
    return torch.empty((), dtype=torch_dtype(spec.dtype)).element_size()


# ---------------------------------------------------------------------------
# launch configurations

@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """One launch configuration: named integer kernel-geometry dims.

    Immutable, hashable and JSON-round-trippable via ``as_dict``.  An
    empty config (the untunable executors' only candidate) is falsy.
    """
    dims: Tuple[Tuple[str, int], ...] = ()

    @classmethod
    def of(cls, value) -> "LaunchConfig":
        """Coerce LaunchConfig | mapping of str -> int | None."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, _MappingABC):
            try:
                dims = tuple(sorted((str(k), int(v))
                                    for k, v in value.items()))
            except (TypeError, ValueError) as e:
                raise ValueError(f"launch-config dims must be str -> int; "
                                 f"got {dict(value)!r}") from e
            return cls(dims)
        raise ValueError(f"cannot build a LaunchConfig from {value!r}")

    def as_dict(self) -> Dict[str, int]:
        return dict(self.dims)

    def get(self, name: str, default: Optional[int] = None) -> Optional[int]:
        for k, v in self.dims:
            if k == name:
                return v
        return default

    def __getitem__(self, name: str) -> int:
        v = self.get(name)
        if v is None:
            raise KeyError(name)
        return v

    def __contains__(self, name: str) -> bool:
        return self.get(name) is not None

    def __bool__(self) -> bool:
        return bool(self.dims)

    def key(self) -> str:
        """Stable one-token rendering for explain()."""
        return ",".join(f"{k}={v}" for k, v in self.dims) or "-"


def _dedup_configs(dicts: Iterable[Dict[str, int]]
                   ) -> Tuple[LaunchConfig, ...]:
    """Ordered, deduplicated candidate list."""
    out, seen = [], set()
    for d in dicts:
        c = LaunchConfig.of(d)
        if c.dims not in seen:
            seen.add(c.dims)
            out.append(c)
    return tuple(out)


class Executor:
    """One registered convolution algorithm: capabilities + execution."""

    #: registry identity (also the persisted-cache algorithm string)
    name: str = ""
    #: raw conv callable ``fn(x, w, stride=, padding=, ...)``
    fn: Optional[Callable] = None
    #: ConvSpec.dtype strings this executor accepts
    dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    #: accumulation behaviour for the channel contraction
    accum: str = "float32"
    #: can execute groups > 1 specs exactly
    supports_groups: bool = False
    #: the bias/ReLU epilogue runs inside the kernel
    fuses_epilogue: bool = False
    #: names of the launch-config dims this executor can tune
    tunable: Tuple[str, ...] = ()
    #: the hand-written CUDA kernels one execution launches (empty for
    #: library calls and plain PyTorch); names of ``_build.LAUNCHES``
    kernels: Tuple[str, ...] = ()
    #: whether the launch config sizes the launch; False where the kernel
    #: picks its own geometry from the shape (``launch_key``)
    config_sizes_launch: bool = True

    # -- capability ------------------------------------------------------
    def supports(self, spec) -> Tuple[bool, str]:
        """Can this executor run ``spec`` exactly (ignoring speed)?"""
        if spec.dtype not in self.dtypes:
            return False, (f"dtype {spec.dtype} not in {self.name}'s "
                           f"declared dtypes {self.dtypes}")
        if spec.groups != 1 and not self.supports_groups:
            return False, (f"no grouped-conv support (groups={spec.groups}); "
                           f"lax feature_group_count is the executor")
        fusable = self.fusions(spec)
        if spec.fused_add != "none" and "add" not in fusable:
            return False, (f"{self.name} does not fuse a residual add "
                           f"(declared fusions for this spec: "
                           f"{list(fusable) or 'none'})")
        if spec.fused_pool and "pool" not in fusable:
            return False, (f"{self.name} does not fuse pool "
                           f"{spec.fused_pool!r} (declared fusions for "
                           f"this spec: {list(fusable) or 'none'})")
        return self._supports(spec)

    def _supports(self, spec) -> Tuple[bool, str]:
        return True, "generic algorithm"

    def fusions(self, spec) -> Tuple[str, ...]:
        """Cross-layer fusions ("add", "pool") this executor absorbs.

        Non-fusing executors take every fusion for free: ``execute``
        applies the residual add / pool after the bare conv.  In-kernel
        (``fuses_epilogue``) executors opt in per fusion kind.
        """
        if self.fuses_epilogue:
            return ()
        return ("add", "pool")

    # -- tuning space ------------------------------------------------------
    def configs(self, spec) -> Tuple[LaunchConfig, ...]:
        """Ordered candidate launch configs (candidate 0 is the historical
        geometry); untunable executors expose one empty config."""
        return (LaunchConfig(),)

    def config_supports(self, spec, config) -> Tuple[bool, str]:
        """Can this executor run ``spec`` under ``config`` exactly?
        Common gates: declared dims, positive values, the shared-memory
        budget via ``vmem_bytes``; geometry rules go in
        ``_config_supports``."""
        config = LaunchConfig.of(config)
        unknown = [k for k, _ in config.dims if k not in self.tunable]
        if unknown:
            return False, (f"{self.name} has no tunable dim(s) {unknown} "
                           f"(tunable: {list(self.tunable) or 'none'})")
        bad = [(k, v) for k, v in config.dims if v < 1]
        if bad:
            return False, f"launch dims must be >= 1; got {bad}"
        ok, why = self._config_supports(spec, config)
        if not ok:
            return False, why
        need = self.vmem_bytes(spec, config)
        if need is not None and need > SMEM_LIMIT:
            return False, (f"config [{config.key()}] stages {need} bytes "
                           f"of shared memory > {SMEM_LIMIT} budget")
        return True, why

    def _config_supports(self, spec, config) -> Tuple[bool, str]:
        return True, "config geometry ok"

    def config_cost(self, spec, config) -> float:
        """Abstract cost of ``spec`` under ``config`` (only ranks)."""
        return 0.0

    def launch_key(self, spec, config) -> tuple:
        """What of ``config`` reaches the launch: configs with equal keys
        launch the same kernels the same way (the config race times one
        of them).  Every config is its own launch by default; none
        changes it where the kernel picks its own geometry."""
        if not self.config_sizes_launch:
            return ()
        return LaunchConfig.of(config).dims

    def default_config(self, spec) -> LaunchConfig:
        """The cheapest feasible candidate by ``config_cost`` (ties keep
        the earliest candidate)."""
        cands = self.configs(spec)
        feasible = [c for c in cands if self.config_supports(spec, c)[0]]
        if not feasible:
            return cands[0]
        return min(feasible, key=lambda c: self.config_cost(spec, c))

    # -- negotiation inputs ----------------------------------------------
    def heuristic_claim(self, spec, backend: str
                        ) -> Optional[Tuple[int, str]]:
        """``(score, reason)`` claim on the paper's regions, or None."""
        return None

    def cost(self, spec) -> float:
        return (self.flop_cost(spec)
                + _COST_PER_HBM_BYTE * self.extra_hbm_bytes(spec))

    def flop_cost(self, spec) -> float:
        n, oh, ow, m = spec.out_shape
        kh, kw, cpg, _ = spec.filter_shape
        return 2.0 * n * oh * ow * m * kh * kw * cpg

    def extra_hbm_bytes(self, spec) -> float:
        """Device-memory traffic beyond reading inputs and writing the
        output once."""
        return 0.0

    def vmem_bytes(self, spec, config=None) -> Optional[int]:
        """Shared memory the kernel stages under ``config``, or None when
        there is no kernel."""
        return None

    def fallback(self, spec) -> Tuple[str, str]:
        return "lax", "library conv covers all geometries"

    # -- execution -------------------------------------------------------
    def execute(self, spec, x, w, bias=None, addend=None, config=None,
                quant=None):
        """Run ``spec`` on ``(x, w, bias[, addend])``, epilogue included.

        Operands are cast to the spec dtype first (master weights stay
        fp32).  Non-fusing executors apply the bias/ReLU epilogue and any
        cross-layer fusion after the bare conv; ``fuses_epilogue``
        executors absorb everything in-kernel.  ``quant`` is the
        quantization payload ConvPlan forwards on int8 plans — ignored
        here; the int8 executor overrides ``execute`` and consumes it.
        """
        dtype = torch_dtype(spec.dtype)
        x = x if x.dtype == dtype else x.to(dtype)
        w = w if w.dtype == dtype else w.to(dtype)
        if bias is not None and bias.dtype != dtype:
            bias = bias.to(dtype)
        if spec.fused_add != "none" and addend is None:
            raise ValueError(f"fused-add spec {spec.key()} needs an addend")
        if addend is not None and addend.dtype != dtype:
            addend = addend.to(dtype)
        kwargs = {"config": LaunchConfig.of(config)}
        if addend is not None and self.fuses_epilogue:
            kwargs["addend"] = addend
        y = self._execute(spec, x, w, bias, **kwargs)
        if not self.fuses_epilogue:
            if spec.has_bias:
                y = y + bias
            if spec.fused_add != "none":
                y = y + addend
                if spec.fused_add == "add_relu":
                    y = torch.relu(y)
            elif spec.wants_relu:
                y = torch.relu(y)
            if spec.fused_pool:
                from repro_torch.kernels import ops
                kind, pkh, pkw, psh, psw, pph, ppw = spec.fused_pool
                y = ops.pool2d(y, kind=kind, window=(pkh, pkw),
                               stride=(psh, psw), padding=(pph, ppw))
        return y

    def _execute(self, spec, x, w, bias, config=None):
        kwargs = {}
        if spec.groups != 1:
            kwargs["groups"] = spec.groups
        return self.fn(x, w, stride=spec.stride, padding=spec.padding,
                       **kwargs)

    def __repr__(self):
        return (f"<Executor {self.name} dtypes={self.dtypes} "
                f"accum={self.accum} groups={self.supports_groups} "
                f"fused_epilogue={self.fuses_epilogue}>")


# ---------------------------------------------------------------------------
# registry

_REGISTRY: Dict[str, Executor] = {}


def register(executor: Executor) -> Executor:
    """Add an executor to the menu (third-party entry point)."""
    name = executor.name
    if not name or not isinstance(name, str):
        raise ValueError(f"executor needs a non-empty string name; "
                         f"got {name!r}")
    if name in _REGISTRY:
        raise ValueError(f"executor {name!r} already registered; "
                         f"unregister it first to replace it")
    if executor.fn is None and type(executor)._execute is Executor._execute:
        raise ValueError(f"executor {name!r} must set `fn` or override "
                         f"`_execute`")
    _REGISTRY[name] = executor
    return executor


def unregister(name: str) -> Executor:
    """Remove a registered executor (returns it); unknown names raise."""
    ex = _REGISTRY.pop(name, None)
    if ex is None:
        raise KeyError(f"unknown algorithm {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return ex


def get(name: str) -> Executor:
    ex = _REGISTRY.get(name)
    if ex is None:
        raise KeyError(f"unknown algorithm {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return ex


def capable(name: str, spec) -> bool:
    """Is ``name`` a registered executor whose declarations cover
    ``spec``?  Stale persisted entries failing this are dropped."""
    ex = _REGISTRY.get(name)
    return ex is not None and ex.supports(spec)[0]


def names() -> Tuple[str, ...]:
    """Registered executor names, in registration order."""
    return tuple(_REGISTRY)


def registered() -> Dict[str, Executor]:
    """Snapshot of the registry (mutating it does not unregister)."""
    return dict(_REGISTRY)


class _AlgorithmsView(_MappingABC):
    """Read-only ``{name: bare conv callable}`` view of the registry,
    the reference's ``ALGORITHMS`` surface.  Executors that expose no
    bare callable (``fn is None``) are absent from the view."""

    def __getitem__(self, name: str) -> Callable:
        fn = get(name).fn
        if fn is None:
            raise KeyError(f"executor {name!r} exposes no bare callable")
        return fn

    def __iter__(self):
        return (n for n, e in _REGISTRY.items() if e.fn is not None)

    def __len__(self):
        return sum(1 for e in _REGISTRY.values() if e.fn is not None)

    def __repr__(self):
        return f"ALGORITHMS({', '.join(self)})"


#: the reference's mapping (``from repro_torch.core import ALGORITHMS``)
ALGORITHMS = _AlgorithmsView()


def algorithms() -> _AlgorithmsView:
    return ALGORITHMS


# ---------------------------------------------------------------------------
# negotiation

def negotiate(spec, backend: str) -> Tuple[str, str, str]:
    """Pick an executor for ``spec`` from capability declarations alone:
    ``(name, source, reason)`` — the highest heuristic claim among
    supporting executors, else the cheapest supported one.  No executor
    supporting the spec is an error naming every refusal."""
    best_claim = None          # (score, name, reason); first-registered wins ties
    cheapest = None            # (cost, name)
    refusals = []
    for ex in _REGISTRY.values():
        ok, why = ex.supports(spec)
        if not ok:
            refusals.append(f"{ex.name}: {why}")
            continue
        claim = ex.heuristic_claim(spec, backend)
        if claim is not None and (best_claim is None
                                  or claim[0] > best_claim[0]):
            best_claim = (claim[0], ex.name, claim[1])
        c = ex.cost(spec)
        if cheapest is None or c < cheapest[0]:
            cheapest = (c, ex.name)
    if best_claim is not None:
        return best_claim[1], "heuristic", best_claim[2]
    if cheapest is not None:
        return (cheapest[1], "cost",
                f"cheapest supported executor (cost {cheapest[0]:.3g})")
    raise ValueError(
        f"no registered executor supports spec {spec.key()}; "
        + "; ".join(refusals))


def supporting(spec) -> Tuple[str, ...]:
    """Names of every registered executor that can run ``spec`` exactly."""
    return tuple(n for n, ex in _REGISTRY.items() if ex.supports(spec)[0])


# ---------------------------------------------------------------------------
# built-in executors (the paper's algorithm family)

class LaxExecutor(Executor):
    """``F.conv2d`` (cuDNN on the card, TF32 off) — the library baseline
    of the paper's comparison, and the only grouped-conv executor."""
    name = "lax"
    supports_groups = True

    def _supports(self, spec):
        if spec.groups != 1:
            return True, (f"grouped conv (groups={spec.groups}): library "
                          f"feature_group_count")
        return True, "library conv covers all geometries"

    def heuristic_claim(self, spec, backend):
        if spec.groups != 1:
            return 95, (f"grouped conv (groups={spec.groups}): library "
                        f"feature_group_count")
        if not spec.unit_stride:
            # a low claim: any capable kernel claiming the strided region
            # outranks it, so winning here means nothing else did
            return 40, ("strided conv: library kernel off the card"
                        if backend != "cuda"
                        else "strided conv: library kernel "
                        "(no higher-priority claim)")
        return None

    def _execute(self, spec, x, w, bias, config=None):
        from repro_torch.core import cuconv
        return cuconv.conv_lax(x, w, stride=spec.stride,
                               padding=spec.padding, groups=spec.groups)


class Im2colExecutor(Executor):
    """Explicit patch matrix + one GEMM; pays KH*KW-fold input
    duplication through device memory."""
    name = "im2col"

    def extra_hbm_bytes(self, spec):
        n, oh, ow, _ = spec.out_shape
        kh, kw, cpg, _ = spec.filter_shape
        return 2.0 * n * oh * ow * kh * kw * cpg * _itemsize(spec)


class WinogradExecutor(Executor):
    """F(2x2, 3x3) minimal filtering in plain PyTorch — the paper's
    strongest competitor in the large-3x3 region."""
    name = "winograd"

    def _supports(self, spec):
        if spec.filter_shape[:2] != (3, 3) or not spec.unit_stride:
            return False, "Winograd F(2x2,3x3) needs 3x3 stride-1"
        return True, "3x3 stride-1: Winograd region"

    def heuristic_claim(self, spec, backend):
        if not _is_small(spec):
            return 70, "large 3x3: Winograd region in the paper"
        return None

    def flop_cost(self, spec):
        # 2.25x fewer multiplies than direct
        return super().flop_cost(spec) / 2.25

    def extra_hbm_bytes(self, spec):
        n, oh, ow, m = spec.out_shape
        c = spec.in_shape[3]
        # 16 positions per 2x2 output block: tiles transit at the spec
        # dtype, the Winograd-domain tensors in fp32
        tiles = n * ((oh + 1) // 2) * ((ow + 1) // 2) * 16
        return tiles * (c + m) * (_itemsize(spec) + 4.0)

    def _execute(self, spec, x, w, bias, config=None):
        from repro_torch.core.winograd import conv_winograd
        return conv_winograd(x, w, 1, spec.padding)


class TwoStageExecutor(Executor):
    """Faithful paper pipeline in plain PyTorch: stage-1 temporaries
    materialized (KH*KW, N, OH, OW, M), stage-2 sum."""
    name = "cuconv_two_stage"

    def extra_hbm_bytes(self, spec):
        n, oh, ow, m = spec.out_shape
        kh, kw = spec.filter_shape[:2]
        return 2.0 * kh * kw * n * oh * ow * m * 4


class CuconvExecutor(Executor):
    """Fused tap accumulation in plain PyTorch (no temporaries)."""
    name = "cuconv"

    def heuristic_claim(self, spec, backend):
        if not spec.unit_stride:
            return None
        if spec.is_1x1:
            return 60, "1x1: single GEMM, no stage 2 (best region)"
        if _is_small(spec):
            return 60, "small batch/spatial: cuConv region"
        if spec.filter_shape[:2] == (3, 3):
            return None                    # Winograd's region in the paper
        return 20, "default cuConv region"


# Tiled-GEMM launch candidates shared by the 1x1 and two-stage kernels:
# (tp, tm, tc) = pixel / out-channel / contraction tiles.  Candidate 0 is
# the JAX package's historical geometry; the list is its own, so plans
# and cache entries read alike.
_GEMM_TILES = (
    (256, 128, 512),
    (512, 256, 512),
    (256, 512, 512),
    (128, 128, 256),
    (512, 128, 1024),
    (128, 64, 128),
)


def _gemm_tile_configs(p: int, m: int, c: int) -> Tuple[LaunchConfig, ...]:
    return _dedup_configs(
        {"tp": min(tp, p), "tm": min(tm, m), "tc": min(tc, c)}
        for tp, tm, tc in _GEMM_TILES)


def _gemm_tile_steps(p: int, m: int, c: int, config: LaunchConfig) -> float:
    """Block-step count of the tiled GEMM under ``config`` (the ranking
    ``config_cost`` minimizes)."""
    tp = min(config.get("tp", 256), p)
    tm = min(config.get("tm", 128), m)
    tc = min(config.get("tc", 512), c)
    return (-(-p // tp)) * (-(-m // tm)) * (-(-c // tc))


class Conv1x1PallasExecutor(Executor):
    """The 1x1 GEMM CUDA kernel (``kernels/conv1x1.py``; the registry
    name is the JAX package's): all N*H*W pixels in one tensor-core GEMM
    — the paper's best-case region on its natural kernel.

    Tuning space: the reference's ``tp``/``tm``/``tc``, ranked by its
    grid-step model, so plans and cache entries read like the
    reference's.  On the card they size nothing: the kernel picks its
    own block tile and contraction splits from the shape
    (``conv1x1.launch_geometry``), and ``vmem_bytes`` is that geometry's
    shared memory, the same for every candidate."""
    name = "conv1x1_pallas"
    tunable = ("tp", "tm", "tc")
    kernels = ("conv1x1_gemm",)
    config_sizes_launch = False

    def _supports(self, spec):
        if (not spec.is_1x1 or not spec.unit_stride
                or spec.padding != (0, 0)):
            return False, "conv1x1 kernel needs 1x1 filter, stride 1, pad 0"
        return True, "1x1 GEMM kernel (all pixels in one GEMM)"

    def heuristic_claim(self, spec, backend):
        if backend == "cuda" and spec.epilogue == "none":
            # no epilogue to fuse: one GEMM over all N*H*W pixels
            return 90, "1x1: dedicated GEMM kernel"
        return None

    def _gemm_dims(self, spec):
        n, h, w, c = spec.in_shape
        return n * h * w, spec.filter_shape[3], c

    def configs(self, spec):
        return _gemm_tile_configs(*self._gemm_dims(spec))

    def vmem_bytes(self, spec, config=None):
        from repro_torch.kernels.conv1x1 import launch_geometry
        p, m, c = self._gemm_dims(spec)
        return launch_geometry(p, c, m, _itemsize(spec))["smem"]

    def config_cost(self, spec, config):
        return _gemm_tile_steps(*self._gemm_dims(spec), config)

    def _execute(self, spec, x, w, bias, config=None):
        from repro_torch.kernels import ops
        cfg = LaunchConfig.of(config)
        return ops.conv1x1(x, w, tp=cfg.get("tp", 256),
                           tm=cfg.get("tm", 128), tc=cfg.get("tc", 512))


class TwoStagePallasExecutor(Executor):
    """The paper's two CUDA kernels, stage 1 + stage 2 (stride 1; the
    registry name is the JAX package's): temporaries in device memory —
    the fused kernel's declared fallback.

    Tuning space: the reference's ``tp``/``tm``/``tc`` (stage 1's tiles),
    ranked by its grid-step model, so plans and cache entries read like
    the reference's.  On the card they size nothing: stage 1 picks its
    own block tile from the shape (``cuconv_stage1.launch_geometry``),
    and ``vmem_bytes`` is that geometry's shared memory, the same for
    every candidate."""
    name = "cuconv_two_stage_pallas"
    tunable = ("tp", "tm", "tc")
    kernels = ("stage1_tap_gemm", "stage2_tap_sum")
    config_sizes_launch = False

    def _supports(self, spec):
        if not spec.unit_stride:
            return False, "two-stage kernels are stride-1 only"
        return True, "two-stage kernel pipeline (bounded shared memory)"

    def extra_hbm_bytes(self, spec):
        n, oh, ow, m = spec.out_shape
        kh, kw = spec.filter_shape[:2]
        return 2.0 * kh * kw * n * oh * ow * m * 4

    def _gemm_dims(self, spec):
        n, oh, ow, m = spec.out_shape
        return n * oh * ow, m, spec.filter_shape[2]

    def configs(self, spec):
        return _gemm_tile_configs(*self._gemm_dims(spec))

    def vmem_bytes(self, spec, config=None):
        from repro_torch.kernels.cuconv_stage1 import launch_geometry
        p, m, c = self._gemm_dims(spec)
        kh, kw = spec.filter_shape[:2]
        return launch_geometry(kh * kw, p, c, m, _itemsize(spec))["smem"]

    def config_cost(self, spec, config):
        p, m, c = self._gemm_dims(spec)
        kh, kw = spec.filter_shape[:2]
        return kh * kw * _gemm_tile_steps(p, m, c, config)

    def _execute(self, spec, x, w, bias, config=None):
        from repro_torch.kernels import ops
        cfg = LaunchConfig.of(config)
        return ops.cuconv_two_stage(x, w, spec.padding,
                                    tp=cfg.get("tp", 256),
                                    tm=cfg.get("tm", 128),
                                    tc=cfg.get("tc", 512))


class FusedPallasExecutor(Executor):
    """The fused CUDA kernel (``kernels/cuconv_fused.py``; the registry
    name is the JAX package's): any stride >= 1, an implicit GEMM over
    (tap, channel) on the tensor cores, bias / residual-add / ReLU /
    pool fused before the single write.

    Tuning space: the reference's ``tm`` (output-channel tile) x
    ``rows`` (output rows per block), ranked by its grid-step model, so
    plans and cache entries read like the reference's.  On the card they
    size nothing: the kernel picks its own block tile and contraction
    splits from the shape (``cuconv_fused.launch_geometry``), and
    ``vmem_bytes`` is that geometry's shared memory, the same for every
    candidate.  The pool rules (``rows % psh``, ``OH % rows``) and the
    JAX package's multi-row halo rule (``KH - 1 <= rows*sh`` for ``rows
    >= 2``), a TPU staging artefact, are kept in ``config_supports`` so
    plans read alike across the two packages.
    """
    name = "cuconv_pallas"
    fuses_epilogue = True
    tunable = ("tm", "rows")
    kernels = ("cuconv_fused",)
    config_sizes_launch = False

    @staticmethod
    def _pool3(spec):
        """``(kind, psh, psw)`` kernel-pool tuple for a fused-pool spec."""
        kind, _, _, psh, psw, _, _ = spec.fused_pool
        return (kind, psh, psw)

    def fusions(self, spec):
        """Any residual add; non-overlapping unpadded pools whose windows
        tile the output (window == stride, OH/OW divisible)."""
        out = ("add",)
        if spec.fused_pool:
            kind, pkh, pkw, psh, psw, pph, ppw = spec.fused_pool
            _, oh, ow, _ = spec.out_shape
            if ((pkh, pkw) == (psh, psw) and (pph, ppw) == (0, 0)
                    and oh % psh == 0 and ow % psw == 0):
                out = out + ("pool",)
        return out

    def _geometry(self, spec):
        from repro_torch.kernels.cuconv_fused import launch_geometry
        return launch_geometry(spec.in_shape, spec.filter_shape,
                               spec.stride, spec.padding,
                               self._pool3(spec) if spec.fused_pool
                               else None, _itemsize(spec))

    def vmem_bytes(self, spec, config=None):
        return self._geometry(spec)["smem"]

    @staticmethod
    def _pool_fits(spec):
        """Whether the pool window fits the kernel's pooled block tile."""
        from repro_torch.kernels.cuconv_fused import pool_tile
        _, oh, ow, _ = spec.out_shape
        try:
            pool_tile(oh, ow, spec.fused_pool[3], spec.fused_pool[4])
        except ValueError as e:
            return False, str(e)
        return True, ""

    def _supports(self, spec):
        if spec.fused_pool:
            ok, why = self._pool_fits(spec)
            if not ok:
                return False, why
        need = self.vmem_bytes(spec)
        if need > SMEM_LIMIT:
            return False, (f"fused kernel stages {need} bytes of shared "
                           f"memory > {SMEM_LIMIT} budget")
        if spec.fused_pool and not any(
                self.config_supports(spec, c)[0] for c in self.configs(spec)):
            return False, ("no feasible row blocking covers fused "
                           f"pool {spec.fused_pool!r}")
        return True, "fused CUDA kernel fits shared memory"

    def configs(self, spec):
        _, oh, _, m = spec.out_shape
        if spec.fused_pool:
            # rows must tile both the pool stride and OH (candidate 0:
            # one pool window of output rows per block)
            psh = spec.fused_pool[3]
            rows_cands = tuple(r for r in (psh, 2 * psh, 4 * psh, 8 * psh)
                               if r <= oh) or (psh,)
        else:
            rows_cands = (1, 2, 4, 8)
        return _dedup_configs(
            {"tm": min(tm, m), "rows": min(rows, oh)}
            for tm in (128, 256, 512)          # candidate 0: tm=128, rows=1
            for rows in rows_cands)

    def _config_supports(self, spec, config):
        rows = config.get("rows", 1)
        _, oh, _, _ = spec.out_shape
        kh = spec.filter_shape[0]
        sh = spec.stride[0]
        if rows > oh:
            return False, (f"rows={rows} exceeds OH={oh} for "
                           f"{spec.key()}")
        if rows > 1 and kh - 1 > rows * sh:
            return False, (f"multi-row blocking needs KH-1 <= rows*sh; "
                           f"got KH={kh}, rows={rows}, sh={sh}")
        if spec.fused_pool:
            ok, why = self._pool_fits(spec)
            if not ok:
                return False, why
            psh = spec.fused_pool[3]
            if rows % psh:
                return False, (f"fused pool needs rows % pool stride == 0; "
                               f"got rows={rows}, psh={psh}")
            if oh % rows:
                return False, (f"fused pool needs OH % rows == 0; "
                               f"got OH={oh}, rows={rows}")
            if kh - 1 > rows * sh:
                return False, (f"fused pool rides the multi-row blocking: "
                               f"needs KH-1 <= rows*sh; got KH={kh}, "
                               f"rows={rows}, sh={sh}")
        return True, "config geometry ok"

    def config_cost(self, spec, config):
        n, oh, _, m = spec.out_shape
        kh, kw = spec.filter_shape[:2]
        tm = min(config.get("tm", 128), m)
        rows = max(1, min(config.get("rows", 1), oh))
        return n * (-(-oh // rows)) * (-(-m // tm)) * kh * kw

    def heuristic_claim(self, spec, backend):
        if backend != "cuda":
            return None                    # plain versions off the card
        if spec.has_fusion:
            # outranks every per-layer claim: the folded add/pool never
            # round-trips device memory
            return 85, "cross-layer fusion in the kernel's epilogue"
        if not spec.unit_stride:
            return 80, "strided conv: fused kernel on the card"
        if spec.is_1x1:
            return 80, "1x1: fused GEMM + epilogue"
        if _is_small(spec):
            return 80, "small batch/spatial: cuConv region"
        return None

    def fallback(self, spec):
        if spec.unit_stride:
            return ("cuconv_two_stage_pallas",
                    "two-stage kernels bound the shared-memory working set")
        return "cuconv", "fused-tap path handles any stride"

    def _execute(self, spec, x, w, bias, config=None, addend=None):
        # epilogue fused into the kernel: bias + residual addend +
        # activation (or the fused pool) before its single write
        from repro_torch.kernels import ops
        cfg = LaunchConfig.of(config)
        if spec.fused_add != "none":
            relu = spec.fused_add == "add_relu"    # post-add activation
        else:
            relu = spec.wants_relu
        return ops.cuconv_fused(
            x, w, spec.padding, stride=spec.stride,
            bias=bias if spec.has_bias else None,
            activation="relu" if relu else None,
            addend=addend,
            pool=self._pool3(spec) if spec.fused_pool else None,
            tm=cfg.get("tm", 128), rows=cfg.get("rows", 1))


# Winograd launch candidates: (tt, tm, tc) tile triples tried under both
# F(m,3) variants — the JAX package's list, so plans read alike.
_WINO_TILES = (
    (128, 128, 128),
    (256, 128, 128),
    (128, 256, 128),
    (128, 128, 256),
    (128, 128, 64),
    (64, 128, 64),
    (64, 256, 128),
)


class WinogradPallasExecutor(Executor):
    """The Winograd F(m,3) CUDA kernel (``kernels/winograd_fused.py``;
    the registry name is the JAX package's): B^T d B and G g G^T, the
    per-position channel products on the tensor cores with fp32
    accumulators in registers, A^T m A and the bias / residual / ReLU
    epilogue in one kernel.

    Tuning space: ``m`` (F(2x2,3x3), 16 positions and 2.25x fewer
    multiplies, or F(4x4,3x3), 36 positions and 4x, at looser numerics),
    and the reference's ``tt`` (tiles per block), ``tm`` (output channels
    per block) and ``tc`` (contraction tile), which the config cost
    counts so plans read like the reference's.  On the card ``tt`` and
    ``tc`` size nothing: the kernel launches one block per its own tile
    block x channel block (``winograd_fused.launch_geometry``), and
    ``tm`` only picks its 16-channel variant for narrow layers.  The
    kernel stages at most 140 KB of shared memory, so no candidate is
    pruned by the budget: where the reference's VMEM budget pruned the
    cheapest candidate, the port's default config differs from the
    reference's.
    """
    name = "winograd_pallas"
    fuses_epilogue = True
    tunable = ("m", "tt", "tm", "tc")
    kernels = ("winograd_fused",)

    def fusions(self, spec):
        # the residual add folds into the epilogue; pool does not
        return ("add",)

    def _supports(self, spec):
        if spec.filter_shape[:2] != (3, 3) or not spec.unit_stride:
            return False, "Winograd F(m,3) needs 3x3 stride-1"
        if not any(self.config_supports(spec, c)[0]
                   for c in self.configs(spec)):
            return False, ("no Winograd candidate fits the shared-memory "
                           "budget for this spec")
        return True, "3x3 stride-1: Winograd CUDA kernel"

    def _tile_counts(self, spec, fm):
        n, oh, ow, m = spec.out_shape
        return n * (-(-oh // fm)) * (-(-ow // fm)), m, spec.filter_shape[2]

    def configs(self, spec):
        cands = []
        for fm in (2, 4):
            p, m, c = self._tile_counts(spec, fm)
            for tt, tm, tc in _WINO_TILES:
                cands.append({"m": fm, "tt": min(tt, p),
                              "tm": min(tm, m), "tc": min(tc, c)})
        return _dedup_configs(cands)

    def _config_supports(self, spec, config):
        fm = config.get("m", 2)
        if fm not in (2, 4):
            return False, (f"F(m,3) variant must be m=2 or m=4; "
                           f"got m={fm}")
        return True, "config geometry ok"

    def vmem_bytes(self, spec, config=None):
        from repro_torch.kernels.winograd_fused import launch_geometry
        cfg = LaunchConfig.of(config)
        fm = cfg.get("m", 2)
        if fm not in (2, 4):
            return None              # refused by _config_supports first
        p, m, _ = self._tile_counts(spec, fm)
        return launch_geometry(fm, p, m, cfg.get("tm", 128),
                               _itemsize(spec))["smem"]

    def launch_key(self, spec, config):
        # the F(m,3) variant and the block the kernel takes for it (tm
        # picks the 16-channel block); tt and tc size nothing
        from repro_torch.kernels.winograd_fused import launch_geometry
        cfg = LaunchConfig.of(config)
        fm = cfg.get("m", 2)
        p, m, _ = self._tile_counts(spec, fm)
        geo = launch_geometry(fm, p, m, cfg.get("tm", 128), _itemsize(spec))
        return (fm, geo["bt"], geo["bn"])

    def config_cost(self, spec, config):
        fm = config.get("m", 2)
        p, m, c = self._tile_counts(spec, fm)
        tt = min(config.get("tt", 128), p)
        tm = min(config.get("tm", 128), m)
        tc = min(config.get("tc", 128), c)
        steps = (-(-p // tt)) * (-(-m // tm)) * (-(-c // tc))
        # (m+2)^2 per-position products per step (the reference's model)
        return steps * (fm + 2) ** 2

    def flop_cost(self, spec):
        # 2.25x fewer multiplies than direct under F(2,3)
        return super().flop_cost(spec) / 2.25

    def extra_hbm_bytes(self, spec):
        n, oh, ow, m = spec.out_shape
        c = spec.filter_shape[2]
        itemsize = _itemsize(spec)
        p = n * ((oh + 1) // 2) * ((ow + 1) // 2)
        # the reference's model (gathered tiles, output tiles, fp32 U), so
        # negotiation ranks alike; the CUDA kernel gathers in the kernel
        return (2.0 * p * 16 * c * itemsize + 2.0 * 16 * c * m * 4
                + 2.0 * p * 4 * m * itemsize)

    def heuristic_claim(self, spec, backend):
        if backend != "cuda" or spec.has_fusion:
            return None
        if not _is_small(spec):
            return 82, "large 3x3: Winograd CUDA kernel (fig. 6 region)"
        return None

    def _execute(self, spec, x, w, bias, config=None, addend=None):
        from repro_torch.kernels import ops
        cfg = LaunchConfig.of(config)
        if spec.fused_add != "none":
            relu = spec.fused_add == "add_relu"    # post-add activation
        else:
            relu = spec.wants_relu
        return ops.winograd_fused(
            x, w, spec.padding, bias=bias if spec.has_bias else None,
            activation="relu" if relu else None, addend=addend,
            m=cfg.get("m", 2), tt=cfg.get("tt", 128), tm=cfg.get("tm", 128),
            tc=cfg.get("tc", 128))


# Direct-conv launch candidates: (tm, tc) output/input channel tiles —
# the JAX package's list.
_DIRECT_TILES = (
    (128, 256),
    (128, 128),
    (256, 128),
    (128, 512),
    (256, 256),
    (64, 64),
    (512, 128),
)


class DirectConvExecutor(Executor):
    """The im2col-free direct-conv CUDA kernel (Li et al. 1610.03618;
    ``kernels/direct_conv.py``): no patch matrix and no per-tap
    temporaries — each block stages its output tile's input halo once
    per channel chunk and runs every tap out of shared memory, on the
    tensor cores.

    Tuning space: the reference's ``tm`` (output channels per block) and
    ``tc`` (its channel slice), ranked by its grid-step model, so plans
    and cache entries read like the reference's (``_DIRECT_TILES`` and
    ``config_cost`` are the JAX package's).  On the card they size
    nothing: the kernel picks its own pixel tile, channel tile, chunk
    and C-splits from the shape (``direct_conv.launch_geometry``), and
    ``vmem_bytes`` is that geometry's shared memory, the same for every
    candidate.  It grows with the filter and the stride, not with C, so
    the large-C region stays feasible; a spec whose smallest tile does
    not fit is refused.
    """
    name = "direct"
    tunable = ("tm", "tc")
    kernels = ("direct_conv",)
    config_sizes_launch = False

    def _supports(self, spec):
        need = self.vmem_bytes(spec)
        if need > SMEM_LIMIT:
            return False, (f"direct kernel's filter slice and input halo "
                           f"stage {need} bytes of shared memory > "
                           f"{SMEM_LIMIT} budget")
        return True, "im2col-free direct conv (spatial and channel tiles)"

    def configs(self, spec):
        m, c = spec.filter_shape[3], spec.filter_shape[2]
        return _dedup_configs({"tm": min(tm, m), "tc": min(tc, c)}
                              for tm, tc in _DIRECT_TILES)

    def vmem_bytes(self, spec, config=None):
        from repro_torch.kernels.direct_conv import launch_geometry
        return launch_geometry(spec.in_shape, spec.filter_shape,
                               spec.stride, spec.padding,
                               _itemsize(spec))["smem"]

    def config_cost(self, spec, config):
        n = spec.in_shape[0]
        kh, kw, c, m = spec.filter_shape
        tm = min(config.get("tm", 128), m)
        tc = min(config.get("tc", 256), c)
        return n * (-(-m // tm)) * (-(-c // tc)) * kh * kw

    def extra_hbm_bytes(self, spec):
        n, h, w_, c = spec.in_shape
        # the reference's model (the input re-read once per 128-channel
        # tile beyond the first), so negotiation ranks alike; the CUDA
        # kernel re-reads each halo once per bn-channel tile, mostly from
        # L2, and its C-split partials go through a workspace
        retiles = -(-spec.filter_shape[3] // 128) - 1
        return float(retiles * n * h * w_ * c * _itemsize(spec))

    def heuristic_claim(self, spec, backend):
        if backend != "cuda" or spec.has_fusion or spec.is_1x1:
            return None
        if spec.filter_shape[2] >= 256:
            # a modest claim: wins the large-C region only where no
            # higher-priority kernel claims
            return 45, "large-C: im2col-free direct path (Li et al.)"
        return None

    def _execute(self, spec, x, w, bias, config=None):
        from repro_torch.kernels import ops
        cfg = LaunchConfig.of(config)
        return ops.direct_conv(x, w, spec.padding, stride=spec.stride,
                               tm=cfg.get("tm", 128), tc=cfg.get("tc", 256))


@functools.lru_cache(maxsize=256)
def _scale_on(x_scale: float, device: torch.device):
    """A calibrated scale as an fp32 tensor on ``device``, copied there
    once.  A tensor, not a Python float: a float divisor takes PyTorch's
    multiply-by-reciprocal path on the card, which rounds differently
    from the reference's division."""
    return torch.tensor(x_scale, dtype=torch.float32, device=device)


class Int8PallasExecutor(Executor):
    """Int8 inference executor: symmetric quantization in, int8 x int8 ->
    int32 accumulation on the int8 tensor cores, fp32 requantization in
    the epilogue, all in one CUDA kernel (``kernels/int8_gemm.py``
    ``int8_conv``) on the card.

    The only executor declaring ``dtypes=("int8",)``: the quantize pass
    flips eligible conv specs to int8 and negotiation lands here.
    Weights get per-output-channel symmetric scales computed from the
    weight values, quantized once per filter (``_quantized_filter``);
    activations use the per-tensor calibrated scale riding in the plan's
    ``quant`` payload, else a dynamic ``max|x|/127``, both as a device
    tensor.  Epilogue order: dequantize the int32 accumulator through
    ``x_scale * w_scale[m]`` (the scale product first), then bias +
    residual + activation in fp32, then a fused pool (``ops.pool2d``,
    after the kernel).

    Tuning space: the reference's tiled-GEMM tiles over the im2col dims
    (N*OH*OW, M, KH*KW*C), ranked by its step model, so plans and cache
    entries read like the reference's.  On the card they size nothing:
    the kernel gives each block one output tile
    (``int8_gemm.launch_geometry``), and ``vmem_bytes`` is that
    geometry's shared memory, the same for every candidate.
    """
    name = "cuconv_int8"
    dtypes = ("int8",)
    accum = "int32"
    tunable = ("tp", "tm", "tc")
    kernels = ("int8_gemm",)
    config_sizes_launch = False
    #: filters whose codes the executor keeps
    FILTERS_KEPT = 64

    def __init__(self):
        # (w.data_ptr(), w._version, shape, strides, dtype, device) ->
        # (w, codes, scales).  The entry holds w itself, so its memory
        # (and address) cannot pass to another tensor while the entry
        # lives; an in-place update of w bumps its version and quantizes
        # again.
        self._filters = collections.OrderedDict()

    def _quantized_filter(self, w):
        """``(codes, scales)`` of an HWIO filter, quantized once: codes
        (M, KH, KW, C) int8, the layout ``int8_conv`` reads, bit-equal to
        ``quantize_to_int8(w, channel_scales(w))``; scales (M,) fp32."""
        from repro_torch.quant import symmetric
        key = None
        if not w.is_inference():        # inference tensors keep no version
            key = (w.data_ptr(), w._version, tuple(w.shape), w.stride(),
                   w.dtype, w.device)
            hit = self._filters.get(key)
            if hit is not None:
                self._filters.move_to_end(key)
                return hit[1], hit[2]
        wf = w.float()
        scales = symmetric.channel_scales(wf)
        codes = symmetric.quantize_to_int8(wf, scales).permute(
            3, 0, 1, 2).contiguous()
        if key is not None:
            self._filters[key] = (w, codes, scales)
            while len(self._filters) > self.FILTERS_KEPT:
                self._filters.popitem(last=False)
        return codes, scales

    def _supports(self, spec):
        return True, "int8 im2col GEMM, int32 accumulation"

    def heuristic_claim(self, spec, backend):
        if backend == "cuda":
            return 95, "int8: quantized GEMM kernel, int32 accumulation"
        return None

    def extra_hbm_bytes(self, spec):
        # the reference's model: the materialized int8 patch matrix (1
        # byte/elem), so negotiation ranks alike; the kernel gathers the
        # patches from the input instead
        n, oh, ow, _ = spec.out_shape
        kh, kw, c, _ = spec.filter_shape
        return float(n * oh * ow * kh * kw * c)

    def _gemm_dims(self, spec):
        n, oh, ow, m = spec.out_shape
        kh, kw, c, _ = spec.filter_shape
        return n * oh * ow, m, kh * kw * c

    def configs(self, spec):
        return _gemm_tile_configs(*self._gemm_dims(spec))

    def vmem_bytes(self, spec, config=None):
        from repro_torch.kernels.int8_gemm import launch_geometry
        p, m, k = self._gemm_dims(spec)
        return launch_geometry(p, k, m)["smem"]

    def config_cost(self, spec, config):
        return _gemm_tile_steps(*self._gemm_dims(spec), config)

    def execute(self, spec, x, w, bias=None, addend=None, config=None,
                quant=None):
        # full override: the base cast-to-spec-dtype would truncate float
        # operands to int8 — quantization IS the cast here
        from repro_torch.kernels import _build, ops
        from repro_torch.quant import symmetric
        if spec.fused_add != "none" and addend is None:
            raise ValueError(f"fused-add spec {spec.key()} needs an addend")
        x = x.float()
        if quant is not None and getattr(quant, "x_scale", 0) > 0:
            x_scale = _scale_on(quant.x_scale, x.device)
        else:
            x_scale = symmetric.scale_for(symmetric.abs_max(x))
        codes, w_scales = self._quantized_filter(w)
        # cached tensors: a graph captured here reads them on every replay
        _build.keep_for_graph(x_scale, codes, w_scales)
        relu = (spec.fused_add == "add_relu" if spec.fused_add != "none"
                else spec.wants_relu)
        cfg = LaunchConfig.of(config)
        # one kernel: quantize x on load, the int8 conv, then the fp32
        # requantization epilogue — the int32 accumulator times the outer
        # product of scales, THEN bias / residual / activation
        y = ops.int8_conv(
            x, codes, spec.stride, spec.padding, scale=x_scale,
            w_scales=w_scales,
            bias=bias.float() if spec.has_bias else None,
            addend=addend.float() if spec.fused_add != "none" else None,
            relu=relu, tp=cfg.get("tp", 256), tm=cfg.get("tm", 128),
            tc=cfg.get("tc", 512))
        if spec.fused_pool:
            kind, pkh, pkw, psh, psw, pph, ppw = spec.fused_pool
            y = ops.pool2d(y, kind=kind, window=(pkh, pkw),
                           stride=(psh, psw), padding=(pph, ppw))
        return y

    def _execute(self, spec, x, w, bias, config=None):
        # bare int8 conv of codes (zero padding is exact under symmetric
        # quantization) -> the int32 accumulator, patches gathered by the
        # kernel
        from repro_torch.kernels import ops
        cfg = LaunchConfig.of(config)
        return ops.int8_conv(x, w.permute(3, 0, 1, 2), spec.stride,
                             spec.padding, tp=cfg.get("tp", 256),
                             tm=cfg.get("tm", 128), tc=cfg.get("tc", 512))


def _register_builtins() -> None:
    # registration order is the JAX package's; iteration order decides
    # ties in negotiation
    from repro_torch.core import cuconv
    for ex, fn in (
            (LaxExecutor(), cuconv.conv_lax),
            (Im2colExecutor(), cuconv.conv_im2col),
            (WinogradExecutor(), cuconv.conv_winograd_or_fallback),
            (TwoStageExecutor(), cuconv.conv_cuconv_two_stage),
            (Conv1x1PallasExecutor(), cuconv.conv_conv1x1_pallas),
            (TwoStagePallasExecutor(), cuconv.conv_cuconv_two_stage_pallas),
            (CuconvExecutor(), cuconv.conv_cuconv),
            (FusedPallasExecutor(), cuconv.conv_cuconv_pallas),
            (WinogradPallasExecutor(), cuconv.conv_winograd_pallas),
            (DirectConvExecutor(), cuconv.conv_direct)):
        ex.fn = fn
        register(ex)
    # no bare-fn surface: the quantize/dequantize epilogue only makes
    # sense through ConvPlan
    register(Int8PallasExecutor())


_register_builtins()
