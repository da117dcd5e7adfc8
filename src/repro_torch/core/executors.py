"""Executor registry: the open menu of convolution algorithms.

Every algorithm is a registered ``Executor`` declaring:

  name             stable string identity — what ``ConvPlan.algorithm``,
                   ``conv2d(algorithm=...)`` and the persisted
                   autotune/graphplans entries resolve through.  The
                   names are the JAX package's: ``cuconv_pallas``,
                   ``conv1x1_pallas`` and ``cuconv_two_stage_pallas``
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

import dataclasses
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
    def execute(self, spec, x, w, bias=None, addend=None, config=None):
        """Run ``spec`` on ``(x, w, bias[, addend])``, epilogue included.

        Operands are cast to the spec dtype first (master weights stay
        fp32).  Non-fusing executors apply the bias/ReLU epilogue and any
        cross-layer fusion after the bare conv; ``fuses_epilogue``
        executors absorb everything in-kernel.
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


def _gemm_tile_smem(config: LaunchConfig, c: int) -> int:
    """Shared memory of the CUDA tile GEMM under ``config``."""
    from repro_torch.kernels.conv1x1 import smem_bytes
    return smem_bytes(min(config.get("tc", 512), c))


def _gemm_tile_steps(p: int, m: int, c: int, config: LaunchConfig) -> float:
    """Block-step count of the tiled GEMM under ``config`` (the ranking
    ``config_cost`` minimizes)."""
    tp = min(config.get("tp", 256), p)
    tm = min(config.get("tm", 128), m)
    tc = min(config.get("tc", 512), c)
    return (-(-p // tp)) * (-(-m // tm)) * (-(-c // tc))


class Conv1x1PallasExecutor(Executor):
    """The 1x1 GEMM CUDA kernel (``kernels/conv1x1.py``; the registry
    name is the JAX package's): all N*H*W pixels in one tiled GEMM —
    the paper's best-case region on its natural kernel."""
    name = "conv1x1_pallas"
    tunable = ("tp", "tm", "tc")

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
        return _gemm_tile_smem(LaunchConfig.of(config), spec.in_shape[3])

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
    the fused kernel's declared fallback."""
    name = "cuconv_two_stage_pallas"
    tunable = ("tp", "tm", "tc")

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
        return _gemm_tile_smem(LaunchConfig.of(config), spec.filter_shape[2])

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
    name is the JAX package's): any stride >= 1, the tap and channel
    loops inside one block, bias / residual-add / ReLU / pool fused
    before the single write.

    Tuning space: ``tm`` (output-channel tile) x ``rows`` (output rows
    per block).  The JAX package's multi-row halo rule (``KH - 1 <=
    rows*sh`` for ``rows >= 2``) is a TPU staging artefact the CUDA
    kernel does not need; it is kept in ``config_supports`` so plans and
    cache entries read alike across the two packages.
    """
    name = "cuconv_pallas"
    fuses_epilogue = True
    tunable = ("tm", "rows")

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

    def vmem_bytes(self, spec, config=None):
        from repro_torch.kernels.cuconv_fused import smem_bytes
        cfg = LaunchConfig.of(config)
        return smem_bytes(spec.in_shape, spec.filter_shape,
                          tm=cfg.get("tm", 128), rows=cfg.get("rows", 1),
                          pad=spec.padding, stride=spec.stride,
                          pool=(self._pool3(spec) if spec.fused_pool
                                else None))

    def _supports(self, spec):
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


def _register_builtins() -> None:
    # registration order is the JAX package's (winograd, winograd_pallas,
    # direct and cuconv_int8 are not ported yet); iteration order decides
    # ties in negotiation
    from repro_torch.core import cuconv
    for ex, fn in (
            (LaxExecutor(), cuconv.conv_lax),
            (Im2colExecutor(), cuconv.conv_im2col),
            (TwoStageExecutor(), cuconv.conv_cuconv_two_stage),
            (Conv1x1PallasExecutor(), cuconv.conv_conv1x1_pallas),
            (TwoStagePallasExecutor(), cuconv.conv_cuconv_two_stage_pallas),
            (CuconvExecutor(), cuconv.conv_cuconv),
            (FusedPallasExecutor(), cuconv.conv_cuconv_pallas)):
        ex.fn = fn
        register(ex)


_register_builtins()
