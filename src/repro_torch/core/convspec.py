"""ConvSpec plan layer: one descriptor-driven entry point for all convs.

  ConvSpec   frozen descriptor of one convolution: shapes, stride,
             padding, dtype, epilogue, groups, cross-layer fusions.
             Hashable; ``key()`` is the key of every cache and gives the
             same string as the JAX package's ``ConvSpec.key()``.
  plan()     the ONLY place algorithm choice lives: capability
             negotiation over the executor registry
             (``core/executors.py``) — a forced executor (capability-
             guarded), the persisted measured-autotune cache, the
             executors' heuristic region claims, then the cheapest
             supported executor by cost model.
  ConvPlan   executable result: call it with (x, w, bias[, addend]);
             ``explain()`` returns a one-line story of the choice.

Plans are device-independent: ``backend`` only decides which region
claims are made (``"cuda"`` is the card), and a plan made for the card
runs the kernels' plain versions when handed CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

Pad = Union[int, Tuple[int, int], str]

EPILOGUES = ("none", "bias", "relu", "bias_relu")

# canonical short spellings for ConvSpec.dtype / PrecisionPolicy inputs
_DTYPE_ALIASES = {"fp32": "float32", "f32": "float32",
                  "bf16": "bfloat16", "bfloat16": "bfloat16",
                  "float32": "float32", "i8": "int8", "int8": "int8"}

#: canonical dtype string -> torch dtype
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "float64": torch.float64}


def canonical_dtype(dtype) -> str:
    """One canonical dtype string ('float32', 'bfloat16', ...) for any
    accepted spelling ('bf16', torch.bfloat16, np.dtype('float32'), ...)."""
    s = str(dtype)
    if s.startswith("torch."):
        s = s[len("torch."):]
    alias = _DTYPE_ALIASES.get(s)
    if alias is not None:
        return alias
    try:
        return str(np.dtype(s).name)
    except TypeError as e:
        raise ValueError(f"unknown dtype {dtype!r}") from e


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of any accepted dtype spelling."""
    return TORCH_DTYPES[canonical_dtype(dtype)]


def default_backend() -> str:
    """The planner's backend when the caller names none: always
    ``"cuda"``.  Plans are device-independent, so this does not look
    for a card; running a plan on the card is what needs one."""
    return "cuda"


def backend_for(device) -> str:
    """The planner's backend for a device: ``"cuda"`` on the card."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Asking for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card by default, and CUDA is not "
            "available here; pass device='cpu' to run the plain versions")
    return dev


def normalize_pad(padding: Pad, kh: int, kw: int) -> Tuple[int, int]:
    """Canonical (ph, pw) for any accepted padding form.

    Rejects negative amounts and wrong-length tuples instead of silently
    truncating or wrapping them.
    """
    if padding == "same":
        return (kh - 1) // 2, (kw - 1) // 2
    if padding == "valid":
        return 0, 0
    if isinstance(padding, int):
        pad = (padding, padding)
    else:
        pad = tuple(padding)
    if len(pad) != 2:
        raise ValueError(f"padding must be 'same', 'valid', an int, or a "
                         f"(ph, pw) pair; got {padding!r}")
    ph, pw = pad
    if ph < 0 or pw < 0:
        raise ValueError(f"padding must be non-negative; got {padding!r}")
    return ph, pw


def normalize_stride(stride) -> Tuple[int, int]:
    """Canonical (sh, sw) stride pair."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if len(s) != 2:
        raise ValueError(f"stride must be an int or an (sh, sw) pair; "
                         f"got {stride!r}")
    if s[0] < 1 or s[1] < 1:
        raise ValueError(f"stride must be >= 1; got {stride!r}")
    return s


def out_size(size: int, k: int, p: int, s: int) -> int:
    """Output extent of one spatial axis: (size + 2p - k) // s + 1."""
    return (size + 2 * p - k) // s + 1


# cross-layer fusions a ConvSpec can carry in its epilogue
FUSED_ADDS = ("none", "add", "add_relu")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Descriptor of one convolution: the planner's (and caches') key.

    ``fused_add``/``fused_pool`` describe cross-layer epilogue fusions
    the graph-level fusion pass (``core/graph.py``) folds into a conv
    node: a residual-add second operand (with optional post-add ReLU),
    or a trailing max/avg pool consuming the conv output before it is
    written.  Both ride ``key()`` and are capability-negotiated.
    """
    in_shape: Tuple[int, int, int, int]       # (N, H, W, C) NHWC
    filter_shape: Tuple[int, int, int, int]   # (KH, KW, C/groups, M) HWIO
    stride: Tuple[int, int] = (1, 1)          # (sh, sw)
    padding: Tuple[int, int] = (0, 0)         # (ph, pw), pre-normalized
    dtype: str = "float32"
    epilogue: str = "none"                    # none | bias | relu | bias_relu
    groups: int = 1                           # feature groups (depthwise: C)
    #: residual-add fusion: a second operand (shape == out_shape) added
    #: after the bias, with 'add_relu' applying ReLU after the sum
    fused_add: str = "none"                   # none | add | add_relu
    #: pool fusion: (kind, kh, kw, sh, sw, ph, pw) applied to the conv
    #: output (post-epilogue), or () for no pool
    fused_pool: Tuple = ()

    def __post_init__(self):
        if self.epilogue not in EPILOGUES:
            raise ValueError(f"epilogue {self.epilogue!r} not in {EPILOGUES}")
        if self.fused_add not in FUSED_ADDS:
            raise ValueError(f"fused_add {self.fused_add!r} not in "
                             f"{FUSED_ADDS}")
        if self.fused_add != "none":
            if self.wants_relu:
                raise ValueError(
                    f"fused_add {self.fused_add!r} needs epilogue 'none' or "
                    f"'bias' (the activation moves AFTER the add); got "
                    f"epilogue {self.epilogue!r}")
            if self.fused_pool:
                raise ValueError("a spec carries at most one cross-layer "
                                 "fusion: fused_add and fused_pool are "
                                 "mutually exclusive")
        if self.fused_pool:
            fp = tuple(self.fused_pool)
            if len(fp) != 7 or fp[0] not in ("max", "avg"):
                raise ValueError(
                    f"fused_pool must be (kind, kh, kw, sh, sw, ph, pw) "
                    f"with kind 'max'|'avg'; got {self.fused_pool!r}")
            kind, pkh, pkw, psh, psw, pph, ppw = fp
            if min(pkh, pkw, psh, psw) < 1 or min(pph, ppw) < 0:
                raise ValueError(f"fused_pool geometry must be positive "
                                 f"windows/strides and non-negative "
                                 f"padding; got {self.fused_pool!r}")
            object.__setattr__(self, "fused_pool",
                               (str(kind),) + tuple(map(int, fp[1:])))
        if not isinstance(self.groups, int) or self.groups < 1:
            raise ValueError(f"groups must be a positive int; "
                             f"got {self.groups!r}")
        object.__setattr__(self, "in_shape", tuple(map(int, self.in_shape)))
        object.__setattr__(self, "filter_shape",
                           tuple(map(int, self.filter_shape)))
        if self.in_shape[3] != self.filter_shape[2] * self.groups:
            raise ValueError(
                f"channel mismatch: input {self.in_shape} needs filter "
                f"depth {self.in_shape[3]} / groups={self.groups}; "
                f"filter {self.filter_shape}")
        if self.filter_shape[3] % self.groups:
            raise ValueError(f"output channels {self.filter_shape[3]} not "
                             f"divisible by groups={self.groups}")
        if len(self.stride) != 2 or any(s < 1 for s in self.stride):
            raise ValueError(f"stride must be an (sh, sw) pair >= 1; "
                             f"got {self.stride!r}")
        if len(self.padding) != 2 or any(p < 0 for p in self.padding):
            raise ValueError(f"padding must be a non-negative (ph, pw) "
                             f"pair; got {self.padding!r}")
        object.__setattr__(self, "stride", tuple(map(int, self.stride)))
        object.__setattr__(self, "padding", tuple(map(int, self.padding)))
        # canonicalize dtype so 'bf16' and 'bfloat16' share cache keys
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))
        if any(d <= 0 for d in self.out_shape):
            raise ValueError(f"spec produces non-positive output shape "
                             f"{self.out_shape}: input {self.in_shape}, "
                             f"filter {self.filter_shape}, stride "
                             f"{self.stride}, padding {self.padding}")

    @classmethod
    def for_conv(cls, x, w, stride=1, padding: Pad = "same",
                 bias=None, activation: Optional[str] = None,
                 groups: int = 1) -> "ConvSpec":
        """Build a spec from operands + call options.

        Unknown activations are an error, not a silent epilogue "none".
        """
        if activation not in (None, "none", "relu"):
            raise ValueError(
                f"activation {activation!r} not supported; the planner "
                f"fuses None or 'relu' (epilogues: {EPILOGUES})")
        relu = activation == "relu"
        kh, kw = int(w.shape[0]), int(w.shape[1])
        epi = ("bias_relu" if bias is not None and relu
               else "bias" if bias is not None
               else "relu" if relu else "none")
        return cls(tuple(map(int, x.shape)), tuple(map(int, w.shape)),
                   normalize_stride(stride), normalize_pad(padding, kh, kw),
                   canonical_dtype(x.dtype), epi, int(groups))

    # -- derived geometry ------------------------------------------------
    @property
    def out_shape(self) -> Tuple[int, int, int, int]:
        n, h, w, _ = self.in_shape
        kh, kw, _, m = self.filter_shape
        (sh, sw), (ph, pw) = self.stride, self.padding
        return (n, out_size(h, kh, ph, sh), out_size(w, kw, pw, sw), m)

    @property
    def is_1x1(self) -> bool:
        return self.filter_shape[0] == 1 and self.filter_shape[1] == 1

    @property
    def unit_stride(self) -> bool:
        return self.stride == (1, 1)

    @property
    def has_bias(self) -> bool:
        return self.epilogue in ("bias", "bias_relu")

    @property
    def wants_relu(self) -> bool:
        return self.epilogue in ("relu", "bias_relu")

    @property
    def has_fusion(self) -> bool:
        """Does this spec carry a cross-layer fusion (add or pool)?"""
        return self.fused_add != "none" or bool(self.fused_pool)

    @property
    def final_shape(self) -> Tuple[int, int, int, int]:
        """``out_shape`` for plain/fused-add specs, the pooled shape for
        fused-pool specs."""
        if not self.fused_pool:
            return self.out_shape
        _, pkh, pkw, psh, psw, pph, ppw = self.fused_pool
        n, oh, ow, m = self.out_shape
        return (n, out_size(oh, pkh, pph, psh),
                out_size(ow, pkw, ppw, psw), m)

    def unfused(self) -> "ConvSpec":
        """This spec with cross-layer fusions stripped."""
        if not self.has_fusion:
            return self
        return dataclasses.replace(self, fused_add="none", fused_pool=())

    def key(self) -> str:
        """Stable string key for persisted caches (the same string as the
        JAX package's key for the same spec)."""
        n, h, w, c = self.in_shape
        kh, kw, _, m = self.filter_shape
        g = f"-g{self.groups}" if self.groups != 1 else ""
        fused = ""
        if self.fused_add != "none":
            fused = "-fadd" if self.fused_add == "add" else "-faddrelu"
        elif self.fused_pool:
            kind, pkh, pkw, psh, psw, pph, ppw = self.fused_pool
            fused = (f"-fpool{kind}{pkh}x{pkw}s{psh}x{psw}p{pph}x{ppw}")
        return (f"n{n}h{h}w{w}c{c}-k{kh}x{kw}m{m}-s{self.stride[0]}x"
                f"{self.stride[1]}-p{self.padding[0]}x{self.padding[1]}-"
                f"{self.dtype}-{self.epilogue}{g}{fused}")


# ---------------------------------------------------------------------------
# plan

# Observable resolution count: every plan() call increments it, and
# NOTHING else does (the graph layer's plan-once contract).
PLAN_STATS = {"resolutions": 0}


def supports(algorithm: str, spec: ConvSpec) -> Tuple[bool, str]:
    """Can ``algorithm`` execute ``spec`` exactly (ignoring speed)?  A
    delegation to ``executors.get(algorithm).supports(spec)``."""
    from repro_torch.core import executors
    return executors.get(algorithm).supports(spec)


def heuristic_algorithm(spec: ConvSpec, backend: str) -> Tuple[str, str]:
    """The negotiated choice absent force or measurement, and why: a
    delegation to ``executors.negotiate``."""
    from repro_torch.core import executors
    name, _source, reason = executors.negotiate(spec, backend)
    return name, reason


def reset_plan_stats() -> int:
    """Zero the resolution counter; returns the count discarded."""
    old = PLAN_STATS["resolutions"]
    PLAN_STATS["resolutions"] = 0
    return old


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Executable ``(algorithm, launch config)`` choice for one ConvSpec."""
    spec: ConvSpec
    algorithm: str
    source: str          # heuristic | cost | measured | forced | fallback
    reason: str
    backend: str = "cpu"
    #: resolved launch config (executors.LaunchConfig; empty for
    #: untunable executors) and its provenance
    config: Optional[object] = None
    config_source: str = "default"    # default | measured | forced
    #: quantization payload (quant.policy.QuantInfo) for int8 specs: the
    #: calibrated per-tensor activation scale + its provenance.  None on
    #: fp plans and on int8 plans resolved outside the quantize pass (the
    #: executor then takes a dynamic scale)
    quant: Optional[object] = None

    @property
    def executor(self):
        """The registry entry this plan resolves to."""
        from repro_torch.core import executors
        return executors.get(self.algorithm)

    def explain(self) -> str:
        ex = self.executor
        cfg = (f" cfg[{self.config_source}]={self.config.key()}"
               if self.config else "")
        q = f" quant[{self.quant.key()}]" if self.quant else ""
        return (f"{self.spec.key()} -> {self.algorithm} "
                f"[{self.source}]{cfg}{q} dtype={self.spec.dtype} "
                f"accum={ex.accum} {self.reason}")

    def __call__(self, x, w, bias=None, addend=None):
        spec = self.spec
        if spec.has_bias and bias is None:
            raise ValueError(f"plan epilogue {spec.epilogue!r} needs a bias")
        if spec.fused_add != "none" and addend is None:
            raise ValueError(f"plan for fused-add spec {spec.key()} needs "
                             f"an addend (the residual operand)")
        if spec.fused_add == "none" and addend is not None:
            raise ValueError(f"plan for spec {spec.key()} does not take an "
                             f"addend (fused_add='none')")
        kwargs = {}
        if self.quant is not None:
            # only the int8 executor receives the payload: the quantize
            # pass attaches it only to plans of int8 specs
            kwargs["quant"] = self.quant
        return self.executor.execute(
            spec, x, w, bias=bias if spec.has_bias else None,
            addend=addend, config=self.config, **kwargs)


def resolve_config(spec: ConvSpec, algorithm: str,
                   backend: str) -> Tuple[object, str]:
    """``(launch config, provenance)`` for an already-chosen algorithm:
    the persisted measured config while it is still valid for this spec,
    else the executor's model-chosen ``default_config``."""
    from repro_torch.core import autotune, executors
    ex = executors.get(algorithm)
    cached = autotune.cached_config(spec, backend, algorithm)
    if cached is not None and ex.config_supports(spec, cached)[0]:
        return cached, "measured"
    return ex.default_config(spec), "default"


def _with_config(spec, algorithm, source, reason, backend,
                 config) -> ConvPlan:
    """Attach the resolved (or caller-forced) launch config to a plan."""
    from repro_torch.core import executors
    if config is not None:
        cfg = executors.LaunchConfig.of(config)
        ok, why = executors.get(algorithm).config_supports(spec, cfg)
        if not ok:
            raise ValueError(
                f"forced launch config {cfg.as_dict()} is not supported "
                f"by executor {algorithm!r} for spec {spec.key()}: {why}")
        return ConvPlan(spec, algorithm, source, reason, backend, cfg,
                        "forced")
    cfg, cfg_src = resolve_config(spec, algorithm, backend)
    return ConvPlan(spec, algorithm, source, reason, backend, cfg, cfg_src)


def plan(spec: ConvSpec, force: Optional[str] = None,
         backend: Optional[str] = None,
         tune: Optional[str] = None,
         config=None, device=None) -> ConvPlan:
    """All conv algorithm choice, in one place, resolving an
    ``(algorithm, launch config)`` pair.

    Algorithm order: forced executor (capability-guarded; an unsupported
    forced choice takes the executor's declared fallback, except grouped
    specs, which raise) > persisted measured-autotune winner > the
    executors' heuristic region claims > cheapest supported executor.
    ``config`` forces a launch config, validated against the executor's
    ``config_supports`` (an infeasible one raises, naming executor,
    config and spec).

    ``tune`` runs the measured sweep on ``device`` first (default: the
    card; ``backend`` defaults to the device's, and must be it):
    ``"algo"`` times every capable executor — with ``force`` the sweep
    still runs and records the unforced winner, the pin only decides
    what this plan serves; ``"full"`` also settles a fused spec against
    its unfused form and races the launch configs of the forced
    executor, or of the winner.  The winners persist, so the plan
    returned already serves them and every later ``plan()`` replays them
    with zero measurement.
    """
    PLAN_STATS["resolutions"] += 1
    if backend is None:
        backend = default_backend() if device is None \
            else backend_for(device)
    from repro_torch.core import autotune, executors

    if tune not in (None, "algo", "full"):
        raise ValueError(f'tune must be None, "algo" or "full"; '
                         f'got {tune!r}')
    if tune is not None:
        autotune.tune_spec(spec, tune=tune, backend=backend,
                           algorithm=force, device=device)

    if force is not None:
        ex = executors.get(force)      # KeyError names the registry
        ok, why = ex.supports(spec)
        if ok:
            return _with_config(spec, force, "forced", why, backend, config)
        if spec.groups != 1 and not ex.supports_groups:
            raise ValueError(
                f"forced algorithm {force!r} cannot execute grouped spec "
                f"{spec.key()} (groups={spec.groups}): {why}.  Force an "
                f"executor that declares grouped support (e.g. 'lax') or "
                f"let plan() negotiate.")
        fb, fb_why = ex.fallback(spec)
        fb_ok, fb_refusal = executors.get(fb).supports(spec)
        if not fb_ok:
            raise ValueError(
                f"forced algorithm {force!r} cannot execute {spec.key()} "
                f"({why}), and its declared fallback {fb!r} cannot either "
                f"({fb_refusal})")
        return _with_config(spec, fb, "fallback",
                            f"{force} unsupported ({why}); {fb_why}",
                            backend, config)

    measured = autotune.cached_best(spec, backend)
    if measured is not None and executors.capable(measured, spec):
        return _with_config(spec, measured, "measured",
                            "persisted autotune winner", backend, config)

    algo, source, reason = executors.negotiate(spec, backend)
    return _with_config(spec, algo, source, reason, backend, config)
