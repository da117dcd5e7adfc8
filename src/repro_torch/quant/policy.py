"""QuantPolicy + the int8 graph rewrite pass.

``QuantPolicy`` extends the graph-wide ``PrecisionPolicy``: its
``default`` is the fp fallback dtype every non-quantized node plans in,
plus the quantization choices — which observer derives activation
scales, which nodes opt out, whether the first/last conv stay fp.  The
policy holds choices, never data: calibrated ranges live in
``calibration.json`` and weight scales are computed per channel from the
weights at execution time, so the policy stays frozen and hashable.

``quantize_graph`` is the planning-time rewrite (same shape as
``fuse_graph``): it runs on the pre-fusion IR and flips eligible conv
nodes' ``ConvSpec.dtype`` to int8.  A node quantizes only when every gate
passes — not opted out, not first/last under the fallback rule, fresh
calibration present, and a registered executor supporting the int8 spec.
Every decision is recorded as a ``NodeQuant`` for ``explain()``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.graph import ConvOp, Graph, PrecisionPolicy
from repro_torch.quant import calibrate, symmetric


@dataclasses.dataclass(frozen=True)
class QuantInfo:
    """Per-node execution payload: the calibrated per-tensor activation
    scale the int8 executor quantizes inputs with."""
    x_scale: float
    source: str                  # calib:absmax | calib:pct99.9 | dynamic

    def key(self) -> str:
        return f"{self.source}:{self.x_scale:.6g}"


@dataclasses.dataclass(frozen=True)
class NodeQuant:
    """Per-node quantization provenance for ``explain()``/reporting."""
    dtype: str                   # int8 | the fp dtype the node kept
    source: str                  # scale source, or the fp-fallback reason
    x_scale: Optional[float] = None

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    def label(self) -> str:
        return (f"int8<-{self.source}" if self.quantized
                else self.source)


@dataclasses.dataclass(frozen=True)
class QuantPolicy(PrecisionPolicy):
    """Int8 inference policy: fp fallback dtype + quantization choices.

    ``QuantPolicy()`` quantizes every eligible conv node to int8 with fp32
    fallback; ``QuantPolicy("bf16")`` falls back to bf16.  ``skip`` opts
    named conv nodes out; ``skip_first_last`` (default True) keeps the
    first and last conv in fp.  ``observer`` picks which calibrated
    statistic activation scales derive from (``"absmax"`` |
    ``"percentile"``).
    """
    quant_dtype: str = "int8"
    skip: Tuple[str, ...] = ()
    skip_first_last: bool = True
    observer: str = "absmax"
    percentile: float = 99.9

    def __post_init__(self):
        super().__post_init__()
        if self.quant_dtype != "int8":
            raise ValueError(
                f"only int8 quantization is supported; got "
                f"{self.quant_dtype!r}")
        if self.observer not in calibrate.Calibrator.OBSERVERS:
            raise ValueError(
                f"observer must be one of {calibrate.Calibrator.OBSERVERS};"
                f" got {self.observer!r}")
        object.__setattr__(self, "skip",
                           tuple(sorted(str(s) for s in self.skip)))
        object.__setattr__(self, "percentile", float(self.percentile))

    def quantizer(self) -> "QuantPolicy":
        """Quant policies quantize (plain precision policies return
        None): the hook ``plan_graph`` keys off."""
        return self

    def key(self) -> str:
        base = super().key()
        skip = ",".join(self.skip)
        return (f"{base}+{self.quant_dtype}[obs={self.observer}"
                f"@{self.percentile:g},fl={int(self.skip_first_last)}"
                f"{',skip=' + skip if skip else ''}]")

    def skips(self, name: str, first: Optional[str], last: Optional[str]
              ) -> Optional[str]:
        """The fp-fallback reason for this node, or None (eligible)."""
        if name in self.skip:
            return "fp:skip"
        if self.skip_first_last and name == first:
            return "fp:first"
        if self.skip_first_last and name == last:
            return "fp:last"
        return None


def quantize_graph(ir: Graph, policy: QuantPolicy,
                   backend: Optional[str] = None
                   ) -> Tuple[Graph, Dict[str, NodeQuant]]:
    """Rewrite eligible conv nodes to int8 specs (planning-time pass).

    Runs on the PRE-fusion IR (calibration entries are keyed by it).
    Returns ``(graph, provenance)``: provenance covers every conv node
    (quantized with its scale, or why it stayed fp); ``plan_graph``
    attaches the quantized nodes' scales to their ConvPlans.  The input
    graph object comes back unchanged when nothing quantizes.
    """
    from repro_torch.core import executors
    convs = [n for n in ir.nodes if isinstance(n, ConvOp)]
    first = convs[0].name if convs else None
    last = convs[-1].name if convs else None
    nodes = list(ir.nodes)
    prov: Dict[str, NodeQuant] = {}
    changed = False
    for i, node in enumerate(nodes):
        if not isinstance(node, ConvOp):
            continue
        name, spec = node.name, node.spec
        reason = policy.skips(name, first, last)
        if reason is not None:
            prov[name] = NodeQuant(spec.dtype, reason)
            continue
        entry = calibrate.calibration_entry(ir, name)
        if entry is None:
            prov[name] = NodeQuant(spec.dtype, "fp:no-calibration")
            continue
        if entry.get("spec") != calibrate.normalized_spec(spec):
            # the node changed under a colliding name since calibration:
            # a scale for a different tensor must never serve
            prov[name] = NodeQuant(spec.dtype, "fp:stale-calibration")
            continue
        qspec = dataclasses.replace(spec, dtype="int8")
        if not executors.supporting(qspec):
            prov[name] = NodeQuant(spec.dtype, "fp:unsupported")
            continue
        amax, source = calibrate.scale_source(entry, policy.observer,
                                              policy.percentile)
        x_scale = float(symmetric.scale_for(amax))
        nodes[i] = ConvOp(name, node.inputs, qspec)
        prov[name] = NodeQuant("int8", source, x_scale)
        changed = True
    if not changed:
        return ir, prov
    return Graph(tuple(nodes), ir.in_shape, ir.input_name, ir.output), prov
