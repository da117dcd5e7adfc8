"""Quantization accuracy harness: bounded output error vs fp32.

  * ``accuracy_report`` / ``assert_accuracy`` — whole network: run the
    QuantPolicy-planned graph and the fp32 graph of the same model on the
    same inputs and compare final outputs.
  * ``spec_accuracy`` — per layer: one int8 ConvSpec against its fp32
    twin on random operands.

The documented bound (``DEFAULT_BOUND``, relative to the fp32 output's
abs max) covers symmetric per-tensor activation + per-channel weight
quantization on calibrated data: each int8 grid contributes at most
``amax/254`` per element, and the fp32 requantization epilogue adds no
further error.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: documented relative-error bound (vs the fp32 output's abs max) for
#: calibrated int8 inference
DEFAULT_BOUND = 0.05


def _rel_err(y_q, y_fp) -> dict:
    y_q = y_q.detach().float().cpu().numpy()
    y_fp = y_fp.detach().float().cpu().numpy()
    ref = float(np.abs(y_fp).max())
    abs_err = float(np.abs(y_q - y_fp).max())
    return {"abs_err": abs_err, "ref_absmax": ref,
            "rel_err": abs_err / (ref + 1e-12)}


def accuracy_report(model, params, x, policy=None,
                    backend: Optional[str] = None) -> dict:
    """Quantized-vs-fp32 output error for one model + input batch, on
    the device of ``params``.  ``policy`` defaults to ``QuantPolicy()``.
    Returns the error stats plus per-node quant provenance."""
    from repro_torch.core.graph import PrecisionPolicy
    from repro_torch.quant.calibrate import input_tensor
    from repro_torch.quant.policy import QuantPolicy
    policy = policy if policy is not None else QuantPolicy()
    x = input_tensor(x, params)
    gp_fp = model.graph_plan(x.shape, backend=backend,
                             precision=PrecisionPolicy("float32"))
    gp_q = model.graph_plan(x.shape, backend=backend, precision=policy)
    rep = _rel_err(gp_q.run(x, params), gp_fp.run(x, params))
    rep["quantized_nodes"] = sorted(
        n for n, q in gp_q.quant.items() if q.quantized)
    rep["fp_nodes"] = {n: q.source for n, q in gp_q.quant.items()
                       if not q.quantized}
    rep["bound"] = DEFAULT_BOUND
    return rep


def assert_accuracy(model, params, x, policy=None,
                    bound: float = DEFAULT_BOUND,
                    backend: Optional[str] = None) -> dict:
    """``accuracy_report`` that raises when the bound is exceeded;
    returns the report."""
    rep = accuracy_report(model, params, x, policy=policy, backend=backend)
    if rep["rel_err"] > bound:
        raise AssertionError(
            f"int8 output error {rep['rel_err']:.4f} exceeds the "
            f"documented bound {bound} (abs {rep['abs_err']:.4f} vs "
            f"fp32 absmax {rep['ref_absmax']:.4f}; quantized nodes: "
            f"{rep['quantized_nodes']})")
    return rep


def spec_accuracy(spec, seed: int = 0, device=None) -> dict:
    """Per-layer int8-vs-fp32 error for one ConvSpec on random operands
    (unit-normal activations, 0.1-std weights), on ``device`` (default:
    the card).  ``spec`` may be fp or int8; both variants derive from it.
    """
    import dataclasses
    from repro_torch.core import convspec as cs
    dev = cs.resolve_device(device)
    rng = np.random.default_rng(seed)
    fp = dataclasses.replace(spec, dtype="float32")
    q8 = dataclasses.replace(spec, dtype="int8")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    x = t(rng.standard_normal(fp.in_shape))
    w = t(rng.standard_normal(fp.filter_shape) * 0.1)
    b = (t(rng.standard_normal((fp.filter_shape[3],)) * 0.1)
         if fp.has_bias else None)
    a = t(rng.standard_normal(fp.out_shape)) if fp.fused_add != "none" \
        else None
    backend = cs.backend_for(dev)
    y_fp = cs.plan(fp, backend=backend)(x, w, b, a)
    y_q = cs.plan(q8, backend=backend)(x, w, b, a)
    return _rel_err(y_q, y_fp)
