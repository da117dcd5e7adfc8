"""Int8 quantized inference: calibration, ``QuantPolicy`` and the
quantize pass, and the accuracy harness.

Calibration observers collect per-node activation ranges during
``GraphPlan.warmup(calibrate=...)``; ``QuantPolicy`` decides which conv
nodes quantize (per-channel symmetric weight scales, per-tensor
activation scales from calibration, first/last-layer fp fallback); the
``cuconv_int8`` executor runs the int8 x int8 -> int32 GEMM kernel with
fp32 requantization in the epilogue.

Attribute access is lazy (PEP 562) so ``quant.symmetric`` imports
without pulling in the graph/executor stack.
"""
from __future__ import annotations

_EXPORTS = {
    "CALIB_SCHEMA": "calibrate", "Calibrator": "calibrate",
    "calibration_entry": "calibrate", "clear_cache": "calibrate",
    "graph_key": "calibrate",
    "NodeQuant": "policy", "QuantInfo": "policy",
    "QuantPolicy": "policy", "quantize_graph": "policy",
    "accuracy_report": "accuracy", "assert_accuracy": "accuracy",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.quant' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.quant.{mod}"), name)
