"""The int8 executor's one-launch path against the JAX package, on the CPU.

``cuconv_int8`` quantizes each filter once (codes in the (M, KH, KW, C)
layout the int8 kernel reads) and runs quantize-on-load, the int8 conv
and the fp32 epilogue through ``ops.int8_conv``; on CPU tensors that is
the plain composition.  The same seeded numpy inputs go through both
packages (the reference's Pallas GEMM in interpret mode): the weight and
activation codes and the int32 accumulators are bit-equal, and the
outputs agree within 1e-6 of their abs max.  The weight cache quantizes
a filter once and again after an in-place update; the wrappers refuse a
contraction long enough to overflow int32.  The geometry at the served
shapes is held in ``tests/test_torch_tensor_cores.py``; the kernel
itself in ``tests/test_torch_cuda.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, np32, rand  # noqa: F401
from repro.core import convspec as rcs
from repro.core import executors as rex
from repro.quant import symmetric as rsym
from repro_torch.core import convspec as tcs
from repro_torch.core import executors
from repro_torch.kernels import int8_gemm
from repro_torch.quant import symmetric

# epilogue name -> (spec epilogue, fused_add)
EPILOGUES = {"bias": ("bias", "none"), "bias_relu": ("bias_relu", "none"),
             "add_relu": ("bias", "add_relu")}
# (C, stride, padding, epilogue): every C at both strides and paddings,
# the three epilogues in turn; "same" is a 3x3 filter's pad of 1
CASES = [(c, s, pad, list(EPILOGUES)[i % 3])
         for i, (c, s, pad) in enumerate(
             (c, s, pad) for c in (4, 6, 16, 32) for s in (1, 2)
             for pad in ("same", "valid"))]


def _specs(C, s, pad, epi, M=8):
    epilogue, fused_add = EPILOGUES[epi]
    p = 1 if pad == "same" else 0
    args = ((2, 9, 9, C), (3, 3, C, M), (s, s), (p, p), "int8", epilogue)
    return (tcs.ConvSpec(*args, fused_add=fused_add),
            rcs.ConvSpec(*args, fused_add=fused_add))


@pytest.mark.parametrize("C,s,pad,epi", CASES)
def test_int8_executor_matches_reference(C, s, pad, epi):
    rng = np.random.default_rng(C * 10 + s)
    tspec, rspec = _specs(C, s, pad, epi)
    M = tspec.filter_shape[3]
    x = rand(rng, tspec.in_shape)
    w = (rng.normal(size=tspec.filter_shape) * 0.1).astype(np.float32)
    b = rand(rng, (M,))
    add = rand(rng, tspec.out_shape) if epi == "add_relu" else None
    # a calibrated scale every other case, else the dynamic max|x|/127
    quant = (types.SimpleNamespace(x_scale=float(np.abs(x).max()) / 150)
             if C in (4, 16) else None)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)

    # weight codes (the kernel's (M, KH, KW, C) layout) and scales
    ex, rx = executors.get("cuconv_int8"), rex.get("cuconv_int8")
    codes, scales = ex._quantized_filter(tw)
    rscales = rsym.channel_scales(jw)
    rcodes = np.asarray(rsym.quantize_to_int8(jw, rscales))
    np.testing.assert_array_equal(codes.permute(1, 2, 3, 0).numpy(), rcodes)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    # activation codes
    xs = (quant.x_scale if quant else
          symmetric.scale_for(symmetric.abs_max(tx)))
    rxs = (quant.x_scale if quant else rsym.scale_for(rsym.abs_max(jx)))
    xq = symmetric.quantize_to_int8(tx, xs)
    rxq = np.asarray(rsym.quantize_to_int8(jx, rxs))
    np.testing.assert_array_equal(xq.numpy(), rxq)
    # the int32 accumulator of those codes
    acc = ex._execute(tspec, xq, codes.permute(1, 2, 3, 0), None)
    racc = rx._execute(rspec, jnp.asarray(rxq), jnp.asarray(rcodes), None,
                       True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(racc))
    # the executor's output, epilogue and all
    got = ex.execute(tspec, tx, tw, torch.from_numpy(b),
                     None if add is None else torch.from_numpy(add),
                     quant=quant)
    want = np32(rx.execute(rspec, jx, jw, jnp.asarray(b),
                           None if add is None else jnp.asarray(add),
                           interpret=True, quant=quant))
    assert got.shape == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_weight_codes_are_quantized_once_and_again_after_an_update(
        monkeypatch):
    rng = np.random.default_rng(3)
    spec, _ = _specs(16, 1, "same", "bias_relu")
    x = torch.from_numpy(rand(rng, spec.in_shape))
    w = torch.from_numpy(rand(rng, spec.filter_shape))
    b = torch.from_numpy(rand(rng, (8,)))
    quant = types.SimpleNamespace(x_scale=0.02)
    weight_calls = []
    real = symmetric.channel_scales
    monkeypatch.setattr(symmetric, "channel_scales",
                        lambda t: weight_calls.append(t.shape) or real(t))
    ex = executors.Int8PallasExecutor()
    first = ex.execute(spec, x, w, b, quant=quant)
    assert weight_calls == [w.shape]
    again = ex.execute(spec, x, w, b, quant=quant)
    assert weight_calls == [w.shape]            # the second call: cached
    assert torch.equal(first, again)
    w.mul_(2)                                    # a new version of w
    updated = ex.execute(spec, x, w, b, quant=quant)
    assert len(weight_calls) == 2
    fresh = executors.Int8PallasExecutor().execute(spec, x, w.clone(), b,
                                                   quant=quant)
    assert torch.equal(updated, fresh)
    assert not torch.equal(updated, first)


@pytest.mark.parametrize("entry", ["int8_gemm", "int8_conv"])
def test_int8_wrappers_refuse_a_k_that_could_overflow(entry):
    """K * 127^2 must stay below 2^31: K = 133,144 is the longest."""
    assert int8_gemm.K_MAX == 133_144
    k = int8_gemm.K_MAX + 1
    with pytest.raises(ValueError, match="overflow"):
        if entry == "int8_gemm":
            int8_gemm.int8_gemm(torch.zeros((2, k), dtype=torch.int8),
                                torch.zeros((k, 2), dtype=torch.int8))
        else:
            int8_gemm.int8_conv(torch.zeros((1, 1, 1, k), dtype=torch.int8),
                                torch.zeros((2, 1, 1, k), dtype=torch.int8))
    # the longest K runs
    x = torch.ones((1, 1, 1, k - 1), dtype=torch.int8) * 127
    acc = int8_gemm.int8_conv(x, x.expand(2, 1, 1, k - 1).contiguous())
    assert acc.flatten().tolist() == [(k - 1) * 127 ** 2] * 2
