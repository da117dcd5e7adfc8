"""The port's Winograd F(m, 3) decompositions against the JAX package's
and against direct convolution.

``repro_torch.core.winograd`` keeps its own copy of the transform
matrices: they must equal the JAX package's, and ``conv_winograd`` must
compute what the JAX package's ``conv_winograd`` computes on the same
numpy inputs, at both variants.  Bounds are ``tests/test_winograd.py``'s
own: 1e-4 for F(2,3) and 2e-3 for F(4,3) (its ±8 inverse-transform
coefficients amplify rounding), 3e-2 for bf16 operands.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (_clear_port_caches, np32, rand, to_jax,  # noqa: F401
                           to_torch)
from repro.core import winograd as rwino
from repro_torch.core import winograd as twino
from repro_torch.core.convspec import normalize_pad
from repro_torch.kernels.ref import conv2d_ref

BOUND = {2: 1e-4, 4: 2e-3}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("m", [2, 4])
def test_matrices_are_the_reference_constants(m):
    for got, want in zip(twino.matrices(m), rwino.matrices(m)):
        np.testing.assert_array_equal(np32(got), np.asarray(want))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("padding", ["same", "valid", 0, 1, 2, (2, 1)])
@pytest.mark.parametrize("shape", [(1, 8, 8, 3, 4), (2, 9, 7, 5, 6),
                                   (1, 13, 13, 8, 8)])
def test_conv_winograd_matches_reference_and_direct(rng, m, padding, shape):
    n, h, w_, c, mo = shape
    x, w = rand(rng, (n, h, w_, c)), rand(rng, (3, 3, c, mo))
    got = twino.conv_winograd(to_torch(x), to_torch(w), padding=padding,
                              m=m)
    want = rwino.conv_winograd(to_jax(x), to_jax(w), padding=padding, m=m)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np32(got), np32(want), rtol=BOUND[m],
                               atol=BOUND[m])
    pad = normalize_pad(padding, 3, 3)
    direct = conv2d_ref(to_torch(x), to_torch(w), 1, pad)
    np.testing.assert_allclose(np32(got), np32(direct), rtol=BOUND[m],
                               atol=BOUND[m])


@pytest.mark.parametrize("m", [2, 4])
def test_transform_filters_matches_reference(rng, m):
    w = rand(rng, (3, 3, 5, 7))
    np.testing.assert_allclose(
        np32(twino.transform_filters(to_torch(w), m)),
        np32(rwino.transform_filters(to_jax(w), m)), rtol=1e-6, atol=1e-6)


def test_bf16_inputs_compute_in_fp32(rng):
    x = rand(rng, (1, 10, 10, 4), "bfloat16")
    w = rand(rng, (3, 3, 4, 8), "bfloat16")
    got = twino.conv_winograd(to_torch(x, "bfloat16"),
                              to_torch(w, "bfloat16"))
    assert str(got.dtype) == "torch.bfloat16"
    want = rwino.conv_winograd(to_jax(x, "bfloat16"), to_jax(w, "bfloat16"))
    np.testing.assert_allclose(np32(got), np32(want), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(
        np32(got), np32(conv2d_ref(to_torch(x), to_torch(w), 1, (1, 1))),
        rtol=3e-2, atol=3e-2)


def test_f4_agrees_with_f2(rng):
    x, w = to_torch(rand(rng, (1, 10, 10, 4))), to_torch(rand(rng,
                                                               (3, 3, 4, 8)))
    np.testing.assert_allclose(np32(twino.conv_winograd(x, w, m=2)),
                               np32(twino.conv_winograd(x, w, m=4)),
                               rtol=2e-3, atol=2e-3)


def test_invalid_variant_filter_and_stride_raise():
    import torch
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="got m=3"):
        twino.matrices(3)
    with pytest.raises(ValueError, match="got m=3"):
        twino.conv_winograd(x, torch.zeros((3, 3, 3, 4)), m=3)
    with pytest.raises(ValueError, match="3x3"):
        twino.conv_winograd(x, torch.zeros((5, 5, 3, 4)))
    with pytest.raises(ValueError, match="stride"):
        twino.conv_winograd(x, torch.zeros((3, 3, 3, 4)), stride=2)
    # the reference refuses the same calls
    with pytest.raises(ValueError, match="got m=3"):
        rwino.matrices(3)
    with pytest.raises(AssertionError, match="stride"):
        rwino.conv_winograd(jnp.zeros((1, 8, 8, 3)),
                            jnp.zeros((3, 3, 3, 4)), stride=2)
