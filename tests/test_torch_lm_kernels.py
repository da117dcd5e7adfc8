"""Parity of the port's LM kernels' plain versions with the JAX package.

The same numpy inputs go through the JAX package's Pallas kernels (in
interpret mode, as tests/test_kernels.py runs them) and through the
port's wrappers on CPU tensors, which run the kernels' plain versions.
Tolerances are tests/test_kernels.py's: fp32 2e-5, bf16 2e-2.  The
port's conv1d adds its bias in fp32 before the cast, where the TPU
wrapper adds it after (kernels/conv1d_tap.py:67): in bf16 the two differ
by at most one rounding, inside the bf16 bound.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (TORCH_DTYPES, _clear_port_caches,  # noqa: F401
                           np32, rand, to_jax, to_torch)
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro_torch.kernels import _build, ops, ref

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,D,K", [(2, 37, 24, 4), (1, 128, 64, 4),
                                     (3, 16, 8, 2)])
def test_conv1d_causal_matches_reference(rng, B, L, D, K, dtype):
    x, w, b = (rand(rng, s, dtype) for s in ((B, L, D), (K, D), (D,)))
    got = ops.conv1d_causal(*(to_torch(a, dtype) for a in (x, w, b)))
    assert got.dtype == TORCH_DTYPES[dtype]
    jx, jw, jb = (to_jax(a, dtype) for a in (x, w, b))
    for want in (jops.conv1d_causal(jx, jw, jb, interpret=True),
                 jref.conv1d_ref(jx, jw, jb)):
        np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])
    # the bias is fused in fp32, as the reference's oracle adds it
    np.testing.assert_array_equal(
        np32(ref.conv1d_ref(*(to_torch(a, dtype) for a in (x, w, b)))),
        np32(got))
    np.testing.assert_allclose(
        np32(ops.conv1d_causal(to_torch(x, dtype), to_torch(w, dtype))),
        np32(jref.conv1d_ref(jx, jw)), **TOLS[dtype])
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("BH,Sq,Sk,D,causal", [
    (3, 40, 40, 16, True), (3, 40, 40, 16, False),
    (2, 100, 100, 32, True), (2, 100, 100, 32, False),
    (1, 64, 128, 8, False),
])
def test_flash_attention_matches_reference(rng, BH, Sq, Sk, D, causal):
    q, k, v = (rand(rng, (BH, s, D)) for s in (Sq, Sk, Sk))
    got = ops.flash_attention(*(to_torch(a) for a in (q, k, v)),
                              causal=causal)
    jq, jk, jv = (to_jax(a) for a in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, tq=32, tk=32,
                               interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS["float32"])
    np.testing.assert_allclose(
        np32(ref.attention_ref(*(to_torch(a) for a in (q, k, v)), causal)),
        np32(jref.attention_ref(jq, jk, jv, causal=causal)),
        **TOLS["float32"])
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa_wrapper_matches_reference(rng, dtype):
    """(B, S, H, D) queries against KVH < H kv heads, read by stride in
    the port and repeated in the reference."""
    B, S, H, KVH, D = 2, 32, 8, 2, 16
    q = rand(rng, (B, S, H, D), dtype)
    k, v = (rand(rng, (B, S, KVH, D), dtype) for _ in range(2))
    got = ops.flash_attention(*(to_torch(a, dtype) for a in (q, k, v)))
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), **TOLS[dtype])
    exact = jattn.exact_attention(jq, jattn._repeat_kv(jk, H),
                                  jattn._repeat_kv(jv, H))
    np.testing.assert_allclose(np32(got), np32(exact), **TOLS[dtype])
    assert got.shape == (B, S, H, D)


def test_lm_wrappers_refuse_bad_operands():
    x = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="taps"):
        ops.conv1d_causal(x, torch.zeros((9, 4)))
    with pytest.raises(ValueError, match="dtype"):
        ops.conv1d_causal(x, torch.zeros((4, 4), dtype=torch.bfloat16))
    q = torch.zeros((1, 8, 6, 16))
    with pytest.raises(ValueError, match="KVH must divide H"):
        ops.flash_attention(q, torch.zeros((1, 8, 4, 16)),
                            torch.zeros((1, 8, 4, 16)))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(*(torch.zeros((2, 8, 256)),) * 3)
    assert sum(_build.LAUNCHES.values()) == 0


def test_flash_attention_smem_model_fits_every_head_dim():
    """Q and two stages of K and V, 64 rows x the padded head dimension
    each, in the input dtype: two bf16 blocks share an SM at D = 128
    (228 KB an SM, 1 KB reserved a block), one fp32 block fits."""
    from repro_torch.kernels import flash_attention as tfa
    assert tfa.smem_bytes(128) == 5 * 64 * 128 * 2 == 81_920
    assert tfa.smem_bytes(128, 4) == 163_840
    assert tfa.smem_bytes(40) == tfa.smem_bytes(64) == 5 * 64 * 64 * 2
    assert 2 * (tfa.smem_bytes(128) + 1024) <= 228 * 1024
    assert max(tfa.smem_bytes(d, size) for d in range(1, tfa.MAX_HEAD_DIM + 1)
               for size in (2, 4)) <= _build.SMEM_LIMIT


@pytest.mark.parametrize("library", sorted(_build.LIBRARIES))
def test_ctypes_signatures_match_the_c_launchers(library):
    """Each launcher's declared argtypes follow its C parameter list:
    a pointer as c_void_p, an int as c_int, a float as c_float."""
    import ctypes
    import re
    src = (_build.CSRC / f"{library}.cu").read_text()
    kinds = {"*": ctypes.c_void_p, "float": ctypes.c_float,
             "int": ctypes.c_int}
    for fn, argtypes in _build.LIBRARIES[library].items():
        m = re.search(rf"REPRO_EXPORT int {fn}\(([^)]*)\)", src)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(",")]
        want = [kinds["*"] if "*" in p else kinds[p.split()[-2]]
                for p in params]
        assert list(argtypes) == want, fn


@pytest.mark.parametrize("B,L,D", [(4, 512, 4096), (4, 512, 256), (1, 7, 5)])
def test_conv1d_tap_launch_geometry_is_the_sources(B, L, D):
    """The wrapper's launch_geometry mirrors csrc/conv1d_tap.cu: a block
    of kC1dThreads channels, kC1dRun positions a thread."""
    import re
    from repro_torch.kernels import conv1d_tap
    src = (_build.CSRC / "conv1d_tap.cu").read_text()
    threads = int(re.search(r"kC1dThreads = (\d+);", src).group(1))
    run = int(re.search(r"kC1dRun = (\d+);", src).group(1))
    geo = conv1d_tap.launch_geometry(B, L, D)
    assert (geo["threads"], conv1d_tap.RUN) == (threads, run)
    assert geo["grid"] == (-(-D // threads), -(-L // run), B)
    assert geo["blocks"] == geo["grid"][0] * geo["grid"][1] * B
