"""Parity of the port's LM stack (configs, layers, ``lm_forward``,
prefill/decode) with the JAX package, on the CPU at smoke size.

Params come from the JAX package's ``init_lm`` and cross as numpy
(``params_from_numpy``); model comparisons run fp32 params, as
tests/test_models.py does, at its 2e-4 bound.  The port's attention
runs the flash kernel's plain version at every length where the
reference takes ``exact_attention`` (or ``chunked_attention`` above
``CHUNKED_THRESHOLD``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, np32  # noqa: F401
from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro_torch.configs import base as tbase
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.nn import attention as tattn

ALL_ARCHS = jbase.list_archs()
#: every arch with neither MoE nor MLA
PORTED = ["qwen2-72b", "mistral-large-123b", "qwen2-1.5b", "qwen3-14b",
          "musicgen-large", "qwen2-vl-2b", "mamba2-1.3b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def tree_numpy(tree):
    """A JAX params tree as float32 numpy (bf16 leaves round-trip
    exactly)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def fp32_params(cfg, seed):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jlm.init_lm(cfg, jax.random.PRNGKey(seed)))


def both_configs(arch):
    return (jbase.smoke_variant(jbase.get_config(arch)),
            tbase.smoke_variant(tbase.get_config(arch)))


def make_batch(cfg, B, S, rng):
    """numpy batch as tests/test_models.py builds it (fp32 embeds)."""
    batch = {}
    if cfg.input_mode == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections:
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    return batch


def cut(batch, sl):
    return {k: (v[:, :, sl] if k == "positions" else v[:, sl])
            for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
def test_registry_and_shapes_match_reference():
    assert tbase.list_archs() == ALL_ARCHS and len(ALL_ARCHS) == 10
    assert tbase.SHAPES == {k: tbase.ShapeConfig(**dataclasses.asdict(v))
                            for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("gpt-5")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_parity(arch):
    for jc, tc in ((jbase.get_config(arch), tbase.get_config(arch)),
                   both_configs(arch)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.num_params() == jc.num_params()
        assert tc.num_active_params() == jc.num_active_params()
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.pattern_period == jc.pattern_period
        assert (tc.uniform_stack, tc.padded_vocab, tc.conv_dim) == (
            jc.uniform_stack, jc.padded_vocab, jc.conv_dim)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "qwen2-vl-2b"])
def test_params_from_numpy_round_trip(arch):
    """Unstacked per layer, bf16 leaves exact, fp32 leaves fp32."""
    jcfg, tcfg = both_configs(arch)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu")
    assert [len(seg) for seg in tp["segments"]] == [
        r for r, _ in lm.stack_plan(tcfg)]
    seen = set()
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(jp):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "segments":
            si, pos, rest = keys[1], keys[2], keys[3:]
            for r in range(leaf.shape[0]):
                node = tp["segments"][si][r][pos]
                for k in rest:
                    node = node[k]
                assert node.dtype == (torch.bfloat16
                                      if leaf.dtype == jnp.bfloat16
                                      else torch.float32), keys
                np.testing.assert_array_equal(
                    np32(node), np.asarray(leaf[r].astype(jnp.float32)))
        else:
            node = tp
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(np32(node),
                                          np.asarray(leaf, np.float32))
        seen.add(keys[-1])
    assert "scale" in seen


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_cache_shapes_match_reference(arch):
    jcfg, tcfg = both_configs(arch)
    jshapes = jlm.cache_shapes(jcfg, 3, 20)
    tshapes = lm.cache_shapes(tcfg, 3, 20)
    jleaves = jax.tree.leaves(
        jshapes, is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))
    tleaves = []
    lm._map(tleaves.append, tuple(tuple(seg.values()) for seg in tshapes))
    assert [(tuple(s.shape), str(s.dtype)) for s in jleaves] == [
        (shape, str(dt)[6:]) for shape, dt in tleaves]
    cache = lm.init_cache(tcfg, 3, 20, device="cpu")
    assert len(cache[0]) == tcfg.num_layers


@pytest.mark.parametrize("arch", PORTED)
def test_lm_forward_matches_reference(arch, rng):
    jcfg, tcfg = both_configs(arch)
    jp = fp32_params(jcfg, 1)
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu",
                              dtype=torch.float32)
    batch = make_batch(jcfg, 2, 16, rng)
    want, _, _ = jlm.lm_forward(jp, jcfg, to_j(batch))
    got, _, aux = lm.lm_forward(tp, tcfg, to_t(batch))
    assert got.shape == (2, 16, tcfg.padded_vocab)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    assert float(aux["load_balance_loss"]) == 0.0
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_prefill_and_decode_match_reference(arch, rng):
    """tests/test_models.py's construction through both packages: the
    prefill logits and 4 decode steps (fp32 cache) against the
    reference's own, and against the teacher-forced forward."""
    jcfg, tcfg = both_configs(arch)
    jp = fp32_params(jcfg, 1)
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu",
                              dtype=torch.float32)
    B, S, MAX = 2, 12, 20
    full = make_batch(jcfg, B, S + 4, rng)
    full_logits, _, _ = lm.lm_forward(tp, tcfg, to_t(full))
    jcache = jlm.init_cache(jcfg, B, MAX, kv_dtype=jnp.float32)
    tcache = lm.init_cache(tcfg, B, MAX, kv_dtype=torch.float32,
                           device="cpu")
    jl, jcache = jlm.prefill(jp, jcfg, to_j(cut(full, slice(0, S))), jcache)
    tl, tcache = lm.prefill(tp, tcfg, to_t(cut(full, slice(0, S))), tcache)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    np.testing.assert_allclose(np32(tl[:, -1]), np32(full_logits[:, S - 1]),
                               **TOL)
    for t in range(4):
        step = cut(full, slice(S + t, S + t + 1))
        jl, jcache = jlm.decode_step(jp, jcfg, to_j(step), jcache, S + t)
        tl, tcache = lm.decode_step(tp, tcfg, to_t(step), tcache, S + t)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
        np.testing.assert_allclose(np32(tl[:, 0]),
                                   np32(full_logits[:, S + t]), **TOL)
    # the in-place cache holds what the reference's returned cache holds
    jleaves = jax.tree.leaves(jcache)
    tleaves = [t for seg in tcache for rep in seg for pos in rep.values()
               for t in jax.tree.leaves(pos)]
    assert len(jleaves) == len(tleaves) // tcfg.num_layers
    for i, j in enumerate(jleaves):
        stacked = np.stack([np32(tleaves[i + len(jleaves) * r])
                            for r in range(tcfg.num_layers)])
        np.testing.assert_allclose(stacked, np32(j), **TOL)


def test_gqa_fwd_above_the_chunked_threshold_matches_reference(rng):
    """S = 2056 > CHUNKED_THRESHOLD: the reference takes
    chunked_attention (3 KV chunks), the port the flash kernel."""
    jcfg, tcfg = both_configs("qwen2-1.5b")
    S = tattn.CHUNKED_THRESHOLD + 8
    assert S > jattn.CHUNKED_THRESHOLD
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jattn.gqa_init(jax.random.PRNGKey(3), jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.normal(size=(1, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = jattn.gqa_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, _ = tattn.gqa_fwd(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_attention_matches_reference(rng, chunk):
    B, S, H, D = 2, 50, 3, 16
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   chunk=chunk)
    got = tattn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  chunk=chunk)
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)
    exact = tattn.exact_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(np32(exact), np32(jattn.exact_attention(
        *(jnp.asarray(a) for a in (q, k, v)))), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v2-lite-16b",
                                  "deepseek-moe-16b"])
def test_moe_and_mla_wait_for_their_slice(arch):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_lm(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (64, 1e4),
                                            (128, 1e6)])
def test_rope_freqs_match_reference(head_dim, theta):
    """Computed on the device in float64, equal to the reference's numpy
    table after the fp32 cast."""
    from repro.nn import layers as jlayers
    from repro_torch.nn import layers as tlayers
    want = np.asarray(jlayers.rope_freqs(head_dim, theta), np.float32)
    np.testing.assert_array_equal(
        tlayers.rope_freqs(head_dim, theta).numpy(), want)
