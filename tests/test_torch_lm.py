"""Parity of the port's LM stack (configs, layers, ``lm_forward``,
prefill/decode) with the JAX package, on the CPU at smoke size.

Params come from the JAX package's ``init_lm`` and cross as numpy
(``params_from_numpy``); model comparisons run fp32 params, as
tests/test_models.py does, at its 2e-4 bound.  In prefill the port's
GQA attention runs the flash kernel's plain version at every length
where the reference takes ``exact_attention`` (or ``chunked_attention``
above ``CHUNKED_THRESHOLD``); in train mode it takes the reference's
own switch, and autograd's gradients match ``jax.grad``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, chip_smoke, np32  # noqa: F401
from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro_torch.configs import base as tbase
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.nn import attention as tattn

ALL_ARCHS = jbase.list_archs()
#: every arch: dense, MoE, MLA, SSM, hybrid, audio, VLM
PORTED = ["qwen2-72b", "mistral-large-123b", "qwen2-1.5b", "qwen3-14b",
          "musicgen-large", "qwen2-vl-2b", "mamba2-1.3b",
          "deepseek-v2-lite-16b", "deepseek-moe-16b", "jamba-v0.1-52b"]
#: the archs with MoE layers (and MLA: deepseek-v2-lite)
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-moe-16b", "jamba-v0.1-52b"]
#: qk_norm, the embeddings input with M-RoPE, and MHA at head dim 64
NEW_ARCHS = ["qwen3-14b", "qwen2-vl-2b", "musicgen-large"]
TOL = dict(rtol=2e-4, atol=2e-4)


def tree_numpy(tree):
    """A JAX params tree as float32 numpy (bf16 leaves round-trip
    exactly)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def fp32_params(cfg, seed):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jlm.init_lm(cfg, jax.random.PRNGKey(seed)))


def both_configs(arch, **kw):
    return tuple(dataclasses.replace(
        base.smoke_variant(base.get_config(arch)), **kw)
        for base in (jbase, tbase))


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


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"] + NEW_ARCHS
                         + MOE_ARCHS)
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
        seen.update(keys[-2:])
    assert "scale" in seen
    if tcfg.qk_norm:            # the per-head norms, fp32 like every scale
        assert {"q_norm", "k_norm"} <= seen
    if tcfg.num_experts:        # the router's "w" arrived fp32
        moe = [layer["moe"] for seg in tp["segments"] for rep in seg
               for layer in rep.values() if "moe" in layer]
        assert moe and all(m["router"]["w"].dtype == torch.float32
                           for m in moe)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"] + NEW_ARCHS
                         + MOE_ARCHS)
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
    assert sum(len(seg) * len(seg[0]) for seg in cache) == tcfg.num_layers


@pytest.mark.parametrize("arch", PORTED)
def test_lm_forward_matches_reference(arch, rng):
    jcfg, tcfg = both_configs(arch)
    jp = fp32_params(jcfg, 1)
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu",
                              dtype=torch.float32)
    batch = make_batch(jcfg, 2, 16, rng)
    want, _, jaux = jlm.lm_forward(jp, jcfg, to_j(batch))
    got, _, aux = lm.lm_forward(tp, tcfg, to_t(batch))
    assert got.shape == (2, 16, tcfg.padded_vocab)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    for k in ("load_balance_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-6,
                                   atol=1e-6)
    if not tcfg.num_experts:
        assert float(aux["load_balance_loss"]) == 0.0
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"] + NEW_ARCHS
                         + MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch, rng):
    """tests/test_models.py's construction through both packages: the
    prefill logits and 4 decode steps (fp32 cache) against the
    reference's own, and against the teacher-forced forward (at its
    capacity factor 8, so the forward drops no token either)."""
    _prefill_and_decode(arch, rng, capacity_factor=8.0)


def test_jamba_at_two_repeats_prefill_and_decode_match_reference(rng):
    """jamba's smoke width at 16 layers, two repeats of its 8-layer
    period (the card serves two at full width): the prefill and 4
    decode steps against the reference's, and the hybrid cache one
    entry per layer, KV at position 4 of each repeat and SSM state at
    the other seven, each written at its own repeat."""
    tcfg, tcache = _prefill_and_decode("jamba-v0.1-52b", rng,
                                       capacity_factor=8.0, num_layers=16)
    assert lm.stack_plan(tcfg)[0][0] == 2
    assert [len(seg) for seg in tcache] == [2]
    assert sum(len(rep) for seg in tcache for rep in seg) == 16
    for rep in tcache[0]:
        assert isinstance(rep["pos4"][0], torch.Tensor)          # k, v
        assert all(len(rep[f"pos{i}"]) == 2 for i in range(8) if i != 4)
    # each repeat holds its own layers' entries
    assert not torch.equal(tcache[0][0]["pos4"][0], tcache[0][1]["pos4"][0])
    assert not torch.equal(tcache[0][0]["pos0"][1], tcache[0][1]["pos0"][1])


def _prefill_and_decode(arch, rng, **kw):
    """The prefill and decode parity at config overrides ``kw``; returns
    the port's config and cache."""
    jcfg, tcfg = both_configs(arch, **kw)
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
    # the in-place cache holds what the reference's returned cache holds,
    # segment by segment and position by position (stacked over repeats)
    n = 0
    for jseg, tseg in zip(jcache, tcache):
        for pos, jpos in jseg.items():
            jleaves = jax.tree.leaves(jpos)
            per_rep = [jax.tree.leaves(rep[pos]) for rep in tseg]
            for i, j in enumerate(jleaves):
                stacked = np.stack([np32(leaves[i]) for leaves in per_rep])
                np.testing.assert_allclose(stacked, np32(j), **TOL)
                n += 1
    assert n == len(jax.tree.leaves(jcache))
    return tcfg, tcache


def test_gqa_fwd_above_the_chunked_threshold_matches_reference(rng):
    """S = 2056 > CHUNKED_THRESHOLD in train mode: both packages take
    chunked_attention (3 KV chunks)."""
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


# ---------------------------------------------------------------------------
# M-RoPE over an image grid, whose t, h and w rows differ

def _grid_positions(B, text, side, after):
    """chip_smoke's M-RoPE grid for B rows, (3, B, S), and the position
    the next token takes."""
    grid, nxt = chip_smoke().mrope_grid(text, side, after)
    return np.broadcast_to(grid[:, None], (3, B, grid.shape[1])).copy(), nxt


def test_mrope_grid_is_qwen2_vls():
    grid, nxt = chip_smoke().mrope_grid(2, 2, 3)
    np.testing.assert_array_equal(grid, [[0, 1, 2, 2, 2, 2, 4, 5, 6],
                                         [0, 1, 2, 2, 3, 3, 4, 5, 6],
                                         [0, 1, 2, 3, 2, 3, 4, 5, 6]])
    assert nxt == 7


def test_apply_rope_on_an_image_grid_matches_reference(rng):
    """sections (4, 2, 2) over rows that differ: text, a 3x3 image, text;
    the second row's positions shifted, as another prompt's would be."""
    from repro.nn import layers as jlayers
    from repro_torch.nn import layers as tlayers
    pos, _ = _grid_positions(2, 3, 3, 4)
    pos[:, 1] += 5
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    x = rng.normal(size=(2, pos.shape[2], 3, 16)).astype(np.float32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              sections=(4, 2, 2))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             sections=(4, 2, 2))
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)


def test_mrope_sections_shift_independently(rng):
    """tests/test_models.py's check on the port: moving only the h-row
    positions changes the output only in the h section's rotary slots."""
    from repro_torch.nn import layers as tlayers
    B, S, H, D = 1, 6, 2, 16
    x = torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
    base = torch.arange(S, dtype=torch.int32).expand(3, B, S).clone()
    shifted = base.clone()
    shifted[1] += 5
    y0 = tlayers.apply_rope(x, base, sections=(4, 2, 2))
    y1 = tlayers.apply_rope(x, shifted, sections=(4, 2, 2))
    d = (y0 - y1).abs().sum(dim=(0, 1, 2)).numpy()
    half = D // 2
    assert d[:4].sum() == 0 and d[half:half + 4].sum() == 0
    assert d[4:6].sum() > 0 and d[half + 4:half + 6].sum() > 0
    assert d[6:half].sum() == 0 and d[half + 6:].sum() == 0


def test_qwen2_vl_grid_prefill_and_decode_match_reference(rng):
    """qwen2-vl-2b at smoke size: a prefill over text, a 3x3 image and
    text (12 positions), then 4 decode steps at M-RoPE positions 8, 9,
    ... while the cache writes at 12, 13, ...: the logits and the cache
    against the reference's ``prefill``/``decode_step``."""
    jcfg, tcfg = both_configs("qwen2-vl-2b")
    jp = fp32_params(jcfg, 1)
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu",
                              dtype=torch.float32)
    B, MAX = 2, 20
    pos, nxt = _grid_positions(B, 2, 3, 1)
    S = pos.shape[2]
    assert S == 12 and nxt == 6
    embeds = rng.normal(size=(B, S + 4, jcfg.d_model)).astype(np.float32)
    jcache = jlm.init_cache(jcfg, B, MAX, kv_dtype=jnp.float32)
    tcache = lm.init_cache(tcfg, B, MAX, kv_dtype=torch.float32,
                           device="cpu")
    first = {"embeds": embeds[:, :S], "positions": pos}
    jl, jcache = jlm.prefill(jp, jcfg, to_j(first), jcache)
    tl, tcache = lm.prefill(tp, tcfg, to_t(first), tcache)
    np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    for t in range(4):
        step = {"embeds": embeds[:, S + t:S + t + 1],
                "positions": np.full((3, B, 1), nxt + t, np.int32)}
        jl, jcache = jlm.decode_step(jp, jcfg, to_j(step), jcache, S + t)
        tl, tcache = lm.decode_step(tp, tcfg, to_t(step), tcache, S + t)
        np.testing.assert_allclose(np32(tl), np32(jl), **TOL)
    for jseg, tseg in zip(jcache, tcache):
        for pos_name, jpos in jseg.items():
            for i, j in enumerate(jax.tree.leaves(jpos)):
                stacked = np.stack([np32(jax.tree.leaves(rep[pos_name])[i])
                                    for rep in tseg])
                np.testing.assert_allclose(stacked, np32(j), **TOL)


# ---------------------------------------------------------------------------
# chip_smoke's CPU side of the card-vs-CPU check, one layer at a time

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-vl-2b",
                                  "deepseek-v2-lite-16b"])
def test_layerwise_cpu_logits_equal_prefill_and_decode(arch):
    """``layerwise_cpu_logits`` (each layer's params copied in, run over
    the prefill and every teacher-forced step, dropped) gives the bits
    of ``lm.prefill`` plus ``lm.decode_step`` (``stepwise_logits``) on
    the CPU, and the same routing record under the same (MoE layer,
    step) keys: jamba at smoke width, one period of 8 layers with all
    its experts; qwen2-vl on an image grid with decode positions off the
    cache offset; deepseek-v2-lite's dense first layer, MLA and shared
    experts."""
    cs = chip_smoke()
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    period = max(len(kinds) for _, kinds in lm.stack_plan(cfg))
    cfg = dataclasses.replace(cfg, num_layers=max(4, period))
    params = lm.init_lm(cfg, seed=0, device="cpu", dtype=torch.float32)
    B, steps = 2, 4
    gen = torch.Generator().manual_seed(0)
    if cfg.input_mode == "tokens":
        S = 12
        toks = torch.randint(0, cfg.vocab_size, (steps + 1, B, S),
                             generator=gen, dtype=torch.int32)
        inputs = [{"tokens": toks[0]}] + [{"tokens": toks[t, :, :1]}
                                          for t in range(1, steps + 1)]
    else:
        pos, nxt = _grid_positions(B, 2, 3, 1)
        S = pos.shape[2]
        e = torch.randn((steps + 1, B, S, cfg.d_model), generator=gen)
        inputs = [{"embeds": e[0], "positions": torch.from_numpy(pos)}] + [
            {"embeds": e[t, :, :1],
             "positions": torch.full((3, B, 1), nxt + t - 1,
                                     dtype=torch.int32)}
            for t in range(1, steps + 1)]
    routes = cs.RoutingLog(), cs.RoutingLog()
    with routes[0]:
        want = cs.stepwise_logits(params, cfg, inputs, S + steps,
                                  torch.device("cpu"), routes[0])
    with routes[1]:
        got = cs.layerwise_cpu_logits(params, cfg, inputs, S + steps,
                                      routes[1])
    assert len(got) == len(want) == steps + 1
    assert got[0].shape == (B, S, cfg.padded_vocab)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n_moe = sum(mlp == "moe" for _, mlp in cfg.layer_kinds())
    assert sorted(routes[1].calls) == sorted(routes[0].calls) == sorted(
        (k, t) for k in range(n_moe) for t in range(steps + 1))
    for key, rec in routes[0].calls.items():
        for field, v in rec.items():
            assert torch.equal(routes[1].calls[key][field], v), (key, field)
    if arch == "jamba-v0.1-52b":
        assert n_moe == 4 and next(iter(routes[0].calls.values()))[
            "probs"].shape[-1] == cfg.num_experts == 4
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# MLA, the MoE archs' statistics, and train mode's gradients

def _mla_params(jcfg, seed):
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jattn.mla_init(jax.random.PRNGKey(seed), jcfg))
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_fwd_matches_reference(mode, rng):
    """The same fp32 params and inputs through both ``mla_fwd``s: the
    output and, in prefill and decode, the latent cache (fp32), within
    2e-5.  Decode writes one token at offset S after a prefill of S."""
    jcfg, tcfg = both_configs("deepseek-v2-lite-16b")
    jp, tp = _mla_params(jcfg, 5)
    B, S, MAX = 2, 10, 16
    x = rng.normal(size=(B, S + 1, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1))
    width = jcfg.kv_lora_rank + jcfg.qk_rope_dim
    jcache = tcache = None                   # train mode takes no cache
    if mode != "train":
        jcache = jnp.zeros((B, MAX, width), jnp.float32)
        tcache = torch.zeros((B, MAX, width))
    n = S + 1 if mode == "train" else S
    want, jcache = jattn.mla_fwd(jp, jcfg, jnp.asarray(x[:, :n]),
                                 jnp.asarray(pos[:, :n]), jcache, 0,
                                 "train" if mode == "train" else "prefill")
    got, tcache = tattn.mla_fwd(tp, tcfg, torch.from_numpy(x[:, :n]),
                                torch.from_numpy(pos[:, :n].copy()), tcache,
                                0, "train" if mode == "train" else "prefill")
    if mode == "decode":
        want, jcache = jattn.mla_fwd(jp, jcfg, jnp.asarray(x[:, S:]),
                                     jnp.asarray(pos[:, S:]), jcache, S,
                                     "decode")
        got, tcache = tattn.mla_fwd(
            tp, tcfg, torch.from_numpy(x[:, S:]),
            torch.from_numpy(pos[:, S:].copy()), tcache,
            torch.tensor(S), "decode")
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)
    if mode != "train":
        np.testing.assert_allclose(np32(tcache), np32(jcache), rtol=2e-5,
                                   atol=2e-5)
    else:
        assert tcache is None and jcache is None


def test_mla_fwd_above_the_chunked_threshold_matches_reference(rng):
    """S = 2056 > CHUNKED_THRESHOLD: both packages expand the latent and
    take chunked_attention, q/k head dim 24 against v head dim 16."""
    jcfg, tcfg = both_configs("deepseek-v2-lite-16b")
    jp, tp = _mla_params(jcfg, 6)
    S = tattn.CHUNKED_THRESHOLD + 8
    x = rng.normal(size=(1, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want, _ = jattn.mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, _ = tattn.mla_fwd(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)


def test_gqa_prefill_above_the_chunked_threshold_matches_reference(rng):
    """S = 2056 in prefill: the reference takes chunked_attention, the
    port the flash kernel (its plain version here); the caches agree."""
    jcfg, tcfg = both_configs("qwen2-1.5b")
    S = tattn.CHUNKED_THRESHOLD + 8
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jattn.gqa_init(jax.random.PRNGKey(3), jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.normal(size=(1, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    shape = (1, S, jcfg.num_kv_heads, jcfg.head_dim)
    jc = (jnp.zeros(shape), jnp.zeros(shape))
    tc = (torch.zeros(shape), torch.zeros(shape))
    want, jc = jattn.gqa_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jc,
                             0, "prefill")
    got, tc = tattn.gqa_fwd(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos), tc, 0, "prefill")
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(np32(a), np32(b), rtol=2e-5, atol=2e-5)
    assert _build.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_lm_aux_matches_reference(arch, mode, rng):
    """The MoE statistics of lm_forward, summed over the MoE layers as
    the reference sums them, at the capacity path's default factor."""
    jcfg, tcfg = both_configs(arch)
    jp = fp32_params(jcfg, 2)
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu",
                              dtype=torch.float32)
    batch = make_batch(jcfg, 2, 16, rng)
    jcache = tcache = None
    if mode == "prefill":
        jcache = jlm.init_cache(jcfg, 2, 16, kv_dtype=jnp.float32)
        tcache = lm.init_cache(tcfg, 2, 16, kv_dtype=torch.float32,
                               device="cpu")
    _, _, jaux = jlm.lm_forward(jp, jcfg, to_j(batch), jcache, 0, mode,
                                moe_groups=2)
    _, _, aux = lm.lm_forward(tp, tcfg, to_t(batch), tcache, 0, mode,
                              moe_groups=2)
    for k in ("load_balance_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-6,
                                   atol=1e-6)
    n_moe = sum(mlp == "moe" for _, mlp in tcfg.layer_kinds())
    assert float(aux["load_balance_loss"]) > 0.9 * n_moe


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_train_mode_gradients_match_jax_grad(arch, rng):
    """A loss through lm_forward(mode="train") (a fixed random projection
    of the logits, plus the load-balance loss where there are experts):
    every param's gradient from autograd equals jax.grad's, and no
    kernel launches (train mode takes the plain versions, which
    autograd differentiates)."""
    jcfg, tcfg = both_configs(arch)
    jp = fp32_params(jcfg, 3)
    tp = lm.params_from_numpy(tree_numpy(jp), tcfg, device="cpu",
                              dtype=torch.float32)
    batch = make_batch(jcfg, 2, 12, rng)
    r = rng.normal(size=(2, 12, jcfg.padded_vocab)).astype(np.float32)

    def jloss(p):
        logits, _, aux = jlm.lm_forward(p, jcfg, to_j(batch))
        return jnp.sum(logits * r) + aux["load_balance_loss"]
    jgrads = jax.grad(jloss)(jp)

    leaves = []

    def track(node):
        if isinstance(node, dict):
            for v in node.values():
                track(v)
        elif isinstance(node, list):
            for v in node:
                track(v)
        else:
            leaves.append(node.requires_grad_(True))
    track(tp)
    logits, _, aux = lm.lm_forward(tp, tcfg, to_t(batch))
    loss = torch.sum(logits * torch.from_numpy(r)) + aux["load_balance_loss"]
    loss.backward()
    assert sum(_build.LAUNCHES.values()) == 0

    checked = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "segments":
            si, pos, rest = keys[1], keys[2], keys[3:]
            nodes = [tp["segments"][si][rep][pos]
                     for rep in range(want.shape[0])]
        else:
            rest, nodes = keys, [tp]
            want = want[None]
        for rep, node in enumerate(nodes):
            for k in rest:
                node = node[k]
            assert node.grad is not None, keys
            scale = max(1.0, float(np.abs(np32(want[rep])).max()))
            np.testing.assert_allclose(np32(node.grad), np32(want[rep]),
                                       rtol=2e-4, atol=2e-5 * scale,
                                       err_msg=str(keys))
            checked += 1
    assert checked == len(leaves)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-moe-16b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b"])
def test_num_params_counts_what_init_lm_draws(arch):
    """tests/test_models.py's check on the port: the analytic count is
    what init_lm draws, in both packages.  ``num_params`` (the
    reference's, unchanged) leaves out MLA's kv_norm scale, one
    kv_lora_rank vector per layer: both packages draw it."""
    jcfg, tcfg = both_configs(arch)
    drawn = lm.init_lm(tcfg, device="cpu")
    actual = 0

    def count(node):
        nonlocal actual
        if isinstance(node, dict):
            for v in node.values():
                count(v)
        elif isinstance(node, list):
            for v in node:
                count(v)
        else:
            actual += node.numel()
    count(drawn)
    jactual = sum(x.size for x in jax.tree.leaves(
        jlm.init_lm(jcfg, jax.random.PRNGKey(0))))
    kv_norm = tcfg.num_layers * tcfg.kv_lora_rank if tcfg.mla else 0
    assert actual == jactual == tcfg.num_params() + kv_norm


@pytest.mark.parametrize("L,K", [(16, 4), (3, 4), (9, 2)])
def test_causal_conv1d_matches_reference(L, K, rng):
    """Mamba2's plain conv (train mode's) against the reference's."""
    from repro.nn import mamba as jmamba
    from repro_torch.nn import mamba as tmamba
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((2, L, 6), (K, 6), (6,)))
    want = jmamba.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = tmamba.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(np32(got), np32(want), rtol=2e-5, atol=2e-5)
