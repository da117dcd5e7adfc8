"""The served programs as CUDA graphs: what the CPU can check.

On the card the port captures each CNN bucket, each LM prefill length
and the LM decode step as a CUDA graph (``repro_torch/serve/graphs.py``),
its counterpart of the JAX package's ``jax.jit``.  What a graph needs of
the program is checked here on the CPU, where the programs run eagerly:
the decode offset as a 0-d int64 tensor through ``lm.decode_step``
against the reference's ``decode_step`` on the same numpy params (fp32
at the 2e-4 bound of tests/test_torch_lm.py, bf16 at 3e-2 of the
logits' abs max: the two frameworks round bf16 at other places), the
decode attention that reads the cache by kv-head group against the
``_repeat_kv`` form it replaced, a greedy ``ServeEngine.run`` against
the reference's tokens, and ``GraphedProgram``'s bookkeeping (captures,
replays, launch counts, re-capture on a changed parameter) with
``torch.cuda``'s graph faked.  Replays themselves run on the card
(``tests/test_torch_cuda.py``).
"""
import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches, np32  # noqa: F401
from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.nn import attention as tattn
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServeEngine

FP32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 3e-2


def _models(arch, dtype, seed=1):
    jcfg = jbase.smoke_variant(jbase.get_config(arch))
    tcfg = tbase.smoke_variant(tbase.get_config(arch))
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(seed))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a, jp)
    tp = lm.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg,
        device="cpu", dtype=torch.float32 if dtype == "float32"
        else torch.bfloat16)
    return jcfg, jp, tcfg, tp


def _close(got, want, dtype):
    got, want = np32(got), np32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_decode_step_with_a_tensor_offset_matches_reference(arch, dtype,
                                                            rng):
    """Prefill 8 tokens, then decode at offsets 8, 9 and 10, each given
    as a 0-d int64 tensor; the smoke qwen2 has 4 query heads over 2 kv
    heads.  The cache is the engines' bf16 in both packages."""
    jcfg, jp, tcfg, tp = _models(arch, dtype)
    assert arch != "qwen2-1.5b" or (tcfg.num_heads, tcfg.num_kv_heads) == (
        4, 2)
    B, S, MAX = 2, 8, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, B, MAX)
    tcache = lm.init_cache(tcfg, B, MAX, device="cpu")
    jl, jcache = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             jcache)
    tl, tcache = lm.prefill(tp, tcfg,
                            {"tokens": torch.from_numpy(toks[:, :S])},
                            tcache)
    _close(tl, jl, dtype)
    for off in (S, S + 1, S + 2):
        step = toks[:, off:off + 1]
        jl, jcache = jlm.decode_step(jp, jcfg, {"tokens": jnp.asarray(step)},
                                     jcache, off)
        offset = torch.tensor(off, dtype=torch.int64)
        tl, tcache = lm.decode_step(tp, tcfg,
                                    {"tokens": torch.from_numpy(step)},
                                    tcache, offset)
        assert tl.shape == (B, 1, tcfg.padded_vocab)
        _close(tl, jl, dtype)
    assert sum(_build.LAUNCHES.values()) == 0


def _repeat_kv(k, num_heads):
    """The decode path's old form: (B, S, KVH, D) -> (B, S, H, D), each kv
    head copied to its group of query heads."""
    B, S, KVH, D = k.shape
    rep = num_heads // KVH
    return k[:, :, :, None, :].expand(B, S, KVH, rep, D).reshape(
        B, S, num_heads, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,L,H,KVH,D,offset", [
    (2, 1, 24, 4, 2, 16, 9), (4, 1, 40, 12, 2, 32, 39),
    (1, 3, 16, 6, 1, 8, 5), (2, 1, 8, 4, 4, 16, 0)])
def test_grouped_decode_attention_matches_the_repeated_form(
        B, S, L, H, KVH, D, offset, dtype):
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((B, S, H, D), generator=gen).to(dtype)
    k, v = (torch.randn((B, L, KVH, D), generator=gen).to(dtype)
            for _ in range(2))
    qi = torch.tensor(offset, dtype=torch.int64) + torch.arange(S)
    valid = torch.arange(L)[None, :] <= qi[:, None]
    got = tattn.grouped_attend(q, k, v, valid)
    want = tattn._softmax_attend(q, _repeat_kv(k, H), _repeat_kv(v, H),
                                 valid)
    assert got.shape == want.shape == (B, S, H, D) and got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else BF16_TOL
    assert (got.float() - want.float()).abs().max() <= tol * max(
        1.0, want.float().abs().max())


def test_gqa_decode_takes_an_int_or_a_tensor_offset_alike(rng):
    """The cache write (``index_copy_`` at offset + arange(S)) and the
    mask read the same positions from an int and from a 0-d tensor."""
    cfg = tbase.smoke_variant(tbase.get_config("qwen2-1.5b"))
    gen = torch.Generator().manual_seed(4)
    p = tattn.gqa_init(gen, cfg, torch.float32)
    x = torch.randn((2, 1, cfg.d_model), generator=gen)
    outs = []
    for off in (5, torch.tensor(5, dtype=torch.int64)):
        cache = tuple(torch.zeros((2, 12, cfg.num_kv_heads, cfg.head_dim))
                      for _ in range(2))
        pos = torch.full((2, 1), 5, dtype=torch.int32)
        out, cache = tattn.gqa_fwd(p, cfg, x, pos, cache, off, "decode")
        assert cache[0][:, 5].abs().sum() > 0
        assert cache[0][:, :5].abs().sum() == cache[0][:, 6:].abs().sum() == 0
        outs.append((out, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_greedy_engine_gives_the_reference_tokens(arch, rng):
    jcfg, jp, tcfg, tp = _models(arch, "float32", seed=0)
    prompts = [rng.integers(0, jcfg.vocab_size, 8).astype(np.int32)
               for _ in range(5)]
    outs = []
    for eng, req in ((JServeEngine(jcfg, jp, slots=2, max_len=24), JRequest),
                     (ServeEngine(tcfg, tp, slots=2, max_len=24,
                                  device="cpu"), Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=6))
        outs.append({r.rid: r.out_tokens for r in eng.run(prompt_len=8)})
    assert outs[1] == outs[0]
    assert sorted(outs[0]) == list(range(5))
    assert all(len(t) == 6 for t in outs[0].values())


# ---------------------------------------------------------------------------
# GraphedProgram's bookkeeping, with torch.cuda's graph faked: a capture
# runs the program once more (a real capture runs nothing) and a replay
# counts itself

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Pools(list):
    """The ``pool`` each capture was given; ``streams``, its stream."""

    def __init__(self):
        super().__init__()
        self.streams = []


@pytest.fixture
def fake_graphs(monkeypatch):
    """Fake CUDA graphs; yields the ``pool`` each capture was given (and
    its capture stream, a stand-in naming the device)."""
    pools = _Pools()

    def graph(g, pool=None, stream=None):
        pools.append(pool)
        pools.streams.append(stream)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(graphs, "capture_stream",
                        lambda device: f"side stream of {device}")
    yield pools


def _program():
    """A program that "launches" cuconv_fused twice and reads w; it
    records its input and whether the garbage collector was on."""
    calls = []

    def fn(params, buffers, x):
        calls.append((x.clone(), gc.isenabled()))
        _build.LAUNCHES["cuconv_fused"] += 2
        if buffers is not None:
            buffers[0].add_(1)
        return params["w"] * x
    return fn, calls


def test_graphed_program_replays_and_counts_launches(fake_graphs):
    fn, calls = _program()
    prog = graphs.GraphedProgram(fn, [torch.zeros(3)])
    params = {"w": torch.full((3,), 2.0)}
    x = torch.tensor([1.0, 2.0, 3.0])
    out = prog(params, None, x)                   # eager, then capture
    assert torch.equal(out, 2 * x) and len(calls) == 2
    # the collector runs before a capture and is held off during it
    assert [on for _, on in calls] == [True, False] and gc.isenabled()
    assert (prog.captures, prog.replays) == (1, 0)
    assert prog.launches == {"cuconv_fused": 2}
    assert _build.LAUNCHES["cuconv_fused"] == 2   # the eager run only
    assert torch.equal(prog.inputs[0], x)
    out2 = prog(params, None, torch.ones(3))       # replay
    assert out2 is prog.outputs and len(calls) == 2
    assert torch.equal(prog.inputs[0], torch.ones(3))
    assert (prog.captures, prog.replays, prog.graph.replays) == (1, 1, 1)
    assert _build.LAUNCHES["cuconv_fused"] == 4   # as eager would count
    with pytest.raises(ValueError, match="shape"):
        prog(params, None, torch.ones(4))


def test_graphed_program_recaptures_on_a_changed_parameter(fake_graphs):
    fn, calls = _program()
    prog = graphs.GraphedProgram(fn, [torch.zeros(3)])
    params = {"w": torch.full((3,), 2.0)}
    prog(params, None, torch.ones(3))
    prog(params, None, torch.ones(3))
    assert (prog.captures, prog.replays) == (1, 1)
    params["w"].add_(1.0)                         # in place: a new version
    out = prog(params, None, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 3.0))
    assert (prog.captures, prog.replays) == (2, 1)
    prog(params, None, torch.ones(3))
    assert (prog.captures, prog.replays) == (2, 2)
    other = {"w": params["w"]}                    # another params object
    prog(other, None, torch.ones(3))
    assert (prog.captures, prog.replays) == (3, 2)
    buf = [torch.zeros(1)]                        # buffers: by address only
    prog(other, buf, torch.ones(3))
    prog(other, buf, torch.ones(3))
    assert (prog.captures, prog.replays) == (4, 3)
    with torch.inference_mode():
        frozen = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="inference"):
        prog(frozen, None, torch.ones(3))


@pytest.mark.parametrize("swap", ["top", "nested", "reshaped"])
def test_graphed_program_recaptures_on_a_tensor_swapped_into_the_dict(
        fake_graphs, swap):
    """The params are walked again on every call: a tensor put into the
    same dict (at any depth), or one at the same address in another
    shape, is a change; the program holds none of the captured ones."""
    calls = []

    def fn(params, buffers, x):
        calls.append(x)
        return params["w"].reshape(-1) * params["blocks"][0]["b"] * x
    prog = graphs.GraphedProgram(fn, [torch.zeros(3)], pool="shared")
    params = {"w": torch.full((3,), 2.0),
              "blocks": [{"b": torch.ones(3)}]}
    prog(params, None, torch.ones(3))
    prog(params, None, torch.ones(3))
    assert (prog.captures, prog.replays) == (1, 1)
    assert fake_graphs == ["shared"]              # the pool it was given
    if swap == "top":
        params["w"] = torch.full((3,), 5.0)
        want = torch.full((3,), 5.0)
    elif swap == "nested":
        params["blocks"][0]["b"] = torch.full((3,), 3.0)
        want = torch.full((3,), 6.0)
    else:                                         # same data_ptr and version
        params["w"] = params["w"].view(1, 3)
        want = torch.full((3,), 2.0)
    out = prog(params, None, torch.ones(3))
    assert torch.equal(out, want)
    assert (prog.captures, prog.replays) == (2, 1)
    prog(params, None, torch.ones(3))
    assert (prog.captures, prog.replays) == (2, 2)
    assert fake_graphs == ["shared", "shared"]


def test_graphed_program_captures_on_a_stream_of_its_inputs_device(
        fake_graphs, monkeypatch):
    """A program is captured on ``capture_stream`` of its static inputs'
    device, one side stream a device, and not on ``torch.cuda.graph``'s
    default: one stream made on whichever device captured first, on
    which a capture of another card's program records nothing (every
    replay then hands back the capture call's output, as the dispatcher
    over four cards did)."""
    fn, _ = _program()
    prog = graphs.GraphedProgram(fn, [torch.zeros(3)])
    prog({"w": torch.ones(3)}, None, torch.ones(3))
    assert fake_graphs.streams == ["side stream of cpu"]
    monkeypatch.undo()
    made = []

    class Stream:
        def __init__(self, device=None):
            made.append(device)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(graphs, "_CAPTURE_STREAMS", {})
    one = graphs.capture_stream("cuda:1")
    assert graphs.capture_stream(torch.device("cuda", 1)) is one
    assert graphs.capture_stream("cuda:2") is not one
    assert made == [1, 2]


def test_graph_capture_keeps_cached_tensors_and_restores_counts():
    with pytest.raises(RuntimeError, match="boom"):
        with _build.graph_capture() as rec:
            _build.LAUNCHES["int8_gemm"] += 3
            t = torch.ones(2)
            _build.keep_for_graph(t)
            raise RuntimeError("boom")
    assert rec == {"launches": {"int8_gemm": 3}, "keep": [t]}
    assert sum(_build.LAUNCHES.values()) == 0
    _build.keep_for_graph(torch.ones(1))          # no capture: nothing held
    assert not _build._CAPTURES
