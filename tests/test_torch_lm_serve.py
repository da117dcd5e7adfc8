"""The port's LM ``ServeEngine`` against the JAX package's, on the CPU.

tests/test_serve.py's constructions through both engines, params cast to
fp32 as in tests/test_models.py:70 (the cache stays bf16, the engines'
default, so decode attends fp32 queries against a bf16 cache in both).
Each engine's prefill and decode logits are recorded and compared at
2e-4; sampled tokens must agree wherever the top-2 margin of the
reference's logits exceeds that bound.
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
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine

BOUND = 2e-4


def _models(arch, seed=0, **kw):
    jcfg, tcfg = (dataclasses.replace(
        base.smoke_variant(base.get_config(arch)), **kw)
        for base in (jbase, tbase))
    jp = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jlm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    tp = lm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu", dtype=torch.float32)
    return jcfg, jp, tcfg, tp


def _record(eng, name, log):
    """Wrap ``eng.<name>`` so each call's logits land in ``log``."""
    fn = getattr(eng, name)

    def wrapped(*args):
        logits, cache = fn(*args)
        log.append(np32(logits))
        return logits, cache
    setattr(eng, name, wrapped)


def _serve(eng, prompts, new_tokens, prompt_len, request_cls):
    log = []
    _record(eng, "_prefill", log)
    _record(eng, "_decode", log)
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=new_tokens))
    done = eng.run(prompt_len=prompt_len)
    return {r.rid: r.out_tokens for r in done}, log


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b", "deepseek-moe-16b"])
def test_engine_matches_reference(arch, rng):
    """The MoE archs run at tests/test_models.py's capacity factor 8, so
    no expert drops a token: a wave's empty slots are rows of token 0
    whose gates differ between positions only in their last bits, and
    which of them a binding capacity drops is decided by those bits,
    differently in each package."""
    jcfg, jp, tcfg, tp = _models(
        arch, **({"capacity_factor": 8.0} if "deepseek" in arch else {}))
    prompts = [rng.integers(0, jcfg.vocab_size, 8).astype(np.int32)
               for _ in range(7)]
    want, jlog = _serve(JServeEngine(jcfg, jp, slots=3, max_len=32),
                        prompts, 4, 8, JRequest)
    got, tlog = _serve(ServeEngine(tcfg, tp, slots=3, max_len=32,
                                   device="cpu"), prompts, 4, 8, Request)
    assert len(tlog) == len(jlog) == 3 * 4      # 3 waves, 1 + 3 steps
    for t, j in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, rtol=BOUND, atol=BOUND)
    # every logits row that picked a token, in the order tokens came out
    assert sorted(got) == sorted(want) == list(range(7))
    for rid in want:
        wave, slot = divmod(rid, 3)
        for step, (a, b) in enumerate(zip(got[rid], want[rid])):
            top2 = np.sort(jlog[wave * 4 + step][slot, :jcfg.vocab_size])
            if top2[-1] - top2[-2] > BOUND:
                assert a == b, (rid, step)
    assert all(0 <= t < tcfg.vocab_size for r in got.values() for t in r)
    assert sum(_build.LAUNCHES.values()) == 0


def test_engine_greedy_matches_manual_decode(rng):
    """Engine output for a single request == hand-rolled greedy loop
    (tests/test_serve.py's check, on the port)."""
    _, _, cfg, params = _models("qwen2-1.5b")
    prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    eng = ServeEngine(cfg, params, slots=1, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    done = eng.run(prompt_len=8)

    cache = lm.init_cache(cfg, 1, 32, device="cpu")
    logits, cache = lm.prefill(
        params, cfg, {"tokens": torch.from_numpy(prompt[None])}, cache)
    cur = int(logits[0, -1, :cfg.vocab_size].argmax())
    toks = [cur]
    for off in range(8, 12):
        lg, cache = lm.decode_step(
            params, cfg, {"tokens": torch.tensor([[cur]], dtype=torch.int32)},
            cache, off)
        cur = int(lg[0, 0, :cfg.vocab_size].argmax())
        toks.append(cur)
    assert done[0].out_tokens == toks


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_engine_respects_max_len_as_the_reference(arch, rng):
    jcfg, jp, tcfg, tp = _models(arch)
    prompt = rng.integers(0, 255, 8).astype(np.int32)
    outs = []
    for eng, req in ((JServeEngine(jcfg, jp, slots=2, max_len=12), JRequest),
                     (ServeEngine(tcfg, tp, slots=2, max_len=12,
                                  device="cpu"), Request)):
        eng.submit(req(rid=0, prompt=prompt, max_new_tokens=100))
        done = eng.run(prompt_len=8)
        assert len(done) == 1 and done[0].done
        outs.append(done[0].out_tokens)
    assert len(outs[1]) == len(outs[0]) == 12 - 8 + 1


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    cfg = tbase.smoke_variant(tbase.get_config("qwen2-1.5b"))
    params = lm.init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.params_from_numpy({"segments": []}, cfg)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_cpu_serving_launches_no_kernel(arch, rng):
    cfg = tbase.smoke_variant(tbase.get_config(arch))
    eng = ServeEngine(cfg, lm.init_lm(cfg, seed=1, device="cpu"), slots=3,
                      max_len=32, device="cpu")
    for i in range(7):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=4))
    done = eng.run(prompt_len=8)
    assert len(done) == 7 and all(len(r.out_tokens) == 4 for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-moe-16b"])
def test_launcher_serves_the_deepseek_pair_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <deepseek> --smoke
    --device cpu``: every request gets its tokens, no kernel launches."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                   "--requests", "4"])
    out = capsys.readouterr().out
    assert "[serve] 4 requests, 64 tokens" in out
    assert sum(_build.LAUNCHES.values()) == 0
