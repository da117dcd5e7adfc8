"""Batched LM inference engine: wave batching over a static cache.

The JAX package's ``serve/engine.py`` on PyTorch.  Requests are
multiplexed onto batch *slots*; a slot holds one sequence's KV/SSM cache
region.  A wave of up to ``slots`` requests is prefilled together, its
prompts right-packed to one length so every slot shares one write
offset, then decoded step by step until every member finishes; then the
next wave is admitted.  Sampling is greedy over ``[:vocab_size]``.

The reference jits one prefill and one decode function and donates the
cache to them.  Here, on the card, each is captured as a CUDA graph
(``serve/graphs.py``): one prefill graph per prompt length, captured
after that length's first eager wave, and one decode graph, captured
after the first eager step, over static tokens and a 0-d int64 offset
tensor; both update the engine's cache buffers in place inside the
graph.  On the CPU both run eagerly.  GQA prefill attention and the
Mamba2 prefill conv run the hand-written kernels (``flash_attention``,
``conv1d_tap``); MLA attends through the plain versions, as the
reference does, and the MoE layers route with static shapes, so both
graphs capture them.  Sampling stays outside the graphs and reads their
static last-position logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convspec import resolve_device
from repro_torch.models import lm
from repro_torch.serve import graphs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (prompt_len,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, device=None):
        """``params`` must live on ``device`` (default: the card).  The
        cache is bf16, as the reference's."""
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.cache = lm.init_cache(cfg, slots, max_len, device=self.device)
        self.offset = 0                   # shared left-aligned cursor
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        #: on the card: ("prefill", prompt_len) and "decode" -> graph,
        #: all in one memory pool
        self.graphs: Dict[object, graphs.GraphedProgram] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if graphs.used_on(self.device) else None)

    def _prefill_fn(self, params, cache, tokens):
        logits, _ = lm.prefill(params, self.cfg, {"tokens": tokens}, cache)
        # a copy, so a graph's static output holds (slots, V), not the
        # whole (slots, prompt_len, V) logits behind a view
        return logits[:, -1, :].contiguous()

    def _decode_fn(self, params, cache, tokens, offset):
        logits, _ = lm.decode_step(params, self.cfg, {"tokens": tokens},
                                   cache, offset)
        return logits[:, -1, :]

    def _prefill(self, params, batch, cache):
        """Last-position logits of a prefill wave; the cache is written
        in place.  On the card through the wave length's CUDA graph."""
        tokens = batch["tokens"]
        if not graphs.used_on(self.device):
            return self._prefill_fn(params, cache, tokens), cache
        key = ("prefill", tokens.shape[1])
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = graphs.GraphedProgram(
                self._prefill_fn, [torch.empty(
                    tokens.shape, dtype=tokens.dtype, device=self.device)],
                pool=self._pool)
        return g(params, cache, tokens), cache

    def _decode(self, params, batch, cache, offset):
        """Last-position logits of one decode step at ``offset``; the
        cache is updated in place.  On the card through the decode
        CUDA graph."""
        tokens = batch["tokens"]
        if not graphs.used_on(self.device):
            return self._decode_fn(params, cache, tokens, offset), cache
        g = self.graphs.get("decode")
        if g is None:
            g = self.graphs["decode"] = graphs.GraphedProgram(
                self._decode_fn,
                [torch.empty(tokens.shape, dtype=tokens.dtype,
                             device=self.device),
                 torch.zeros((), dtype=torch.int64, device=self.device)],
                pool=self._pool)
        return g(params, cache, tokens, offset), cache

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.out_tokens = []
        self.queue.append(req)

    def _fill_batch(self, prompts_len: int):
        """Admit a wave and right-pack its prompts to one length."""
        toks = np.zeros((self.slots, prompts_len), np.int32)
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                self.active[s] = self.queue.pop(0)
            r = self.active[s]
            if r is not None:
                p = r.prompt[:prompts_len]
                toks[s, prompts_len - len(p):] = p       # right-pack
        return torch.from_numpy(toks)

    def run(self, prompt_len: int = 32) -> List[Request]:
        """Serve until queue and slots drain, one wave at a time.
        Returns finished requests."""
        finished: List[Request] = []
        while self.queue or any(r is not None for r in self.active):
            if all(r is None for r in self.active):
                # admit the next wave; stale cache beyond `offset` is
                # masked by the causal offset logic, SSM states are
                # recomputed by prefill itself
                self.offset = 0
                toks = self._fill_batch(prompt_len)
                logits, self.cache = self._prefill(
                    self.params, {"tokens": toks}, self.cache)
                self.offset = prompt_len
                self._emit(self._sample(logits), finished)
                continue
            if self.offset >= self.max_len:
                # out of cache: finish everything still active
                for s, r in enumerate(self.active):
                    if r is not None:
                        r.done = True
                        finished.append(r)
                        self.active[s] = None
                continue
            logits, self.cache = self._decode(
                self.params, {"tokens": self._current_tokens()}, self.cache,
                self.offset)
            self.offset += 1
            self._emit(self._sample(logits), finished)
        return finished

    # ------------------------------------------------------------------
    def _current_tokens(self):
        toks = np.zeros((self.slots, 1), np.int32)
        for s, r in enumerate(self.active):
            if r is not None and r.out_tokens:
                toks[s, 0] = r.out_tokens[-1]
        return torch.from_numpy(toks)

    def _sample(self, logits) -> np.ndarray:
        return logits[..., :self.cfg.vocab_size].float().argmax(-1).cpu() \
            .numpy()

    def _emit(self, next_tok, finished):
        for s, r in enumerate(self.active):
            if r is None:
                continue
            r.out_tokens.append(int(next_tok[s]))
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                finished.append(r)
                self.active[s] = None
