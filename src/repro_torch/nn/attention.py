"""GQA attention (qwen / mistral / musicgen / qwen2-vl).

Three functions compute attention, all numerically equivalent:
  * ``ops.flash_attention``: the hand-written kernel, which ``gqa_fwd``
    runs in "train" and "prefill" mode at every sequence length.  The
    JAX package switches there between ``exact_attention`` and its XLA
    online-softmax twin ``chunked_attention`` at ``CHUNKED_THRESHOLD``;
    the kernel is the counterpart of both, and reads the kv heads by
    stride instead of repeating them;
  * ``exact_attention`` and ``chunked_attention``: the JAX package's
    plain versions, kept as references;
  * decode: one query token against the cache, the plain masked einsum
    (the JAX package computes it outside any kernel too), reading the
    (B, Lmax, KVH, D) cache in place by kv head, as ``flash_attention``
    reads it by stride: no key or value is copied or repeated per query
    head.

MLA (deepseek-v2) waits for the MoE/MLA item of ROADMAP queue 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.nn import layers as L

CHUNKED_THRESHOLD = 2048   # where the JAX package turns to chunked_attention
KV_CHUNK = 1024


def gqa_init(gen, cfg, dtype=L.DEFAULT_DTYPE):
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.q_dim, dtype,
                           bias=cfg.qkv_bias),
        "wk": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype,
                           bias=cfg.qkv_bias),
        "wv": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dtype,
                           bias=cfg.qkv_bias),
        "wo": L.dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(cfg.head_dim, gen.device)
        p["k_norm"] = L.rmsnorm_init(cfg.head_dim, gen.device)
    return p


def _qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    q = L.dense_fwd(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = L.dense_fwd(p["wk"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = L.dense_fwd(p["wv"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm_fwd(p["q_norm"], q, cfg.rms_norm_eps, cfg.norm_impl)
        k = L.rmsnorm_fwd(p["k_norm"], k, cfg.rms_norm_eps, cfg.norm_impl)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.rope_impl)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.rope_impl)
    return q, k, v


def _softmax_attend(q, k, v, valid):
    """softmax over keys of masked fp32 scores, in q's dtype, times v.
    q: (B,Sq,H,D); k, v: (B,Sk,H,D); valid: (Sq, Sk) bool."""
    scores = torch.einsum("bqhd,bkhd->bhqk", *L.promote(q, k)).float()
    scores = scores / torch.tensor(q.shape[-1], dtype=torch.float32).sqrt()
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", *L.promote(w, v))


def grouped_attend(q, k, v, valid):
    """``_softmax_attend`` with the kv heads read in place: query head h
    attends kv head h // (H/KVH), one kv head at a time, through batched
    products on (B, Sk, D) strided views of k and v, so no key or value
    is copied.  q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); valid: (Sq, Sk)
    bool."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    scale = torch.tensor(D, dtype=torch.float32).sqrt()
    masked = ~valid[:, None, :]                             # (Sq, 1, Sk)
    outs = []
    for g in range(KVH):
        qg = q[:, :, g * rep:(g + 1) * rep].reshape(B, Sq * rep, D)
        scores = torch.bmm(*L.promote(qg, k[:, :, g].transpose(1, 2)))
        scores = (scores.float() / scale).reshape(B, Sq, rep, -1)
        scores = scores.masked_fill(masked, float("-inf"))
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.bmm(*L.promote(w.reshape(B, Sq * rep, -1), v[:, :, g]))
        outs.append(out.reshape(B, Sq, rep, D))
    return torch.cat(outs, dim=2)


def exact_attention(q, k, v, causal=True):
    """q: (B,Sq,H,D); k,v: (B,Sk,H,D). fp32 softmax accumulation."""
    Sq, Sk = q.shape[1], k.shape[1]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = (torch.arange(Sq, device=q.device)[:, None]
                 >= torch.arange(Sk, device=q.device)[None, :])
    return _softmax_attend(q, k, v, valid)


def chunked_attention(q, k, v, causal=True, chunk=KV_CHUNK):
    """Online-softmax attention over KV chunks: O(Sq * chunk) live
    memory; the JAX package's XLA twin of the flash kernel (its default
    fp32 scores), the ``lax.scan`` over chunks a loop here."""
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[1]
    nchunks = (Sk + chunk - 1) // chunk
    scale = 1.0 / torch.tensor(D, dtype=torch.float32).sqrt()
    qi = torch.arange(Sq, device=q.device)[:, None]
    NEG = torch.finfo(torch.float32).min / 2
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), device=q.device)
    for ci in range(nchunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        n = kb.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * scale
        ki = ci * chunk + torch.arange(n, device=q.device)[None, :]
        mask = ki < Sk
        if causal:
            mask = mask & (qi >= ki)
        s = s.masked_fill(~mask, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        # guard all-masked rows (m_new = NEG): they contribute nothing
        m_safe = torch.where(m_new > NEG / 2, m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0)
        corr = torch.where(m > NEG / 2, torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", *L.promote(p.to(q.dtype), vb)).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                  # (B, Sq, H, D)


def gqa_fwd(p, cfg, x, positions, cache=None, offset=0, mode="train"):
    """Returns (out, cache).

    mode: "train" (no cache), "prefill" (attend within the batch, write
    the cache at ``offset``), "decode" (attend against the cache).
    cache: (k_buf, v_buf) of shape (B, Lmax, KVH, D), updated in place
    (the JAX package donates it to its jitted step instead).  In decode
    ``offset`` may be a 0-d int64 tensor on the cache's device: the
    write, the mask and (in the caller) the positions come from it on
    the device, so one captured CUDA graph serves every step.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if mode in ("train", "prefill"):
        out = ops.flash_attention(q, k, v, causal=True)
        if mode == "prefill":
            ck, cv = cache
            ck[:, offset:offset + S] = k.to(ck.dtype)
            cv[:, offset:offset + S] = v.to(cv.dtype)
    else:
        ck, cv = cache                             # (B, Lmax, KVH, D) x2
        qi = offset + torch.arange(S, device=x.device)      # int64 (S,)
        ck.index_copy_(1, qi, k.to(ck.dtype))
        cv.index_copy_(1, qi, v.to(cv.dtype))
        ki = torch.arange(ck.shape[1], device=x.device)[None, :]
        out = grouped_attend(q, ck, cv, ki <= qi[:, None])
    out = out.reshape(B, S, cfg.q_dim)
    return L.dense_fwd(p["wo"], out), cache
