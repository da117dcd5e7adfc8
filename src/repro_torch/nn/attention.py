"""Attention mixers: GQA (qwen / mistral / musicgen / qwen2-vl) and MLA
(deepseek-v2).

Three functions compute attention, all numerically equivalent:
  * ``ops.flash_attention``: the hand-written kernel, which ``gqa_fwd``
    runs in "prefill" mode at every sequence length.  The JAX package
    switches there between ``exact_attention`` and its XLA
    online-softmax twin ``chunked_attention`` at ``CHUNKED_THRESHOLD``;
    the kernel is the counterpart of both, and reads the kv heads by
    stride instead of repeating them;
  * ``exact_attention`` and ``chunked_attention``: the JAX package's
    plain versions.  "train" mode takes them with the reference's own
    switch at ``CHUNKED_THRESHOLD``: autograd differentiates them, and
    the kernel has no backward;
  * decode: one query token against the cache, the plain masked einsum
    (the JAX package computes it outside any kernel too), reading the
    (B, Lmax, KVH, D) cache in place by kv head, as ``flash_attention``
    reads it by stride: no key or value is copied or repeated per query
    head.

MLA (``mla_fwd``) attends through the plain versions in every mode, as
the reference does: its q/k head dim (qk_nope + qk_rope) differs from its
v head dim, which the kernel's single head dim cannot take.
"""
from __future__ import annotations

import functools

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
    # on a mesh a head count the 'model' axis does not divide is split
    # whole (``layers.split_heads``)
    q = L.split_heads(L.dense_fwd(p["wq"], x), cfg.num_heads, cfg.head_dim)
    k = L.split_heads(L.dense_fwd(p["wk"], x), cfg.num_kv_heads,
                      cfg.head_dim)
    v = L.split_heads(L.dense_fwd(p["wv"], x), cfg.num_kv_heads,
                      cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm_fwd(p["q_norm"], q, cfg.rms_norm_eps, cfg.norm_impl)
        k = L.rmsnorm_fwd(p["k_norm"], k, cfg.rms_norm_eps, cfg.norm_impl)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.rope_impl)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.rope_impl)
    return q, k, v


def _repeat_kv(k, num_heads):
    """(B, S, KVH, D) -> (B, S, H, D) by head-group broadcast."""
    B, S, KVH, D = k.shape
    rep = num_heads // KVH
    return k[:, :, :, None, :].expand(B, S, KVH, rep, D).reshape(
        B, S, num_heads, D)


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
    return _softmax_attend(q, k, v, L.like(valid, q))


def chunked_attention(q, k, v, causal=True, chunk=KV_CHUNK):
    """Online-softmax attention over KV chunks: O(Sq * chunk) live
    memory; the JAX package's XLA twin of the flash kernel (its default
    fp32 scores), the ``lax.scan`` over chunks a loop here."""
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[1]
    nchunks = (Sk + chunk - 1) // chunk
    scale = 1.0 / torch.tensor(D, dtype=torch.float32).sqrt()
    qi = L.like(torch.arange(Sq, device=q.device)[:, None], q)
    NEG = torch.finfo(torch.float32).min / 2
    m = L.like(torch.full((B, H, Sq), float("-inf"), device=q.device), q)
    l = L.like(torch.zeros((B, H, Sq), device=q.device), q)
    acc = L.like(torch.zeros((B, H, Sq, Dv), device=q.device), q)
    for ci in range(nchunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        n = kb.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * scale
        ki = L.like(ci * chunk + torch.arange(n, device=q.device)[None, :],
                    q)
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


def _plain_attention(cfg, q, k, v):
    """The reference's switch: ``chunked_attention`` above
    ``CHUNKED_THRESHOLD`` (unless the config asks for exact attention),
    ``exact_attention`` up to it.  k, v carry q's head count."""
    if q.shape[1] > CHUNKED_THRESHOLD and cfg.attn_impl != "exact":
        return chunked_attention(q, k, v)
    return exact_attention(q, k, v)


def _attend_heads(cfg, q, k, v):
    """``_plain_attention`` on each rank's (batch, head) pairs on a mesh
    (``layers.shard_local``): the einsums flatten the batch and head
    dims, which DTensor cannot do with both sharded (torch 2.11).  Heads
    that the 'model' axis does not cut (a count it does not divide) are
    zero-padded and cut over it for the core (``layers.pad_heads``)."""
    (q, k, v), H = L.pad_heads(q, k, v)
    out = L.shard_local(functools.partial(_plain_attention, cfg), q, k, v,
                        dims=(0, 2))
    return L.unpad_heads(out, H)


def _flash_heads(cfg, q, k, v):
    """``ops.flash_attention`` (causal), the prefill's attention.  On a
    mesh it runs on each rank's (batch, head) pairs
    (``layers.shard_local``; the kernel takes local tensors), its kv
    heads repeated to the query heads' count there (a rank's query heads
    need not map onto a whole kv head) and, as in ``_attend_heads``,
    heads the 'model' axis does not cut padded and cut over it."""
    if not isinstance(q, L.DTensor):
        return ops.flash_attention(q, k, v, causal=True)
    H = cfg.num_heads
    (q, k, v), H = L.pad_heads(q, _repeat_kv(k, H), _repeat_kv(v, H))
    out = L.shard_local(functools.partial(ops.flash_attention, causal=True),
                        q, k, v, dims=(0, 2))
    return L.unpad_heads(out, H)


def gqa_fwd(p, cfg, x, positions, cache=None, offset=0, mode="train"):
    """Returns (out, cache).

    mode: "train" (no cache, the plain differentiable attention),
    "prefill" (attend within the batch through the kernel, write the
    cache at ``offset``), "decode" (attend against the cache).
    cache: (k_buf, v_buf) of shape (B, Lmax, KVH, D), updated in place
    (the JAX package donates it to its jitted step instead).  In decode
    ``offset`` may be a 0-d int64 tensor on the cache's device: the
    write, the mask and (in the caller) the positions come from it on
    the device, so one captured CUDA graph serves every step.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if mode == "train":
        out = _attend_heads(cfg, q, _repeat_kv(k, cfg.num_heads),
                            _repeat_kv(v, cfg.num_heads))
    elif mode == "prefill":
        out = _flash_heads(cfg, q, k, v)
        ck, cv = cache
        L.write(ck[:, offset:offset + S], k.to(ck.dtype))
        L.write(cv[:, offset:offset + S], v.to(cv.dtype))
    else:
        ck, cv = cache                             # (B, Lmax, KVH, D) x2
        qi = L.like(offset + torch.arange(S, device=x.device), x)  # (S,)
        L.write_at(ck, 1, qi, k.to(ck.dtype))
        L.write_at(cv, 1, qi, v.to(cv.dtype))
        ki = L.like(torch.arange(ck.shape[1], device=x.device)[None, :], x)
        out = grouped_attend(q, ck, cv, ki <= qi[:, None])
    out = L.merge_heads(out, cfg.num_heads)
    return L.dense_fwd(p["wo"], out), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV.

def mla_init(gen, cfg, dtype=L.DEFAULT_DTYPE):
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": L.dense_init(gen, cfg.d_model, cfg.num_heads * qk_dim, dtype),
        "w_dkv": L.dense_init(gen, cfg.d_model,
                              cfg.kv_lora_rank + cfg.qk_rope_dim, dtype),
        "kv_norm": L.rmsnorm_init(cfg.kv_lora_rank, gen.device),
        "w_ukv": L.dense_init(
            gen, cfg.kv_lora_rank,
            cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim), dtype),
        "wo": L.dense_init(gen, cfg.num_heads * cfg.v_head_dim, cfg.d_model,
                           dtype),
    }


def _mla_qkv(p, cfg, x, positions, latent):
    """Per-head queries (nope + roped) and the step's new latent
    (B, S, lora + rope): the normed compressed kv and the roped shared
    key.  ``latent`` (the cache) is unused, as in the reference."""
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = L.split_heads(L.dense_fwd(p["wq"], x), H, qk_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta,
                          impl=cfg.rope_impl)
    q = torch.cat([q_nope, q_rope], dim=-1)

    ckv = L.dense_fwd(p["w_dkv"], x)                       # (B,S,lora+rope)
    c_kv, k_rope = ckv.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = L.rmsnorm_fwd(p["kv_norm"], c_kv, cfg.rms_norm_eps,
                         cfg.norm_impl)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta,
                          impl=cfg.rope_impl)
    new_latent = torch.cat(L.promote(c_kv, k_rope[:, :, 0, :]), dim=-1)
    return q, new_latent


def _mla_expand(p, cfg, latent):
    """Expand a latent (B, S, lora + rope) -> per-head K (nope + rope)
    and V."""
    B, S, _ = latent.shape
    H = cfg.num_heads
    c_kv, k_rope = latent.split([cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    kv = L.split_heads(L.dense_fwd(p["w_ukv"], c_kv), H,
                       cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    k_rope = k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)
    k = torch.cat(L.promote(k_nope, k_rope), dim=-1)
    return k, v


def _decode_attend(q, k, v, valid):
    """MLA decode's attention over the expanded cache: q (B, Sq, H,
    qk_nope + qk_rope), k (B, L, H, qk_nope + qk_rope), v (B, L, H,
    v_head_dim), valid (Sq, L) bool; fp32 scores, softmax in q's
    dtype."""
    scale = 1.0 / torch.tensor(q.shape[-1], dtype=torch.float32).sqrt()
    scores = torch.einsum("bqhd,bkhd->bhqk", *L.promote(q, k)).float() * scale
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", *L.promote(w, v))


def mla_fwd(p, cfg, x, positions, cache=None, offset=0, mode="train"):
    """Returns (out, cache).

    The port of the reference's XLA path, not a fallback from a kernel:
    the reference's MLA never reaches its Pallas kernel either.  "train"
    and "prefill" expand the step's latent and attend with
    ``exact_attention`` (``chunked_attention`` above
    ``CHUNKED_THRESHOLD``); ``flash_attention`` takes one head dim for
    q, k and v, and MLA's q/k head dim (qk_nope + qk_rope) is not its v
    head dim.  cache: the (B, Lmax, kv_lora_rank + qk_rope_dim) latent,
    written in place at ``offset``.  "decode" writes it with
    ``index_copy_`` at ``offset`` (a 0-d int64 tensor on the cache's
    device serves every step from one CUDA graph), expands the whole
    buffer and masks keys past the query.
    """
    B, S, _ = x.shape
    q, latent = _mla_qkv(p, cfg, x, positions, None)
    if mode in ("train", "prefill"):
        k, v = _mla_expand(p, cfg, latent)
        out = _attend_heads(cfg, q, k, v)
        if mode == "prefill":
            L.write(cache[:, offset:offset + S], latent.to(cache.dtype))
    else:
        qi = L.like(offset + torch.arange(S, device=x.device), x)  # (S,)
        L.write_at(cache, 1, qi, latent.to(cache.dtype))
        k, v = _mla_expand(p, cfg, cache)
        ki = L.like(torch.arange(cache.shape[1], device=x.device)[None, :],
                    x)
        # on a mesh per rank's (batch, head) pairs (``layers.shard_local``):
        # DTensor's strategy search for these einsums on a 3-D mesh does
        # not finish
        (q, k, v), H = L.pad_heads(q, k, v)
        out = L.unpad_heads(L.shard_local(
            _decode_attend, q, k, v, ki <= qi[:, None], dims=(0, 2),
            whole=(3,)), H)
    out = L.merge_heads(out, cfg.num_heads)
    return L.dense_fwd(p["wo"], out), cache
